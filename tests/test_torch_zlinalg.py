"""The port's blocked complex LU (ops/zlinalg.py) vs the JAX package.

Complex64 inputs made with NumPy from a seed go through both packages:
JAX's blocked solve with the 'pstrip' panel (its Pallas strip kernel in
interpret mode) and the port's, which runs the strip kernel's plain
version on the CPU.  Both are partial-pivot LUs of the same matrix in
float32 with the same pivots but differently rounded updates, so each is
within ~cond * u32 * growth of the truth: the random matrices here have
cond ~750 (u32 = 6e-8), measured differences 2e-4 of the solution's
largest entry, bound 1e-3.  The mixed tier is held to its contract
(2e-6 relative) against a complex128 NumPy inverse.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaunegf_tpu.ops import zlinalg as jzl
from gaunegf_tpu_torch.ops import zlinalg as tzl

N, BS = 192, 64
LU_REL = 1e-3
MIXED_REL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(7)
    A = (rng.standard_normal((2, N, N))
         + 1j * rng.standard_normal((2, N, N))).astype(np.complex64)
    B = (rng.standard_normal((2, N, 5))
         + 1j * rng.standard_normal((2, N, 5))).astype(np.complex64)
    return A, B


def _rel(x, ref):
    return np.max(np.abs(np.asarray(x) - ref)) / np.max(np.abs(ref))


def test_zinv_matches_jax_blocked_and_lapack(system):
    A, _ = system
    X_t = tzl.zinv(torch.as_tensor(A), bs=BS, panel_impl="pstrip").numpy()
    eye = np.broadcast_to(np.eye(N, dtype=np.complex64), A.shape)
    X_j = np.asarray(jzl.zsolve(jnp.asarray(A), jnp.asarray(eye),
                                method="blocked", bs=BS,
                                panel_impl="pstrip"))
    X_ref = np.linalg.inv(A.astype(np.complex128))
    assert _rel(X_t, X_j) < LU_REL
    assert _rel(X_t, X_ref) < LU_REL


def test_zsolve_rhs_matches_jax(system):
    A, B = system
    X_t = tzl.zsolve(torch.as_tensor(A), torch.as_tensor(B), bs=BS).numpy()
    X_j = np.asarray(jzl.zsolve(jnp.asarray(A), jnp.asarray(B),
                                method="blocked", bs=BS, panel_impl="pstrip"))
    assert _rel(X_t, X_j) < LU_REL
    assert _rel(X_t, np.linalg.solve(A.astype(complex), B)) < LU_REL


def test_zlu_factor_solve_matches_jax(system):
    A, B = system
    f_t = tzl.zlu_factor(torch.as_tensor(A), bs=BS, panel_impl="pstrip")
    X_t = tzl.zlu_solve(f_t, torch.as_tensor(B)).numpy()
    f_j = jzl.zlu_factor(jnp.asarray(A), bs=BS, panel_impl="pstrip")
    X_j = np.asarray(jzl.zlu_solve(f_j, jnp.asarray(B)))
    assert _rel(X_t, X_j) < LU_REL
    # the saved pivots are the JAX package's, panel by panel
    for p_t, p_j in zip(f_t["data"]["perms"], f_j["data"]["perms"]):
        assert np.array_equal(p_t.numpy(), np.asarray(p_j))


@pytest.mark.parametrize("n", [5, 37, 100])
def test_zinv_odd_sizes_pad(n):
    """Sizes off the panel grid pad to block-diag(A, I) and panels of at
    most one strip (bs < 64) take the single-strip path."""
    rng = np.random.default_rng(n)
    A = (rng.standard_normal((1, n, n))
         + 1j * rng.standard_normal((1, n, n))).astype(np.complex64)
    X = tzl.zinv(torch.as_tensor(A)).numpy()
    assert _rel(X, np.linalg.inv(A.astype(complex))) < LU_REL


def test_zinv_refined_mixed_contract(system):
    """Mixed tier: complex64 seed + one complex128-residual Newton step,
    against the complex128 operator itself."""
    A, _ = system
    A128 = A.astype(np.complex128)
    X = tzl.zinv_refined(torch.as_tensor(A128), steps=1, bs=BS).numpy()
    assert X.dtype == np.complex64
    assert _rel(X, np.linalg.inv(A128)) < MIXED_REL


def test_zinv_refined_keeps_seed_when_singular():
    """A residual >= 0.5 (kappa ~ 1/eps32) keeps the seed instead of a
    noise-amplifying Newton step."""
    A = np.zeros((1, 16, 16), np.complex128)
    A[0, 0, 0] = 1.0
    X0 = tzl.zinv(torch.as_tensor(A.astype(np.complex64))).numpy()
    X1 = tzl.zinv_refined(torch.as_tensor(A), steps=1).numpy()
    assert np.array_equal(np.nan_to_num(X0), np.nan_to_num(X1))


def test_default_method_is_blocked_for_complex64(system, monkeypatch):
    """method=None on complex64 runs the blocked LU, never the library."""
    def boom(*a, **k):
        raise AssertionError("torch.linalg.solve called")
    monkeypatch.setattr(torch.linalg, "solve", boom)
    A, _ = system
    tzl.zinv(torch.as_tensor(A[:1]), bs=BS)


@pytest.mark.parametrize("name", ["auto", "scan", "pstrip", None])
def test_panel_names_resolve_to_strip_panel(name):
    assert tzl._pick_panel(1000, name) == "pstrip"


@pytest.mark.parametrize("name", ["split", "psplit", "virtual", "fused",
                                  "fused3", "pallas", "xla"])
def test_unported_panel_names_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tzl._pick_panel(1000, name)


def test_unknown_panel_name_is_an_error():
    with pytest.raises(ValueError):
        tzl._pick_panel(1000, "bogus")


@pytest.mark.parametrize("n,req,want", [(1000, None, 256), (999, None, 128),
                                        (1000, 64, 64), (48, None, 32),
                                        (5, None, 8)])
def test_pick_block(n, req, want):
    assert tzl._pick_block(n, req) == want


def test_fractional_matrix_power_matches_jax():
    rng = np.random.default_rng(3)
    M = rng.standard_normal((12, 12))
    S = M @ M.T + 12 * np.eye(12)
    got = tzl.fractional_matrix_power(torch.as_tensor(S), -0.5).numpy()
    ref = np.asarray(jzl.fractional_matrix_power(jnp.asarray(S), -0.5))
    assert np.max(np.abs(got - ref)) < 1e-12
