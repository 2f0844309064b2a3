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

import jax
import jax.numpy as jnp

from gaunegf_tpu.ops import zlinalg as jzl
from gaunegf_tpu_torch.ops import zlinalg as tzl
from gaunegf_tpu_torch.parallel.launch import spawn_ranks
import torch_chain_ranks as cr

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


@pytest.mark.parametrize("name", ["split", "psplit", "virtual", "xla"])
def test_unported_panel_names_raise(name):
    """The XLA panel names, which raised before they were ported, resolve
    to themselves and run through zinv to the JAX package's zinv on the
    same name (the LU bound; the pivots are compared panel by panel in
    test_xla_panels_match_jax)."""
    assert tzl._pick_panel(1000, name) == name
    A = _panels(3, (1, 64, 64), np.complex64) + 8 * np.eye(64)
    X_t = tzl.zinv(torch.as_tensor(A), bs=32, panel_impl=name).numpy()
    X_j = np.asarray(jzl.zinv(jnp.asarray(A), method="blocked", bs=32,
                              panel_impl=name))
    assert _rel(X_t, X_j) < LU_REL


# ---------------------------------------------------------------------------
# The XLA panels against the JAX package's panel functions
# ---------------------------------------------------------------------------

def _panels(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _panel_case(kind, dtype):
    """(B, m, bs) panels: random tall / square / one-strip, or a first
    column of exact magnitude ties (|3+4i| = |5| = |-5| = |4-3i|) whose
    first maximum is row 1, or a zero column (a zero pivot)."""
    if kind == "tie":
        A = _panels(1, (2, 96, 64), dtype)
        A[:, :, 0] = np.resize([1, 5, 3 + 4j, -5, 4 - 3j, 2], 96)
        return A
    if kind == "zero-column":
        A = _panels(2, (2, 80, 64), dtype)
        A[:, :, 7] = 0
        return A
    m, bs = {"tall": (160, 64), "square": (64, 64), "strip": (130, 32)}[kind]
    return _panels(m + bs, (2, m, bs), dtype)


def _jax_panel(name):
    if name == "xla":
        return lambda p: jzl._factor_panel(
            p, jnp.arange(p.shape[0], dtype=jnp.int32))
    if name == "virtual":
        return jzl._factor_panel_virtual
    if name == "split":
        return jzl._factor_panel_split
    # psplit: the Pallas strip kernel at every leaf, in interpret mode
    return lambda p: jzl._factor_panel_split(p, strip_impl="pallas")


_PORT_PANEL = {"xla": tzl._factor_panel_xla,
               "virtual": tzl._factor_panel_virtual,
               "split": tzl._factor_panel_split,
               "psplit": lambda p: tzl._dispatch_panel(p, "psplit")}
# unit roundoff of the panel's dtype; the bound below is 4 bs u relative
# to the packed panel's largest entry: each entry passes at most bs
# eliminations, rounded differently in the two packages (complex
# division and the fused multiply-adds); measured up to 1.1 bs u
_U = {np.complex64: 2.0 ** -24, np.complex128: 2.0 ** -53}


# 'psplit' runs the complex64 strip kernel; on complex128 it raises
# (test_psplit_refuses_complex128)
_PANEL_DTYPES = [(name, dtype) for name in ("xla", "virtual", "split",
                                            "psplit")
                 for dtype in (np.complex64, np.complex128)
                 if not (name == "psplit" and dtype == np.complex128)]


@pytest.mark.parametrize("kind", ["tall", "square", "strip", "tie",
                                  "zero-column"])
@pytest.mark.parametrize("name,dtype", _PANEL_DTYPES)
def test_xla_panels_match_jax(name, dtype, kind):
    """Each panel against the JAX function on the same panels: the perm
    is equal (the partial-pivot sequence, first row on ties) and the
    packed values agree to a few roundings per elimination."""
    A = _panel_case(kind, dtype)
    p_j, perm_j = jax.vmap(_jax_panel(name))(jnp.asarray(A))
    p_t, perm_t = _PORT_PANEL[name](torch.as_tensor(A))
    assert perm_t.dtype == torch.int64
    assert np.array_equal(perm_t.numpy(), np.asarray(perm_j))
    if kind == "tie":
        assert (perm_t[:, 0] == 1).all()
    p_j = np.asarray(p_j)
    assert p_t.dtype == torch.as_tensor(A).dtype
    assert np.isfinite(p_t.numpy()).all()
    assert _rel(p_t.numpy(), p_j) < 4 * A.shape[-1] * _U[dtype]


def test_psplit_refuses_complex128():
    with pytest.raises(ValueError, match="complex64 only"):
        tzl._pick_panel(1000, "psplit", torch.complex128)
    for name in ("xla", "virtual", "split"):
        assert tzl._pick_panel(1000, name, torch.complex128) == name


@pytest.mark.parametrize("name", ["xla", "virtual", "split", "psplit"])
def test_psplit_leaves_run_the_strip_kernel(name, monkeypatch):
    """'psplit' hands every leaf strip to the strip kernel's wrapper (a
    (B, <= 32, m) transposed strip); the other names never call it."""
    from gaunegf_tpu_torch.ops.kernels import strip_elim
    seen = []

    def spy(sb, avail):
        seen.append(tuple(sb.shape))
        return strip_elim.eliminate_strip(sb, avail)
    monkeypatch.setattr(tzl, "eliminate_strip", spy)
    tzl._dispatch_panel(torch.as_tensor(_panels(5, (2, 160, 128),
                                                np.complex64)), name)
    if name == "psplit":
        assert seen == [(2, 32, 160), (2, 32, 128), (2, 32, 96),
                        (2, 32, 64)]
    else:
        assert seen == []


@pytest.mark.parametrize("name", ["xla", "virtual", "split", "psplit"])
def test_zinv_panel_names_match_jax(name):
    """zinv and zsolve on each name against the JAX package's on the same
    name (N=128 in two panels of 64, one split each): complex64 at the LU
    bound, complex128 ('xla', 'virtual', 'split') against the JAX x64
    solve at 1e-10."""
    n = 128
    A = _panels(9, (2, n, n), np.complex64)
    B = _panels(10, (2, n, 3), np.complex64)
    eye = np.broadcast_to(np.eye(n), A.shape)
    X_t = tzl.zinv(torch.as_tensor(A), bs=64, panel_impl=name).numpy()
    X_j = np.asarray(jzl.zsolve(jnp.asarray(A), jnp.asarray(
        eye.astype(np.complex64)), method="blocked", bs=64,
        panel_impl=name))
    assert _rel(X_t, X_j) < LU_REL
    Y_t = tzl.zsolve(torch.as_tensor(A), torch.as_tensor(B), bs=64,
                     panel_impl=name).numpy()
    assert _rel(Y_t, np.linalg.solve(A.astype(complex), B)) < LU_REL
    if name == "psplit":
        return
    A128 = A.astype(np.complex128)
    X_t = tzl.zinv(torch.as_tensor(A128), method="blocked", bs=64,
                   panel_impl=name).numpy()
    X_j = np.asarray(jzl.zsolve(jnp.asarray(A128), jnp.asarray(
        eye.astype(complex)), method="blocked", bs=64, panel_impl=name))
    assert _rel(X_t, X_j) < 1e-10


@pytest.fixture(scope="module")
def world_m(tmp_path_factory):
    return spawn_ranks(2, cr.dist_checks, (), backend="gloo",
                       init_dir=str(tmp_path_factory.mktemp("dist_m")),
                       timeout=300)


@pytest.mark.parametrize("name", ["split", "virtual", "psplit"])
def test_zsolve_dist_panels_match_serial(world_m, name):
    """zsolve_dist on two 'm' ranks (gloo) on 'split', 'virtual' and
    'psplit' against zsolve on the same panel: every rank the same
    solution, within the complex64 LU bound of the serial one (the
    distributed trailing updates round in another order)."""
    assert [r["coords"]["m"] for r in world_m] == [0, 1]
    r0 = world_m[0][name]
    assert np.array_equal(world_m[1][name]["dist"], r0["dist"])
    assert _rel(r0["dist"], r0["serial"]) < LU_REL
    A, B = cr.dist_system()
    assert _rel(r0["dist"], np.linalg.solve(A.astype(complex), B)) < LU_REL


@pytest.mark.parametrize("name", ["xla", "fused"])
def test_zsolve_dist_refuses_other_panels(name):
    with pytest.raises(ValueError, match="zsolve_dist supports"):
        tzl._dist_panel(1000, name, torch.complex64)


@pytest.mark.parametrize("name,want", [("fused", "fused"), ("fused3", "fused"),
                                       ("pallas", "pallas")])
def test_kernel_panel_names_resolve(name, want):
    """The two panel kernels ported beside the strip kernel; 'fused3' (the
    TPU's bf16-split mode) is an alias of 'fused'."""
    assert tzl._pick_panel(1000, name) == want


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


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_library_wrappers(dtype):
    """inv, solve, eigh, eig (reference utils.py) on tensors."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((6, 6)) + 1j * rng.standard_normal((6, 6))
    A = torch.as_tensor(a + 6 * np.eye(6)).to(dtype)
    B = torch.as_tensor(rng.standard_normal((6, 2)) + 0j).to(dtype)
    tol = 1e-4 if dtype == torch.complex64 else 1e-12
    eye = torch.eye(6, dtype=dtype)
    assert (tzl.inv(A) @ A - eye).abs().max() < tol
    assert (A @ tzl.solve(A, B) - B).abs().max() < tol
    Hm = A + A.conj().T
    w, v = tzl.eigh(Hm)
    assert (Hm @ v - v * w).abs().max() < 10 * tol
    w, v = tzl.eig(A)
    assert (A @ v - v * w).abs().max() < 10 * tol
    assert tzl.inv(A).dtype == dtype and w.dtype == dtype
    if dtype == torch.complex128:       # the JAX package's wrappers (x64)
        assert np.abs(np.asarray(jzl.inv(jnp.asarray(A.numpy())))
                      - tzl.inv(A).numpy()).max() < tol
        assert np.abs(np.sort_complex(np.asarray(jzl.eig(jnp.asarray(
            A.numpy()))[0])) - np.sort_complex(w.numpy())).max() < 1e-10
