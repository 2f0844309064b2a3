"""The swap-pivoted panel LU (ops/kernels/panel_lu.py) vs the JAX package.

The same NumPy panels go through the TPU kernel
``gaunegf_tpu.ops.pallas.panel_lu.factor_panel_pallas`` in interpret mode
and through the port's plain version (what the wrapper runs on the CPU).
Both pick pivots by re^2 + im^2 and perform the same operations, so the
permutations agree exactly; the values differ only where XLA contracts
a product and a sum into one rounding: within 1e-5 of panels of O(1)
values in complex64 and 1e-12 in complex128.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaunegf_tpu.ops.pallas.panel_lu import factor_panel_pallas
from gaunegf_tpu_torch.ops import zlinalg as tzl
from gaunegf_tpu_torch.ops.kernels import panel_lu as kpl

BOUND = {np.complex64: 1e-5, np.complex128: 1e-12}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _panels(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("m,bs", [(32, 8), (64, 32), (96, 32)])
def test_plain_matches_jax_kernel(m, bs, dtype):
    A = _panels(m + bs, (3, m, bs), dtype)
    p_j, perm_j = factor_panel_pallas(jnp.asarray(A), interpret=True)
    p_t, perm_t = kpl.factor_panel_lu(torch.as_tensor(A))
    assert perm_t.dtype == torch.int64 and p_t.dtype == torch.as_tensor(A).dtype
    assert np.array_equal(perm_t.numpy(), np.asarray(perm_j))
    assert np.max(np.abs(p_t.numpy() - np.asarray(p_j))) < BOUND[dtype]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_square_panel_matches_jax_kernel(dtype):
    """m == bs, the last panel of an LU.  Its last columns are sums of
    cancelling terms (the values grow ~10x), so the rounding differences
    reach ~1e-5 of the largest value in complex64 (measured 1.3e-5
    absolute): bound 10x the tall panels' bound, relative to it."""
    A = _panels(64, (3, 32, 32), dtype)
    p_j, perm_j = factor_panel_pallas(jnp.asarray(A), interpret=True)
    p_t, perm_t = kpl.factor_panel_lu(torch.as_tensor(A))
    assert np.array_equal(perm_t.numpy(), np.asarray(perm_j))
    p_j = np.asarray(p_j)
    assert np.max(np.abs(p_t.numpy() - p_j)) \
        < 10 * BOUND[dtype] * np.max(np.abs(p_j))


def test_packed_panel_reconstructs_rows():
    """packed = L \\ U of the rows perm of the input: L U == A[perm]."""
    A = _panels(3, (2, 48, 16), np.complex128)
    packed, perm = kpl.factor_panel_lu_plain(torch.as_tensor(A))
    P = packed.numpy()
    for b in range(2):
        L = np.tril(P[b], -1)
        L[:16] += np.eye(16)
        U = np.triu(P[b][:16])
        assert np.allclose(L @ U, A[b][perm[b].numpy()], atol=1e-12)


def test_zero_column_and_ties_stay_finite():
    """A zero column meets the den == 0 guard; exact |c|^2 ties pick the
    first row, as jnp.argmax does."""
    A = np.zeros((1, 8, 4), np.complex128)
    A[0, :, 0] = [3 + 4j, 5, -5, 4 - 3j, 0, 1, 2, 3]   # |c|^2 = 25 ties
    A[0, :, 2] = 0
    A[0, :, 1] = np.arange(8)
    A[0, :, 3] = 1j * np.arange(8)
    p_t, perm_t = kpl.factor_panel_lu(torch.as_tensor(A))
    p_j, perm_j = factor_panel_pallas(jnp.asarray(A), interpret=True)
    assert perm_t[0, 0] == 0
    assert np.array_equal(perm_t.numpy(), np.asarray(perm_j))
    assert np.isfinite(p_t.numpy()).all()
    assert np.max(np.abs(p_t.numpy() - np.asarray(p_j))) < 1e-12


def test_cpu_wrapper_runs_the_plain_version():
    A = torch.as_tensor(_panels(5, (2, 40, 8), np.complex64))
    before = kpl.LAUNCHES
    p_w, perm_w = kpl.factor_panel_lu(A)
    p_p, perm_p = kpl.factor_panel_lu_plain(A)
    assert kpl.LAUNCHES == before
    assert torch.equal(p_w, p_p) and torch.equal(perm_w, perm_p)


def test_zinv_complex128_on_pallas_panel():
    """The high tier's solve: the complex128 blocked LU on this panel."""
    A = _panels(11, (2, 100, 100), np.complex128)
    X = tzl.zinv(torch.as_tensor(A), method="blocked", bs=32,
                 panel_impl="pallas").numpy()
    ref = np.linalg.inv(A)
    assert np.max(np.abs(X - ref)) / np.max(np.abs(ref)) < 1e-11


def test_zinv_complex64_on_pallas_panel():
    A = _panels(12, (1, 96, 96), np.complex64)
    X = tzl.zinv(torch.as_tensor(A), bs=32, panel_impl="pallas").numpy()
    ref = np.linalg.inv(A.astype(np.complex128))
    assert np.max(np.abs(X - ref)) / np.max(np.abs(ref)) < 1e-3


def test_complex128_auto_panel_is_pallas():
    assert tzl._pick_panel(1000, "auto", torch.complex128) == "pallas"
    assert tzl._pick_panel(1000, None, torch.complex128) == "pallas"
    with pytest.raises(ValueError, match="complex64"):
        tzl._pick_panel(1000, "pstrip", torch.complex128)
