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
from torch_recording import recording  # noqa: F401  (a fixture)

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


def test_cpu_wrapper_runs_the_plain_version(recording):
    A = torch.as_tensor(_panels(5, (2, 40, 8), np.complex64))
    p_w, perm_w = kpl.factor_panel_lu(A)
    p_p, perm_p = kpl.factor_panel_lu_plain(A)
    assert recording.count("launch.panel_lu") == 0
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


def _update(vr, vi, lr, li, ur, ui):
    """v - l * u in the plain version's order and rounding."""
    return vr - (lr * ur - li * ui), vi - (lr * ui + li * ur)


def _factor_left_looking(panel, nb):
    """The operation order of the card's kernel (csrc/panel_lu.cu), on the
    CPU: column sub-panels J of width nb, each first taking the pending
    updates of every earlier sub-panel K in k order (K's rows of J by
    forward substitution with K's unit-lower triangle, then K's rank-nb
    update of the rows below), then factored right-looking; the columns
    outside J take J's row swaps after J, in pivot order."""
    B, m, bs = panel.shape
    re, im = panel.real.clone(), panel.imag.clone()
    perm = torch.arange(m).repeat(B, 1)
    bi = torch.arange(B)
    for j0 in range(0, bs, nb):
        w = min(nb, bs - j0)
        ar, ai = re[:, :, j0:j0 + w].clone(), im[:, :, j0:j0 + w].clone()
        for k0 in range(0, j0, nb):
            for r in range(k0 + 1, k0 + nb):
                for k in range(k0, r):
                    ar[:, r], ai[:, r] = _update(
                        ar[:, r], ai[:, r], re[:, r, k, None],
                        im[:, r, k, None], ar[:, k], ai[:, k])
            below = slice(k0 + nb, m)
            for k in range(k0, k0 + nb):
                ar[:, below], ai[:, below] = _update(
                    ar[:, below], ai[:, below], re[:, below, k, None],
                    im[:, below, k, None], ar[:, None, k], ai[:, None, k])
        pivots = []
        for t in range(w):
            j = j0 + t
            cr, ci = ar[:, j:, t], ai[:, j:, t]
            p = torch.argmax(cr * cr + ci * ci, dim=1) + j
            pivots.append(p)
            for x in (ar, ai):
                rj, rp = x[bi, j].clone(), x[bi, p].clone()
                x[bi, p] = rj
                x[bi, j] = rp
            pr, pi = ar[:, j, t:t + 1], ai[:, j, t:t + 1]
            den = pr * pr + pi * pi
            den = torch.where(den == 0, torch.ones_like(den), den)
            inv_r, inv_i = pr / den, -pi / den
            cr, ci = ar[:, j + 1:, t], ai[:, j + 1:, t]
            lr, li = cr * inv_r - ci * inv_i, cr * inv_i + ci * inv_r
            ar[:, j + 1:, t + 1:], ai[:, j + 1:, t + 1:] = _update(
                ar[:, j + 1:, t + 1:], ai[:, j + 1:, t + 1:], lr[:, :, None],
                li[:, :, None], ar[:, j, None, t + 1:], ai[:, j, None, t + 1:])
            ar[:, j + 1:, t], ai[:, j + 1:, t] = lr, li
        for t, p in enumerate(pivots):
            for x in (re, im, perm):
                rj, rp = x[bi, j0 + t].clone(), x[bi, p].clone()
                x[bi, p] = rj
                x[bi, j0 + t] = rp
        re[:, :, j0:j0 + w], im[:, :, j0:j0 + w] = ar, ai
    return torch.complex(re, im), perm


def _blocked_order_panel(kind, dtype):
    rng = np.random.default_rng(len(kind))
    if kind == "tie":                       # |3+4i|^2 == |5|^2: exact ties
        A = rng.integers(-2, 3, (2, 64, 40)).astype(dtype)
        A[:, ::3] = 3 + 4j
        A[:, 1::3] = 5
        return A
    if kind == "zero-column":               # column 5 -> den == 0 guard
        A = _panels(7, (2, 72, 40), dtype)
        A[:, :, 5] = 0
        return A
    m, bs = {"tall": (96, 48), "square": (64, 64), "ragged": (80, 36)}[kind]
    return _panels(m + bs, (2, m, bs), dtype)


@pytest.mark.parametrize("kind", ["tall", "square", "ragged", "tie",
                                  "zero-column"])
@pytest.mark.parametrize("nb", [8, 16, 32])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_blocked_order_is_bit_identical(kind, nb, dtype):
    """The kernel's left-looking sub-panel order gives every element the
    same updates, in the same k order and rounding, as the right-looking
    plain version: identical values and permutation, bit for bit."""
    A = torch.as_tensor(_blocked_order_panel(kind, dtype))
    p_b, perm_b = _factor_left_looking(A, nb)
    p_p, perm_p = kpl.factor_panel_lu_plain(A)
    assert torch.equal(perm_b, perm_p)
    assert torch.equal(p_b, p_p)
    assert torch.isfinite(p_b).all()
