"""CUDA kernels of gaunegf_tpu_torch against their plain versions, on the
card.  Imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Elsewhere every test skips (decided inside the test, never at import).
"""

import numpy as np
import pytest
import torch

from gaunegf_tpu_torch.ops import zlinalg as tzl
from gaunegf_tpu_torch.ops.kernels import panel_fused as pf
from gaunegf_tpu_torch.ops.kernels import panel_lu as pl
from gaunegf_tpu_torch.ops.kernels import strip_elim as se


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _cplx(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1024, 384, 128])
def test_strip_kernel_matches_plain(card, m):
    """Identical pivots and avail, values bit for bit: both round every
    operation the same way."""
    rng = np.random.default_rng(m)
    sb = torch.as_tensor(_cplx(rng, (8, 32, m)), device=card)
    av = torch.as_tensor(rng.random((8, m)) < 0.9, device=card)
    av[:, :32] = True
    before = se.LAUNCHES
    out_k, piv_k, av_k = se.eliminate_strip(sb, av)
    assert se.LAUNCHES == before + 1
    out_p, piv_p, av_p = se.eliminate_strip_plain(sb, av)
    torch.cuda.synchronize()
    assert torch.equal(piv_k, piv_p) and torch.equal(av_k, av_p)
    assert torch.equal(out_k, out_p)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,m", [(32, 4096), (16, 1000), (8, 300),
                                    (32, 9000)])
def test_strip_kernel_cluster_shapes(card, rows, m):
    """Cluster sizing: 8 CTAs at m = 4096, lanes per CTA that are not a
    multiple of 32, fewer than 32 rows, and m = 9000, where each CTA keeps
    part of its lanes in device memory.  Bit for bit against plain."""
    rng = np.random.default_rng(rows + m)
    sb = torch.as_tensor(_cplx(rng, (4, rows, m)), device=card)
    av = torch.as_tensor(rng.random((4, m)) < 0.9, device=card)
    av[:, :rows] = True
    out_k, piv_k, av_k = se.eliminate_strip(sb, av)
    out_p, piv_p, av_p = se.eliminate_strip_plain(sb, av)
    torch.cuda.synchronize()
    assert torch.equal(piv_k, piv_p) and torch.equal(av_k, av_p)
    assert torch.equal(out_k, out_p)


@pytest.mark.cuda
def test_strip_kernel_rejects_what_it_cannot_take(card):
    sb = torch.zeros((2, 32, 64), dtype=torch.complex64, device=card)
    av = torch.ones((2, 64), dtype=torch.bool, device=card)
    with pytest.raises(TypeError):
        se.eliminate_strip(sb.to(torch.complex128), av)
    with pytest.raises(TypeError):
        se.eliminate_strip(sb, av.to(torch.uint8))
    with pytest.raises(ValueError):
        se.eliminate_strip(torch.zeros((2, 33, 64), dtype=torch.complex64,
                                       device=card),
                           av)


@pytest.mark.cuda
@pytest.mark.parametrize("m,bs", [(1024, 256), (256, 256), (96, 32),
                                  (64, 16)])
def test_fused_panel_kernel_matches_plain(card, m, bs):
    """Identical perms, values bit for bit: the kernel and the plain
    version take every sum in the same order and round alike."""
    rng = np.random.default_rng(m + bs)
    A = torch.as_tensor(_cplx(rng, (8, m, bs)), device=card)
    before = pf.LAUNCHES
    p_k, perm_k = pf.factor_panel_fused(A)
    assert pf.LAUNCHES == before + 1
    p_p, perm_p = pf.factor_panel_fused_plain(A)
    torch.cuda.synchronize()
    assert torch.equal(perm_k, perm_p) and torch.equal(p_k, p_p)


@pytest.mark.cuda
@pytest.mark.parametrize("m,bs", [(4096, 256), (4096, 16), (1000, 64),
                                  (3000, 512), (12000, 64)])
def test_fused_panel_kernel_cluster_shapes(card, m, bs):
    """Cluster sizing at batch 4 (8 CTAs a panel): m = 4096, one strip
    narrower than 32, lanes per CTA that are not a multiple of 32 (1000),
    bs = 512 with W taking half of shared memory and a few lanes of each
    CTA in device memory (3000), and m = 12000, where about half of each
    CTA's lanes stay in device memory.  Bit for bit against plain."""
    rng = np.random.default_rng(m + bs)
    A = torch.as_tensor(_cplx(rng, (4, m, bs)), device=card)
    p_k, perm_k = pf.factor_panel_fused(A)
    p_p, perm_p = pf.factor_panel_fused_plain(A)
    torch.cuda.synchronize()
    assert torch.equal(perm_k, perm_p) and torch.equal(p_k, p_p)
    cfg = pf.config(m, bs, 4)
    assert cfg["ncta"] == 8 and cfg["lanes"] == -(-m // 8)
    assert (cfg["on_chip"] < cfg["lanes"]) == (m in (3000, 12000))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("m,bs", [(1024, 256), (256, 256), (40, 8)])
def test_panel_lu_kernel_matches_plain(card, m, bs, dtype):
    rng = np.random.default_rng(m + bs)
    A = torch.as_tensor(_cplx(rng, (8, m, bs), dtype), device=card)
    before = pl.LAUNCHES
    p_k, perm_k = pl.factor_panel_lu(A)
    assert pl.LAUNCHES == before + 1
    p_p, perm_p = pl.factor_panel_lu_plain(A)
    torch.cuda.synchronize()
    assert torch.equal(perm_k, perm_p) and torch.equal(p_k, p_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("m,bs", [(4096, 256), (4096, 16), (1000, 24),
                                  (3000, 200), (12000, 64)])
def test_panel_lu_kernel_cluster_shapes(card, m, bs, dtype):
    """Cluster and sub-panel sizing: m = 4096 (8 CTAs; nb = 16 in
    complex128), bs below 32 and not a multiple of the sub-panel width,
    heights that are not a multiple of a CTA's rows, and m = 12000 (nb = 8
    in complex128).  Bit for bit against plain."""
    rng = np.random.default_rng(m + bs)
    A = torch.as_tensor(_cplx(rng, (4, m, bs), dtype), device=card)
    p_k, perm_k = pl.factor_panel_lu(A)
    p_p, perm_p = pl.factor_panel_lu_plain(A)
    torch.cuda.synchronize()
    assert torch.equal(perm_k, perm_p) and torch.equal(p_k, p_p)


@pytest.mark.cuda
def test_panel_kernels_reject_what_they_cannot_take(card):
    A = torch.zeros((2, 64, 48), dtype=torch.complex64, device=card)
    with pytest.raises(ValueError):
        pf.factor_panel_fused(A)                  # 48 % 32 != 0
    with pytest.raises(ValueError):
        pf.factor_panel_fused(A[:, :, :32].to(torch.complex128))
    with pytest.raises(TypeError):
        pl.factor_panel_lu(A.real)


@pytest.mark.cuda
@pytest.mark.parametrize("panel", ["fused", "pallas"])
def test_blocked_inverse_on_kernel_panels(card, panel):
    """complex64 inverses through each panel kernel agree with complex128,
    and complex128 through the swap-pivoted panel to ~1e-12."""
    rng = np.random.default_rng(6)
    A = _cplx(rng, (4, 300, 300))
    X = tzl.zinv(torch.as_tensor(A, device=card), bs=128,
                 panel_impl=panel).cpu().numpy()
    ref = np.linalg.inv(A.astype(np.complex128))
    assert np.max(np.abs(X - ref)) < 1e-3 * np.max(np.abs(ref))
    if panel == "pallas":
        A128 = A.astype(np.complex128)
        X = tzl.zinv(torch.as_tensor(A128, device=card), method="blocked",
                     bs=128, panel_impl=panel).cpu().numpy()
        assert np.max(np.abs(X - ref)) < 1e-11 * np.max(np.abs(ref))


@pytest.mark.cuda
def test_blocked_inverse_on_card_matches_cpu(card):
    """The blocked LU on the card (kernel strips) and on the CPU (plain
    strips) agree: same pivots, float32 rounding of different GEMMs."""
    rng = np.random.default_rng(5)
    A = _cplx(rng, (4, 300, 300))
    before = se.LAUNCHES
    X_card = tzl.zinv(torch.as_tensor(A, device=card), bs=128).cpu().numpy()
    assert se.LAUNCHES > before
    X_cpu = tzl.zinv(torch.as_tensor(A), bs=128).numpy()
    ref = np.linalg.inv(A.astype(np.complex128))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(X_card - ref)) < 1e-3 * scale
    assert np.max(np.abs(X_card - X_cpu)) < 1e-3 * scale
