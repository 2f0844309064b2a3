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
from torch_recording import recording  # noqa: F401  (a fixture)


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
def test_strip_kernel_matches_plain(card, m, recording):
    """Identical pivots and avail, values bit for bit: both round every
    operation the same way."""
    rng = np.random.default_rng(m)
    sb = torch.as_tensor(_cplx(rng, (8, 32, m)), device=card)
    av = torch.as_tensor(rng.random((8, m)) < 0.9, device=card)
    av[:, :32] = True
    before = recording.count("launch.strip_elim")
    out_k, piv_k, av_k = se.eliminate_strip(sb, av)
    assert recording.count("launch.strip_elim") == before + 1
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
def test_fused_panel_kernel_matches_plain(card, m, bs, recording):
    """Identical perms, values bit for bit: the kernel and the plain
    version take every sum in the same order and round alike."""
    rng = np.random.default_rng(m + bs)
    A = torch.as_tensor(_cplx(rng, (8, m, bs)), device=card)
    before = recording.count("launch.panel_fused")
    p_k, perm_k = pf.factor_panel_fused(A)
    assert recording.count("launch.panel_fused") == before + 1
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
def test_panel_lu_kernel_matches_plain(card, m, bs, dtype, recording):
    rng = np.random.default_rng(m + bs)
    A = torch.as_tensor(_cplx(rng, (8, m, bs), dtype), device=card)
    before = recording.count("launch.panel_lu")
    p_k, perm_k = pl.factor_panel_lu(A)
    assert recording.count("launch.panel_lu") == before + 1
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
def test_blocked_inverse_on_card_matches_cpu(card, recording):
    """The blocked LU on the card (kernel strips) and on the CPU (plain
    strips) agree: same pivots, float32 rounding of different GEMMs."""
    rng = np.random.default_rng(5)
    A = _cplx(rng, (4, 300, 300))
    before = recording.count("launch.strip_elim")
    X_card = tzl.zinv(torch.as_tensor(A, device=card), bs=128).cpu().numpy()
    assert recording.count("launch.strip_elim") > before
    X_cpu = tzl.zinv(torch.as_tensor(A), bs=128).numpy()
    ref = np.linalg.inv(A.astype(np.complex128))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(X_card - ref)) < 1e-3 * scale
    assert np.max(np.abs(X_card - X_cpu)) < 1e-3 * scale


# ---------------------------------------------------------------------------
# The fixed-point kernels (csrc/fixed_point.cu, csrc/sancho_rubio.cu)
# ---------------------------------------------------------------------------

# Where kernel and plain stop at the same sweep, the results agree to
# max(1e-10, 10 s) of the lane's largest entry, s the lane's difference
# between the plain version on the card and on the host: Gauss-Jordan
# against getrf/getri pivots differ only in rounding, which a decimation in
# the band amplifies through nearly singular blocks (chip_smoke.py phase
# 14 states the same rule).  A lane may stop one sweep apart only where the
# earlier stopper's last metric lies within max(1e-6 conv, 1e-13) of conv
# (the metric of the two inversion orders differs by a few ulp of
# max|sigma|); such a lane agrees to 10 conv.  (Phase 14 also runs the
# Dyson map at conv 1e-11, where its element-wise metric sits at its
# rounding floor and lanes may stop several sweeps apart.)
HELD_REL = 1e-10
METRIC_FLOOR = 1e-13


def fixed_point_held(vals_k, vals_p, counts_k, counts_p, metric_k, metric_p,
                     conv, vals_h=None):
    """Largest per-lane relative difference under the rule above (vals_h:
    the plain version's result on the host, for s); raises AssertionError
    where a lane breaks it."""
    vk, vp = vals_k.cpu().numpy(), vals_p.cpu().numpy()
    ck, cp = counts_k.cpu().numpy().reshape(len(vk), -1), \
        counts_p.cpu().numpy().reshape(len(vk), -1)
    mk, mp = metric_k.cpu().numpy().reshape(ck.shape), \
        metric_p.cpu().numpy().reshape(ck.shape)
    worst = 0.0
    for i in range(len(vk)):
        axes = tuple(range(vk[i].ndim))
        rel = float(np.abs(vk[i] - vp[i]).max(axis=axes)
                    / max(np.abs(vp[i]).max(), 1e-300))
        if (ck[i] == cp[i]).all():
            spread = 0.0 if vals_h is None else float(
                np.abs(vals_h[i] - vp[i]).max() / np.abs(vp[i]).max())
            assert rel <= max(HELD_REL, 10 * spread), (i, rel, spread)
        else:
            for j in np.nonzero(ck[i] != cp[i])[0]:
                early = mk[i, j] if ck[i, j] < cp[i, j] else mp[i, j]
                assert abs(int(ck[i, j]) - int(cp[i, j])) == 1, (i, ck, cp)
                assert abs(early - conv) <= max(1e-6 * conv,
                                                METRIC_FLOOR), (i, early, conv)
            assert rel <= 10 * conv, (i, rel)
        worst = max(worst, rel)
    return worst


def _au_operators(b, seed, device):
    from gaunegf_tpu_torch.models import harrison as hr
    from gaunegf_tpu_torch.models import slater_koster as sk
    p = hr.bethe_params("Au")
    n_vecs = sk.fcc111_neighbor_directions(np.array([0, 0, 1.0]),
                                           np.array([1.0, 0, 0]))
    Sl = np.stack([sk.bond_matrix(p.overlap, d) for d in n_vecs])
    Vl = np.stack([sk.bond_matrix(p.hopping, d) for d in n_vecs])
    rng = np.random.default_rng(seed)
    E = rng.uniform(-10.0, 4.0, b) + 1j * rng.uniform(0.0, 0.05, b)
    z = E - 1e-5j
    A = z[:, None, None] * np.eye(9) - p.h0()
    B = z[:, None, None, None] * Sl - Vl
    return (torch.as_tensor(A, device=device),
            torch.as_tensor(B, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 24, 64, 96, 129, 400])
@pytest.mark.parametrize("conv", [1e-5, 1e-11])
@pytest.mark.parametrize("mode", [("jacobi", True, False),
                                  ("seidel", True, False),
                                  ("jacobi", False, False),
                                  ("seidel", False, False),
                                  ("jacobi", True, True),
                                  ("jacobi", False, True),
                                  (None, True, True)])
def test_fixed_point_kernel_matches_plain(card, mode, conv, b, recording):
    """Every mode of kernel A against its plain version on the card, with a
    per-lane warm seed for the surface loop alone (the k-space mode), at
    lane counts that give one lane a CTA (b up to the SM count) and three
    (400 = 3 * 133 + 1: a CTA with one lane, two of its slots idle)."""
    from gaunegf_tpu_torch.ops.kernels import fixed_point as fpk
    bulk, exclusion, surface = mode
    A, B = _au_operators(b, 11, card)
    if bulk is None:
        rng = np.random.default_rng(12)
        A = A - 0.3j * torch.eye(9, dtype=A.dtype, device=card)
        seed = torch.as_tensor(0.05 * _cplx(rng, (b, 9, 9, 9), np.complex128),
                               device=card)
    else:
        seed = (-1j * torch.eye(9, dtype=A.dtype, device=card)).expand(
            b, 12, 9, 9)
    before = recording.count("launch.fixed_point")
    kb, ks_, ck, mk = fpk.fixed_point(A, B, seed, conv, 0.5, 1000, bulk,
                                      exclusion, surface)
    assert recording.count("launch.fixed_point") == before + 1
    pb, ps, cp, mp = fpk.fixed_point_plain(A, B, seed, conv, 0.5, 1000, bulk,
                                           exclusion, surface)
    torch.cuda.synchronize()
    assert (ck[:, 0 if bulk else 1] >= 1).all()
    for k, p in ((kb, pb), (ks_, ps)):
        assert (k is None) == (p is None)
        if k is not None:
            assert torch.isfinite(k).all()
            fixed_point_held(k, p, ck, cp, mk, mp, conv)


@pytest.mark.cuda
@pytest.mark.parametrize("max_iter", [0, 1])
@pytest.mark.parametrize("mode", [("jacobi", True, True),
                                  ("seidel", True, False),
                                  (None, True, True)])
def test_fixed_point_kernel_nan_lane_and_max_iter(card, mode, max_iter):
    """A lane whose seed is NaN stops after its first sweep with a NaN
    metric while the lanes that share its CTA run on and match plain;
    max_iter 0 and 1 are honoured (counts 0 and inf metrics, or one
    sweep)."""
    from gaunegf_tpu_torch.ops.kernels import fixed_point as fpk
    bulk, exclusion, surface = mode
    b = 400                                   # three lanes a CTA
    A, B = _au_operators(b, 13, card)
    slots = 12 if bulk else 9
    seed = (-1j * torch.eye(9, dtype=A.dtype, device=card)).expand(
        b, slots, 9, 9).clone()
    seed[1] = float("nan")
    for iters in (max_iter, 1000):
        kb, ks_, ck, mk = fpk.fixed_point(A, B, seed, 1e-5, 0.5, iters, bulk,
                                          exclusion, surface)
        pb, ps, cp, mp = fpk.fixed_point_plain(A, B, seed, 1e-5, 0.5, iters,
                                               bulk, exclusion, surface)
        torch.cuda.synchronize()
        assert torch.equal(ck[1], cp[1]) and bool(mk[1].isnan().any()
                                                  or iters == 0)
        keep = torch.ones(b, dtype=torch.bool, device=card)
        keep[1] = False
        assert torch.equal(ck[keep], cp[keep])
        for k, p in ((kb, pb), (ks_, ps)):
            if k is not None:
                assert torch.isnan(k[1]).any()
                fixed_point_held(k[keep], p[keep], ck[keep], cp[keep],
                                 mk[keep], mp[keep], 1e-5)
        if iters == 0:
            assert (ck == 0).all() and torch.isinf(mk).all()


def _lead_case(n, b, card):
    rng = np.random.default_rng(n)
    alpha = rng.standard_normal((n, n)) * 0.3
    alpha = alpha + alpha.T
    beta = -np.eye(n) + 0.1 * rng.standard_normal((n, n))
    E = np.linspace(-2.6, 2.4, b) + 1j * 1e-4
    A = torch.as_tensor(E[:, None, None] * np.eye(n) - alpha, device=card)
    B = torch.as_tensor(np.broadcast_to(-beta, A.shape).copy(), device=card)
    return A, B


_SANCHO_CASES = [(mode, n, 37) for mode in ("sancho", "dyson")
                 for n in (1, 2, 8, 9, 16, 17, 27, 32, 33, 40, 64, 150)] + [
    ("sancho", 150, b) for b in (1, 16, 22, 26, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,n,b", _SANCHO_CASES)
def test_sancho_rubio_kernel_matches_plain(card, mode, n, b, recording):
    """Kernel B in both modes against its plain version on the card: the
    scalar layout (n = 1), n threads a lane (2..16; 37 lanes leave the last
    warp ragged), one CTA a lane in shared memory (17..32), the Dyson map in
    the global scratch (33, 40, 64, 150) and the Sancho mode's cluster
    layout there (37 lanes: 3 CTAs a lane on an H100); at n = 150 (the Si
    nanowire's lead cell) lane counts that pick clusters of 8, 6, 5, 4, 2
    and 1 CTAs on an H100."""
    from gaunegf_tpu_torch.ops.kernels import sancho_rubio as srk
    A, B = _lead_case(n, b, card)
    max_iter = 64 if mode == "sancho" else 2000
    before = recording.count("launch.sancho_rubio")
    gk, ck, mk = srk.decimate(A, B, 1e-8, max_iter, mode)
    assert recording.count("launch.sancho_rubio") == before + 1
    gp, cp, mp = srk.decimate_plain(A, B, 1e-8, max_iter, mode)
    gh, _, _ = srk.decimate_plain(A.cpu(), B.cpu(), 1e-8, max_iter, mode)
    torch.cuda.synchronize()
    assert torch.isfinite(gk).all()
    fixed_point_held(gk, gp, ck, cp, mk, mp, 1e-8, gh.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("max_iter", [0, 1])
@pytest.mark.parametrize("n", [1, 2, 9, 17, 40, 64, 150])
@pytest.mark.parametrize("mode", ["sancho", "dyson"])
def test_sancho_rubio_kernel_nan_lane_and_max_iter(card, mode, n, max_iter):
    """A NaN lane stops after one iteration (NaN result, count 1) without
    stalling the lanes that share its warp, which match plain; max_iter 0
    and 1 are honoured."""
    from gaunegf_tpu_torch.ops.kernels import sancho_rubio as srk
    A, B = _lead_case(n, 11, card)
    A[3] = float("nan")
    keep = torch.arange(11, device=card) != 3
    for iters in (max_iter, 64 if mode == "sancho" else 2000):
        gk, ck, mk = srk.decimate(A, B, 1e-8, iters, mode)
        gp, cp, mp = srk.decimate_plain(A, B, 1e-8, iters, mode)
        gh, _, _ = srk.decimate_plain(A.cpu(), B.cpu(), 1e-8, iters, mode)
        torch.cuda.synchronize()
        assert torch.equal(ck, cp)
        assert torch.isnan(gk[3]).all()
        fixed_point_held(gk[keep], gp[keep], ck[keep], cp[keep], mk[keep],
                         mp[keep], 1e-8, gh.numpy()[keep.cpu().numpy()])
        if iters == 0:
            assert (ck == 0).all() and torch.isinf(mk).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [22, 64])
def test_sancho_rubio_counts_the_cluster_lanes(card, b, recording):
    """A Sancho call at n = 150 takes the cluster layout and adds its b
    lanes to sancho.cluster_lanes; a Dyson call at n = 150 adds none.  The
    C entry point picks the cluster width the wrapper states for the
    clusters this card holds (each width times its CTAs within the SMs)."""
    from gaunegf_tpu_torch.ops.kernels import sancho_rubio as srk
    A, B = _lead_case(150, b, card)
    lib, cap = srk.build(), srk.card_clusters()
    assert all(cap[c - 1] * c <= torch.cuda.get_device_properties(
        card).multi_processor_count for c in range(1, 9))
    for n, mode in ((150, 0), (150, 1), (33, 0), (32, 0), (257, 0)):
        name = ("sancho", "dyson")[mode]
        assert lib.gaunegf_sancho_rubio_cluster_width(n, b, mode) == \
            srk.cluster_width(n, b, name, cap)
    before = recording.count("sancho.cluster_lanes")
    srk.decimate(A, B, 1e-8, 64, "sancho")
    assert recording.count("sancho.cluster_lanes") == before + b
    srk.decimate(A, B, 1e-8, 3, "dyson")
    torch.cuda.synchronize()
    assert recording.count("sancho.cluster_lanes") == before + b


@pytest.mark.cuda
def test_fixed_point_model_functions_launch_the_kernels(card, monkeypatch,
                                                       recording):
    """On CUDA tensors the model functions launch the kernels and never
    call a plain version; complex64 blocks are refused."""
    from gaunegf_tpu_torch.models import bethe as bt
    from gaunegf_tpu_torch.models import chain1d as tchain
    from gaunegf_tpu_torch.ops.kernels import fixed_point as fpk
    from gaunegf_tpu_torch.ops.kernels import sancho_rubio as srk

    def refuse(*a, **k):
        raise AssertionError("a plain fixed point ran on a CUDA tensor")
    monkeypatch.setattr(fpk, "fixed_point_plain", refuse)
    monkeypatch.setattr(srk, "decimate_plain", refuse)
    A, B = _au_operators(4, 1, card)
    launches = lambda: (recording.count("launch.fixed_point"),
                        recording.count("launch.sancho_rubio"))
    before = launches()
    E = torch.linspace(-4, 1, 4, device=card).to(torch.complex128)
    from gaunegf_tpu_torch.models import harrison as hr
    from gaunegf_tpu_torch.models import slater_koster as sk
    p = hr.bethe_params("Au")
    n_vecs = sk.fcc111_neighbor_directions(np.array([0, 0, 1.0]),
                                           np.array([1.0, 0, 0]))
    Sl = np.stack([sk.bond_matrix(p.overlap, d) for d in n_vecs])
    Vl = np.stack([sk.bond_matrix(p.hopping, d) for d in n_vecs])
    H = torch.as_tensor(p.h0(), device=card)
    surf, bulk = bt.bethe_sigma_surface(E, H, Sl, Vl, 1e-5,
                                        sig0=-1j * np.eye(9)[None].repeat(
                                            12, 0))
    assert surf.shape == (4, 9, 9, 9) and bulk.shape == (4, 12, 9, 9)
    g = tchain.surface_g_sancho(A[:, :2, :2].contiguous(),
                                B[:, 0, :2, :2].contiguous())
    assert g.shape == (4, 2, 2)
    assert launches() == (before[0] + 1, before[1] + 1)
    with pytest.raises(TypeError):
        srk.decimate(A.to(torch.complex64), A.to(torch.complex64), 1e-5, 64)
    with pytest.raises(TypeError):
        fpk.fixed_point(A.to(torch.complex64), B, B, 1e-5, 0.5, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_near_pole_guard_values_on_the_card(card, overlap, recording):
    """The near-pole guard's eigenvalues of a 1000-orbital pencil, taken
    on the card from the engine's complex128 H and S, match the host's
    eigvalsh to 1e-12 of the largest |lambda|; the guard copies nothing
    to the card and reads its values back once."""
    import warnings

    import scipy.linalg

    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.interop import constant_self_energy_from_arrays
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    n = 1000
    rng = np.random.default_rng(1000 + overlap)
    A = rng.standard_normal((n, n))
    H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1)) + 0.02 * (A + A.T)
    S = np.eye(n)
    if overlap:
        S = S + 0.08 * (np.eye(n, k=1) + np.eye(n, k=-1))
    g = constant_self_energy_from_arrays(
        H, S, (np.arange(8), np.arange(n - 8, n)), -0.1j, -0.1j)
    eng = EnergyEngine(H, S, g, ExecutionConfig(solver="lu"), device=card)
    lam_ref = scipy.linalg.eigvalsh(H, S)
    h2d, d2h = recording.count("wait.h2d"), recording.count("wait.d2h")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        eng._near_pole_guard(np.linspace(-2.0, 2.0, 64) + 0j)
    assert recording.count("guard.eigvals") == 1
    assert recording.count("wait.h2d") == h2d
    assert recording.count("wait.d2h") == d2h + 1
    assert eng._pole_lam.dtype == np.float64
    assert np.max(np.abs(eng._pole_lam - lam_ref)) \
        <= 1e-12 * np.max(np.abs(lam_ref))
