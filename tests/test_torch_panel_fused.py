"""The fused panel factorization (ops/kernels/panel_fused.py) vs the JAX
package.

The same NumPy panels go through the TPU kernel
``gaunegf_tpu.ops.pallas.panel_fused.factor_panel_fused`` in interpret
mode and through the port's plain version (what the wrapper runs on the
CPU).  The eliminations are the same operations, so the pivot sequences
agree exactly.  The deferred updates are not: the JAX kernel sums the 32
terms of each strip's trailing product in one float32 dot, inverts L11^T
by a Neumann product and writes W into the pivot lanes as (U + W) - U,
while the port substitutes and accumulates one term at a time.  Each
differs from the exact update by ~32 u32 per strip, and the panel's
values grow through its strips, so the bound is 1e-5 (~84 u32) of the
panel's largest value (measured 2.4e-6 at (160, 64)).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaunegf_tpu.ops.pallas.panel_fused import factor_panel_fused
from gaunegf_tpu_torch.ops import zlinalg as tzl
from gaunegf_tpu_torch.ops.kernels import panel_fused as kpf
from gaunegf_tpu_torch.ops.kernels import strip_elim as kse

REL = 1e-5
MIXED_REL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _panels(seed, shape, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("m,bs,rel", [(96, 32, REL), (160, 64, REL),
                                      (64, 16, REL), (64, 64, 10 * REL)])
def test_plain_matches_jax_kernel(m, bs, rel):
    """Several strips, one strip narrower than 32, and m == bs (the last
    panel of an LU, whose last columns are sums of cancelling terms:
    measured 1.1e-5 of the largest value, bound 10x)."""
    A = _panels(m * bs, (2, m, bs))
    p_j, perm_j = factor_panel_fused(jnp.asarray(A), interpret=True)
    p_t, perm_t = kpf.factor_panel_fused(torch.as_tensor(A))
    assert perm_t.dtype == torch.int64
    assert np.array_equal(perm_t.numpy(), np.asarray(perm_j))
    p_j = np.asarray(p_j)
    assert np.max(np.abs(p_t.numpy() - p_j)) < rel * np.max(np.abs(p_j))


def test_same_pivots_as_strip_scanned_panel():
    """Kernel 2 fuses the strip-scanned panel: the pivot sequence and the
    packing are the 'pstrip' panel's."""
    A = torch.as_tensor(_panels(4, (2, 128, 64)))
    p_f, perm_f = kpf.factor_panel_fused(A)
    p_s, perm_s = tzl._factor_panel_scan(A)
    assert torch.equal(perm_f, perm_s)
    assert float((p_f - p_s).abs().max()) < REL * float(p_s.abs().max())


def test_cpu_wrapper_runs_the_plain_version():
    A = torch.as_tensor(_panels(5, (2, 64, 32)))
    before = kpf.LAUNCHES
    p_w, perm_w = kpf.factor_panel_fused(A)
    p_p, perm_p = kpf.factor_panel_fused_plain(A)
    assert kpf.LAUNCHES == before
    assert torch.equal(p_w, p_p) and torch.equal(perm_w, perm_p)


def test_fused3_resolves_to_the_fused_panel():
    assert tzl._pick_panel(1000, "fused3") == "fused"
    assert tzl._pick_panel(1000, "fused") == "fused"
    A = _panels(6, (1, 64, 64))
    X3 = tzl.zinv(torch.as_tensor(A), bs=32, panel_impl="fused3")
    X1 = tzl.zinv(torch.as_tensor(A), bs=32, panel_impl="fused")
    assert torch.equal(X3, X1)


def test_complex128_raises():
    """The JAX kernel casts a complex128 panel to float32 silently; the
    port refuses it."""
    with pytest.raises(ValueError, match="complex64"):
        tzl._pick_panel(1000, "fused", torch.complex128)
    A128 = torch.as_tensor(_panels(7, (1, 64, 64), np.complex128))
    with pytest.raises(ValueError, match="complex64"):
        tzl.zinv(A128, method="blocked", panel_impl="fused")
    with pytest.raises(ValueError, match="complex64"):
        kpf.factor_panel_fused(A128[:, :, :32])


def test_mixed_tier_zinv_on_fused_panel_holds_contract():
    """Mixed tier on the fused panel: complex64 seed + one complex128
    Newton step, against the complex128 operator (contract 2e-6)."""
    A = _panels(8, (2, 128, 128), np.complex128)
    X = tzl.zinv_refined(torch.as_tensor(A), steps=1, bs=64,
                         panel_impl="fused").numpy()
    ref = np.linalg.inv(A)
    assert X.dtype == np.complex64
    assert np.max(np.abs(X - ref)) / np.max(np.abs(ref)) < MIXED_REL


def _sub_mul(ar, ai, wr, wi, br, bi):
    """a - w * b in the kernel's order and rounding."""
    return ar - (wr * br - wi * bi), ai - (wr * bi + wi * br)


def _factor_cluster_schedule(panel, ncta, reverse_k=False):
    """The operation order of the card's kernel (csrc/panel_fused.cu), on
    the CPU, in the panel's stored (B, m, bs) layout (lanes are rows): the
    lanes split into ncta contiguous CTA ranges; per strip column a
    per-CTA argmax and a combine (first lane on ties), the winner's
    columns as G's column; each CTA solving W for every later column
    itself and updating only its own lanes, in groups of 8 later columns
    that the two halves of a CTA take in turn (half 0 groups 0, 2, ...,
    half 1 groups 1, 3, ...; the next strip's 32 columns among them, all
    written in place before any is read as the next strip), each element's
    terms in ascending k (descending with reverse_k, in the first group
    only: a broken order the test must catch); W into the pivot lanes."""
    B, m, bs = panel.shape
    S = min(32, bs)
    W = -(-m // ncta)
    ranges = [(r * W, min(m, (r + 1) * W)) for r in range(ncta)
              if r * W < m]
    re, im = panel.real.clone(), panel.imag.clone()
    avail = torch.ones((B, m), dtype=torch.bool)
    bi = torch.arange(B)
    pivrows = torch.empty((B, bs), dtype=torch.int64)
    for s0 in range(0, bs, S):
        s1 = s0 + S
        Gr = torch.empty((B, S, S))
        Gi = torch.empty((B, S, S))
        for j in range(S):
            mag = torch.where(avail, kse._hypot(re[:, :, s0 + j],
                                                im[:, :, s0 + j]),
                              torch.full((B, m), -1.0))
            cand = torch.stack([lo + torch.argmax(mag[:, lo:hi], dim=1)
                                for lo, hi in ranges], dim=1)
            cmag = mag.gather(1, cand)
            p = cand.gather(1, torch.argmax(cmag, dim=1)[:, None])[:, 0]
            ur, ui = re[bi, p, s0:s1], im[bi, p, s0:s1]          # (B, S)
            Gr[:, :, j], Gi[:, :, j] = ur, ui
            inv_r, inv_i = kpf._recip_den(ur[:, j:j + 1], ui[:, j:j + 1])
            avail[bi, p] = False
            for lo, hi in ranges:
                cr, ci = re[:, lo:hi, s0 + j], im[:, lo:hi, s0 + j]
                lr = cr * inv_r - ci * inv_i
                li = cr * inv_i + ci * inv_r
                vr, vi = _sub_mul(re[:, lo:hi, s0 + j + 1:s1],
                                  im[:, lo:hi, s0 + j + 1:s1],
                                  ur[:, None, j + 1:], ui[:, None, j + 1:],
                                  lr[:, :, None], li[:, :, None])
                keep = avail[:, lo:hi]
                re[:, lo:hi, s0 + j] = torch.where(keep, lr, cr)
                im[:, lo:hi, s0 + j] = torch.where(keep, li, ci)
                re[:, lo:hi, s0 + j + 1:s1] = torch.where(
                    keep[:, :, None], vr, re[:, lo:hi, s0 + j + 1:s1])
                im[:, lo:hi, s0 + j + 1:s1] = torch.where(
                    keep[:, :, None], vi, im[:, lo:hi, s0 + j + 1:s1])
            pivrows[:, s0 + j] = p
        rest = bs - s1
        if rest == 0:
            break
        piv = pivrows[:, s0:s1]
        Ur = re[bi[:, None], piv, s1:].transpose(1, 2)            # (B, rest, S)
        Ui = im[bi[:, None], piv, s1:].transpose(1, 2)
        new_re, new_im = re.clone(), im.clone()
        for lo, hi in ranges:
            # this CTA's W = U (L11^T)^-1, column i, then the updates k > i
            Wr, Wi = Ur.clone(), Ui.clone()
            for i in range(S - 1):
                for k in range(i + 1, S):
                    Wr[:, :, k], Wi[:, :, k] = _sub_mul(
                        Wr[:, :, k], Wi[:, :, k], Wr[:, :, i], Wi[:, :, i],
                        Gr[:, None, i, k], Gi[:, None, i, k])
            keep = avail[:, lo:hi, None]
            Lr, Li = re[:, lo:hi, s0:s1], im[:, lo:hi, s0:s1]
            for r0 in [*range(0, rest, 16), *range(8, rest, 16)]:
                r1 = r0 + 8
                ks = range(S - 1, -1, -1) if reverse_k and r0 == 0 \
                    else range(S)
                ar = re[:, lo:hi, s1 + r0:s1 + r1]
                ai = im[:, lo:hi, s1 + r0:s1 + r1]
                for k in ks:
                    ar, ai = _sub_mul(ar, ai, Wr[:, None, r0:r1, k],
                                      Wi[:, None, r0:r1, k],
                                      Lr[:, :, k, None], Li[:, :, k, None])
                new_re[:, lo:hi, s1 + r0:s1 + r1] = torch.where(
                    keep, ar, re[:, lo:hi, s1 + r0:s1 + r1])
                new_im[:, lo:hi, s1 + r0:s1 + r1] = torch.where(
                    keep, ai, im[:, lo:hi, s1 + r0:s1 + r1])
            # the owners write W into their pivot lanes
            own = (piv >= lo) & (piv < hi)
            for b in range(B):
                for k in torch.nonzero(own[b])[:, 0].tolist():
                    new_re[b, piv[b, k], s1:] = Wr[b, :, k]
                    new_im[b, piv[b, k], s1:] = Wi[b, :, k]
        re, im = new_re, new_im
    rows = torch.complex(re, im)
    perm = kpf.virtual_perm(pivrows, avail)
    return rows.gather(1, perm[:, :, None].expand(B, m, bs)), perm


def _schedule_panel(kind):
    if kind == "tie":                       # |3+4i| == |5|: exact ties
        A = np.random.default_rng(9).integers(-2, 3, (2, 96, 64))
        A = A.astype(np.complex64)
        A[:, ::3] = 3 + 4j
        A[:, 1::3] = 5
        return A, 2
    if kind == "zero-column":               # column 5 -> den == 0 guard
        A = _panels(10, (2, 128, 64))
        A[:, :, 5] = 0
        return A, 3
    m, bs, ncta = kind
    return _panels(m * bs + ncta, (2, m, bs)), ncta


@pytest.mark.parametrize("kind", [(96, 32, 2), (160, 64, 2), (256, 256, 3),
                                  (64, 16, 2), (40, 8, 3), (300, 96, 3),
                                  "tie", "zero-column"])
def test_cluster_schedule_is_bit_identical(kind):
    """The card kernel's schedule (CTA lane ranges, per-CTA W solves, the
    trailing update in column groups taken by two halves of a CTA) gives
    every element the plain version's operations in the same order:
    identical perms and values, bit for bit.  (300, 96) on 3 CTAs has lane
    ranges of 100, not a multiple of 32."""
    A, ncta = _schedule_panel(kind)
    A = torch.as_tensor(A)
    p_s, perm_s = _factor_cluster_schedule(A, ncta)
    p_p, perm_p = kpf.factor_panel_fused_plain(A)
    assert torch.equal(perm_s, perm_p)
    assert torch.equal(p_s, p_p)
    assert torch.isfinite(p_s).all()


def test_cluster_schedule_catches_a_reversed_k_order():
    """The mirror is sensitive to the order of one update's terms: the
    first look-ahead group summed over k in descending order differs."""
    A = torch.as_tensor(_panels(11, (2, 160, 64)))
    p_s, _ = _factor_cluster_schedule(A, 2, reverse_k=True)
    p_p, _ = kpf.factor_panel_fused_plain(A)
    assert not torch.equal(p_s, p_p)
