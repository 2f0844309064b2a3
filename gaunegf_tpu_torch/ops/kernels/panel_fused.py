"""Fused panel factorization: the whole strip-scanned panel as one kernel.

Replaces the TPU kernel ``gaunegf_tpu/ops/pallas/panel_fused.py::
factor_panel_fused`` (``lu_panel='fused'``; ``'fused3'``, its bf16-split
mode for the TPU matrix unit, is an alias here).  One call factors a
batch of complex64 (m, bs) panels by virtual pivoting on the transposed
(bs, m) layout (rows = panel columns, lanes = panel rows), strip by strip
(strip = min(32, bs) rows):

* eliminations with the TPU kernel's arithmetic: masked ``hypot`` argmax
  over the available lanes (first lane on ties), reciprocal
  (pr, -pi) / (pr^2 + pi^2) with a zero denominator reading as 1,
  multipliers at the available lanes other than the pivot, rank-1 update
  of the strip's later rows;
* the deferred update of the panel's later rows: G[j, k] = strip[j,
  piv_k] gives the unit upper L11^T, W = U (L11^T)^-1 with U the later
  rows at the pivot lanes (forward substitution), rest -= W L over the
  still-available lanes, and W into the pivot lanes.

The packing is the strip-scanned panel's (``pack_virtual``): pivot rows
first in elimination order, then the unused rows in ascending order.

On the card the hand-written CUDA kernel ``csrc/panel_fused.cu`` runs: one
thread-block cluster per batch element, its lanes split over the CTAs,
each strip held in shared memory from its look-ahead update to its store
(``config`` gives the cluster shape it picks).  It factors a contiguous
copy of the panel in place in the stored (B, m, bs) layout, and the
wrapper packs the rows with one gather; the source describes its design
and bound.  On the CPU the plain PyTorch version ``factor_panel_fused_plain``
runs instead.  Both take every sum in the same order and round every
operation alike (the substitution and the trailing update accumulate
over k one term at a time), so they agree bit for bit.

A complex128 panel raises ValueError (the TPU kernel casts it to
float32 silently).  The counter ``launch.panel_fused`` (utils/logging) counts
the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from gaunegf_tpu_torch.ops.kernels import _build
from gaunegf_tpu_torch.utils.logging import perf_count
from gaunegf_tpu_torch.ops.kernels.strip_elim import eliminate_strip_plain

__all__ = ["factor_panel_fused", "factor_panel_fused_plain", "pack_virtual",
           "virtual_perm", "build", "config", "STRIP", "MAX_BS"]

STRIP = 32
MAX_BS = 512        # W of the later rows lives in shared memory (120 KB)


def build() -> ctypes.CDLL:
    """Compile (at first use) and load the CUDA kernel's library."""
    lib = _build.load_library("panel_fused")
    fn = lib.gaunegf_panel_fused_c64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gaunegf_panel_fused_config.argtypes = [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
    lib.gaunegf_panel_fused_config.restype = ctypes.c_int
    return lib


def config(m: int, bs: int, batch: int) -> dict:
    """The kernel's launch shape for a batch of (m, bs) panels on the
    current CUDA device: CTAs per cluster, lanes per CTA and lanes each
    holds on chip.  Needs the built library."""
    out = (ctypes.c_int * 3)()
    rc = build().gaunegf_panel_fused_config(m, bs, batch,
                                            ctypes.addressof(out))
    if rc != 0:
        raise ValueError(f"panel_fused: no launch shape for ({m}, {bs})")
    return {"ncta": out[0], "lanes": out[1], "on_chip": out[2]}


def virtual_perm(pivrows, avail):
    """The virtually pivoted panel's row order (B, m) int64: the pivot
    lanes pivrows (B, bs) in elimination order, then the still-available
    lanes (avail (B, m) bool) in ascending order (the partial-pivot row
    sequence)."""
    m, bs = avail.shape[1], pivrows.shape[1]
    rest = torch.argsort((~avail).to(torch.int8), dim=1,
                         stable=True)[:, :m - bs]
    return torch.cat([pivrows.to(torch.int64), rest], dim=1)


def pack_virtual(pt, pivrows, avail):
    """Pack a virtually pivoted transposed panel pt (B, bs, m) in the
    order of ``virtual_perm``.  Returns (packed (B, m, bs), perm (B, m)
    int64)."""
    nb, bs, m = pt.shape
    perm = virtual_perm(pivrows, avail)
    packed = pt.gather(2, perm[:, None, :].expand(nb, bs, m)).transpose(1, 2)
    return packed, perm


def _recip_den(pr, pi):
    """1 / p as (pr, -pi) / (pr^2 + pi^2), a zero denominator read as 1."""
    den = pr * pr + pi * pi
    den = torch.where(den == 0, torch.ones_like(den), den)
    return pr / den, -pi / den


def _strip_width(bs: int) -> int:
    strip = min(STRIP, bs)
    if bs % strip:
        raise ValueError(f"panel width bs={bs} must be a multiple of the "
                         f"strip width {strip}")
    return strip


def _deferred_update_plain(pt, s0, width, piv, avail):
    """Deferred update of rows s0+width.. of pt (B, bs, m), in place, with
    the kernel's order of operations: W by forward substitution column by
    column, then rest -= W_k L_k for k = 0, 1, ... one term at a time."""
    nb, bs, m = pt.shape
    s1 = s0 + width
    sb = pt[:, s0:s1]
    later = pt[:, s1:]
    G = sb.gather(2, piv[:, None, :].expand(nb, width, width))
    Gr, Gi = G.real, G.imag
    U = later.gather(2, piv[:, None, :].expand(nb, bs - s1, width))
    Wr, Wi = U.real.clone(), U.imag.clone()
    for i in range(width - 1):
        wr, wi = Wr[:, :, i:i + 1], Wi[:, :, i:i + 1]
        gr, gi = Gr[:, None, i, i + 1:], Gi[:, None, i, i + 1:]
        Wr[:, :, i + 1:] -= wr * gr - wi * gi
        Wi[:, :, i + 1:] -= wr * gi + wi * gr
    zero = torch.zeros((), dtype=Gr.dtype, device=pt.device)
    Lr = torch.where(avail[:, None, :], sb.real, zero)
    Li = torch.where(avail[:, None, :], sb.imag, zero)
    Rr, Ri = later.real.clone(), later.imag.clone()
    for k in range(width):
        wr, wi = Wr[:, :, k:k + 1], Wi[:, :, k:k + 1]
        lr, li = Lr[:, None, k], Li[:, None, k]
        Rr -= wr * lr - wi * li
        Ri -= wr * li + wi * lr
    out = torch.complex(Rr, Ri)
    out.scatter_(2, piv[:, None, :].expand(nb, bs - s1, width),
                 torch.complex(Wr, Wi))
    pt[:, s1:] = out


def factor_panel_fused_plain(panel):
    """Plain PyTorch version: Python loops over strips, rows and terms.
    panel: (B, m, bs) complex, m >= bs.  Returns (packed, perm)."""
    nb, m, bs = panel.shape
    width = _strip_width(bs)
    pt = panel.transpose(1, 2).clone(memory_format=torch.contiguous_format)
    avail = torch.ones((nb, m), dtype=torch.bool, device=panel.device)
    pivrows = torch.empty((nb, bs), dtype=torch.int64, device=panel.device)
    for s0 in range(0, bs, width):
        sb, piv32, avail = eliminate_strip_plain(pt[:, s0:s0 + width], avail,
                                                 recip=_recip_den)
        pt[:, s0:s0 + width] = sb
        piv = piv32.to(torch.int64)
        pivrows[:, s0:s0 + width] = piv
        if s0 + width < bs:
            _deferred_update_plain(pt, s0, width, piv, avail)
    return pack_virtual(pt, pivrows, avail)


def factor_panel_fused(panel):
    """Factor a batch of (m, bs) complex64 panels: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor.

    panel: (B, m, bs) complex64, m >= bs, bs a multiple of min(32, bs);
    not modified.  Returns (packed (B, m, bs), perm (B, m) int64).
    Raises on anything the kernel does not take; it never falls back."""
    if panel.dtype != torch.complex64:
        raise ValueError(f"factor_panel_fused: the fused panel takes "
                         f"complex64, got {panel.dtype} (the 'pallas' "
                         "panel takes complex128)")
    if panel.device.type == "cpu":
        return factor_panel_fused_plain(panel)
    if panel.device.type != "cuda":
        raise ValueError(f"factor_panel_fused: no kernel for device "
                         f"{panel.device}")
    if panel.dim() != 3:
        raise ValueError(f"factor_panel_fused: shape {tuple(panel.shape)} "
                         "is not (B, m, bs)")
    nb, m, bs = panel.shape
    _strip_width(bs)
    if not 1 <= bs <= min(MAX_BS, m):
        raise ValueError(f"factor_panel_fused: bs={bs}; the kernel takes "
                         f"1..{MAX_BS} and at most m={m}")
    # a fresh contiguous copy in the stored layout (copy_ also materializes
    # conj/neg views), factored in place by the kernel
    rows = torch.empty((nb, m, bs), dtype=panel.dtype, device=panel.device)
    rows.copy_(panel)
    avail = torch.empty((nb, m), dtype=torch.bool, device=panel.device)
    piv = torch.empty((nb, bs), dtype=torch.int32, device=panel.device)
    lib = build()
    with torch.cuda.device(panel.device):
        stream = torch.cuda.current_stream(panel.device).cuda_stream
        rc = lib.gaunegf_panel_fused_c64(rows.data_ptr(), avail.data_ptr(),
                                         piv.data_ptr(), nb, m, bs, stream)
    if rc != 0:
        raise RuntimeError(f"panel_fused kernel launch failed: CUDA error "
                           f"{rc}")
    perf_count("launch.panel_fused")
    perm = virtual_perm(piv, avail)
    return rows.gather(1, perm[:, :, None].expand(nb, m, bs)), perm
