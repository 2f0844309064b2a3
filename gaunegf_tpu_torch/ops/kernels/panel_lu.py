"""Swap-pivoted panel LU: the blocked LU's panel as one kernel, in
complex64 or complex128.

Replaces the TPU kernel ``gaunegf_tpu/ops/pallas/panel_lu.py::
factor_panel_pallas``.  One call factors a batch of (m, bs) panels by
partial pivoting with physical row swaps, with exactly the TPU kernel's
per-column semantics (column j = 0 .. bs-1):

* pivot p = the first row >= j of largest re^2 + im^2 (not hypot: the
  TPU kernel compares squared magnitudes);
* rows j and p swap across the whole panel, and so do their entries of
  the permutation;
* the pivot's reciprocal is (pr, -pi) / (pr^2 + pi^2), a zero
  denominator reading as 1 (padded rows and singular columns give zeros);
* the multipliers l = c / p replace column j below the diagonal, and the
  rows below take the rank-1 update a[r, c] -= l[r] * a[j, c] right of
  column j.

Returns (packed (B, m, bs), perm (B, m) int64) with packed[b, i] =
(factored) row perm[b, i] of the input, the contract of the port's other
panels (ops/zlinalg.py consumes perm only through a row gather).

On the card the hand-written CUDA kernel ``csrc/panel_lu.cu`` runs: one
thread-block cluster per batch element, the panel factored left-looking
in column sub-panels held in the cluster's shared memory (``config``
gives the sub-panel width and cluster size it picks); the source
describes its design and bound.  On the CPU the plain PyTorch version
``factor_panel_lu_plain`` runs instead.  Both round every operation
alike and give each element its updates in the same order, so they agree
bit for bit.

The counter ``launch.panel_lu`` (utils/logging) counts the kernel's
launches (never the plain version's calls).
"""

from __future__ import annotations

import ctypes

import torch

from gaunegf_tpu_torch.ops.kernels import _build
from gaunegf_tpu_torch.utils.logging import perf_count

__all__ = ["factor_panel_lu", "factor_panel_lu_plain", "build", "config",
           "MAX_BS"]

MAX_BS = 1024


def build() -> ctypes.CDLL:
    """Compile (at first use) and load the CUDA kernel's library."""
    lib = _build.load_library("panel_lu")
    for name in ("gaunegf_panel_lu_c64", "gaunegf_panel_lu_c128"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.gaunegf_panel_lu_config.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
    lib.gaunegf_panel_lu_config.restype = ctypes.c_int
    return lib


def config(m: int, dtype, batch: int) -> dict:
    """The kernel's launch shape for a batch of (m, bs) panels of
    ``dtype`` on the current CUDA device: the sub-panel width nb, the CTAs
    per cluster and the rows each holds.  Needs the built library."""
    out = (ctypes.c_int * 3)()
    elem = 8 if dtype == torch.complex64 else 16
    rc = build().gaunegf_panel_lu_config(m, elem, batch,
                                         ctypes.addressof(out))
    if rc != 0:
        raise ValueError(f"panel_lu: no launch shape fits m={m}")
    return {"nb": out[0], "ncta": out[1], "rows": out[2]}


def factor_panel_lu_plain(panel):
    """Plain PyTorch version: a Python loop over the panel's columns,
    batched over B, in the real dtype of ``panel`` (float32 for complex64,
    float64 for complex128).  panel: (B, m, bs) complex, m >= bs."""
    nb, m, bs = panel.shape
    re = panel.real.clone()
    im = panel.imag.clone()
    perm = torch.arange(m, device=panel.device).repeat(nb, 1)
    bi = torch.arange(nb, device=panel.device)
    for j in range(bs):
        cr, ci = re[:, j:, j], im[:, j:, j]
        p = torch.argmax(cr * cr + ci * ci, dim=1) + j     # first maximum
        for x in (re, im, perm):
            rj, rp = x[bi, j].clone(), x[bi, p].clone()
            x[bi, p] = rj
            x[bi, j] = rp
        pr, pi = re[:, j, j:j + 1], im[:, j, j:j + 1]      # (B, 1)
        den = pr * pr + pi * pi
        den = torch.where(den == 0, torch.ones_like(den), den)
        inv_r, inv_i = pr / den, -pi / den
        cr, ci = re[:, j + 1:, j], im[:, j + 1:, j]        # (B, m-j-1)
        lr = cr * inv_r - ci * inv_i
        li = cr * inv_i + ci * inv_r
        ur, ui = re[:, j, None, j + 1:], im[:, j, None, j + 1:]
        lr3, li3 = lr[:, :, None], li[:, :, None]
        re[:, j + 1:, j + 1:] -= lr3 * ur - li3 * ui
        im[:, j + 1:, j + 1:] -= lr3 * ui + li3 * ur
        re[:, j + 1:, j] = lr
        im[:, j + 1:, j] = li
    return torch.complex(re, im), perm


def factor_panel_lu(panel):
    """Factor a batch of (m, bs) panels: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.

    panel: (B, m, bs) complex64 or complex128, m >= bs; not modified.
    Returns (packed (B, m, bs), perm (B, m) int64).  Raises on anything
    the kernel does not take; it never falls back."""
    if panel.device.type == "cpu":
        return factor_panel_lu_plain(panel)
    if panel.device.type != "cuda":
        raise ValueError(f"factor_panel_lu: no kernel for device "
                         f"{panel.device}")
    if panel.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"factor_panel_lu: the kernel takes complex64 or "
                        f"complex128, got {panel.dtype}")
    if panel.dim() != 3:
        raise ValueError(f"factor_panel_lu: shape {tuple(panel.shape)} is "
                         "not (B, m, bs)")
    nb, m, bs = panel.shape
    if not 1 <= bs <= min(MAX_BS, m):
        raise ValueError(f"factor_panel_lu: bs={bs}; the kernel takes "
                         f"1..{MAX_BS} and at most m={m}")
    # fresh contiguous output (copy_ also materializes conj/neg views),
    # factored in place by the kernel
    out = torch.empty((nb, m, bs), dtype=panel.dtype, device=panel.device)
    out.copy_(panel)
    perm = torch.empty((nb, m), dtype=torch.int64, device=panel.device)
    lib = build()
    fn = (lib.gaunegf_panel_lu_c64 if panel.dtype == torch.complex64
          else lib.gaunegf_panel_lu_c128)
    with torch.cuda.device(panel.device):
        stream = torch.cuda.current_stream(panel.device).cuda_stream
        rc = fn(out.data_ptr(), perm.data_ptr(), nb, m, bs, stream)
    if rc != 0:
        raise RuntimeError(f"panel_lu kernel launch failed: CUDA error {rc}")
    perf_count("launch.panel_lu")
    return out, perm
