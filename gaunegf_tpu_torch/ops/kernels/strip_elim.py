"""Strip elimination: the strip-scanned panel's inner loop as one kernel.

Replaces the TPU kernel ``gaunegf_tpu/ops/pallas/strip_elim.py::
eliminate_strip``.  One call factors a batch of transposed panel strips
(rows = panel columns, lanes = panel rows), up to 32 sequential pivoted
eliminations each, with exactly the TPU kernel's per-column semantics:
masked ``hypot`` argmax pivot (first lane on ties), complex reciprocal by
two divisions by |p| with the zero-pivot guard, multipliers at the
available lanes, rank-1 update of the rows below, pivot recorded and
cleared from ``avail``.

On the card the hand-written CUDA kernel ``csrc/strip_elim.cu`` runs: one
thread block per batch element.  What bounds it is the latency of the 32
dependent block-wide reductions, not bytes or flops; the design and its
limits are described in the source.  On the CPU the plain PyTorch version
``eliminate_strip_plain`` below runs instead; the two compute the same
rounded operations, so they agree bit for bit.

``LAUNCHES`` counts the kernel's launches (never the plain version's
calls), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from gaunegf_tpu_torch.ops.kernels import _build

__all__ = ["eliminate_strip", "eliminate_strip_plain", "build", "LAUNCHES",
           "MAX_ROWS"]

MAX_ROWS = 32
LAUNCHES = 0


def build() -> ctypes.CDLL:
    """Compile (at first use) and load the CUDA kernel's library."""
    lib = _build.load_library("strip_elim", ("strip_elim.cu",))
    fn = lib.gaunegf_strip_elim_c64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _hypot(x, y):
    """jnp.hypot's formula: big * sqrt(1 + (small / big)^2)."""
    ax, ay = x.abs(), y.abs()
    big, small = torch.maximum(ax, ay), torch.minimum(ax, ay)
    q = small / torch.where(big == 0, torch.ones_like(big), big)
    r = torch.where(big == 0, big, big * torch.sqrt(1 + q * q))
    return torch.where(torch.isinf(ax) | torch.isinf(ay),
                       torch.full_like(r, float("inf")), r)


def eliminate_strip_plain(sb, avail):
    """Plain PyTorch version: a Python loop over the strip's rows.

    sb: (B, rows, m) complex; avail: (B, m) bool.  Computes in the real
    dtype of ``sb`` (float32 for complex64, mirroring the kernel; float64
    for complex128).  Returns (sb', piv (B, rows) int32, avail')."""
    bsz, rows, m = sb.shape
    re = sb.real.clone()
    im = sb.imag.clone()
    av = avail.clone()
    piv = torch.empty((bsz, rows), dtype=torch.int32, device=sb.device)
    lanes = torch.arange(m, device=sb.device)
    for j in range(rows):
        cr, ci = re[:, j], im[:, j]                        # (B, m)
        mag = torch.where(av, _hypot(cr, ci), torch.full_like(cr, -1.0))
        p = torch.argmax(mag, dim=1)                       # first maximum
        onehot = lanes[None, :] == p[:, None]
        pr = cr.gather(1, p[:, None])                      # (B, 1)
        pi = ci.gather(1, p[:, None])
        pm = _hypot(pr, pi)
        pm = torch.where(pm == 0, torch.ones_like(pm), pm)  # zero-pivot guard
        inv_r, inv_i = (pr / pm) / pm, -(pi / pm) / pm
        keep = av & ~onehot
        zero = torch.zeros_like(cr)
        lr = torch.where(keep, cr * inv_r - ci * inv_i, zero)
        li = torch.where(keep, cr * inv_i + ci * inv_r, zero)
        if j + 1 < rows:
            idx = p[:, None, None].expand(bsz, rows - j - 1, 1)
            ur = re[:, j + 1:].gather(2, idx)              # (B, rows-j-1, 1)
            ui = im[:, j + 1:].gather(2, idx)
            re[:, j + 1:] -= ur * lr[:, None] - ui * li[:, None]
            im[:, j + 1:] -= ur * li[:, None] + ui * lr[:, None]
        re[:, j] = torch.where(keep, lr, cr)
        im[:, j] = torch.where(keep, li, ci)
        piv[:, j] = p.to(torch.int32)
        av = keep
    return torch.complex(re, im), piv, av


def eliminate_strip(sb, avail):
    """Factor a batch of (rows, m) strips: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.

    sb: (B, rows, m) complex64 on the card (any complex dtype on the CPU),
    rows <= 32; avail: (B, m) bool on the same device.  Returns
    (sb', piv (B, rows) int32, avail'); the inputs are not modified.
    Raises on anything the kernel does not take; it never falls back."""
    global LAUNCHES
    if sb.device.type == "cpu":
        return eliminate_strip_plain(sb, avail)
    if sb.device.type != "cuda":
        raise ValueError(f"eliminate_strip: no kernel for device {sb.device}")
    if sb.dtype != torch.complex64:
        raise TypeError(f"eliminate_strip: the kernel takes complex64, "
                        f"got {sb.dtype}")
    if avail.dtype != torch.bool or avail.device != sb.device:
        raise TypeError("eliminate_strip: avail must be a bool tensor on "
                        "the strip's device")
    if sb.dim() != 3 or avail.shape != (sb.shape[0], sb.shape[2]):
        raise ValueError(f"eliminate_strip: shapes {tuple(sb.shape)} and "
                         f"{tuple(avail.shape)} are not (B, rows, m), (B, m)")
    bsz, rows, m = sb.shape
    if not 1 <= rows <= min(MAX_ROWS, m):
        raise ValueError(f"eliminate_strip: {rows} rows; the kernel takes "
                         f"1..{MAX_ROWS} and at most m={m}")
    # fresh contiguous outputs (copy_ also materializes conj/neg views);
    # the kernel factors them in place
    out = torch.empty((bsz, rows, m), dtype=sb.dtype, device=sb.device)
    out.copy_(sb)
    av = torch.empty((bsz, m), dtype=torch.bool, device=sb.device)
    av.copy_(avail)
    piv = torch.empty((bsz, rows), dtype=torch.int32, device=sb.device)
    lib = build()
    with torch.cuda.device(sb.device):
        stream = torch.cuda.current_stream(sb.device).cuda_stream
        rc = lib.gaunegf_strip_elim_c64(out.data_ptr(), av.data_ptr(),
                                        piv.data_ptr(), bsz, rows, m, stream)
    if rc != 0:
        raise RuntimeError(f"strip_elim kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out, piv, av
