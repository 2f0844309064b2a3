"""Surface Green's functions of semi-infinite leads as one kernel:
Sancho-Rubio decimation and the relaxed Dyson map on n x n blocks.

Replaces the jitted ``lax.while_loop``s of ``gaunegf_tpu/models/chain1d.py::
surface_g_sancho`` and ``surface_g_dyson`` (neither a ``pallas_call``),
which the JAX package also runs per k point in
``gaunegf_tpu/models/kspace.py::kspace_sigma_down``.  Each lane (one
energy, or one energy and k point) converges on its own: it stops once its
own metric passes ``conv`` (or after ``max_iter`` iterations), and a lane
that has stopped is frozen.

* mode 'sancho': Lopez Sancho-Rubio decimation with balanced couplings
  and a joint power-of-two exponent (quadratic convergence; the balancing
  keeps the doubling transients from overflowing);
  ``models/chain1d.surface_g_sancho`` calls it.
* mode 'dyson': the reference's relaxed fixed point
  g <- relax * inv(A - B g B+) + (1 - relax) * g
  (``models/chain1d.surface_g_dyson``).

On the card the hand-written CUDA kernel ``csrc/sancho_rubio.cu`` runs the
whole loop and the final inverse in one launch: one CTA per lane, the
lane's blocks in shared memory for n <= 32 and in a global scratch beyond
(the source describes what bounds it).  On the CPU the plain PyTorch
versions below run instead: the eager loops, one batched
``torch.linalg.inv`` an iteration.  The two differ only in the rounding of
the inverses (Gauss-Jordan against getrf/getri).

``LAUNCHES`` counts the kernel's launches (never the plain versions'
calls), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gaunegf_tpu_torch.config import SURFACE_RELAXATION_FACTOR
from gaunegf_tpu_torch.ops.kernels import _build

__all__ = ["decimate", "decimate_plain", "build", "LAUNCHES",
           "MAX_SHARED_N"]

MAX_SHARED_N = 32           # larger blocks live in a global scratch
_MODES = {"sancho": 0, "dyson": 1}
_BLOCKS = {"sancho": 9, "dyson": 5}     # n x n blocks a lane keeps

LAUNCHES = 0


def build() -> ctypes.CDLL:
    """Compile (at first use) and load the CUDA kernel's library."""
    lib = _build.load_library("sancho_rubio")
    fn = lib.gaunegf_sancho_rubio_c128
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------

def _dagger(M):
    return M.conj().transpose(-1, -2)


def _absmax(M):
    return M.abs().amax(dim=(-2, -1))


def _sancho_plain(A, B, conv, max_iter):
    """Balanced Sancho-Rubio decimation for a batch A, B (b, n, n):
    (g, iterations (b,) int32, last metric (b,))."""
    rdt = A.real.dtype
    tiny = torch.tensor(np.finfo(np.float32).tiny, dtype=rdt, device=A.device)
    nb = A.shape[0]
    B = B.to(A.dtype)
    eps_s, eps = A, A
    al, be = B, _dagger(B)
    c = torch.zeros(nb, dtype=rdt, device=A.device)
    diff = torch.full((nb,), float("inf"), dtype=rdt, device=A.device)
    count = torch.zeros(nb, dtype=torch.int32, device=A.device)
    for _ in range(max_iter):
        active = diff > conv
        if not bool(active.any()):
            break
        g = torch.linalg.inv(eps)
        scale = torch.exp2(c)[:, None, None]
        agb = al @ g @ be * scale
        bga = be @ g @ al * scale
        eps_s_new = eps_s - agb
        eps_new = eps - agb - bga
        al_new = al @ g @ al
        be_new = be @ g @ be
        sa = torch.exp2(torch.ceil(torch.log2(
            torch.maximum(_absmax(al_new), tiny))))
        sb = torch.exp2(torch.ceil(torch.log2(
            torch.maximum(_absmax(be_new), tiny))))
        c_new = 2.0 * c + torch.log2(sa) + torch.log2(sb)
        diff_new = _absmax(eps_s_new - eps_s) / torch.clamp(
            _absmax(eps_s_new), min=1e-30)
        m = active[:, None, None]
        eps_s = torch.where(m, eps_s_new, eps_s)
        eps = torch.where(m, eps_new, eps)
        al = torch.where(m, al_new / sa[:, None, None], al)
        be = torch.where(m, be_new / sb[:, None, None], be)
        c = torch.where(active, c_new, c)
        diff = torch.where(active, diff_new, diff)
        count += active
    return torch.linalg.inv(eps_s), count, diff


def _dyson_plain(A, B, conv, relax, max_iter):
    """The relaxed Dyson map for a batch A, B (b, n, n): (g, iterations
    (b,) int32, last metric (b,))."""
    B = B.to(A.dtype)
    B_dag = _dagger(B)
    g = torch.linalg.inv(A)
    diff = torch.full((A.shape[0],), float("inf"), dtype=A.real.dtype,
                      device=A.device)
    count = torch.zeros(A.shape[0], dtype=torch.int32, device=A.device)
    for _ in range(max_iter):
        active = diff > conv
        if not bool(active.any()):
            break
        g_new = torch.linalg.inv(A - B @ g @ B_dag)
        dg = (g_new - g).abs() / torch.clamp(g_new.abs(), min=1e-12)
        diff = torch.where(active, dg.amax(dim=(-2, -1)), diff)
        g = torch.where(active[:, None, None],
                        g_new * relax + g * (1 - relax), g)
        count += active
    return g, count, diff


def decimate_plain(A, B, conv, max_iter, mode="sancho",
                   relax=SURFACE_RELAXATION_FACTOR):
    """Plain PyTorch version of ``decimate`` (same arguments and
    returns)."""
    if mode == "sancho":
        return _sancho_plain(A, B, conv, max_iter)
    if mode == "dyson":
        return _dyson_plain(A, B, conv, relax, max_iter)
    raise ValueError(f"decimate: mode={mode!r}; 'sancho' or 'dyson'")


# ---------------------------------------------------------------------------
# The dispatch
# ---------------------------------------------------------------------------

def decimate(A, B, conv, max_iter, mode="sancho",
             relax=SURFACE_RELAXATION_FACTOR):
    """The surface Green's function of every lane: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor.

    A, B (b, n, n), A complex128 on the card (B is cast to A's dtype, as
    the plain version does); mode 'sancho' (max_iter iterations at most,
    relax unused) or 'dyson'.  Returns (g (b, n, n), iterations (b,) int32,
    last metric (b,) float64).  The inputs are not modified.  Every n
    launches the kernel (beyond MAX_SHARED_N its blocks live in a global
    scratch); raises on anything the kernel does not take and never falls
    back."""
    global LAUNCHES
    if A.device.type == "cpu":
        return decimate_plain(A, B, conv, max_iter, mode, relax)
    if A.device.type != "cuda":
        raise ValueError(f"decimate: no kernel for device {A.device}")
    if mode not in _MODES:
        raise ValueError(f"decimate: mode={mode!r}; 'sancho' or 'dyson'")
    if A.dtype != torch.complex128:
        raise TypeError(f"decimate: the kernel takes complex128, got "
                        f"{A.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2] \
            or tuple(B.shape) != tuple(A.shape):
        raise ValueError(f"decimate: shapes {tuple(A.shape)} and "
                         f"{tuple(B.shape)} are not both (b, n, n)")
    if B.device != A.device:
        raise TypeError(f"decimate: B lies on {B.device}, A on {A.device}")
    b, n = A.shape[0], A.shape[1]
    dev = A.device
    g = torch.empty((b, n, n), dtype=A.dtype, device=dev)
    counts = torch.zeros(b, dtype=torch.int32, device=dev)
    metrics = torch.full((b,), float("inf"), dtype=torch.float64,
                         device=dev)
    if b == 0 or n == 0:
        return g, counts, metrics
    A_c = torch.empty((b, n, n), dtype=A.dtype, device=dev)
    A_c.copy_(A)
    B_c = torch.empty((b, n, n), dtype=A.dtype, device=dev)
    B_c.copy_(B)
    scratch = None
    if n > MAX_SHARED_N:
        scratch = torch.empty((b, _BLOCKS[mode], n, n), dtype=A.dtype,
                              device=dev)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gaunegf_sancho_rubio_c128(
            A_c.data_ptr(), B_c.data_ptr(), g.data_ptr(), counts.data_ptr(),
            metrics.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, n,
            _MODES[mode], float(conv), float(relax), int(max_iter), stream)
    if rc != 0:
        raise RuntimeError(f"sancho_rubio kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return g, counts, metrics

