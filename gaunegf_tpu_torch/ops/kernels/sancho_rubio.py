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

On the card the hand-written CUDA kernel ``csrc/sancho_rubio.cu`` runs
the whole loop and the final inverse in one launch, in a layout chosen
by n and the mode (``variant``): 'scalar' for n = 1 (one thread a lane,
all in registers), 'column' for 2 <= n <= 16 (n threads a lane, a column
each, floor(32 / n) lanes a warp, warp-synchronous), 'cta' for 17 <= n
<= 32 (one CTA a lane, the blocks in shared memory), 'cluster' for the
Sancho mode at CLUSTER_N0 <= n <= MAX_CLUSTER_N (a lane over a cluster
of CTAs, the products and the blocked inverse's updates on the FP64
tensor cores; its width from b and the clusters the card holds,
``cluster_width``) and 'cta_global' for the rest (the blocks in a global
scratch); the source describes what bounds it.  On the CPU the plain
PyTorch versions below run instead: the eager loops, one batched
``torch.linalg.inv`` an iteration.  The two differ only in rounding.

The counter ``launch.sancho_rubio`` (utils/logging) counts the kernel's
launches (never the plain versions' calls), so a run can show that its
main path went through the kernel; ``sancho.cluster_lanes`` counts the
lanes the cluster layout took.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gaunegf_tpu_torch.config import SURFACE_RELAXATION_FACTOR
from gaunegf_tpu_torch.ops.kernels import _build
from gaunegf_tpu_torch.ops.kernels.fixed_point import device_operand
from gaunegf_tpu_torch.ops.transfer import host_bool, to_device
from gaunegf_tpu_torch.utils.logging import perf_count

__all__ = ["decimate", "decimate_plain", "build", "variant", "launch_shape",
           "cluster_width", "card_clusters", "MAX_SHARED_N", "MAX_COLUMN_N",
           "CLUSTER_N0", "MAX_CLUSTER_N", "VARIANTS"]

MAX_COLUMN_N = 16           # n threads a lane up to here
MAX_SHARED_N = 32           # larger blocks live in a global scratch
CLUSTER_N0 = 33             # the Sancho mode's cluster layout from here ...
MAX_CLUSTER_N = 256         # ... to here (its panels' shared memory)
MAX_CLUSTER = 8             # CTAs a lane at most (the portable cluster)
VARIANTS = ("scalar", "column", "cta", "cta_global", "cluster")  # C's
_MODES = {"sancho": 0, "dyson": 1}
_BLOCKS = {"sancho": 9, "dyson": 5}     # n x n blocks a lane keeps

_FN = None                  # the loaded entry point


def build() -> ctypes.CDLL:
    """Compile (at first use) and load the CUDA kernel's library."""
    global _FN
    lib = _build.load_library("sancho_rubio")
    if _FN is None:
        fn = lib.gaunegf_sancho_rubio_c128
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gaunegf_sancho_rubio_variant.argtypes = [ctypes.c_int]
        lib.gaunegf_sancho_rubio_variant.restype = ctypes.c_int
        lib.gaunegf_sancho_rubio_cluster_width.argtypes = [ctypes.c_int] * 3
        lib.gaunegf_sancho_rubio_cluster_width.restype = ctypes.c_int
        lib.gaunegf_sancho_rubio_cluster_capacity.argtypes = [ctypes.c_int]
        lib.gaunegf_sancho_rubio_cluster_capacity.restype = ctypes.c_int
        _FN = fn
    return lib


def variant(n: int, mode: str | None = None) -> str:
    """The kernel's layout for n x n blocks in this mode (the rule of the
    C entry point): the Sancho mode at CLUSTER_N0 <= n <= MAX_CLUSTER_N
    takes 'cluster'; otherwise n alone decides
    (``gaunegf_sancho_rubio_variant``), as it does with no mode."""
    if n < 1:
        raise ValueError(f"decimate: no variant for n = {n}")
    if mode == "sancho" and CLUSTER_N0 <= n <= MAX_CLUSTER_N:
        return "cluster"
    if n == 1:
        return "scalar"
    if n <= MAX_COLUMN_N:
        return "column"
    return "cta" if n <= MAX_SHARED_N else "cta_global"


def cluster_width(n: int, b: int, mode: str, capacity) -> int:
    """CTAs a lane of the cluster layout (``gaunegf_sancho_rubio_cluster_
    width``): the widest cluster, up to MAX_CLUSTER, of which the card holds
    all b lanes at once (capacity[c - 1] clusters of c CTAs, as
    ``card_clusters`` reads them: one CTA an SM, and a cluster lives in one
    GPC, so the GPCs' sizes, which differ from card to card, set how many
    fit), so that a launch is one wave; 1 beyond that; 0 where another
    layout serves (n, mode)."""
    if b < 1 or variant(n, mode) != "cluster":
        return 0
    for c in range(MAX_CLUSTER, 1, -1):
        if b <= capacity[c - 1]:
            return c
    return 1


def card_clusters() -> tuple:
    """The current card's capacity for clusters of 1..8 CTAs of the cluster
    layout, read from the C entry point (builds the kernel)."""
    lib = build()
    return tuple(lib.gaunegf_sancho_rubio_cluster_capacity(c)
                 for c in range(1, MAX_CLUSTER + 1))


def _padded(n):
    return -(-n // 8) * 8


def _cluster_lane_elems(n):
    """complex128 elements of a lane's scratch in the cluster layout: nine
    NP x NP blocks (NP = n rounded up to a multiple of 8) and NP int32
    pivot rows."""
    np_ = _padded(n)
    return 9 * np_ * np_ + np_ // 4


def _cluster_shared_bytes(n):
    """Dynamic shared memory of a CTA of the cluster layout (the C entry
    point's ``cluster_smem_bytes``): the larger of the products' two
    stages (16 x 64 tiles of depth 8, rows padded to 12) and the inverse's
    two panels and permuted rows, then the pivot column, the maxima and
    three index arrays."""
    np_ = _padded(n)
    pw = 16 if np_ <= 160 else 8              # a panel's columns
    st = pw + 4
    union = max(2 * np_ * st + pw * st, 2 * (2 * 16 * 12 + 2 * 64 * 12))
    return 16 * (union + np_) + 8 * (8 * 4 + 8) + 4 * (2 * np_ + 16)


_COLUMN_BLOCKS = {"sancho": 6, "dyson": 3}


def launch_shape(n: int, b: int, mode: str, capacity=None) -> dict:
    """The kernel's launch for b lanes of n x n blocks (as the C entry
    point picks it): variant, lanes per CTA, CTAs, threads and dynamic
    shared memory per CTA; the cluster layout adds its CTAs a lane
    ('cluster'), which depend on the clusters the card holds: ``capacity``
    (``card_clusters()`` on the card); without it they are None."""
    v = variant(n, mode)
    if v == "cluster":
        C = None if capacity is None \
            else cluster_width(n, b, mode, capacity)
        return {"variant": v, "lanes_per_cta": 1,
                "ctas": None if C is None else b * C,
                "threads": 256, "shared_bytes": _cluster_shared_bytes(n),
                "cluster": C}
    if v == "scalar":
        per, threads, smem = 128, 128, 0
    elif v == "column":
        per, threads = 32 // n, 32
        smem = 16 * per * _COLUMN_BLOCKS[mode] * n * n
    else:
        per = 1
        threads = min(256, max(32, -(-n * n // 32) * 32))
        small = 16 * n + 8 * 4 * 32 + 4 * n    # pivot column, maxima, swaps
        smem = small + (16 * _BLOCKS[mode] * n * n if v == "cta" else 0)
    return {"variant": v, "lanes_per_cta": per, "ctas": -(-b // per),
            "threads": threads, "shared_bytes": smem}


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
    tiny = to_device(np.finfo(np.float32).tiny, A.device, rdt)
    nb = A.shape[0]
    B = B.to(A.dtype)
    eps_s, eps = A, A
    al, be = B, _dagger(B)
    c = torch.zeros(nb, dtype=rdt, device=A.device)
    diff = torch.full((nb,), float("inf"), dtype=rdt, device=A.device)
    count = torch.zeros(nb, dtype=torch.int32, device=A.device)
    for _ in range(max_iter):
        active = diff > conv
        if not host_bool(active.any()):
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
        if not host_bool(active.any()):
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
    scratch, the cluster layout's too); raises on anything the kernel does
    not take and never falls back."""
    if A.device.type == "cpu":
        return decimate_plain(A, B, conv, max_iter, mode, relax)
    if A.device.type != "cuda":
        raise ValueError(f"decimate: no kernel for device {A.device}")
    check_operands(A, B, mode)
    b, n = A.shape[0], A.shape[1]
    dev = A.device
    g = torch.empty((b, n, n), dtype=A.dtype, device=dev)
    counts = torch.empty(b, dtype=torch.int32, device=dev)
    metrics = torch.empty(b, dtype=torch.float64, device=dev)
    if b == 0 or n == 0:
        return g, counts.zero_(), metrics.fill_(float("inf"))
    A, B = device_operand(A), device_operand(B.to(A.dtype))
    scratch = None
    v = variant(n, mode)
    if v == "cta_global":
        scratch = torch.empty((b, _BLOCKS[mode], n, n), dtype=A.dtype,
                              device=dev)
    elif v == "cluster":
        scratch = torch.empty((b, _cluster_lane_elems(n)), dtype=A.dtype,
                              device=dev)
    if _FN is None:
        build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _FN(A.data_ptr(), B.data_ptr(), g.data_ptr(), counts.data_ptr(),
                 metrics.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), b, n,
                 _MODES[mode], float(conv), float(relax), int(max_iter),
                 stream)
    if rc != 0:
        raise RuntimeError(f"sancho_rubio kernel launch failed: CUDA error "
                           f"{rc}")
    perf_count("launch.sancho_rubio")
    if v == "cluster":
        perf_count("sancho.cluster_lanes", b)
    return g, counts, metrics


def check_operands(A, B, mode):
    """Raise on anything the kernel does not take: a mode other than
    'sancho' or 'dyson', A other than complex128, B on another device,
    shapes other than two (b, n, n)."""
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
