"""The Bethe-lattice fixed points (bulk and surface) as one kernel.

Replaces the jitted ``lax.while_loop``s of ``gaunegf_tpu/models/bethe.py::
bethe_sigma_k`` and ``bethe_sigma_surface`` and of
``gaunegf_tpu/models/kspace.py::kspace_sigma_surface`` (none of them a
``pallas_call``).  Per lane (one energy, or one energy and k point) the
relaxed map

    sigma_k <- mix * B_k g_k B_k^+ + (1 - mix) * sigma_k

runs on the updated slots until the lane's relative change
max|sigma - sigma_old| / max(max|sigma_old|, 1e-30) is <= conv or
max_iter sweeps have run; a lane that has stopped is frozen, so the result
does not depend on the other lanes.  ``bulk='jacobi'`` / ``'seidel'``
iterates the 12 direction slots (g_k = inv(A - sum sigma + sigma_pair(k))
with exclusion, one shared inverse without); ``surface=True`` then (or,
without a bulk loop, from the seed) re-relaxes the 6 in-plane slots of the
9-slot stack around one shared inverse.

On the card the hand-written CUDA kernel ``csrc/fixed_point.cu`` runs the
whole loop -- bulk and surface -- in one launch: one CTA per lane, a warp
per direction, everything in shared memory (the source describes what
bounds it).  On the CPU the plain PyTorch version ``fixed_point_plain``
below runs instead: the eager loop, one batched ``torch.linalg.inv`` a
sweep.  The two differ only in the rounding of the 9x9 inverses
(Gauss-Jordan against getrf/getri).

``LAUNCHES`` counts the kernel's launches (never the plain version's
calls), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from gaunegf_tpu_torch.ops.kernels import _build

__all__ = ["fixed_point", "fixed_point_plain", "build", "LAUNCHES", "DIM",
           "NN", "PLANE_DIRS", "PAIR"]

DIM = 9
NN = 12
PLANE_DIRS = (0, 1, 2, 6, 7, 8)       # in-plane direction slots
PAIR = tuple((k + 6) % NN for k in range(NN))
_BULK_MODES = {None: 0, "jacobi": 1, "seidel": 2}

LAUNCHES = 0


def build() -> ctypes.CDLL:
    """Compile (at first use) and load the CUDA kernel's library."""
    lib = _build.load_library("fixed_point")
    fn = lib.gaunegf_fixed_point_c128
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _check_every(device) -> int:
    """How often the host looks at the lanes: every sweep on the CPU
    (where it costs nothing), every 4th on a CUDA device (a look is a
    synchronisation; a frozen lane makes the extra sweeps harmless)."""
    return 1 if device.type == "cpu" else 4


def _absmax3(M):
    return M.abs().amax(dim=(-3, -2, -1))


def _iterate(step, sig, conv, max_iter):
    """Per-lane relaxed fixed point: sig <- step(sig) on the lanes whose
    relative change max|sig - sig_old| / max|sig_old| still exceeds conv.
    Returns (sig, sweeps (b,) int32, last relative change (b,))."""
    dev = sig.device
    diff = torch.full((sig.shape[0],), float("inf"), dtype=torch.float64,
                      device=dev)
    every = _check_every(dev)
    sweeps = torch.zeros(sig.shape[0], dtype=torch.int32, device=dev)
    for count in range(max_iter):
        active = diff > conv
        if count % every == 0 and not bool(active.any()):
            break
        new = step(sig)
        diff_new = _absmax3(new - sig) / torch.clamp(_absmax3(sig),
                                                     min=1e-30)
        sig = torch.where(active[:, None, None, None], new, sig)
        diff = torch.where(active, diff_new, diff)
        sweeps += active
    return sig, sweeps, diff


def _bulk_step(A, B, Bd, mix, update, exclusion):
    pair = torch.as_tensor(PAIR, device=A.device)
    if update == "jacobi":
        def step(sig):
            sig_tot = sig.sum(dim=1)
            if exclusion:
                gk = torch.linalg.inv(
                    (A - sig_tot)[:, None] + sig[:, pair])   # (b, 12, 9, 9)
            else:
                gk = torch.linalg.inv(A - sig_tot)[:, None]  # shared inverse
            return mix * (B @ gk @ Bd) + (1 - mix) * sig
    else:
        def step(sig_old):
            sig_tot = sig_old.sum(dim=1)
            sig = sig_old.clone()
            for k in range(NN):
                M = A - sig_tot
                if exclusion:
                    M = M + sig[:, PAIR[k]]
                gk = torch.linalg.inv(M)
                sig[:, k] = mix * (B[:, k] @ gk @ Bd[:, k]) \
                    + (1 - mix) * sig_old[:, k]
            return sig
    return step


def _surface_step(A, B, Bd, mix):
    plane = torch.as_tensor(PLANE_DIRS, device=A.device)
    Bp, Bdp = B[:, plane], Bd[:, plane]

    def step(sig):
        # one g per sweep (Jacobi); the 6 in-plane directions together
        g = torch.linalg.inv(A - sig.sum(dim=1))
        new = sig.clone()
        new[:, plane] = mix * (Bp @ g[:, None] @ Bdp) \
            + (1 - mix) * sig[:, plane]
        return new
    return step


def fixed_point_plain(A, B, sig, conv, mix, max_iter, bulk="jacobi",
                      exclusion=True, surface=False):
    """Plain PyTorch version of ``fixed_point`` (same arguments and
    returns): the eager loop, one batched inverse per sweep."""
    b = A.shape[0]
    Bd = B.conj().transpose(-1, -2)
    counts = torch.zeros((b, 2), dtype=torch.int32, device=A.device)
    metrics = torch.full((b, 2), float("inf"), dtype=torch.float64,
                         device=A.device)
    sig_bulk = sig_surf = None
    if bulk is not None:
        sig_bulk, counts[:, 0], metrics[:, 0] = _iterate(
            _bulk_step(A, B, Bd, mix, bulk, exclusion), sig, conv, max_iter)
        sig = sig_bulk[:, :9].clone()
    if surface:
        sig_surf, counts[:, 1], metrics[:, 1] = _iterate(
            _surface_step(A, B, Bd, mix), sig, conv, max_iter)
    return sig_bulk, sig_surf, counts, metrics


# ---------------------------------------------------------------------------
# The dispatch
# ---------------------------------------------------------------------------

def fixed_point(A, B, sig, conv, mix, max_iter, bulk="jacobi",
                exclusion=True, surface=False):
    """The relaxed fixed point of every lane: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.

    A (b, 9, 9) and B (b, 12, 9, 9) complex128 on one device (B_k^+ is
    taken inside); sig the seed, (b, 12, 9, 9) when ``bulk`` is 'jacobi'
    or 'seidel', else (b, 9, 9, 9) for the surface loop alone.  With
    ``surface`` the in-plane loop runs after the bulk one (from the bulk
    result's first 9 slots) or alone (from sig).  Returns (bulk state or
    None, surface stack or None, sweeps (b, 2) int32, last relative change
    (b, 2) float64), column 0 the bulk loop's and column 1 the surface
    loop's.  The inputs are not modified.  Raises on anything the kernel
    does not take; it never falls back."""
    global LAUNCHES
    if A.device.type == "cpu":
        return fixed_point_plain(A, B, sig, conv, mix, max_iter, bulk,
                                 exclusion, surface)
    if A.device.type != "cuda":
        raise ValueError(f"fixed_point: no kernel for device {A.device}")
    if bulk not in _BULK_MODES:
        raise ValueError(f"fixed_point: bulk={bulk!r}; the kernel takes "
                         "None, 'jacobi' or 'seidel'")
    if bulk is None and not surface:
        raise ValueError("fixed_point: neither a bulk nor a surface loop")
    b = A.shape[0]
    slots = NN if bulk is not None else 9
    for name, x, shape in (("A", A, (b, DIM, DIM)),
                           ("B", B, (b, NN, DIM, DIM)),
                           ("sig", sig, (b, slots, DIM, DIM))):
        if x.dtype != torch.complex128 or x.device != A.device:
            raise TypeError(f"fixed_point: {name} must be complex128 on "
                            f"{A.device}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"fixed_point: {name} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
    dev = A.device
    counts = torch.zeros((b, 2), dtype=torch.int32, device=dev)
    metrics = torch.full((b, 2), float("inf"), dtype=torch.float64,
                         device=dev)
    # fresh contiguous state (copy_ also materializes conj/neg views); the
    # kernel iterates it in place
    sig_bulk = sig_surf = None
    if bulk is not None:
        sig_bulk = torch.empty((b, NN, DIM, DIM), dtype=A.dtype, device=dev)
        sig_bulk.copy_(sig)
    if surface:
        sig_surf = torch.empty((b, 9, DIM, DIM), dtype=A.dtype, device=dev)
        if bulk is None:
            sig_surf.copy_(sig)
    if b == 0:
        return sig_bulk, sig_surf, counts, metrics
    A_c = torch.empty(A.shape, dtype=A.dtype, device=dev)
    A_c.copy_(A)
    B_c = torch.empty(B.shape, dtype=B.dtype, device=dev)
    B_c.copy_(B)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gaunegf_fixed_point_c128(
            A_c.data_ptr(), B_c.data_ptr(),
            None if sig_bulk is None else sig_bulk.data_ptr(),
            None if sig_surf is None else sig_surf.data_ptr(),
            counts.data_ptr(), metrics.data_ptr(), b, _BULK_MODES[bulk],
            int(bool(exclusion)), int(bool(surface)), float(conv),
            float(mix), int(max_iter), stream)
    if rc != 0:
        raise RuntimeError(f"fixed_point kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return sig_bulk, sig_surf, counts, metrics
