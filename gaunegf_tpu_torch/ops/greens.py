"""Energy-batched Green's-function engines (the throughput core).

Port of the LU route of ``gaunegf_tpu/ops/greens.py``.  Every call is

    host energy grid (NumPy) -> one copy to the device
      -> Python loop over chunks of ``energy_chunk`` energies
        -> batched blocked LU of the chunk         (ops/zlinalg.py)
        -> weighted observable per energy
      -> complex128 accumulation of the weighted sum
    -> one copy of the (N, N) sum to the host

Point functions take a batch of energies E (b,) and return (b, ...)
stacks.  Self-energy providers expose ``total_apply()`` /
``contact_apply(i)`` -> (fn, params): params a dict of NumPy arrays,
fn(params, E) on torch tensors returning Sigma broadcastable to
(b, N, N).  The engine copies params to the device once per dispatch.

The spectral route of the JAX package is not ported yet: ``solver='auto'``
runs this LU route (LU is one of the outcomes of the JAX 'auto'), and
``solver='spectral'`` raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import hashlib
import warnings
from typing import Optional

import numpy as np
import torch

from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.ops import zlinalg as zl

__all__ = ["EnergyEngine", "resolve_device"]

_DEFAULT_EXEC = ExecutionConfig()

# Peak device bytes of one energy lane of a mixed-tier gr_sum chunk,
# divided by N^2: 99-107 measured on the H100 at N=1000 and 2000 over
# panel widths 64-256 and chunks 32-256 (PERF.md).  With the budget below
# it sets the automatic energy chunk; past 128 lanes the sweep gained
# nothing.
_LANE_BYTES_PER_N2 = 108
_CHUNK_BUDGET_BYTES = 32e9      # 40% of an 80 GB card
_CHUNK_MAX = 128

# Eigenvalues of (H, S) pencils by content digest.  The spectral route
# fills this cache once it is ported; the near-pole guard only reads it.
_PENCIL_EIGENVALUES: dict = {}


def resolve_device(device) -> torch.device:
    """The torch.device to run on.  There is no default: the caller names
    the device, and 'cuda' without a visible GPU raises."""
    if device is None:
        raise TypeError("device is required, e.g. device='cuda' or "
                        "device='cpu'")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} was requested but torch "
                           "sees no CUDA device")
    return dev


def _content_digest(*arrays) -> str:
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Per-energy observables (batched over the chunk)
# ---------------------------------------------------------------------------

def _assemble_A(E, H, S, sigma):
    return E[:, None, None] * S - H - sigma


def _gr_point(E, H, S, sigma, exec_cfg: ExecutionConfig):
    """G(E) = (E*S - H - Sigma)^-1 for a batch of energies, with the
    configured precision policy: 'mixed' refines the complex64 LU seed
    against the operator as assembled (complex128), 'fast' solves the
    complex64 operator, 'strict' the complex128 one."""
    A = _assemble_A(E, H, S, sigma)
    if exec_cfg.precision == "mixed":
        return zl.zinv_refined(A, steps=exec_cfg.refine_steps,
                               bs=exec_cfg.lu_block,
                               panel_impl=exec_cfg.lu_panel)
    return zl.zinv(A, bs=exec_cfg.lu_block, panel_impl=exec_cfg.lu_panel)


def _gamma(sig):
    return 1j * (sig - sig.conj().transpose(-1, -2))


def _point_gr_weighted(E, w, H, S, params, sig_tot_fn, _unused, exec_cfg):
    sigma = sig_tot_fn(params, E)
    G = _gr_point(E, H, S, sigma, exec_cfg)
    return w.to(G.dtype)[:, None, None] * G


def _point_gless_weighted(E, w, H, S, params, sig_tot_fn, sig_c_fn, exec_cfg):
    sig_tot = sig_tot_fn(params, E)
    sig_c = sig_c_fn(params, E) if sig_c_fn is not None else sig_tot
    Gr = _gr_point(E, H, S, sig_tot, exec_cfg)
    Ga = Gr.conj().transpose(-1, -2)
    gamma = _gamma(sig_c).to(Gr.dtype)
    return w.to(Gr.dtype)[:, None, None] * torch.matmul(
        torch.matmul(Gr, gamma), Ga)


def _gr_cols(E, H, S, sigma, cols, exec_cfg):
    """Selected columns G(E)[:, cols] for a batch of energies: one blocked
    complex64 factorization and unit-column right-hand sides; the mixed
    tier adds one refinement solve against the complex128 residual of the
    operator as assembled.  'strict' solves with torch.linalg.solve."""
    A = _assemble_A(E, H, S, sigma)
    N = H.shape[-1]
    B = torch.zeros((A.shape[0], N, len(cols)), dtype=A.dtype,
                    device=A.device)
    B[:, list(cols), torch.arange(len(cols), device=A.device)] = 1.0
    if exec_cfg.precision == "strict":
        return zl.zsolve(A, B)
    factors = zl.zlu_factor(A.to(torch.complex64), bs=exec_cfg.lu_block,
                            panel_impl=exec_cfg.lu_panel)
    X = zl.zlu_solve(factors, B.to(torch.complex64))
    if exec_cfg.precision == "mixed":
        R = B.to(torch.complex128) - torch.matmul(
            A.to(torch.complex128), X.to(torch.complex128))
        X = X + zl.zlu_solve(factors, R.to(torch.complex64))
    return X


def _point_gless_weighted_lowrank(E, w, H, S, params, sig_tot_fn, sig_c_fn,
                                  c, exec_cfg):
    """w * G Gamma_c G+ from contact-column solves: Y = G[:, c],
    result = w * Y Gamma_cc Y+."""
    sig_tot = sig_tot_fn(params, E)
    Y = _gr_cols(E, H, S, sig_tot, c, exec_cfg)         # (b, N, nc)
    sig_c = sig_c_fn(params, E) if sig_c_fn is not None else sig_tot
    ci = torch.as_tensor(c, device=Y.device)
    sig_cc = sig_c[..., ci[:, None], ci[None, :]]
    gamma = _gamma(sig_cc).to(Y.dtype)
    return w.to(Y.dtype)[:, None, None] * torch.matmul(
        torch.matmul(Y, gamma), Y.conj().transpose(-1, -2))


# ---------------------------------------------------------------------------
# Chunk sizing
# ---------------------------------------------------------------------------

def _auto_chunk_cfg(exec_cfg: ExecutionConfig, N: int) -> ExecutionConfig:
    """Resolve energy_chunk=0: the largest power-of-two chunk whose live
    bytes (_LANE_BYTES_PER_N2 * N^2 per energy, measured) fit the budget,
    clamped to [1, _CHUNK_MAX]."""
    chunk = 1
    while (chunk * 2 <= _CHUNK_MAX
           and chunk * 2 * _LANE_BYTES_PER_N2 * N * N <= _CHUNK_BUDGET_BYTES):
        chunk *= 2
    return dataclasses.replace(exec_cfg, energy_chunk=chunk)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class EnergyEngine:
    """Bound engine for a fixed (H, S, provider) system on one device.

    Holds H, S, the energies and Sigma on the device in the operator dtype
    of the tier -- complex64 for 'fast', complex128 for 'mixed' (whose LU
    still runs in complex64; the operator feeds its residual) and
    'strict'; methods take host energy grids and return host NumPy
    results."""

    def __init__(self, H, S, provider, exec_cfg: ExecutionConfig = _DEFAULT_EXEC,
                 *, device):
        self.device = resolve_device(device)
        self.provider = provider
        if exec_cfg.solver == "spectral":
            raise NotImplementedError(
                "solver='spectral' is not ported yet (ROADMAP section 1, "
                "item 4); use solver='lu' or 'auto'")
        if exec_cfg.solver not in ("auto", "lu"):
            raise ValueError(f"unknown solver {exec_cfg.solver!r}")
        if exec_cfg.precision in ("high", "exact"):
            raise NotImplementedError(
                f"precision={exec_cfg.precision!r} is not ported yet "
                "(ROADMAP section 1, item 2)")
        if exec_cfg.precision not in ("fast", "mixed", "strict"):
            raise ValueError(f"unknown precision {exec_cfg.precision!r}")
        self._H_host = np.asarray(H)
        self._S_host = np.asarray(S)
        N = self._H_host.shape[-1]
        if not exec_cfg.energy_chunk:
            exec_cfg = _auto_chunk_cfg(exec_cfg, N)
        self.exec_cfg = exec_cfg
        self.cdtype = (torch.complex64 if exec_cfg.precision == "fast"
                       else torch.complex128)
        self.H = self._to_device(self._H_host)
        self.S = self._to_device(self._S_host)
        self._pole_checked = set()     # grids already guard-checked

    def _to_device(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.complex128),
                               device=self.device).to(self.cdtype)

    def _params(self, params):
        """Provider params (dict of NumPy arrays) on the device."""
        return {k: self._to_device(v) for k, v in params.items()}

    def _chunks(self, E, w):
        """(E, w) chunk pairs of the grid, as device tensors."""
        E_d = self._to_device(np.asarray(E, dtype=np.complex128).ravel())
        w_d = self._to_device(np.asarray(w, dtype=np.complex128).ravel())
        ch = self.exec_cfg.energy_chunk
        for i in range(0, E_d.shape[0], ch):
            yield E_d[i:i + ch], w_d[i:i + ch]

    def _sum(self, point, E, w, imag: bool):
        """sum_k point(E_k, w_k) accumulated in complex128 (float64 when
        only the imaginary part is wanted)."""
        N = self.H.shape[-1]
        acc = torch.zeros((N, N), device=self.device,
                          dtype=torch.float64 if imag else torch.complex128)
        for Eb, wb in self._chunks(E, w):
            vals = point(Eb, wb)
            if imag:
                acc += vals.imag.sum(dim=0, dtype=torch.float64)
            else:
                acc += vals.sum(dim=0, dtype=torch.complex128)
        return acc

    def _contact_inds(self, contact):
        """Static contact support for the low-rank path, or None."""
        if not self.exec_cfg.use_lowrank:
            return None
        getter = getattr(self.provider, "contact_inds", None)
        if getter is None:
            return None
        inds = getter(contact)
        if inds is None:
            return None
        inds = tuple(int(i) for i in inds)
        if len(inds) > self.H.shape[-1] // 2:
            return None
        return inds

    def _near_pole_guard(self, E):
        """Warn when a fast/mixed LU dispatch is asked for real-axis points
        near a bare eigenvalue of the (H, S) pencil, where the refined-f32
        tier floors at cond * u_res above its accuracy contract.

        Unlike the JAX package, which computes a host eigendecomposition
        for the check, this guard consults only eigenvalues already in the
        cache (_PENCIL_EIGENVALUES); with none cached it stays silent.
        Checked once per (engine, grid)."""
        cfg = self.exec_cfg
        if cfg.precision not in ("fast", "mixed") or not cfg.near_pole_warn:
            return
        z = np.asarray(E, dtype=np.complex128).ravel()
        if z.size == 0:
            return
        key = hash(z.tobytes())
        if key in self._pole_checked:
            return
        self._pole_checked.add(key)
        thresh = cfg.spectral_dist_f32
        cand = np.abs(z.imag) < thresh
        if not cand.any() or not _PENCIL_EIGENVALUES:
            return
        lam = _PENCIL_EIGENVALUES.get(
            _content_digest(self._H_host, self._S_host))
        if lam is None:
            return
        d = np.abs(z[cand][:, None] - np.asarray(lam)[None, :]).min(axis=1)
        dmin = float(d.min())
        if dmin < thresh:
            warnings.warn(
                f"LU '{cfg.precision}' tier: {int((d < thresh).sum())} grid "
                f"point(s) within {thresh:g} of a bare eigenvalue of the "
                f"(H, S) pencil (closest {dmin:.2e}); the refined-f32 solve "
                f"floors at cond * u_res there and can exceed its accuracy "
                f"contract.  Use precision='strict', or set "
                f"near_pole_warn=False to silence.",
                RuntimeWarning, stacklevel=3)

    # --- sums ----------------------------------------------------------
    def gr_sum(self, E, w, epilog=None):
        """sum_k w_k G(E_k); parity with integrate.GrInt.

        epilog='im': return Im(sum) as a real float64 array (accumulated
        from the imaginary parts only).  Runs the LU route (the only
        solver family ported; the JAX package's _gr_sum_lu)."""
        self._near_pole_guard(E)
        fn, params = self.provider.total_apply()
        p = self._params(params)
        point = lambda e, ww: _point_gr_weighted(
            e, ww, self.H, self.S, p, fn, None, self.exec_cfg)
        out = self._sum(point, E, w, imag=epilog == "im")
        return out.cpu().numpy()

    def _gless_point(self, contact):
        """The G< point function (low-rank when the contact support is
        static and small) for ``contact``, with its device params."""
        fn, params = self.provider.total_apply()
        cfn = None
        if contact is not None:
            cfn, params = self.provider.contact_apply(contact)
        p = self._params(params)
        c = self._contact_inds(contact)
        if c is not None:
            return lambda e, ww: _point_gless_weighted_lowrank(
                e, ww, self.H, self.S, p, fn, cfn, c, self.exec_cfg)
        return lambda e, ww: _point_gless_weighted(
            e, ww, self.H, self.S, p, fn, cfn, self.exec_cfg)

    def gless_sum(self, E, w, contact: Optional[int] = None):
        """sum_k w_k [G Gamma_i G^+](E_k); parity with integrate.GrLessInt
        (the JAX package's _gless_sum_lu)."""
        self._near_pole_guard(E)
        out = self._sum(self._gless_point(contact), E, w, imag=False)
        return out.cpu().numpy()

    def density_neq_sum(self, E_eq, w_eq, E_neq, w_neq,
                        contact: Optional[int] = None):
        """Im(sum w G) over the eq grid + sum w [G Gamma G+] over the bias
        window, combined on the device into one complex density
        contribution and one copy to the host (scale factors belong in the
        weights)."""
        fn, params = self.provider.total_apply()
        p = self._params(params)
        point_eq = lambda e, ww: _point_gr_weighted(
            e, ww, self.H, self.S, p, fn, None, self.exec_cfg)
        out = self._sum(point_eq, E_eq, w_eq, imag=True) \
            + self._sum(self._gless_point(contact), E_neq, w_neq, imag=False)
        return out.cpu().numpy()

    def density_eq_split(self, E_real, w_real, E_contour, w_contour):
        """Im(sum w G) over the real-axis and contour grids in one
        dispatch.  The JAX package can run the contour on Newton-Schulz
        continuation; this package runs both grids on the batched LU."""
        E = np.concatenate([np.asarray(E_real, complex),
                            np.asarray(E_contour, complex)])
        w = np.concatenate([np.asarray(w_real, complex),
                            np.asarray(w_contour, complex)])
        return self.gr_sum(E, w, epilog="im")
