"""Spectral (eigenbasis + Woodbury) energy-grid route.

Port of ``gaunegf_tpu/ops/spectral.py``.  Across one energy grid H and S
are fixed and the self-energy differs from a constant background only on
the contact orbitals (rank k << N), so the whole grid shares one spectral
decomposition:

    Sigma(z) = c0 * S + P_c M(z) P_c^T          (P_c: N x k selector)
    A(z)     = z' S - H - P_c M(z) P_c^T,  z' = z - c0
    H C = S C diag(lam),  C^T S C = I           (one float64 eigh per Fock)
    (z' S - H)^{-1} = C D(z) C^T,  D = diag(1/(z' - lam))

and Woodbury gives, in the eigenbasis,

    Ghat(z) = D + (D Cc^T) K(z) (Cc D),   Cc = P_c^T C        (k x N)
    G0cc    = Cc D Cc^T,   K = (I_k - M G0cc)^{-1} M          (k x k)
    sum_j w_j G(z_j) = C [ sum_j w_j Ghat_j ] C^T             (one rotation)

Per energy point that is O(N^2 k) work (the rank-k outer product; a chunk
of points stacks into ONE (N, ch*k) @ (ch*k, N) product) instead of an
O(N^3) LU.  The O(N^3) rotation happens once per grid, the eigh once per
Fock matrix.

Precision.  The JAX package runs an f32 outer product with a double-word
k x k chain, because the TPU has no float64.  Here the whole route runs
in float64 / complex128 on the engine's device: the basis, D, the
k-chain, the stacked product, the accumulator and the rotation (~1e-12
relative away from poles).  Grid points within ``spectral_dist_f32`` of
a bare eigenvalue (3x that for G<) run the pole-deflated chain
(``spectral_deflate`` nearest modes reintroduced in closed form), which
stays finite and exact even on an exact real-axis hit; with deflation off
(``spectral_deflate=0``) points within ``spectral_dist_lu`` go to the
exact-tier LU (``EnergyEngine._spectral_fallback_engine``).

Every point function takes a chunk of b energies and returns (b, ...)
stacks, like the point functions of ``ops/greens.py``.

Not ported, because each emulates float64 that the H100 has natively
(ROADMAP "What does not port") or needs several devices:

* ``device_basis`` and its Ogita-Aishima refinement: the basis is one
  float64 ``torch.linalg.eigh`` on the engine's device;
* the deflation's union Rayleigh-Ritz refinement (``_defl_basis`` would
  return the basis as it is, the JAX package's host-basis branch);
* ``_s_m12_host``;
* the double-word helpers (``_dw_*``, ``_cdw_*``, ``ctwo_*``,
  ``zmatmul_dw``, ``zinv_dw``, the Ozaki "lite" products);
* the ``shard_map`` engines and ``_pvary``: under an ('e', 'm') mesh
  (``mesh=``, parallel/mesh.py) each rank serves its 'e' share of every
  segment's points (``grid_layout``) and the sums reduce once over 'e';
  the route shards 'e' only, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models.selfenergy import _host_eval, tree_map
from gaunegf_tpu_torch.parallel.mesh import grid_layout, grid_unlayout

__all__ = ["SpectralStructure", "spectral_basis", "detect_structure",
           "spectral_supported", "SpectralRunner", "spectral_chunk"]

_C128 = torch.complex128


# ---------------------------------------------------------------------------
# Basis and structure
# ---------------------------------------------------------------------------

_BASIS_CACHE: dict = {}
_BASIS_CACHE_SIZE = 4


def content_digest(*arrays) -> str:
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _eigh_pencil(H, S, device):
    """float64 (lam, C) of the pencil on ``device``: eigh of H when S = I,
    else eigh of L^-1 H L^-T with S = L L^T and C = L^-T Y."""
    Hd = torch.as_tensor(H, device=device)
    if np.array_equal(S, np.eye(S.shape[0])):
        return torch.linalg.eigh(Hd)
    L = torch.linalg.cholesky(torch.as_tensor(S, device=device))
    X = torch.linalg.solve_triangular(L, Hd, upper=False)      # L^-1 H
    A = torch.linalg.solve_triangular(L, X.T, upper=False)     # L^-1 H L^-T
    lam, Y = torch.linalg.eigh(0.5 * (A + A.T))
    return lam, torch.linalg.solve_triangular(L.T, Y, upper=True)


def _eigh_pencil_shared(H, S, device, mesh):
    """_eigh_pencil computed by 'e' rank 0 and broadcast over 'e': the
    basis must be the same bits on every rank (each rank's sums rotate
    with it, and their partial sums add), so one rank computes it rather
    than each computing its own and checking."""
    N = H.shape[0]
    ok = torch.zeros(1, dtype=torch.float64, device=device)
    lam = torch.empty(N, dtype=torch.float64, device=device)
    C = torch.empty((N, N), dtype=torch.float64, device=device)
    if mesh.coords["e"] == 0:
        try:
            lam, C = _eigh_pencil(H, S, device)
            ok.fill_(1.0)
        except torch.linalg.LinAlgError:
            pass
    if not bool(mesh.broadcast_e(ok)):
        raise torch.linalg.LinAlgError("S is not positive definite")
    return mesh.broadcast_e(lam), mesh.broadcast_e(C)


def spectral_basis(H, S, device, mesh=None):
    """float64 generalized eigendecomposition of the (H, S) pencil.

    ``device`` is required, as at every entry point of the package
    (``ops.greens.resolve_device``: None raises TypeError).  Returns
    (lam (N,) float64 NumPy, C (N, N) float64 tensor on
    ``device`` with C^T S C = I), or None when the pencil is not
    real-symmetric-definite (the spectral route requires it).  Runs on the
    device (cuSOLVER on a card).  Cached by content digest and device, 4
    entries: SCF cycles rebuild engines with a fresh F, but repeated
    sweeps and the near-pole guard on one Fock pay the eigh once.  Under a
    mesh 'e' rank 0 computes it and broadcasts it over 'e'
    (_eigh_pencil_shared), cached apart from the unsharded basis."""
    from gaunegf_tpu_torch.ops.greens import resolve_device  # imports us
    device = resolve_device(device)
    H = np.asarray(H)
    S = np.asarray(S)
    if np.iscomplexobj(H):
        if np.abs(H.imag).max() > 0.0:
            return None
        H = H.real
    if np.iscomplexobj(S):
        if np.abs(S.imag).max() > 0.0:
            return None
        S = S.real
    H = H.astype(np.float64)
    S = S.astype(np.float64)
    scale = max(np.abs(H).max(), 1e-300)
    if np.abs(H - H.T).max() > 1e-10 * scale:
        return None
    key = (content_digest(H, S), str(device))
    if mesh is not None:
        key += ("mesh",)
    hit = _BASIS_CACHE.get(key)
    if hit is not None:
        return hit
    try:
        lam, C = (_eigh_pencil(H, S, device) if mesh is None
                  else _eigh_pencil_shared(H, S, device, mesh))
    except torch.linalg.LinAlgError:        # S not positive definite
        return None
    if len(_BASIS_CACHE) >= _BASIS_CACHE_SIZE:
        _BASIS_CACHE.pop(next(iter(_BASIS_CACHE)))
    _BASIS_CACHE[key] = (lam.cpu().numpy(), C)
    return _BASIS_CACHE[key]


class SpectralStructure(NamedTuple):
    """Detected low-rank structure of a provider's Sigma."""
    c: tuple            # contact orbital indices
    c0: complex         # background coefficient: Sigma_offblock == c0 * S
    bg_cc: np.ndarray   # c0 * S[c, c], complex128


def detect_structure(provider, S, probes=(0.137 + 0.211j, -0.233 + 0.173j),
                     tol=1e-6, *, device):
    """Detect Sigma(z) = c0*S + P_c M(z) P_c^T from two probes.

    The probes run in complex128 on ``device`` through the provider's
    (fn, params).  The fit is exact for every form_sigma-based provider
    (background -1j*1e-9*S); a Sigma that leaks outside the contact block,
    or whose background depends on the energy, fails the residual check
    and the caller keeps the LU route.  Cached on the provider: the
    structure does not change under set_fock."""
    cached = getattr(provider, "_spectral_struct", None)
    if cached is not None:
        return cached
    getter = getattr(provider, "contact_inds", None)
    if getter is None:
        return None
    try:
        c = getter(None)
    except (TypeError, IndexError):
        return None
    if not c:
        return None
    c = tuple(int(j) for j in c)
    S = np.asarray(S, dtype=np.float64)
    N = S.shape[0]
    # beyond k ~ N/2 the O(N^2 k) route has no advantage over the LU
    if len(c) > N // 2:
        return None
    fn, params = provider.total_apply()
    sigs = [np.asarray(_host_eval(fn, params, z, device), dtype=np.complex128)
            for z in probes]
    off = np.ones((N, N))
    off[np.ix_(c, c)] = 0.0
    Sm = S * off
    denom = float(np.vdot(Sm, Sm).real)
    c0s = []
    for sig in sigs:
        R = sig * off
        c0 = complex(np.vdot(Sm, R) / denom) if denom > 0 else 0.0
        scale = max(np.abs(sig).max(), 1e-30)
        if np.abs(R - c0 * Sm).max() > tol * scale + 1e-12:
            return None
        c0s.append(c0)
    if abs(c0s[0] - c0s[1]) > tol * (abs(c0s[0]) + 1e-12):
        return None
    c0 = c0s[0]
    struct = SpectralStructure(c=c, c0=c0,
                               bg_cc=(c0 * S[np.ix_(c, c)]).astype(complex))
    try:
        provider._spectral_struct = struct
    except AttributeError:                  # a provider with __slots__
        pass
    return struct


def spectral_supported(provider, H, S, device):
    """True when both the pencil and the Sigma structure qualify; the
    pencil's basis is computed on ``device`` (required)."""
    return (spectral_basis(H, S, device) is not None
            and detect_structure(provider, S, device=device) is not None)


# ---------------------------------------------------------------------------
# Per-point assembly, batched over a chunk of b energies
# ---------------------------------------------------------------------------

def _dagger(x):
    return x.conj().transpose(-1, -2)


def _block(sig, c_t):
    return sig[..., c_t[:, None], c_t[None, :]]


def _sigma_block(E, params, sig_tot_fn, sig_block_fn, c_t, bg_cc):
    """M(E) = Sigma_total[c, c] - c0*S[c, c] -> (b, k, k) complex128."""
    if sig_block_fn is not None:
        blk = sig_block_fn(params, E)
    else:
        blk = _block(sig_tot_fn(params, E), c_t)
    k = c_t.shape[0]
    return torch.broadcast_to(blk.to(_C128) - bg_cc, (E.shape[0], k, k))


def _gamma_block(E, params, gamma_fn, c_t, M):
    """i(Sigma_c - Sigma_c^H) on the contact block: the contact's Sigma
    when ``gamma_fn`` is given, else M (the total block without the
    background).  The broadening background's ~1e-9 Gamma outside the
    block is dropped, as in the low-rank LU functions."""
    blk = M if gamma_fn is None else torch.broadcast_to(
        _block(gamma_fn(params, E), c_t).to(_C128), M.shape)
    return 1j * (blk - _dagger(blk))


def _k_chain(zp, M, lam, Cc):
    """The per-point Woodbury chain: D = 1/(z' - lam) (b, N),
    X = D Cc^T (b, N, k), G0 = Cc D Cc^T and K = (I - M G0)^-1 M
    (b, k, k)."""
    D = 1.0 / (zp[:, None] - lam[None, :])
    X = D[:, :, None] * Cc.T
    G0 = Cc @ X
    eye = torch.eye(Cc.shape[0], dtype=_C128, device=Cc.device)
    K = torch.linalg.solve(eye - M @ G0, M)
    return D, X, G0, K


class _Deflated(NamedTuple):
    """The deflated chain of a chunk (see _k_chain_defl)."""
    Dp: torch.Tensor      # (b, N) bare diagonal, near modes masked to 0
    Xp: torch.Tensor      # (b, N, k) Dp Cc^T
    G0p: torch.Tensor     # (b, k, k) Cc Dp Cc^T
    K: torch.Tensor       # (b, k, k) full K
    W: torch.Tensor       # (b, k, m) A'^-1 M u
    L: torch.Tensor       # (b, m, k) u^T A'^-1 M
    Sinv: torch.Tensor    # (b, m, m) capacitance inverse
    u: torch.Tensor       # (b, k, m) Cc[:, near]
    Pt: torch.Tensor      # (b, m, N) near-mode selector rows


def _k_chain_defl(zp, M, lam, Cc, idx):
    """The pole-deflated Woodbury chain.

    The m modes in ``idx`` (b, m) (each point's nearest eigenvalues) are
    removed from the bare resolvent and reintroduced in closed form: with
    delta = z' - lam_near, u = Cc[:, idx], A' = I - M G0' (G0' the
    deflated contact-block resolvent), W = A'^-1 M u, L = u^T A'^-1 M and
    B = u^T W, the capacitance S_m = diag(delta) - B is O(1)-conditioned
    and

        K                  = A'^-1 M + W S_m^-1 L
        K u diag(1/delta)  = W S_m^-1
        diag(1/delta) u^T K = S_m^-1 L
        near-near block    = S_m^-1

    so no 1/delta appears anywhere and an exact real-axis hit
    (delta = 0) stays finite.  The masked denominators are replaced by 1
    before the reciprocal (1/0 * 0 would be NaN)."""
    den = zp[:, None] - lam[None, :]
    far = torch.ones(den.shape, dtype=torch.bool, device=den.device)
    far.scatter_(1, idx, False)
    Dp = torch.where(far, 1.0 / torch.where(far, den, torch.ones_like(den)),
                     torch.zeros_like(den))
    delta = torch.gather(den, 1, idx)                     # (b, m)
    Xp = Dp[:, :, None] * Cc.T
    G0p = Cc @ Xp
    uT = Cc.T[idx]                                        # (b, m, k)
    u = uT.transpose(1, 2)
    eye = torch.eye(Cc.shape[0], dtype=_C128, device=Cc.device)
    Kp = torch.linalg.solve(eye - M @ G0p, M)             # A'^-1 M
    W = Kp @ u
    L = uT @ Kp
    Sinv = torch.linalg.inv(torch.diag_embed(delta) - L @ u)
    K = Kp + W @ Sinv @ L
    Pt = torch.nn.functional.one_hot(idx, lam.shape[0]).to(_C128)
    return _Deflated(Dp, Xp, G0p, K, W, L, Sinv, u, Pt)


def _point_factors(zp, w, M, lam, Cc):
    """Retarded sum of a chunk -> (X, Z, D): Ghat_j - D_j = X_j Z_j / w_j
    with X = D Cc^T (b, N, k), Z = w K (Cc D) (b, k, N)."""
    D, X, _, K = _k_chain(zp, M, lam, Cc)
    Y = Cc * D[:, None, :]
    return X, w[:, None, None] * (K @ Y), D


def _point_factors_defl(zp, w, M, lam, Cc, idx):
    """Deflated retarded sum of a chunk -> (X, Z, Dp):

        Ghat - Dp = [X', P] @ [K Y' + W S_m^-1 P^T ;
                               S_m^-1 (L Y' + P^T)]

    with P the (N, m) near-mode selector, so the chunk stacks into one
    (N, ch*(k+m)) @ (ch*(k+m), N) product like the plain points."""
    d = _k_chain_defl(zp, M, lam, Cc, idx)
    Yp = Cc * d.Dp[:, None, :]
    R1 = d.K @ Yp + (d.W @ d.Sinv) @ d.Pt
    R2 = d.Sinv @ (d.L @ Yp + d.Pt)
    Z = w[:, None, None] * torch.cat([R1, R2], dim=1)
    X = torch.cat([d.Xp, d.Pt.transpose(1, 2)], dim=2)
    return X, Z, d.Dp


def _point_gless_factors(zp, w, M, gamma, lam, Cc):
    """G< of a chunk -> (Xt, R): G Gamma G^H = C [Xt (w Gamma) Xt^H] C^T
    with Xt = G P_c in the eigenbasis = D Cc^T (I + K G0cc) (b, N, k) and
    R = (w Gamma) Xt^H (b, k, N)."""
    _, X, G0, K = _k_chain(zp, M, lam, Cc)
    eye = torch.eye(Cc.shape[0], dtype=_C128, device=Cc.device)
    Xt = X @ (eye + K @ G0)
    return Xt, (w[:, None, None] * gamma) @ _dagger(Xt)


def _point_gless_factors_defl(zp, w, M, gamma, lam, Cc, idx):
    """Deflated G< of a chunk -> (Xt, R), the near modes folded in:

        Xt = X' [I + K G0' + W S_m^-1 u^T] + P S_m^-1 [u^T + L G0']."""
    d = _k_chain_defl(zp, M, lam, Cc, idx)
    eye = torch.eye(Cc.shape[0], dtype=_C128, device=Cc.device)
    uT = d.u.transpose(1, 2)
    T1 = eye + d.K @ d.G0p + (d.W @ d.Sinv) @ uT
    T2 = d.Sinv @ (uT + d.L @ d.G0p)
    Xt = d.Xp @ T1 + d.Pt.transpose(1, 2) @ T2
    return Xt, (w[:, None, None] * gamma) @ _dagger(Xt)


def _trace_t(Gcc, p1, p2, gamma1, gamma2):
    """T = Re tr(Gamma1 G12 Gamma2 G12^H), G12 = Gcc[p1, p2]."""
    G12 = Gcc[:, p1[:, None], p2[None, :]]
    M1 = gamma1 @ G12
    M2 = gamma2 @ _dagger(G12)
    return torch.einsum("bij,bji->b", M1, M2).real


def _point_transmission_sp(zp, M, lam, Cc, p1, p2, gamma1, gamma2):
    """T(E) in the contact subspace, O(N k^2) per point:
    Gcc = G0cc + G0cc K G0cc."""
    _, _, G0, K = _k_chain(zp, M, lam, Cc)
    return _trace_t(G0 + G0 @ K @ G0, p1, p2, gamma1, gamma2)


def _point_transmission_defl(zp, M, lam, Cc, idx, p1, p2, gamma1, gamma2):
    """Deflated T(E):

        Gcc = G0' + G0' K G0' + (G0' W) S_m^-1 u^T
            + u S_m^-1 (L G0') + u S_m^-1 u^T

    every term O(1)-bounded, so near-pole points stay exact."""
    d = _k_chain_defl(zp, M, lam, Cc, idx)
    uT = d.u.transpose(1, 2)
    Gcc = (d.G0p + d.G0p @ d.K @ d.G0p
           + (d.G0p @ d.W) @ d.Sinv @ uT
           + d.u @ (d.Sinv @ (d.L @ d.G0p))
           + d.u @ d.Sinv @ uT)
    return _trace_t(Gcc, p1, p2, gamma1, gamma2)


def _chunk_corr(Xs, Zs):
    """sum_j X_j Z_j over the chunk as ONE stacked product:
    (N, b*k) @ (b*k, N)."""
    b, N, k = Xs.shape
    return Xs.permute(1, 0, 2).reshape(N, b * k) @ Zs.reshape(b * k, N)


def _rotate(C, Shat, imag):
    """C Shat C^T with C real: float64 Im part only when ``imag``, else
    complex128."""
    if imag:
        return C @ Shat.imag @ C.T
    return torch.complex(C @ Shat.real @ C.T, C @ Shat.imag @ C.T)


def _to_host(x):
    """x as NumPy, copied from a card through pinned memory (the N x N
    result of a sum: a pageable copy runs at a few GB/s)."""
    if x.device.type != "cuda":
        return x.cpu().numpy()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out.numpy()


# ---------------------------------------------------------------------------
# Chunk sizing
# ---------------------------------------------------------------------------

# Spectral energy chunk when the engine's chunk is automatic.  The live
# bytes of a lane are the O(N k) factor stacks, not the LU's O(N^2), so
# the LU rule would starve the stacked products at large N.  The
# automatic chunk is the largest power of two in [_SPECTRAL_CHUNK_MIN,
# _SPECTRAL_CHUNK_MAX] whose lanes fit the budget.  On the H100 (PERF.md)
# a lane took 57-99 bytes per N*k (N=1000, 2000, k=16), and chunk 64
# led 32 by 11-33% at N=1000 and tied it within the run-to-run spread at
# N=2000 (the sweep of ``python -m gaunegf_tpu_torch.tune --solver
# spectral``).
_SPECTRAL_CHUNK_MIN = 8
_SPECTRAL_CHUNK_MAX = 64
_SPECTRAL_LANE_BYTES_PER_NK = 104
_SPECTRAL_CHUNK_BUDGET_BYTES = 2e9


def spectral_chunk(k: int, N: int) -> int:
    """The automatic spectral energy chunk for k contact orbitals and N
    orbitals."""
    lane = _SPECTRAL_LANE_BYTES_PER_NK * max(k, 1) * N
    ch = _SPECTRAL_CHUNK_MIN
    while (ch * 2 <= _SPECTRAL_CHUNK_MAX
           and ch * 2 * lane <= _SPECTRAL_CHUNK_BUDGET_BYTES):
        ch *= 2
    return ch


# ---------------------------------------------------------------------------
# Runner (used by EnergyEngine)
# ---------------------------------------------------------------------------

class SpectralRunner:
    """Per-(H, S, provider) spectral state: basis, structure, dispatch.

    Built lazily by EnergyEngine when exec_cfg.solver engages the route;
    ``available`` is False when the pencil or the Sigma structure
    disqualify (complex H, Sigma outside the contact block, ...) and the
    caller keeps the LU route.  Host grids in, host NumPy results out, as
    the engine's methods."""

    def __init__(self, H, S, provider, exec_cfg: ExecutionConfig, device,
                 chunk_auto=False, mesh=None):
        self.exec_cfg = exec_cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.available = False
        struct = detect_structure(provider, S, device=self.device)
        if struct is None:
            return
        if chunk_auto:
            self.exec_cfg = dataclasses.replace(
                exec_cfg, energy_chunk=spectral_chunk(len(struct.c),
                                                      np.shape(H)[-1]))
        basis = spectral_basis(H, S, self.device, mesh=mesh)
        if basis is None:
            return
        self.lam64, self.C = basis
        self.lam = torch.as_tensor(self.lam64, device=self.device)
        self.c = struct.c
        self.c0 = struct.c0
        self.c_t = torch.as_tensor(self.c, device=self.device)
        self.Cc = self.C[self.c_t].to(_C128)                 # (k, N)
        self.bg_cc = torch.as_tensor(struct.bg_cc, device=self.device)
        self.available = True

    # -- host helpers ----------------------------------------------------

    def _window(self, E, m):
        """For each shifted point z' = E - c0: the positions (n, w) of the
        w = min(2m, N) eigenvalues around Re z' in the sorted spectrum,
        and |Re z' - lam| over them.  |z' - lam|^2 = (Re z' - lam)^2 +
        (Im z')^2, so the m eigenvalues nearest z' are the m nearest
        Re z', which lie in that window: O(n (log N + m)) on the host
        instead of O(n N)."""
        zp = np.asarray(E, dtype=np.complex128).ravel() - self.c0
        lam = self.lam64
        w = min(2 * m, lam.size)
        start = np.clip(np.searchsorted(lam, zp.real) - m, 0, lam.size - w)
        cand = start[:, None] + np.arange(w)
        return zp, cand, np.abs(zp.real[:, None] - lam[cand])

    def _dists(self, E):
        """Per point, the distance of z' = E - c0 to the bare spectrum."""
        zp, _, dx = self._window(E, 1)
        return np.hypot(dx.min(axis=1), zp.imag)

    def _deflate_m(self):
        """Deflated-mode count (0 disables the analytic deflation)."""
        m = int(self.exec_cfg.spectral_deflate or 0)
        return min(m, self.lam64.size) if m > 0 else 0

    def _near_idx(self, E, m):
        """(n, m) nearest-eigenvalue indices per shifted point."""
        _, cand, dx = self._window(E, m)
        pick = np.argpartition(dx, m - 1, axis=1)[:, :m]
        return np.take_along_axis(cand, pick, axis=1)

    def _mode(self, E):
        """'plain' when every point stays spectral_dist_f32 away from the
        bare spectrum; 'defl' when deflation is on and some point is
        nearer; with deflation off 'plain' for the points at or beyond
        spectral_dist_lu, or None when no point qualifies."""
        d = self._dists(E)
        if self._deflate_m() > 0:
            return "plain" if d.min() >= self.exec_cfg.spectral_dist_f32 \
                else "defl"
        return "plain" if (d >= self.exec_cfg.spectral_dist_lu).any() \
            else None

    def bad_mask(self, E):
        """Points the spectral route must not serve: none with deflation
        on (stable at any pole distance); otherwise those within
        spectral_dist_lu of a bare eigenvalue, which go to the exact-tier
        LU."""
        d = self._dists(E)
        if self._deflate_m() > 0:
            return np.zeros(d.shape, dtype=bool)
        return d < self.exec_cfg.spectral_dist_lu

    def split_grid(self, E, w):
        """((E_sp, w_sp), (E_lu, w_lu)): the spectral part and the
        LU-fallback part of the grid."""
        E = np.asarray(E, dtype=np.complex128).ravel()
        w = np.asarray(w, dtype=np.complex128).ravel()
        bad = self.bad_mask(E)
        return (E[~bad], w[~bad]), (E[bad], w[bad])

    def _segments(self, E, thresh):
        """[(positions, near-mode indices or None)]: the points at least
        ``thresh`` from the bare spectrum run the plain chain, the others
        the deflated one (all plain with deflation off)."""
        m = self._deflate_m()
        if m == 0:
            return [(np.arange(E.size), None)]
        far = self._dists(E) >= thresh
        segs = []
        if far.any():
            segs.append((np.nonzero(far)[0], None))
        if (~far).any():
            near = np.nonzero(~far)[0]
            segs.append((near, self._near_idx(E[near], m)))
        return segs

    def _shard(self, seg):
        """This rank's 'e' share of a segment (grid_layout over its
        points) and the share's padding mask."""
        pos, idx = seg
        lp, pad = grid_layout(pos.size, self.mesh, self.exec_cfg.energy_chunk)
        return (pos[lp], None if idx is None else idx[lp]), pad

    def _fns(self, provider):
        fn, params = provider.total_apply()
        block = getattr(provider, "total_block_apply", None)
        return fn, (block(self.c) if block is not None else None), params

    def _params(self, params):
        return tree_map(lambda v: torch.as_tensor(
            np.asarray(v, dtype=np.complex128), device=self.device), params)

    def _chunks(self, E, seg):
        """(E (b,), z' (b,), positions, near idx or None) per chunk of a
        segment, as device tensors (one host copy per segment)."""
        pos, idx = seg
        E_d = torch.as_tensor(E[pos], device=self.device)
        zp_d = torch.as_tensor(E[pos] - self.c0, device=self.device)
        idx_d = None if idx is None else torch.as_tensor(idx,
                                                         device=self.device)
        ch = self.exec_cfg.energy_chunk
        for i in range(0, pos.size, ch):
            yield (E_d[i:i + ch], zp_d[i:i + ch], slice(i, i + ch),
                   None if idx_d is None else idx_d[i:i + ch])

    # -- dispatch --------------------------------------------------------

    def _sum(self, kind, provider, E, w, contact=None, epilog=None):
        E = np.asarray(E, dtype=np.complex128).ravel()
        if E.size == 0:
            return None
        w = np.asarray(w, dtype=np.complex128).ravel()
        fn, block_fn, params = self._fns(provider)
        gamma_fn = None
        if kind == "gless" and contact is not None:
            gamma_fn, params = provider.contact_apply(contact)
        p = self._params(params)
        N = self.lam.shape[0]
        Shat = torch.zeros((N, N), dtype=_C128, device=self.device)
        dsum = torch.zeros(N, dtype=_C128, device=self.device)
        # G Gamma G^H hits the plain chain's cancellation earlier than G
        # (the JAX package measured it): deflate 3x as far for G<
        thresh = self.exec_cfg.spectral_dist_f32 * (
            3.0 if kind == "gless" else 1.0)
        for seg in self._segments(E, thresh):
            seg, pad = self._shard(seg)
            w_d = torch.as_tensor(np.where(pad, 0.0, w[seg[0]]),
                                  device=self.device)
            for Eb, zp, sl, idx in self._chunks(E, seg):
                wb = w_d[sl]
                M = _sigma_block(Eb, p, fn, block_fn, self.c_t, self.bg_cc)
                if kind == "gr":
                    X, Z, D = (_point_factors(zp, wb, M, self.lam, self.Cc)
                               if idx is None else _point_factors_defl(
                                   zp, wb, M, self.lam, self.Cc, idx))
                    dsum += (wb[:, None] * D).sum(dim=0)
                else:
                    gamma = _gamma_block(Eb, p, gamma_fn, self.c_t, M)
                    X, Z = (_point_gless_factors(zp, wb, M, gamma, self.lam,
                                                 self.Cc)
                            if idx is None else _point_gless_factors_defl(
                                zp, wb, M, gamma, self.lam, self.Cc, idx))
                Shat += _chunk_corr(X, Z)
        Shat.diagonal().add_(dsum)
        if self.mesh is not None:
            Shat = self.mesh.sum_e(Shat)
        return _to_host(_rotate(self.C, Shat, epilog == "im"))

    def gr_sum(self, provider, E, w, epilog=None):
        """sum_j w_j G(E_j) -> (N, N) complex128 (float64 Im part for
        epilog='im'), or None for an empty grid."""
        return self._sum("gr", provider, E, w, epilog=epilog)

    def gless_sum(self, provider, E, w, contact=None):
        """sum_j w_j [G Gamma_c G^H](E_j) -> (N, N) complex128."""
        return self._sum("gless", provider, E, w, contact=contact)

    def transmission(self, provider, E):
        """Per-point T(E) -> (len(E),) float64, or None when a contact
        reaches outside the union support c (or no point qualifies).  The
        caller removes bad_mask points first: T is a map, so they cannot
        fold into a second sum here."""
        try:
            c1 = tuple(int(j) for j in provider.contact_inds(0))
            c2 = tuple(int(j) for j in provider.contact_inds(-1))
        except TypeError:               # a contact without a static support
            return None
        if not (c1 and c2 and set(c1) <= set(self.c)
                and set(c2) <= set(self.c)):
            return None
        E = np.asarray(E, dtype=np.complex128).ravel()
        if self._mode(E) is None:
            return None
        fn, block_fn, params = self._fns(provider)
        g1, _ = provider.contact_apply(0)
        g2, _ = provider.contact_apply(-1)
        p = self._params(params)
        pos = {j: i for i, j in enumerate(self.c)}
        dev = self.device
        p1 = torch.as_tensor([pos[j] for j in c1], device=dev)
        p2 = torch.as_tensor([pos[j] for j in c2], device=dev)
        c1_t = torch.as_tensor(c1, device=dev)
        c2_t = torch.as_tensor(c2, device=dev)
        out = np.empty(E.size, dtype=np.float64)
        for full in self._segments(E, self.exec_cfg.spectral_dist_f32):
            seg, _ = self._shard(full)
            vals = []
            for Eb, zp, _, idx in self._chunks(E, seg):
                M = _sigma_block(Eb, p, fn, block_fn, self.c_t, self.bg_cc)
                s1 = _block(g1(p, Eb), c1_t).to(_C128)
                s2 = _block(g2(p, Eb), c2_t).to(_C128)
                gam1 = torch.broadcast_to(1j * (s1 - _dagger(s1)),
                                          (Eb.shape[0],) + s1.shape[-2:])
                gam2 = torch.broadcast_to(1j * (s2 - _dagger(s2)),
                                          (Eb.shape[0],) + s2.shape[-2:])
                vals.append(
                    _point_transmission_sp(zp, M, self.lam, self.Cc, p1, p2,
                                           gam1, gam2)
                    if idx is None else _point_transmission_defl(
                        zp, M, self.lam, self.Cc, idx, p1, p2, gam1, gam2))
            vals = torch.cat(vals)
            if self.mesh is not None:
                vals = grid_unlayout(self.mesh.gather_e(vals), full[0].size,
                                     self.mesh, self.exec_cfg.energy_chunk)
            out[full[0]] = vals.cpu().numpy()
        return out
