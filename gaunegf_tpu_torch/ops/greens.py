"""Energy-batched Green's-function engines (the throughput core).

Port of the LU route of ``gaunegf_tpu/ops/greens.py``.  Every call is

    host energy grid (NumPy) -> one copy to the device
      -> Python loop over chunks of ``energy_chunk`` energies
        -> batched blocked LU of the chunk         (ops/zlinalg.py)
        -> weighted observable per energy
      -> complex128 accumulation of the weighted sum
    -> one copy of the (N, N) sum to the host

Point functions take a batch of energies E (b,) and return (b, ...)
stacks; ``map_engine`` runs any such function over a grid (transmission,
gr_diag and dos are built on it).  Self-energy providers expose ``total_apply()`` /
``contact_apply(i)`` -> (fn, params): params a dict of NumPy arrays,
fn(params, E) on torch tensors returning Sigma broadcastable to
(b, N, N).  The engine copies params to the device once per dispatch.

Providers with a warm interface (``contacts_warm_apply()`` -> (fn, params,
init): the Bethe and 3D-lattice electrodes, and 1D chains under
``warm_start="force"``) run the LU route's sums and T(E) on the
warm-started engines below the high tiers, as in the JAX package: the
grid is laid out lane-major (each lane of a chunk owns a contiguous
segment of the grid), each lane's fixed-point state is carried from chunk
to chunk, and one solve per contact and energy serves Sigma_total and
both Gammas.  ``warm_start=False`` gives the cold path (a Bethe or
3D-lattice T(E) still solves each contact once per energy, from the
initial state).
On the 'high', 'exact' and 'strict' tiers the engine asks a provider whose
Sigma is an iterated fixed point (``iterated``) for it at ``conv =
TIGHT_CONV``, through the ``conv`` argument of its apply methods.

``continuation`` runs the Newton-Schulz continuation of the JAX package
(``EnergyEngine._chain_sum``): along each lane's contiguous, sorted grid
segment the previous energy's G seeds a few Newton iterations, which are
plain batched matmuls, and a chunk-wide residual gate sends a chunk whose
iterates do not converge to the tier's LU.  ``True`` runs gr_sum on it
below the high tiers; ``'contour'`` (the default) runs only the contour
of ``density_eq_split`` on it, where the real-axis segment stays on the
batched LU.

``solver='auto'`` (the default) and ``'spectral'`` route the fast and
mixed tiers through the spectral route (ops/spectral.py: one float64
eigendecomposition of the (H, S) pencil per Fock, a rank-k Woodbury
correction per energy) wherever the JAX package does: gr_sum, gless_sum,
density_neq_sum, density_eq_split and transmission, with the pole-distance
fallback points on the exact-tier LU.  Everything else, and ``'lu'``,
runs the LU route.

Under an ('e', 'm') mesh (``mesh=``, parallel/mesh.py: one process per
rank, every rank running this same host program) the grid shards over
'e' as the JAX package's ``_layout`` does, and every weighted sum reduces
once over 'e' per dispatch while every per-energy map gathers over 'e';
the warm engines keep one contiguous segment per rank.  Where N divides
by the 'm' size, the LU route's gr_sum, gless_sum, density_neq_sum and
transmission solve only the rank's N/m columns of each G
(zlinalg.zinv_refined_cols, or zsolve_dist with ``distribute_lu``) and
gather the column blocks over 'm' at the end; the spectral route shards
over 'e' only, and declines a mesh with more than one 'm' rank.
"""

from __future__ import annotations

import dataclasses
import logging
import warnings
from typing import Optional

import numpy as np
import torch

from gaunegf_tpu_torch.config import TIGHT_CONV, ExecutionConfig
from gaunegf_tpu_torch.models.selfenergy import tree_map
from gaunegf_tpu_torch.ops import zlinalg as zl
from gaunegf_tpu_torch.ops.spectral import SpectralRunner, spectral_basis
from gaunegf_tpu_torch.parallel.mesh import (grid_layout, grid_unlayout,
                                             warm_segment)
from gaunegf_tpu_torch.utils.logging import get_logger, perf_span

__all__ = ["EnergyEngine", "resolve_device", "weighted_gr_sum",
           "weighted_gless_sum", "transmission_map", "dos_map",
           "gr_diag_map"]

_DEFAULT_EXEC = ExecutionConfig()

# Peak device bytes of one energy lane of a mixed-tier gr_sum chunk,
# divided by N^2: 99-107 measured on the H100 at N=1000 and 2000 over
# panel widths 64-256 and chunks 32-256 (PERF.md).  With the budget below
# it sets the automatic energy chunk; past 128 lanes the sweep gained
# nothing.
_LANE_BYTES_PER_N2 = 108
# The same for the high/exact tiers, whose LU runs in complex128: 167.4
# measured on the H100 at N=1000, bs=256, chunk 64 (PERF.md).
_LANE_BYTES_PER_N2_C128 = 168
_CHUNK_BUDGET_BYTES = 32e9      # 40% of an 80 GB card
_CHUNK_MAX = 128

# The Newton-Schulz chain's residual gates (the JAX package's): r is
# max|A X - I| before the last plain Newton update, so the error after it
# is ~r^2 ('fast', the complex64 LU's floor for r < 5e-3) or ~r^4 after
# the mixed tier's complex128 polish squares it once more (< 8e-7).  r is
# the largest entry, as the JAX package reads it, and the largest entry
# of a square can reach N r^2: an estimate, not a bound.
_CHAIN_GATE_FAST = 5e-3
_CHAIN_GATE_MIXED = 3e-2
# An automatic chunk gives the chain the LU's automatic chunk capped at 32
# lanes (the JAX rule: the largest power of two <= 32 that fits the
# budget); with more lanes over a short grid each lane owns a point or
# two, and every step would be the LU's.
_CHAIN_MAX_LANES = 32
# Steps of the chain since the counts were last set to 0: Newton steps
# that passed the gate, and LU steps (the first of every call, and every
# step that failed the gate).
CHAIN_STEPS = {"newton": 0, "lu": 0}

_SPECTRAL_UNSET = object()


def resolve_device(device, mesh=None) -> torch.device:
    """The torch.device to run on.  There is no default: the caller names
    the device, and 'cuda' without a visible GPU raises.  Under a mesh the
    device is the rank's (``mesh.device``); naming another raises."""
    if mesh is not None:
        if device is not None and not _same_device(
                resolve_device(device), mesh.device):
            raise ValueError(f"device={device!r} differs from the mesh's "
                             f"device {mesh.device}")
        return mesh.device
    if device is None:
        raise TypeError("device is required, e.g. device='cuda' or "
                        "device='cpu'")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} was requested but torch "
                           "sees no CUDA device")
    return dev


def _same_device(a: torch.device, b: torch.device) -> bool:
    """'cuda' names the current card."""
    def idx(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index
    return a.type == b.type and idx(a) == idx(b)


# ---------------------------------------------------------------------------
# Per-energy observables (batched over the chunk)
# ---------------------------------------------------------------------------

def _assemble_A(E, H, S, sigma):
    return E[:, None, None] * S - H - sigma


def _newton_step(A, X):
    """X + X (I - A X) in the dtype of A and X; a batch element whose
    residual reaches 0.5 keeps X (a Newton step would amplify noise)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    R = eye - torch.matmul(A, X)
    ok = R.abs().amax(dim=(-2, -1)) < 0.5
    return torch.where(ok[..., None, None], X + torch.matmul(X, R), X)


def _gr_point(E, H, S, sigma, exec_cfg: ExecutionConfig):
    """G(E) = (E*S - H - Sigma)^-1 for a batch of energies (_inv_tier)."""
    return _inv_tier(_assemble_A(E, H, S, sigma), exec_cfg)


def _inv_tier(A, exec_cfg: ExecutionConfig):
    """A^-1 for a batch of operators with the configured precision policy:
    'mixed' refines the complex64 LU seed against the operator as
    assembled (complex128), 'fast' solves the complex64 operator on the
    blocked LU, 'high' the complex128 operator on the blocked LU ('exact'
    adds one complex128 Newton step), 'strict' the complex128 operator
    with torch.linalg.solve."""
    if exec_cfg.precision == "mixed":
        return zl.zinv_refined(A, steps=exec_cfg.refine_steps,
                               bs=exec_cfg.lu_block,
                               panel_impl=exec_cfg.lu_panel)
    if exec_cfg.precision in ("high", "exact"):
        X = zl.zinv(A, method="blocked", bs=exec_cfg.lu_block,
                    panel_impl=exec_cfg.lu_panel)
        return _newton_step(A, X) if exec_cfg.precision == "exact" else X
    return zl.zinv(A, bs=exec_cfg.lu_block, panel_impl=exec_cfg.lu_panel)


def _newton_chain(A, X, k: int):
    """k Newton-Schulz iterations X <- 2X - X (A X) from the seed X, in
    the dtype of A and X, and r = max|A X - I| over the batch, taken on
    the last iteration before its update (NaN where an iterate is)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    r = None
    for i in range(k):
        Y = torch.matmul(A, X)
        if i == k - 1:
            r = (Y - eye).abs().amax()
        X = 2.0 * X - torch.matmul(X, Y)
    return X, r


def _gamma(sig):
    return 1j * (sig - sig.conj().transpose(-1, -2))


def _point_gr_weighted(E, w, H, S, params, sig_tot_fn, _unused, exec_cfg):
    sigma = sig_tot_fn(params, E)
    G = _gr_point(E, H, S, sigma, exec_cfg)
    return w.to(G.dtype)[:, None, None] * G


def _gless_weighted(E, w, H, S, sig_tot, sig_c, exec_cfg):
    """w * G Gamma_c G+ from the full G, the sigmas given."""
    Gr = _gr_point(E, H, S, sig_tot, exec_cfg)
    Ga = Gr.conj().transpose(-1, -2)
    gamma = _gamma(sig_c).to(Gr.dtype)
    return w.to(Gr.dtype)[:, None, None] * torch.matmul(
        torch.matmul(Gr, gamma), Ga)


def _point_gless_weighted(E, w, H, S, params, sig_tot_fn, sig_c_fn, exec_cfg):
    sig_tot = sig_tot_fn(params, E)
    sig_c = sig_c_fn(params, E) if sig_c_fn is not None else sig_tot
    return _gless_weighted(E, w, H, S, sig_tot, sig_c, exec_cfg)


def _solve_cols(A, B, exec_cfg, mesh=None):
    """A X = B for a batch, B (b, N, k): one blocked factorization at the
    tier's precision.  'fast' and 'mixed' factor in complex64, the mixed
    tier adding one refinement solve against the complex128 residual of
    the operator as assembled; 'high' and 'exact' factor in complex128,
    'exact' adding one refinement solve.  'strict' solves with
    torch.linalg.solve.  Under a mesh with ``distribute_lu``, B holds this
    'm' rank's columns and zsolve_dist factors panel-cyclically."""
    if exec_cfg.precision == "strict":
        return zl.zsolve(A, B)
    lu_dtype = (torch.complex128 if exec_cfg.precision in ("high", "exact")
                else torch.complex64)
    A_lu = A.to(lu_dtype)
    if mesh is not None and exec_cfg.distribute_lu:
        solve = lambda rhs: zl.zsolve_dist(
            A_lu, rhs.to(lu_dtype), mesh, bs=exec_cfg.lu_block,
            panel_impl=exec_cfg.lu_panel)
    else:
        factors = zl.zlu_factor(A_lu, bs=exec_cfg.lu_block,
                                panel_impl=exec_cfg.lu_panel)
        solve = lambda rhs: zl.zlu_solve(factors, rhs.to(lu_dtype))
    X = solve(B)
    if exec_cfg.precision in ("mixed", "exact"):
        R = B.to(torch.complex128) - torch.matmul(
            A.to(torch.complex128), X.to(torch.complex128))
        X = X + solve(R)
    return X


def _gr_cols(E, H, S, sigma, cols, exec_cfg):
    """Selected columns G(E)[:, cols] for a batch of energies: unit-column
    right-hand sides through _solve_cols."""
    A = _assemble_A(E, H, S, sigma)
    N = H.shape[-1]
    B = torch.zeros((A.shape[0], N, len(cols)), dtype=A.dtype,
                    device=A.device)
    B[:, list(cols), torch.arange(len(cols), device=A.device)] = 1.0
    return _solve_cols(A, B, exec_cfg)


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


def _transmission(E, H, S, sig_tot, s1, s2, exec_cfg):
    """T(E) = Re tr(Gamma1 Gr Gamma2 Ga) per energy, from the full G, the
    total and the two contacts' sigmas given."""
    Gr = _gr_point(E, H, S, sig_tot, exec_cfg)
    gamma1 = _gamma(s1).to(Gr.dtype)
    gamma2 = _gamma(s2).to(Gr.dtype)
    M1 = torch.matmul(gamma1, Gr)
    M2 = torch.matmul(gamma2, Gr.conj().transpose(-1, -2))
    return torch.einsum("bij,bji->b", M1, M2).real.to(torch.float64)


def _transmission_lowrank(E, H, S, sig_tot, s1, s2, c1, c2, exec_cfg):
    """T(E) from contact-column solves: T = tr(G1 Gr[c1,c2] G2 Gr[c1,c2]+)
    with the Gamma blocks restricted to their contact support.  Neglects
    the -1j*1e-9*S broadening background's contribution to Gamma
    (~1e-9 relative)."""
    X = _gr_cols(E, H, S, sig_tot, c2, exec_cfg)        # (b, N, nc2)
    i1 = torch.as_tensor(c1, device=X.device)
    return _trace_lowrank(X[:, i1, :], s1, s2, i1,
                          torch.as_tensor(c2, device=X.device))


def _trace_lowrank(G12, s1, s2, i1, i2):
    """Re tr(Gamma1 G12 Gamma2 G12^H) per energy, G12 = Gr[c1, c2]
    (b, nc1, nc2), the Gammas restricted to the contact supports."""
    gamma1 = _gamma(s1[..., i1[:, None], i1[None, :]]).to(G12.dtype)
    gamma2 = _gamma(s2[..., i2[:, None], i2[None, :]]).to(G12.dtype)
    M1 = torch.matmul(gamma1, G12)
    M2 = torch.matmul(gamma2, G12.conj().transpose(-1, -2))
    return torch.einsum("bij,bji->b", M1, M2).real.to(torch.float64)


def _point_transmission(E, H, S, params, sig_tot_fn, g1_fn, g2_fn,
                        exec_cfg):
    return _transmission(E, H, S, sig_tot_fn(params, E), g1_fn(params, E),
                         g2_fn(params, E), exec_cfg)


def _point_transmission_lowrank(E, H, S, params, sig_tot_fn, g1_fn, g2_fn,
                                c1, c2, exec_cfg):
    return _transmission_lowrank(E, H, S, sig_tot_fn(params, E),
                                 g1_fn(params, E), g2_fn(params, E), c1, c2,
                                 exec_cfg)


def _sum_sigs(sigs):
    sig_tot = sigs[0]
    for sg in sigs[1:]:
        sig_tot = sig_tot + sg
    return sig_tot


def _point_sum_pre(kind, E, w, H, S, sigs, contact, exec_cfg):
    """w * G ('gr') or w * G Gamma_c G+ ('gless') from precomputed
    per-contact sigmas (warm path)."""
    sig_tot = _sum_sigs(sigs)
    if kind == "gr":
        Gr = _gr_point(E, H, S, sig_tot, exec_cfg)
        return w.to(Gr.dtype)[:, None, None] * Gr
    sig_c = sigs[contact % len(sigs)] if contact is not None else sig_tot
    return _gless_weighted(E, w, H, S, sig_tot, sig_c, exec_cfg)


def _point_gr_diag(E, H, S, params, sig_tot_fn, exec_cfg):
    """diag G(E) per energy (the DOS building block)."""
    G = _gr_point(E, H, S, sig_tot_fn(params, E), exec_cfg)
    return torch.diagonal(G, dim1=-2, dim2=-1)


# ---------------------------------------------------------------------------
# Per-energy observables sharded over the mesh's 'm' axis: each rank holds
# the (b, N, N/m) column block of its output (JAX ops/greens.py:293-463)
# ---------------------------------------------------------------------------

def _gr_cols_mp(A, mesh, exec_cfg):
    """The rank's column block of G = A^-1 at the tier's precision, the
    sharded twin of _gr_point: 'fast' the complex64 LU, 'mixed' refined
    against the complex128 operator, 'high' the complex128 LU, 'exact'
    plus one complex128 Newton step."""
    p = exec_cfg.precision
    kw = dict(bs=exec_cfg.lu_block, panel_impl=exec_cfg.lu_panel,
              distribute_lu=exec_cfg.distribute_lu)
    if p in ("high", "exact"):
        return zl.zinv_refined_cols(A, mesh, steps=int(p == "exact"),
                                    lu_dtype=torch.complex128, **kw)
    steps = exec_cfg.refine_steps if p == "mixed" else 0
    return zl.zinv_refined_cols(A, mesh, steps=steps, **kw)


def _point_gr_weighted_cols(E, w, H, S, params, sig_tot_fn, _unused, mesh,
                            exec_cfg):
    X = _gr_cols_mp(_assemble_A(E, H, S, sig_tot_fn(params, E)), mesh,
                    exec_cfg)
    return w.to(X.dtype)[:, None, None] * X


def _rows_h(G, mesh):
    """(G[rows of this 'm' rank, :])^H: the rank's columns of G^H."""
    rank, wq = zl._rank_cols(G.shape[1], mesh)
    return G[:, rank * wq:(rank + 1) * wq, :].conj().transpose(-1, -2)


def _point_gless_weighted_full_cols(E, w, H, S, params, sig_tot_fn,
                                    sig_c_fn, mesh, exec_cfg):
    """The rank's columns of w * Gr Gamma Ga: its column block of Gr, one
    gather over 'm', then out[:, cols] = Gr (Gamma (Gr[cols, :])^H)."""
    sig_tot = sig_tot_fn(params, E)
    sig_c = sig_c_fn(params, E) if sig_c_fn is not None else sig_tot
    Gr = mesh.gather_m(_gr_cols_mp(_assemble_A(E, H, S, sig_tot), mesh,
                                   exec_cfg), dim=-1)
    gamma = _gamma(sig_c).to(Gr.dtype)
    out = torch.matmul(Gr, torch.matmul(gamma, _rows_h(Gr, mesh)))
    return w.to(Gr.dtype)[:, None, None] * out


def _contact_cols_sharded(A, c, mesh, exec_cfg):
    """The rank's share of the solves for the nc contact columns G[:, c]
    (through _solve_cols), padded so that every rank owns the same count
    (a padding column has no unit entry and stays zero through the
    solve), and nc."""
    nc = len(c)
    m = mesh.shape["m"]
    ncl = -(-nc // m)
    targets = np.full(ncl * m, -1)
    targets[:nc] = c
    tgt = targets[mesh.coords["m"] * ncl:(mesh.coords["m"] + 1) * ncl]
    B = torch.zeros((A.shape[0], A.shape[-1], ncl), dtype=A.dtype,
                    device=A.device)
    j = np.nonzero(tgt >= 0)[0]
    B[:, torch.as_tensor(tgt[j], device=A.device),
      torch.as_tensor(j, device=A.device)] = 1.0
    return _solve_cols(A, B, exec_cfg, mesh), nc


def _point_gless_weighted_lowrank_cols(E, w, H, S, params, sig_tot_fn,
                                       sig_c_fn, c, mesh, exec_cfg):
    """The rank's columns of w * Y Gamma_cc Y^H, Y = G[:, c]: each rank
    solves its share of the contact columns, one small gather over 'm'
    gives Y, and the outer product divides over the output columns."""
    sig_tot = sig_tot_fn(params, E)
    Y, nc = _contact_cols_sharded(_assemble_A(E, H, S, sig_tot), c, mesh,
                                  exec_cfg)
    Y = mesh.gather_m(Y, dim=-1)[..., :nc]
    sig_c = sig_c_fn(params, E) if sig_c_fn is not None else sig_tot
    ci = torch.as_tensor(c, device=Y.device)
    gamma = _gamma(sig_c[..., ci[:, None], ci[None, :]]).to(Y.dtype)
    out = torch.matmul(Y, torch.matmul(gamma, _rows_h(Y, mesh)))
    return w.to(Y.dtype)[:, None, None] * out


def _point_transmission_lowrank_cols(E, H, S, params, sig_tot_fn, g1_fn,
                                     g2_fn, c1, c2, mesh, exec_cfg):
    """T(E) from the c2 contact columns of Gr split over 'm'; after one
    small gather of G12 every rank evaluates the same trace."""
    A = _assemble_A(E, H, S, sig_tot_fn(params, E))
    Y, nc2 = _contact_cols_sharded(A, c2, mesh, exec_cfg)
    i1 = torch.as_tensor(c1, device=Y.device)
    G12 = mesh.gather_m(Y[:, i1, :], dim=-1)[..., :nc2]
    return _trace_lowrank(G12, g1_fn(params, E), g2_fn(params, E), i1,
                          torch.as_tensor(c2, device=Y.device))


def _point_transmission_full_cols(E, H, S, params, sig_tot_fn, g1_fn,
                                  g2_fn, mesh, exec_cfg):
    """T(E) = Re tr(G1 Gr G2 Ga) with Gr's columns sharded and gathered:
    each rank sums the trace over its own rows, O(N^2 N/m), and a gather
    over 'm' adds the ranks' parts in 'm' order."""
    sig_tot = sig_tot_fn(params, E)
    A = _assemble_A(E, H, S, sig_tot)
    Gr = mesh.gather_m(_gr_cols_mp(A, mesh, exec_cfg), dim=-1)
    rank, wq = zl._rank_cols(A.shape[-1], mesh)
    gamma1 = _gamma(g1_fn(params, E)).to(Gr.dtype)
    gamma2 = _gamma(g2_fn(params, E)).to(Gr.dtype)
    P = torch.matmul(gamma1[..., rank * wq:(rank + 1) * wq, :], Gr)
    Q = torch.matmul(gamma2, _rows_h(Gr, mesh))
    t = torch.einsum("bij,bji->b", P, Q).real.to(torch.float64)
    return mesh.gather_m(t[:, None], dim=-1).sum(dim=-1)


# ---------------------------------------------------------------------------
# Chunk sizing
# ---------------------------------------------------------------------------

def _auto_chunk_cfg(exec_cfg: ExecutionConfig, N: int) -> ExecutionConfig:
    """Resolve energy_chunk=0: the largest power-of-two chunk whose live
    bytes (measured bytes per energy lane, per N^2, of the tier's LU
    dtype) fit the budget, clamped to [1, _CHUNK_MAX]."""
    per_n2 = (_LANE_BYTES_PER_N2_C128
              if exec_cfg.precision in ("high", "exact")
              else _LANE_BYTES_PER_N2)
    lane = per_n2 * N * N
    chunk = 1
    while (chunk * 2 <= _CHUNK_MAX
           and chunk * 2 * lane <= _CHUNK_BUDGET_BYTES):
        chunk *= 2
    return dataclasses.replace(exec_cfg, energy_chunk=chunk)


def _lane_major(n: int, chunk: int):
    """Warm-start layout of an n-point grid: (lanes, n_chunks, index) with
    index (n_chunks, lanes) and index[c, j] = j * n_chunks + c, so lane j
    owns the contiguous segment [j * n_chunks, (j + 1) * n_chunks) and
    successive chunks continue each lane's segment (the JAX package's
    _layout_lane_major).  Positions >= n are padding: they trail the last
    lanes, so chunk c's valid lanes are a prefix."""
    lanes = max(1, min(chunk, n))
    n_chunks = -(-n // lanes)
    index = (np.arange(lanes)[None, :] * n_chunks
             + np.arange(n_chunks)[:, None])
    return lanes, n_chunks, index


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class EnergyEngine:
    """Bound engine for a fixed (H, S, provider) system on one device.

    Holds H, S, the energies and Sigma on the device in the operator dtype
    of the tier -- complex64 for 'fast', complex128 for 'mixed' (whose LU
    still runs in complex64; the operator feeds its residual), 'high',
    'exact' and 'strict'; methods take host energy grids and return host
    NumPy results.  Under a ``mesh`` the device is the rank's, and every
    rank returns the same result."""

    def __init__(self, H, S, provider,
                 exec_cfg: ExecutionConfig = _DEFAULT_EXEC, mesh=None, *,
                 device=None):
        self.mesh = mesh
        self.device = resolve_device(device, mesh)
        self.provider = provider
        if exec_cfg.solver not in ("auto", "lu", "spectral"):
            raise ValueError(f"unknown solver {exec_cfg.solver!r}")
        if exec_cfg.precision not in ("fast", "mixed", "high", "exact",
                                      "strict"):
            raise ValueError(f"unknown precision {exec_cfg.precision!r}")
        self._H_host = np.asarray(H)
        self._S_host = np.asarray(S)
        N = self._H_host.shape[-1]
        # an automatic chunk is re-derived by the spectral runner: its
        # lanes hold O(N k) factors, not the LU's O(N^2)
        self._chunk_was_auto = not exec_cfg.energy_chunk
        if not exec_cfg.energy_chunk:
            exec_cfg = _auto_chunk_cfg(exec_cfg, N)
        self.exec_cfg = exec_cfg
        self.cdtype = (torch.complex64 if exec_cfg.precision == "fast"
                       else torch.complex128)
        self.H = self._to_device(self._H_host)
        self.S = self._to_device(self._S_host)
        self._pole_checked = set()     # grids already guard-checked
        self._spectral = _SPECTRAL_UNSET
        self._spectral_fb = None

    def _to_device(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.complex128),
                               device=self.device).to(self.cdtype)

    def _params(self, params):
        """Provider params (nested dicts / tuples of NumPy arrays) on the
        device."""
        return tree_map(self._to_device, params)

    def _chunks(self, E, w):
        """(E, w) chunk pairs of this rank's share of the grid
        (grid_layout),
        as device tensors; padding carries zero weight."""
        E = np.asarray(E, dtype=np.complex128).ravel()
        w = np.asarray(w, dtype=np.complex128).ravel()
        ch = self.exec_cfg.energy_chunk
        pos, pad = grid_layout(E.size, self.mesh, ch)
        E_d = self._to_device(E[pos])
        w_d = self._to_device(np.where(pad, 0.0, w[pos]))
        for i in range(0, E_d.shape[0], ch):
            yield E_d[i:i + ch], w_d[i:i + ch]

    def _map(self, point, E):
        """point(E_chunk) over this rank's chunks, gathered over 'e' and
        returned in grid order on the host as NumPy."""
        E = np.asarray(E, dtype=np.complex128).ravel()
        ch = self.exec_cfg.energy_chunk
        pos, _ = grid_layout(E.size, self.mesh, ch)
        E_d = self._to_device(E[pos])
        vals = torch.cat([point(E_d[i:i + ch])
                          for i in range(0, E_d.shape[0], ch)])
        if self.mesh is not None:
            vals = grid_unlayout(self.mesh.gather_e(vals), E.size,
                                 self.mesh, ch)
        return vals.cpu().numpy()

    def _sum(self, point, E, w, imag: bool, m: int = 1):
        """sum_k point(E_k, w_k) over this rank's chunks, accumulated in
        complex128 (float64 when only the imaginary part is wanted): an
        (N, N/m) partial sum on the device, which _finish reduces."""
        N = self.H.shape[-1]
        acc = torch.zeros((N, N // m), device=self.device,
                          dtype=torch.float64 if imag else torch.complex128)
        for Eb, wb in self._chunks(E, w):
            vals = point(Eb, wb)
            if imag:
                acc += vals.imag.sum(dim=0, dtype=torch.float64)
            else:
                acc += vals.sum(dim=0, dtype=torch.complex128)
        return acc

    def _finish(self, acc, m: int = 1):
        """A partial sum reduced once over 'e' and, from 'm' column blocks,
        gathered over 'm'; on the host as NumPy."""
        if self.mesh is not None:
            acc = self.mesh.sum_e(acc)
            if m > 1:
                acc = self.mesh.gather_m(acc, dim=-1)
        return acc.cpu().numpy()

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

    def _tight(self):
        return self.exec_cfg.precision in ("high", "exact", "strict")

    def _conv(self):
        """Keyword arguments of the provider's apply methods: on the
        high, exact and strict tiers a provider whose sigma is an iterated
        fixed point (``iterated``: Bethe, 3D lattice) is asked for it at
        TIGHT_CONV."""
        if self._tight() and getattr(self.provider, "iterated", False):
            return {"conv": TIGHT_CONV}
        return {}

    def _total(self):
        return self.provider.total_apply(**self._conv())

    def _contact(self, i):
        return self.provider.contact_apply(i, **self._conv())

    def _has_warm(self):
        return getattr(self.provider, "contacts_warm_apply", None) is not None

    def _recommends_warm(self):
        """The provider has a warm interface and recommends it
        (``warm_profitable``; Bethe and 3D lattices: yes, their fixed
        points dominate; chains: no)."""
        return self._has_warm() and bool(
            getattr(self.provider, "warm_profitable", True))

    def _use_warm(self):
        """Warm engines engage below the high tiers where the provider
        recommends its warm interface; ``warm_start="force"`` overrides
        the recommendation."""
        ws = self.exec_cfg.warm_start
        if not ws or self._tight() or not self._has_warm():
            return False
        return ws == "force" or self._recommends_warm()

    def _warm_transmission(self):
        """T(E) solves each contact once per energy through the warm
        interface where the warm engines engage, and (cold) for every
        provider that recommends it."""
        return self._use_warm() or self._recommends_warm()

    def _model_shards(self, dw_ok: bool = False) -> int:
        """The 'm' size of the column-sharded paths: 1 (replicated over
        'm') unless the mesh has more than one 'm' rank and N divides by
        it (JAX ops/greens.py:1940-1957).  The warm and continuation
        families, and the strict tier's library solve, always run
        replicated; the high tiers shard only where asked with
        ``dw_ok=True`` (gr_sum, as in the JAX package; there the
        complex128 zinv_refined_cols takes the double-word leg's
        place)."""
        if self.mesh is None:
            return 1
        m = self.mesh.shape["m"]
        cfg = self.exec_cfg
        high = cfg.precision in ("high", "exact")
        if (m == 1 or self.H.shape[-1] % m or (high and not dw_ok)
                or cfg.precision == "strict" or cfg.continuation is True
                or self._use_warm()):
            return 1
        return m

    def _warm_chunks(self, E, carry=True):
        """The sweep of a provider with a warm interface over a host grid:
        yields (positions, the same on the device, E chunk on the device,
        per-contact sigmas) chunk by chunk in lane-major order over this
        rank's contiguous segment of the grid (warm_segment), one
        fixed-point
        solve per contact and energy.  With ``carry`` each lane's
        fixed-point state continues from its previous energy; without,
        every chunk starts from the provider's initial state, which is the
        cold solve.  Padding lanes are dropped, not computed."""
        wfn, params, init = self.provider.contacts_warm_apply(**self._conv())
        p = self._params(params)
        E = np.asarray(E, dtype=np.complex128).ravel()
        lo, hi, _ = warm_segment(E.size, self.mesh,
                                 self.exec_cfg.energy_chunk)
        n = hi - lo
        lanes, n_chunks, index = _lane_major(n, self.exec_cfg.energy_chunk)
        state0 = tuple(
            torch.as_tensor(np.asarray(s0, dtype=np.complex128),
                            device=self.device)
            .expand((lanes,) + np.shape(s0)) for s0 in init)
        state = state0
        E_d = self._to_device(E)
        for c in range(n_chunks):
            pos = lo + index[c][index[c] < n]
            if pos.size == 0:
                break
            state = tuple(st[:pos.size]
                          for st in (state if carry else state0))
            pos_d = torch.as_tensor(pos, device=self.device)
            Eb = E_d[pos_d]
            sigs, state = wfn(p, Eb, state)
            yield pos, pos_d, Eb, sigs

    def _warm_sum(self, kind, E, w, contact=None, imag=False):
        """Warm-started weighted sums ('gr' / 'gless')."""
        N = self.H.shape[-1]
        acc = torch.zeros((N, N), device=self.device,
                          dtype=torch.float64 if imag else torch.complex128)
        w_d = self._to_device(np.asarray(w, dtype=np.complex128).ravel())
        for _, pos_d, Eb, sigs in self._warm_chunks(E):
            vals = _point_sum_pre(kind, Eb, w_d[pos_d], self.H, self.S,
                                  sigs, contact, self.exec_cfg)
            if imag:
                acc += vals.imag.sum(dim=0, dtype=torch.float64)
            else:
                acc += vals.sum(dim=0, dtype=torch.complex128)
        return self._finish(acc)

    def _chain_lanes(self) -> int:
        """Lanes of the chain: an explicit energy_chunk, else the
        automatic chunk capped at _CHAIN_MAX_LANES."""
        ch = self.exec_cfg.energy_chunk
        return min(ch, _CHAIN_MAX_LANES) if self._chunk_was_auto else ch

    def _chain_sum(self, E, w, imag: bool):
        """sum_k w_k G(E_k) by Newton-Schulz continuation over this rank's
        contiguous segment of the grid (the JAX package's
        _build_sum_engine_chain and _make_chain_scan), accumulated as
        _sum does: an (N, N) partial sum on the device for _finish.

        Lane-major as the warm engines lay it out (_lane_major over
        warm_segment): lane j owns a contiguous sorted segment and step c
        solves the c-th point of every lane at once; padding lanes are
        dropped and the carried X is cut to the valid prefix.  Per step,
        from each lane's previous X, ``chain_steps`` Newton iterations
        (0: 2 on 'mixed', 3 otherwise; at least 3 on 'strict') in
        complex64 ('strict': complex128).  The gate is chunk-wide: the
        step keeps the iterates when it has a seed and max_lanes(r) is
        below the tier's gate (5e-3; 3e-2 on 'mixed'), which a NaN fails;
        otherwise the whole chunk runs the tier's LU (_inv_tier).  That
        one host read per step is the step's only sync.  'mixed' and
        'strict' then polish X with one Newton step against the
        complex128 operator (_newton_step).  The chain carries X in the
        Newton dtype."""
        cfg = self.exec_cfg
        mixed, strict = cfg.precision == "mixed", cfg.precision == "strict"
        k = cfg.chain_steps or (2 if mixed else 3)
        gate = _CHAIN_GATE_MIXED if mixed else _CHAIN_GATE_FAST
        if strict:
            k = max(k, 3)
        ndt = torch.complex128 if strict else torch.complex64
        fn, params = self._total()
        p = self._params(params)
        E = np.asarray(E, dtype=np.complex128).ravel()
        w = np.asarray(w, dtype=np.complex128).ravel()
        lanes = self._chain_lanes()
        lo, hi, _ = warm_segment(E.size, self.mesh, lanes)
        _, n_chunks, index = _lane_major(hi - lo, lanes)
        E_d, w_d = self._to_device(E[lo:hi]), self._to_device(w[lo:hi])
        N = self.H.shape[-1]
        acc = torch.zeros((N, N), device=self.device,
                          dtype=torch.float64 if imag else torch.complex128)
        X_prev = None
        for c in range(n_chunks):
            pos = index[c][index[c] < hi - lo]
            if pos.size == 0:
                break
            pos_d = torch.as_tensor(pos, device=self.device)
            Eb, wb = E_d[pos_d], w_d[pos_d]
            A = _assemble_A(Eb, self.H, self.S, fn(p, Eb))
            X = None
            if X_prev is not None:
                Xn, r = _newton_chain(A.to(ndt), X_prev[:pos.size], k)
                if bool(r < gate):
                    X = Xn
            CHAIN_STEPS["lu" if X is None else "newton"] += 1
            if X is None:
                X = _inv_tier(A, cfg)
            if mixed or strict:
                X = _newton_step(A, X.to(A.dtype))
            X_prev = X.to(ndt)
            vals = wb.to(X.dtype)[:, None, None] * X
            if imag:
                acc += vals.imag.sum(dim=0, dtype=torch.float64)
            else:
                acc += vals.sum(dim=0, dtype=torch.complex128)
        return acc

    def _near_pole_guard(self, E):
        """Warn when a fast/mixed LU dispatch is asked for real-axis points
        within spectral_dist_f32 of a bare eigenvalue of the (H, S) pencil,
        where the complex64-seeded solve floors at cond * u32 above its
        accuracy contract.  Once per (engine, grid); the eigenvalues come
        from spectral_basis on the engine's device, through the cache the
        spectral route shares, so an SCF cycle pays at most one eigh per
        Fock.  Contour and broadened grids (|Im E| >= the threshold) pass
        without an eigh; complex or non-symmetric pencils are skipped."""
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
        if not cand.any():
            return
        basis = spectral_basis(self._H_host, self._S_host, self.device,
                               mesh=self.mesh)
        if basis is None:
            return
        d = np.abs(z[cand][:, None] - basis[0][None, :]).min(axis=1)
        dmin = float(d.min())
        if dmin < thresh:
            warnings.warn(
                f"LU '{cfg.precision}' tier: {int((d < thresh).sum())} grid "
                f"point(s) within {thresh:g} of a bare eigenvalue of the "
                f"(H, S) pencil (closest {dmin:.2e}); the complex64-seeded "
                f"solve floors at cond * u32 there and can exceed its "
                f"accuracy contract.  Use solver='auto'/'spectral' "
                f"(pole-deflated, in contract at any distance) or "
                f"precision='high'/'exact', or set near_pole_warn=False to "
                f"silence.", RuntimeWarning, stacklevel=4)

    def _log_dispatch(self, kind, n_energies):
        log = get_logger("engine")
        if log.isEnabledFor(logging.DEBUG):
            cfg = self.exec_cfg
            where = f"device={self.device}"
            if self.mesh is not None:
                where += (f" mesh={self.mesh.shape} rank={self.mesh.rank} "
                          f"coords={self.mesh.coords}")
            log.debug(f"{kind}: N={self.H.shape[-1]} nE={n_energies} "
                      f"chunk={cfg.energy_chunk} {where} "
                      f"precision={cfg.precision}")

    # --- routing -------------------------------------------------------
    def _spectral_runner(self):
        """The spectral route's state, built once per engine; None when the
        route does not apply.  It engages for solver 'auto'/'spectral' on
        the fast and mixed tiers, and declines (the LU route runs) for the
        high, exact and strict tiers, for continuation=True, under a mesh
        with more than one 'm' rank (the caller asked for the
        column-sharded LU, which the route would bypass), and where
        SpectralRunner finds the system unfit: no contact_inds, Sigma
        leaking outside the contact block or with an energy-dependent
        background, k > N//2, a complex or non-symmetric H."""
        cfg = self.exec_cfg
        if cfg.solver not in ("spectral", "auto") \
                or cfg.precision not in ("fast", "mixed") \
                or cfg.continuation is True:
            return None
        if self.mesh is not None and self.mesh.shape["m"] > 1:
            return None
        if self._spectral is _SPECTRAL_UNSET:
            r = SpectralRunner(self._H_host, self._S_host, self.provider,
                               cfg, self.device,
                               chunk_auto=self._chunk_was_auto,
                               mesh=self.mesh)
            self._spectral = r if r.available else None
            if self._spectral is None:
                get_logger("engine").debug(
                    "spectral route declined; the LU route serves this "
                    "engine")
        return self._spectral

    def _spectral_fallback_engine(self):
        """The exact-tier sibling that serves the spectral route's points
        within spectral_dist_lu of a bare eigenvalue (spectral_deflate=0):
        the complex128 blocked LU ('auto' panel: the swap-pivoted panel
        kernel) plus one Newton step, chunk 4 -- a handful of points per
        grid."""
        if self._spectral_fb is None:
            cfg = dataclasses.replace(
                self.exec_cfg, precision="exact", solver="lu",
                energy_chunk=4, continuation=False, lu_panel="auto")
            self._spectral_fb = EnergyEngine(
                self._H_host, self._S_host, self.provider, cfg, self.mesh,
                device=self.device)
        return self._spectral_fb

    # --- sums ----------------------------------------------------------
    def gr_sum(self, E, w, epilog=None):
        """sum_k w_k G(E_k); parity with integrate.GrInt.

        epilog='im': return Im(sum) as a real float64 array.  With the
        spectral route live the grid is split by pole distance: the
        spectral dispatch serves the bulk, the exact-tier LU the points
        it must not serve.  Each dispatch is a perf_span: gr_sum_spectral
        on the spectral route, gr_sum on the LU and warm engines."""
        self._log_dispatch("gr_sum", np.size(E))
        runner = self._spectral_runner()
        if runner is not None:
            (Eg, wg), (Eb, wb) = runner.split_grid(E, w)
            if Eg.size:
                with perf_span("gr_sum_spectral", nE=Eg.size):
                    out = runner.gr_sum(self.provider, Eg, wg, epilog=epilog)
                if Eb.size:
                    out = out + self._spectral_fallback_engine() \
                        ._gr_sum_lu(Eb, wb, epilog)
                return out
        return self._gr_sum_lu(E, w, epilog)

    def _gr_sum_lu(self, E, w, epilog=None):
        """The LU route of gr_sum (the JAX package's _gr_sum_lu): the warm
        engines where they engage, else with continuation=True below the
        high tiers the Newton-Schulz chain (span gr_sum_chain), else the
        batched LU (span gr_sum)."""
        self._near_pole_guard(E)
        warm = self._use_warm()
        if (not warm and self.exec_cfg.continuation is True
                and self.exec_cfg.precision not in ("high", "exact")):
            with perf_span("gr_sum_chain", nE=np.size(E)):
                return self._finish(self._chain_sum(E, w, epilog == "im"))
        with perf_span("gr_sum", nE=np.size(E), warm=warm):
            if warm:
                return self._warm_sum("gr", E, w, imag=epilog == "im")
            fn, params = self._total()
            p = self._params(params)
            m = self._model_shards(dw_ok=True)
            if m > 1:
                point = lambda e, ww: _point_gr_weighted_cols(
                    e, ww, self.H, self.S, p, fn, None, self.mesh,
                    self.exec_cfg)
            else:
                point = lambda e, ww: _point_gr_weighted(
                    e, ww, self.H, self.S, p, fn, None, self.exec_cfg)
            return self._finish(self._sum(point, E, w, imag=epilog == "im",
                                          m=m), m)

    def _gless_point(self, contact, m=1):
        """The G< point function (low-rank when the contact support is
        static and small) for ``contact``, with its device params; the
        'm'-sharded twin when m > 1."""
        fn, params = self._total()
        cfn = None
        if contact is not None:
            cfn, params = self._contact(contact)
        p = self._params(params)
        c = self._contact_inds(contact)
        H, S, cfg, mesh = self.H, self.S, self.exec_cfg, self.mesh
        if m > 1 and c is not None:
            return lambda e, ww: _point_gless_weighted_lowrank_cols(
                e, ww, H, S, p, fn, cfn, c, mesh, cfg)
        if m > 1:
            return lambda e, ww: _point_gless_weighted_full_cols(
                e, ww, H, S, p, fn, cfn, mesh, cfg)
        if c is not None:
            return lambda e, ww: _point_gless_weighted_lowrank(
                e, ww, H, S, p, fn, cfn, c, cfg)
        return lambda e, ww: _point_gless_weighted(
            e, ww, H, S, p, fn, cfn, cfg)

    def gless_sum(self, E, w, contact: Optional[int] = None):
        """sum_k w_k [G Gamma_i G^+](E_k); parity with integrate.GrLessInt.
        The spectral route splits the grid as gr_sum does."""
        runner = self._spectral_runner()
        if runner is not None:
            (Eg, wg), (Eb, wb) = runner.split_grid(E, w)
            if Eg.size:
                with perf_span("gless_sum_spectral", nE=Eg.size):
                    out = runner.gless_sum(self.provider, Eg, wg, contact)
                if Eb.size:
                    out = out + self._spectral_fallback_engine() \
                        ._gless_sum_lu(Eb, wb, contact)
                return out
        return self._gless_sum_lu(E, w, contact)

    def _gless_sum_lu(self, E, w, contact: Optional[int] = None):
        """The LU route of gless_sum (the JAX package's _gless_sum_lu)."""
        self._near_pole_guard(E)
        if self._use_warm():
            return self._warm_sum("gless", E, w, contact)
        m = self._model_shards()
        return self._finish(self._sum(self._gless_point(contact, m), E, w,
                                      imag=False, m=m), m)

    def density_neq_sum(self, E_eq, w_eq, E_neq, w_neq,
                        contact: Optional[int] = None):
        """Im(sum w G) over the eq grid + sum w [G Gamma G+] over the bias
        window (scale factors belong in the weights).  With the spectral
        route live that is gr_sum(eq, 'im') + gless_sum(window); on the LU
        route the two sums combine on the device into one reduction and
        one copy to the host (span density_neq); the warm engines and
        continuation=True have no fused variant and run the two sums one
        after the other."""
        if (self._spectral_runner() is not None or self._use_warm()
                or self.exec_cfg.continuation is True):
            return (self.gr_sum(E_eq, w_eq, epilog="im")
                    + self.gless_sum(E_neq, w_neq, contact))
        fn, params = self._total()
        p = self._params(params)
        m = self._model_shards()
        if m > 1:
            point_eq = lambda e, ww: _point_gr_weighted_cols(
                e, ww, self.H, self.S, p, fn, None, self.mesh, self.exec_cfg)
        else:
            point_eq = lambda e, ww: _point_gr_weighted(
                e, ww, self.H, self.S, p, fn, None, self.exec_cfg)
        with perf_span("density_neq", nE=np.size(E_eq) + np.size(E_neq)):
            out = self._sum(point_eq, E_eq, w_eq, imag=True, m=m) \
                + self._sum(self._gless_point(contact, m), E_neq, w_neq,
                            imag=False, m=m)
            return self._finish(out, m)

    def density_eq_split(self, E_real, w_real, E_contour, w_contour):
        """Im(sum w G) over the real-axis and contour grids.  With
        continuation 'contour' or True below the high tiers, off the warm
        engines, the spectral route and a column-sharded mesh (the JAX
        package's conditions), the real segment runs on the batched LU
        and the contour on the Newton-Schulz chain, reduced once (span
        density_eq_split); otherwise the two grids run as one gr_sum on
        whichever route applies."""
        cfg = self.exec_cfg
        split = (cfg.continuation in ("contour", True)
                 and cfg.precision not in ("high", "exact")
                 and not self._use_warm() and self._model_shards() == 1
                 and self._spectral_runner() is None)
        if not split:
            E = np.concatenate([np.asarray(E_real, complex),
                                np.asarray(E_contour, complex)])
            w = np.concatenate([np.asarray(w_real, complex),
                                np.asarray(w_contour, complex)])
            return self.gr_sum(E, w, epilog="im")
        fn, params = self._total()
        p = self._params(params)
        point = lambda e, ww: _point_gr_weighted(e, ww, self.H, self.S, p,
                                                 fn, None, cfg)
        with perf_span("density_eq_split",
                       nE=np.size(E_real) + np.size(E_contour)):
            acc = self._sum(point, E_real, w_real, imag=True) \
                + self._chain_sum(E_contour, w_contour, imag=True)
            return self._finish(acc)

    # --- per-energy maps -------------------------------------------------
    def transmission(self, E):
        """T(E) over the grid, float64 (n,).  The spectral route evaluates
        T in the contact subspace (O(N k^2) per point); points it must
        not serve are computed by the exact-tier LU and put back in
        place."""
        runner = self._spectral_runner()
        if runner is not None:
            E_arr = np.asarray(E, dtype=np.complex128).ravel()
            bad = runner.bad_mask(E_arr)
            if not bad.all():
                with perf_span("transmission_spectral",
                               nE=int((~bad).sum())):
                    good = runner.transmission(self.provider, E_arr[~bad])
                if good is not None:
                    vals = np.empty(E_arr.size, dtype=np.float64)
                    vals[~bad] = good
                    if bad.any():
                        vals[bad] = self._spectral_fallback_engine() \
                            ._transmission_lu(E_arr[bad])
                    return vals
        return self._transmission_lu(E)

    def _transmission_lu(self, E):
        """The LU route of transmission (the JAX package's
        _transmission_lu without its double-word engines): contact-column
        solves when both contacts have a small static support, the full G
        otherwise, each split over 'm' where _model_shards allows.  With a
        provider that has a warm interface each energy's contact sigmas
        are solved once and serve Sigma_total and both Gammas: from the
        lane's previous energy where the warm engines engage, from the
        initial state (the cold solve) where they do not.  A provider that
        does not recommend its warm interface (``warm_profitable`` False:
        chains) takes it only where the warm engines engage (``"force"``)."""
        c1 = self._contact_inds(0)
        c2 = self._contact_inds(-1)
        if self._warm_transmission():
            return self._transmission_warm(E, c1, c2)
        fn, params = self._total()
        g1, _ = self._contact(0)
        g2, _ = self._contact(-1)
        p = self._params(params)
        H, S, cfg, mesh = self.H, self.S, self.exec_cfg, self.mesh
        m = self._model_shards()
        if m > 1 and c1 is not None and c2 is not None:
            point = lambda e: _point_transmission_lowrank_cols(
                e, H, S, p, fn, g1, g2, c1, c2, mesh, cfg)
        elif m > 1:
            point = lambda e: _point_transmission_full_cols(
                e, H, S, p, fn, g1, g2, mesh, cfg)
        elif c1 is not None and c2 is not None:
            point = lambda e: _point_transmission_lowrank(
                e, H, S, p, fn, g1, g2, c1, c2, cfg)
        else:
            point = lambda e: _point_transmission(
                e, H, S, p, fn, g1, g2, cfg)
        return self._map(point, E)

    def _transmission_warm(self, E, c1, c2):
        """T(E) over this rank's warm segment, gathered over 'e'."""
        E_arr = np.asarray(E, dtype=np.complex128).ravel()
        lo, _, per = warm_segment(E_arr.size, self.mesh,
                                  self.exec_cfg.energy_chunk)
        out = torch.zeros(per, dtype=torch.float64, device=self.device)
        for _, pos_d, Eb, sigs in self._warm_chunks(
                E_arr, carry=self._use_warm()):
            args = (Eb, self.H, self.S, _sum_sigs(sigs), sigs[0], sigs[-1])
            if c1 is not None and c2 is not None:
                vals = _transmission_lowrank(*args, c1, c2, self.exec_cfg)
            else:
                vals = _transmission(*args, self.exec_cfg)
            out[pos_d - lo] = vals
        if self.mesh is not None:
            out = self.mesh.gather_e(out)
        return out[:E_arr.size].cpu().numpy()

    def map_engine(self, point_fn, fns, E):
        """Run a custom observable over the grid:
        point_fn(E_chunk, H, S, params, *fns, exec_cfg) -> (b, ...), with
        the provider's total params on the device; sharded over 'e'."""
        _, params = self._total()
        p = self._params(params)
        return self._map(lambda e: point_fn(e, self.H, self.S, p, *fns,
                                            self.exec_cfg), E)

    def gr_diag(self, E):
        """diag G(E) over the grid (DOS building block): complex (n, N)."""
        fn, _ = self._total()
        return self.map_engine(_point_gr_diag, (fn,), E)

    def dos(self, E):
        """(total_dos, per_site_dos) over the grid."""
        per_site = -np.imag(self.gr_diag(E)) / np.pi
        return per_site.sum(axis=-1), per_site


# Functional wrappers ------------------------------------------------------

def weighted_gr_sum(H, S, provider, E, w, exec_cfg=_DEFAULT_EXEC, *,
                    device=None, mesh=None):
    return EnergyEngine(H, S, provider, exec_cfg, mesh,
                        device=device).gr_sum(E, w)


def weighted_gless_sum(H, S, provider, E, w, contact=None,
                       exec_cfg=_DEFAULT_EXEC, *, device=None, mesh=None):
    return EnergyEngine(H, S, provider, exec_cfg, mesh,
                        device=device).gless_sum(E, w, contact)


def transmission_map(H, S, provider, E, exec_cfg=_DEFAULT_EXEC, *,
                     device=None, mesh=None):
    return EnergyEngine(H, S, provider, exec_cfg, mesh,
                        device=device).transmission(E)


def dos_map(H, S, provider, E, exec_cfg=_DEFAULT_EXEC, *, device=None,
            mesh=None):
    return EnergyEngine(H, S, provider, exec_cfg, mesh,
                        device=device).dos(E)


def gr_diag_map(H, S, provider, E, exec_cfg=_DEFAULT_EXEC, *, device=None,
                mesh=None):
    return EnergyEngine(H, S, provider, exec_cfg, mesh,
                        device=device).gr_diag(E)
