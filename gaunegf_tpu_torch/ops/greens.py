"""Energy-batched Green's-function engines (the throughput core).

Port of the LU route of ``gaunegf_tpu/ops/greens.py``.  Every call is

    host energy grid (NumPy) -> one copy to the device
      -> Python loop over chunks of ``energy_chunk`` energies
        -> batched blocked LU of the chunk         (ops/zlinalg.py)
        -> weighted observable per energy
      -> complex128 accumulation of the weighted sum
    -> one copy of the (N, N) sum to the host

Observables take a chunk of energies E (b,), a sum's weights and the
chunk's self-energies, and return (b, ...) stacks; ``EnergyEngine._walk``
is the one loop over a grid's chunks, and ``map_engine`` runs a custom
point function over a grid.  ``EnergyEngine.route(kind)`` decides which
of the routes below serves each method; its docstring holds the table.
Self-energy providers expose ``total_apply()`` /
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
(``EnergyEngine._chain``): along each lane's contiguous, sorted grid
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
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from gaunegf_tpu_torch.config import TIGHT_CONV, ExecutionConfig
from gaunegf_tpu_torch.models.selfenergy import sigma_spanned, tree_map
from gaunegf_tpu_torch.ops import zlinalg as zl
from gaunegf_tpu_torch.ops.spectral import SpectralRunner, pencil_eigvals
from gaunegf_tpu_torch.ops.transfer import host_bool, to_device, to_host
from gaunegf_tpu_torch.parallel.mesh import (grid_layout, grid_unlayout,
                                             warm_segment)
from gaunegf_tpu_torch.utils.logging import (get_logger, perf_count,
                                             perf_span)

__all__ = ["EnergyEngine", "Route", "resolve_device", "weighted_gr_sum",
           "weighted_gless_sum", "transmission_map", "dos_map",
           "gr_diag_map"]

_DEFAULT_EXEC = ExecutionConfig()

# The precision tiers: all of them; those whose LU factors in complex64
# (the spectral route and the near-pole guard serve them); those on the
# complex128 blocked LU; those that ask an iterated provider for
# TIGHT_CONV and stay off the warm engines; and those whose column solves
# take one refinement solve.
_TIERS = ("fast", "mixed", "high", "exact", "strict")
_FAST_TIERS = ("fast", "mixed")
_C128_TIERS = ("high", "exact")
_TIGHT_TIERS = ("high", "exact", "strict")
_REFINED_TIERS = ("mixed", "exact")

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

_SPECTRAL_UNSET = object()
_UNSET = object()


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
#
# An observable takes a chunk of energies E (b,), for a sum the chunk's
# weights w (b,), and the chunk's self-energies as a _Sigmas, and returns
# (b, ...) stacks.  The cold and the warm routes share them; each asks the
# source for a sigma at the point of its work where the route has always
# evaluated it.
# ---------------------------------------------------------------------------

class _Sigmas:
    """One chunk's self-energies: ``tot`` (Sigma_total) and ``of(i)``
    (contact i's; None: the total), each computed once, when first asked
    for.  The cold source (EnergyEngine._cold) calls the provider's
    closures; the warm one (EnergyEngine._warm) hands out the contacts'
    sigmas of one fixed-point solve and their sum."""

    def __init__(self, get):
        self._get, self._got = get, {}

    def of(self, i=None):
        if i not in self._got:
            self._got[i] = self._get(i)
        return self._got[i]

    @property
    def tot(self):
        return self.of()


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
    if exec_cfg.precision in _C128_TIERS:
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


def _gr_weighted(E, w, sig, H, S, exec_cfg):
    """w * G."""
    G = _gr_point(E, H, S, sig.tot, exec_cfg)
    return w.to(G.dtype)[:, None, None] * G


def _gless_weighted(E, w, sig, H, S, exec_cfg, contact=None):
    """w * G Gamma_c G+ from the full G (contact None: Sigma_total's
    Gamma)."""
    sig_tot, sig_c = sig.tot, sig.of(contact)
    Gr = _gr_point(E, H, S, sig_tot, exec_cfg)
    Ga = Gr.conj().transpose(-1, -2)
    gamma = _gamma(sig_c).to(Gr.dtype)
    return w.to(Gr.dtype)[:, None, None] * torch.matmul(
        torch.matmul(Gr, gamma), Ga)


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
    lu_dtype = (torch.complex128 if exec_cfg.precision in _C128_TIERS
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
    if exec_cfg.precision in _REFINED_TIERS:
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
    B[:, to_device(list(cols), A.device),
      torch.arange(len(cols), device=A.device)] = 1.0
    return _solve_cols(A, B, exec_cfg)


def _gless_lowrank(E, w, sig, H, S, exec_cfg, contact, c):
    """w * G Gamma_c G+ from contact-column solves: Y = G[:, c],
    result = w * Y Gamma_cc Y+."""
    Y = _gr_cols(E, H, S, sig.tot, c, exec_cfg)         # (b, N, nc)
    sig_c = sig.of(contact)
    ci = to_device(c, Y.device)
    gamma = _gamma(sig_c[..., ci[:, None], ci[None, :]]).to(Y.dtype)
    return w.to(Y.dtype)[:, None, None] * torch.matmul(
        torch.matmul(Y, gamma), Y.conj().transpose(-1, -2))


def _trace(G, gamma1, gamma2):
    """Re tr(Gamma1 G Gamma2 G^H) per energy, float64."""
    M1 = torch.matmul(gamma1, G)
    M2 = torch.matmul(gamma2, G.conj().transpose(-1, -2))
    return torch.einsum("bij,bji->b", M1, M2).real.to(torch.float64)


def _transmission(E, sig, H, S, exec_cfg):
    """T(E) = Re tr(Gamma1 Gr Gamma2 Ga) per energy, from the full G."""
    sig_tot, s1, s2 = sig.tot, sig.of(0), sig.of(-1)
    Gr = _gr_point(E, H, S, sig_tot, exec_cfg)
    return _trace(Gr, _gamma(s1).to(Gr.dtype), _gamma(s2).to(Gr.dtype))


def _transmission_lowrank(E, sig, H, S, exec_cfg, c1, c2):
    """T(E) from contact-column solves: T = tr(G1 Gr[c1,c2] G2 Gr[c1,c2]+)
    with the Gamma blocks restricted to their contact support.  Neglects
    the -1j*1e-9*S broadening background's contribution to Gamma
    (~1e-9 relative)."""
    sig_tot, s1, s2 = sig.tot, sig.of(0), sig.of(-1)
    X = _gr_cols(E, H, S, sig_tot, c2, exec_cfg)        # (b, N, nc2)
    i1 = to_device(c1, X.device)
    return _trace_lowrank(X[:, i1, :], s1, s2, i1, to_device(c2, X.device))


def _trace_lowrank(G12, s1, s2, i1, i2):
    """Re tr(Gamma1 G12 Gamma2 G12^H) per energy, G12 = Gr[c1, c2]
    (b, nc1, nc2), the Gammas restricted to the contact supports."""
    gamma1 = _gamma(s1[..., i1[:, None], i1[None, :]]).to(G12.dtype)
    gamma2 = _gamma(s2[..., i2[:, None], i2[None, :]]).to(G12.dtype)
    return _trace(G12, gamma1, gamma2)


def _gr_diag(E, sig, H, S, exec_cfg):
    """diag G(E) per energy (the DOS building block)."""
    G = _gr_point(E, H, S, sig.tot, exec_cfg)
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
    if p in _C128_TIERS:
        return zl.zinv_refined_cols(A, mesh, steps=int(p == "exact"),
                                    lu_dtype=torch.complex128, **kw)
    steps = exec_cfg.refine_steps if p == "mixed" else 0
    return zl.zinv_refined_cols(A, mesh, steps=steps, **kw)


def _gr_weighted_cols(E, w, sig, H, S, exec_cfg, mesh):
    X = _gr_cols_mp(_assemble_A(E, H, S, sig.tot), mesh, exec_cfg)
    return w.to(X.dtype)[:, None, None] * X


def _rows_h(G, mesh):
    """(G[rows of this 'm' rank, :])^H: the rank's columns of G^H."""
    rank, wq = zl._rank_cols(G.shape[1], mesh)
    return G[:, rank * wq:(rank + 1) * wq, :].conj().transpose(-1, -2)


def _gless_full_cols(E, w, sig, H, S, exec_cfg, contact, mesh):
    """The rank's columns of w * Gr Gamma Ga: its column block of Gr, one
    gather over 'm', then out[:, cols] = Gr (Gamma (Gr[cols, :])^H)."""
    sig_tot, sig_c = sig.tot, sig.of(contact)
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
    B[:, to_device(tgt[j], A.device), to_device(j, A.device)] = 1.0
    return _solve_cols(A, B, exec_cfg, mesh), nc


def _gless_lowrank_cols(E, w, sig, H, S, exec_cfg, contact, c, mesh):
    """The rank's columns of w * Y Gamma_cc Y^H, Y = G[:, c]: each rank
    solves its share of the contact columns, one small gather over 'm'
    gives Y, and the outer product divides over the output columns."""
    Y, nc = _contact_cols_sharded(_assemble_A(E, H, S, sig.tot), c, mesh,
                                  exec_cfg)
    Y = mesh.gather_m(Y, dim=-1)[..., :nc]
    sig_c = sig.of(contact)
    ci = to_device(c, Y.device)
    gamma = _gamma(sig_c[..., ci[:, None], ci[None, :]]).to(Y.dtype)
    out = torch.matmul(Y, torch.matmul(gamma, _rows_h(Y, mesh)))
    return w.to(Y.dtype)[:, None, None] * out


def _transmission_lowrank_cols(E, sig, H, S, exec_cfg, c1, c2, mesh):
    """T(E) from the c2 contact columns of Gr split over 'm'; after one
    small gather of G12 every rank evaluates the same trace."""
    A = _assemble_A(E, H, S, sig.tot)
    Y, nc2 = _contact_cols_sharded(A, c2, mesh, exec_cfg)
    i1 = to_device(c1, Y.device)
    G12 = mesh.gather_m(Y[:, i1, :], dim=-1)[..., :nc2]
    return _trace_lowrank(G12, sig.of(0), sig.of(-1), i1,
                          to_device(c2, Y.device))


def _transmission_full_cols(E, sig, H, S, exec_cfg, mesh):
    """T(E) = Re tr(G1 Gr G2 Ga) with Gr's columns sharded and gathered:
    each rank sums the trace over its own rows, O(N^2 N/m), and a gather
    over 'm' adds the ranks' parts in 'm' order."""
    A = _assemble_A(E, H, S, sig.tot)
    Gr = mesh.gather_m(_gr_cols_mp(A, mesh, exec_cfg), dim=-1)
    rank, wq = zl._rank_cols(A.shape[-1], mesh)
    gamma1 = _gamma(sig.of(0)).to(Gr.dtype)
    gamma2 = _gamma(sig.of(-1)).to(Gr.dtype)
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
              if exec_cfg.precision in _C128_TIERS
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

class Route(NamedTuple):
    """What serves one of EnergyEngine's methods (EnergyEngine.route): the
    route's name and, on the batched LU, the 'm' width of its
    column-sharded solves (1: replicated over 'm')."""
    name: str
    m: int = 1


_KINDS = ("gr", "gless", "density_neq", "density_eq_split", "transmission",
          "gr_diag", "map")
# the runner's method and the engine's non-spectral dispatch of each kind
# that the spectral route serves: runner.<name> and EnergyEngine._<name>_lu
_SPECTRAL_NAMES = {"gr": "gr_sum", "gless": "gless_sum",
                   "transmission": "transmission"}


class EnergyEngine:
    """Bound engine for a fixed (H, S, provider) system on one device.

    Holds H, S, the energies and Sigma on the device in the operator dtype
    of the tier -- complex64 for 'fast', complex128 for 'mixed' (whose LU
    still runs in complex64; the operator feeds its residual), 'high',
    'exact' and 'strict'; methods take host energy grids and return host
    NumPy results.  Under a ``mesh`` the device is the rank's, and every
    rank returns the same result.  ``route(kind)`` says which route serves
    each method."""

    def __init__(self, H, S, provider,
                 exec_cfg: ExecutionConfig = _DEFAULT_EXEC, mesh=None, *,
                 device=None):
        self.mesh = mesh
        self.device = resolve_device(device, mesh)
        self.provider = provider
        if exec_cfg.solver not in ("auto", "lu", "spectral"):
            raise ValueError(f"unknown solver {exec_cfg.solver!r}")
        if exec_cfg.precision not in _TIERS:
            raise ValueError(f"unknown precision {exec_cfg.precision!r}")
        with perf_span("engine.setup"):
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
        self._pole_lam = _UNSET        # the guard's eigenvalues, or None
        self._spectral = _SPECTRAL_UNSET
        self._spectral_fb = None

    def _to_device(self, x):
        return to_device(np.asarray(x, dtype=np.complex128), self.device,
                         self.cdtype)

    def _params(self, params):
        """Provider params (nested dicts / tuples of NumPy arrays) on the
        device."""
        with perf_span("engine.setup"):
            return tree_map(self._to_device, params)

    # --- the chunk loop ------------------------------------------------
    def _walk(self, E, w, visit, sigmas=None, lanes=None):
        """The engine's one chunk loop: visit(slots, E chunk, w chunk or
        None, _Sigmas or None) over this rank's share of a host grid, each
        chunk a span engine.chunk; ``slots`` index the share.

        ``lanes`` None: the replicated layout (grid_layout), copied to the
        device once, padding at zero weight, chunks of energy_chunk.
        ``lanes`` L: lane-major over this rank's contiguous segment of the
        grid (warm_segment, _lane_major), so each of L lanes walks its own
        run of the grid; each chunk's slots are copied to the device, and
        padding lanes are dropped (every chunk keeps lane 0).  ``sigmas``
        (EnergyEngine._cold, _warm) gives each chunk its _Sigmas."""
        E, w = (None if a is None else np.asarray(a, np.complex128).ravel()
                for a in (E, w))
        if lanes is None:
            ch = self.exec_cfg.energy_chunk
            pos, pad = grid_layout(E.size, self.mesh, ch)
            steps = [slice(i, i + ch) for i in range(0, pos.size, ch)]
            E, w = E[pos], None if w is None else np.where(pad, 0.0, w[pos])
        else:
            lo, hi, _ = warm_segment(E.size, self.mesh, lanes)
            _, _, index = _lane_major(hi - lo, lanes)
            steps = [row[row < hi - lo] for row in index]
            E, w = E[lo:hi], None if w is None else w[lo:hi]
        E_d = self._to_device(E)
        w_d = None if w is None else self._to_device(w)
        for at in steps:
            with perf_span("engine.chunk"):
                if lanes is not None:
                    at = to_device(at, self.device)
                Eb = E_d[at]
                visit(at, Eb, None if w_d is None else w_d[at],
                      None if sigmas is None else sigmas(Eb))

    def _sum(self, plan, E, w, imag: bool, m: int = 1):
        """The sum of the plan's observable (weighted by the grid's w)
        over this rank's chunks of the plan's layout, accumulated in
        complex128 (float64 when only the imaginary part is wanted): an
        (N, N/m) partial sum on the device, which _finish reduces."""
        obs, sigmas, lanes = plan
        N = self.H.shape[-1]
        acc = torch.zeros((N, N // m), device=self.device,
                          dtype=torch.float64 if imag else torch.complex128)

        def add(at, Eb, wb, sig):
            vals = obs(Eb, wb, sig)
            acc.add_(vals.imag.sum(dim=0, dtype=torch.float64) if imag
                     else vals.sum(dim=0, dtype=torch.complex128))
        self._walk(E, w, add, sigmas, lanes)
        return acc

    def _finish(self, acc, m: int = 1):
        """A partial sum reduced once over 'e' and, from 'm' column blocks,
        gathered over 'm'; on the host as NumPy."""
        with perf_span("engine.finish"):
            if self.mesh is not None:
                acc = self.mesh.sum_e(acc)
                if m > 1:
                    acc = self.mesh.gather_m(acc, dim=-1)
            return to_host(acc)

    def _map(self, plan, E):
        """The plan's observable per energy over this rank's chunks of the
        plan's layout, gathered over 'e' and returned in grid order on the
        host as NumPy (lane-major: float64 values, as T(E)'s)."""
        obs, sigmas, lanes = plan
        n = np.size(E)
        if lanes is None:
            vals = []
            self._walk(E, None, lambda at, Eb, _, sig: vals.append(
                obs(Eb, sig)), sigmas)
            with perf_span("engine.finish"):
                vals = torch.cat(vals)
                if self.mesh is not None:
                    vals = grid_unlayout(self.mesh.gather_e(vals), n,
                                         self.mesh, self.exec_cfg.energy_chunk)
                return to_host(vals)
        out = torch.zeros(warm_segment(n, self.mesh, lanes)[2],
                          dtype=torch.float64, device=self.device)

        def put(at, Eb, _, sig):
            out[at] = obs(Eb, sig)
        self._walk(E, None, put, sigmas, lanes)
        with perf_span("engine.finish"):
            if self.mesh is not None:
                out = self.mesh.gather_e(out)
            return to_host(out[:n])

    # --- sigma sources and observables ---------------------------------
    def _contact_inds(self, contact):
        """Static contact support for the low-rank path; None without
        use_lowrank or the provider's contact_inds, or for a support of
        more than N/2 orbitals."""
        getter = getattr(self.provider, "contact_inds", None)
        if not self.exec_cfg.use_lowrank or getter is None:
            return None
        inds = getter(contact)
        if inds is None or len(inds) > self.H.shape[-1] // 2:
            return None
        return tuple(int(i) for i in inds)

    def _conv(self):
        """Keyword arguments of the provider's apply methods: on the
        high, exact and strict tiers a provider whose sigma is an iterated
        fixed point (``iterated``: Bethe, 3D lattice) is asked for it at
        TIGHT_CONV."""
        if (self.exec_cfg.precision in _TIGHT_TIERS
                and getattr(self.provider, "iterated", False)):
            return {"conv": TIGHT_CONV}
        return {}

    def _total(self):
        fn, params = self.provider.total_apply(**self._conv())
        return sigma_spanned(fn), params

    def _contact(self, i):
        fn, params = self.provider.contact_apply(i, **self._conv())
        return sigma_spanned(fn), params

    def _cold(self, *contacts):
        """The cold sigma source, E chunk -> _Sigmas: the provider's total
        closure and those of ``contacts``, each call a span engine.sigma,
        on the total's params copied to the device once; in a chunk each
        runs at most once, when an observable first asks for it."""
        fn, params = self._total()
        fns = {None: fn, **{i: self._contact(i)[0] for i in contacts}}
        p = self._params(params)
        return lambda E: _Sigmas(lambda i: fns[i](p, E))

    def _warm(self, carry=True):
        """The warm sigma source, E chunk -> _Sigmas: the fn of
        contacts_warm_apply, each call a span engine.sigma, solves every
        contact once per energy of the chunk; the chunk's _Sigmas hand out
        the contacts' sigmas and their sum.  With ``carry`` each lane
        starts from its own state after the previous chunk (the chunk's
        lanes are a prefix of the previous chunk's); without, every chunk
        starts from the provider's initial state, which is the cold
        solve."""
        wfn, params, init = self.provider.contacts_warm_apply(**self._conv())
        wfn = sigma_spanned(wfn)
        p = self._params(params)
        with perf_span("engine.setup"):
            init = [to_device(np.asarray(s0, dtype=np.complex128),
                              self.device) for s0 in init]
        state = None

        def chunk(E):
            nonlocal state
            b = E.shape[0]
            st = (tuple(s[:b] for s in state) if carry and state is not None
                  else tuple(s0.expand((b,) + s0.shape) for s0 in init))
            sigs, state = wfn(p, E, st)
            # the total: the contacts' sigmas added in contact order
            return _Sigmas(lambda i: sum(sigs[1:], sigs[0]) if i is None
                           else sigs[i % len(sigs)])
        return chunk

    def _chain_lanes(self) -> int:
        """Lanes of the chain: an explicit energy_chunk, else the
        automatic chunk capped at _CHAIN_MAX_LANES."""
        ch = self.exec_cfg.energy_chunk
        return min(ch, _CHAIN_MAX_LANES) if self._chunk_was_auto else ch

    def _chain(self):
        """The observable of the Newton-Schulz continuation (the JAX
        package's _build_sum_engine_chain and _make_chain_scan), w * G, on
        the chain's lane-major layout (_walk with _chain_lanes lanes):
        lane j owns a contiguous sorted segment and step c solves the c-th
        point of every lane at once; padding lanes are dropped and the
        carried X is cut to the valid prefix.  Per step, from each lane's
        previous X, ``chain_steps`` Newton iterations (0: 2 on 'mixed', 3
        otherwise; at least 3 on 'strict') in complex64 ('strict':
        complex128).  The gate is chunk-wide: the step keeps the iterates
        when it has a seed and max_lanes(r) is below the tier's gate
        (5e-3; 3e-2 on 'mixed'), which a NaN fails; otherwise the whole
        chunk runs the tier's LU (_inv_tier).  That one host read per step
        is the step's only sync.  'mixed' and 'strict' then polish X with
        one Newton step against the complex128 operator (_newton_step).
        The chain carries X in the Newton dtype."""
        cfg = self.exec_cfg
        mixed, strict = cfg.precision == "mixed", cfg.precision == "strict"
        k = cfg.chain_steps or (2 if mixed else 3)
        gate = _CHAIN_GATE_MIXED if mixed else _CHAIN_GATE_FAST
        if strict:
            k = max(k, 3)
        ndt = torch.complex128 if strict else torch.complex64
        X_prev = None

        def observe(E, w, sig):
            nonlocal X_prev
            A = _assemble_A(E, self.H, self.S, sig.tot)
            X = None
            if X_prev is not None:
                Xn, r = _newton_chain(A.to(ndt), X_prev[:E.shape[0]], k)
                if host_bool(r < gate):
                    X = Xn
            perf_count("chain.lu" if X is None else "chain.newton")
            if X is None:
                X = _inv_tier(A, cfg)
            if mixed or strict:
                X = _newton_step(A, X.to(A.dtype))
            X_prev = X.to(ndt)
            return w.to(X.dtype)[:, None, None] * X
        return observe

    def _plan(self, kind, route, contact=None):
        """(observable, sigma source, lanes) of 'gr', 'gless' or
        'transmission' on ``route`` ('warm', 'cold', 'chain' or 'lu' with
        its m), for _sum and _map; the provider's closures are taken and
        its params copied here.  The LU takes the contact-column
        observables where the contacts (G<: the contact) have a small
        static support (_contact_inds), and their 'm'-sharded twins where
        m > 1; the warm engines' G< takes the full G, as the JAX
        package's does."""
        if route.name == "chain":
            return self._chain(), self._cold(), self._chain_lanes()
        kw = {"H": self.H, "S": self.S, "exec_cfg": self.exec_cfg}
        sharded = route.m > 1
        if sharded:
            kw["mesh"] = self.mesh
        warm = route.name in ("warm", "cold")
        lanes = self.exec_cfg.energy_chunk if warm else None
        if kind == "gr":
            src = self._warm() if warm else self._cold()
            return (partial(_gr_weighted_cols if sharded else _gr_weighted,
                            **kw), src, lanes)
        if kind == "gless":
            if warm:
                return (partial(_gless_weighted, contact=contact, **kw),
                        self._warm(), lanes)
            src = self._cold(*(() if contact is None else (contact,)))
            c = self._contact_inds(contact)
            if c is None:
                core = _gless_full_cols if sharded else _gless_weighted
            else:
                core = _gless_lowrank_cols if sharded else _gless_lowrank
                kw["c"] = c
            return partial(core, contact=contact, **kw), src, lanes
        c1, c2 = self._contact_inds(0), self._contact_inds(-1)
        src = self._warm(route.name == "warm") if warm else self._cold(0, -1)
        if c1 is None or c2 is None:
            core = _transmission_full_cols if sharded else _transmission
        else:
            core = (_transmission_lowrank_cols if sharded
                    else _transmission_lowrank)
            kw.update(c1=c1, c2=c2)
        return partial(core, **kw), src, lanes

    # --- the near-pole guard -------------------------------------------
    def _near_pole_guard(self, E):
        """Warn when a fast/mixed LU dispatch is asked for real-axis points
        within spectral_dist_f32 of a bare eigenvalue of the (H, S) pencil,
        where the complex64-seeded solve floors at cond * u32 above its
        accuracy contract.  Once per (engine, grid).  The first grid with
        real-axis points computes the pencil's float64 eigenvalues on the
        engine's device, values only (pencil_eigvals: from the engine's
        complex128 H and S, or on the fast tier from one copy of the host
        arrays as they are; under a mesh each rank computes its own), and
        the engine keeps them for every later grid (counters
        guard.eigvals, guard.reuse).  Contour and broadened grids
        (|Im E| >= the threshold) compute nothing; complex, non-symmetric
        or indefinite pencils are skipped.  Unlike the JAX guard it
        neither digests the pencil nor fills spectral_basis's cache.  The
        whole check is the span engine.pole_guard."""
        with perf_span("engine.pole_guard"):
            self._check_near_pole(E)

    def _check_near_pole(self, E):
        cfg = self.exec_cfg
        if cfg.precision not in _FAST_TIERS or not cfg.near_pole_warn:
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
        if self._pole_lam is _UNSET:
            perf_count("guard.eigvals")
            H, S = self.H, self.S
            if self.cdtype != torch.complex128:
                H = to_device(self._H_host, self.device)
                S = to_device(self._S_host, self.device)
            self._pole_lam = pencil_eigvals(H, S)
        else:
            perf_count("guard.reuse")
        lam = self._pole_lam
        if lam is None:
            return
        d = np.abs(z[cand][:, None] - lam[None, :]).min(axis=1)
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
                f"silence.", RuntimeWarning, stacklevel=5)

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
    def route(self, kind: str, spectral: bool = True) -> Route:
        """The route that serves ``kind`` on this engine: 'gr' (gr_sum),
        'gless' (gless_sum), 'density_neq' (density_neq_sum),
        'density_eq_split', 'transmission', 'gr_diag' or 'map'
        (map_engine).  The one place that reads the solver, the precision
        tier, continuation, warm_start, the provider's warm interface and
        the mesh's 'm' size to choose a route; every method dispatches on
        it.  The table, first row that applies:

        ================ =========== ======================================
        kind             route       where
        ================ =========== ======================================
        gr               spectral    SP
                         warm        W
                         chain       continuation is True, the tier not
                                     'high' or 'exact'
                         lu, m       otherwise, m = M
        gless            spectral    SP
                         warm        W
                         lu, m       otherwise (never the chain), m = M
        density_neq      gr+gless    SP, W or continuation is True:
                                     gr_sum(eq, 'im') + gless_sum(window),
                                     each on its own route
                         lu, m       otherwise: the fused sum, m = M
        density_eq_split lu+chain    continuation 'contour' or True, the
                                     tier not 'high' or 'exact', not W,
                                     M = 1 and not SP: the real axis on the
                                     batched LU, the contour on the chain
                         route('gr') otherwise: one gr_sum of both grids
        transmission     spectral    SP
                         warm        W: the warm interface, each lane's
                                     state carried along the grid
                         cold        the provider recommends its warm
                                     interface: the same, every chunk from
                                     the initial state
                         lu, m       otherwise, m = M
        gr_diag, map     lu, 1       always
        ================ =========== ======================================

        SP, the spectral route: solver 'auto' or 'spectral', the tier
        'fast' or 'mixed', continuation not True, at most one 'm' rank,
        and SpectralRunner accepts the system (_spectral_runner).  Its
        points within spectral_dist_lu of a bare eigenvalue
        (spectral_deflate=0) run on the exact-tier fallback engine; a grid
        it declines whole (every point such, or T(E) with a contact
        outside its support) runs ``route(kind, spectral=False)``, the
        table without SP.

        W, the warm engines: warm_start set, the tier below the tight
        ones ('high', 'exact', 'strict'), the provider has
        contacts_warm_apply, and warm_start is "force" or the provider
        recommends it (warm_profitable, default True).

        M, the 'm' width: the mesh's 'm' size where it is above 1 and
        divides N, the tier is not 'strict' (nor 'high' or 'exact' but for
        'gr', where zinv_refined_cols serves them), continuation is not
        True and not W; else 1 (JAX ops/greens.py:1940-1957)."""
        cfg = self.exec_cfg
        if kind not in _KINDS:
            raise ValueError(f"unknown kind {kind!r}")
        if kind in ("gr_diag", "map"):
            return Route("lu")
        m = 1 if self.mesh is None else self.mesh.shape["m"]
        sp = (spectral and cfg.solver in ("auto", "spectral")
              and cfg.precision in _FAST_TIERS
              and cfg.continuation is not True and m == 1
              and self._spectral_runner() is not None)
        has_warm = getattr(self.provider, "contacts_warm_apply",
                           None) is not None
        recommends = has_warm and bool(
            getattr(self.provider, "warm_profitable", True))
        warm = (bool(cfg.warm_start) and cfg.precision not in _TIGHT_TIERS
                and has_warm and (cfg.warm_start == "force" or recommends))
        if (self.H.shape[-1] % m or cfg.precision == "strict"
                or (cfg.precision in _C128_TIERS and kind != "gr")
                or cfg.continuation is True or warm):
            m = 1
        if kind == "density_eq_split":
            if (cfg.continuation in ("contour", True)
                    and cfg.precision not in _C128_TIERS and not warm
                    and m == 1 and not sp):
                return Route("lu+chain")
            return self.route("gr", spectral)
        if kind == "density_neq":
            return (Route("gr+gless") if sp or warm
                    or cfg.continuation is True else Route("lu", m))
        if sp:
            return Route("spectral")
        if warm:
            return Route("warm")
        if kind == "transmission" and recommends:
            return Route("cold")
        if (kind == "gr" and cfg.continuation is True
                and cfg.precision not in _C128_TIERS):
            return Route("chain")
        return Route("lu", m)

    def _spectral_runner(self):
        """The spectral route's state, built once per engine: a
        SpectralRunner, or None where it finds the system unfit (no
        contact_inds, Sigma leaking outside the contact block or with an
        energy-dependent background, k > N//2, a complex or non-symmetric
        H).  route() asks for it where the configuration allows the
        route."""
        if self._spectral is _SPECTRAL_UNSET:
            with perf_span("engine.setup"):
                r = SpectralRunner(self._H_host, self._S_host,
                                   self.provider, self.exec_cfg, self.device,
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

    def _spectral_split(self, kind, E, w=None, *args):
        """The spectral dispatch of 'gr', 'gless' or 'transmission' where
        route(kind) is 'spectral', else None.  The runner serves the grid
        but for its bad_mask points, which the fallback engine's non-
        spectral dispatch serves; the sums add the two parts, T(E) puts
        them in place.  The runner's part is the span <name>_spectral.
        None too where the runner declines the grid whole (every point
        bad, or T(E) with a contact outside its support): the caller then
        runs route(kind, spectral=False) on the whole grid.  ``args``
        follow the grid to both dispatches (epilog, contact)."""
        if self.route(kind).name != "spectral":
            return None
        runner = self._spectral_runner()
        name = _SPECTRAL_NAMES[kind]
        grid = [np.asarray(a, dtype=np.complex128).ravel()
                for a in ((E,) if w is None else (E, w))]
        bad = runner.bad_mask(grid[0])
        if bad.all():
            return None
        part = lambda sel: [a[sel] for a in grid]
        with perf_span(f"{name}_spectral", nE=int((~bad).sum())):
            out = getattr(runner, name)(self.provider, *part(~bad), *args)
        if out is None or not bad.any():
            return out
        low = getattr(self._spectral_fallback_engine(),
                      f"_{name}_lu")(*part(bad), *args)
        if w is not None:
            return out + low
        vals = np.empty(bad.size, dtype=np.float64)
        vals[~bad], vals[bad] = out, low
        return vals

    # --- sums ----------------------------------------------------------
    def gr_sum(self, E, w, epilog=None):
        """sum_k w_k G(E_k) on route('gr'); parity with integrate.GrInt.

        epilog='im': return Im(sum) as a real float64 array.  Each
        dispatch is a perf_span: gr_sum_spectral on the spectral route,
        gr_sum_chain on the chain, gr_sum on the LU and warm engines."""
        self._log_dispatch("gr_sum", np.size(E))
        out = self._spectral_split("gr", E, w, epilog)
        return self._gr_sum_lu(E, w, epilog) if out is None else out

    def _gr_sum_lu(self, E, w, epilog=None):
        """gr_sum on route('gr', spectral=False), after the near-pole
        guard (the JAX package's _gr_sum_lu)."""
        self._near_pole_guard(E)
        route = self.route("gr", spectral=False)
        span = (perf_span("gr_sum_chain", nE=np.size(E))
                if route.name == "chain" else
                perf_span("gr_sum", nE=np.size(E), warm=route.name == "warm"))
        with span:
            return self._finish(self._sum(self._plan("gr", route), E, w,
                                          epilog == "im", route.m), route.m)

    def gless_sum(self, E, w, contact: Optional[int] = None):
        """sum_k w_k [G Gamma_i G^+](E_k) on route('gless'); parity with
        integrate.GrLessInt.  The spectral route splits the grid as
        gr_sum does."""
        out = self._spectral_split("gless", E, w, contact)
        return self._gless_sum_lu(E, w, contact) if out is None else out

    def _gless_sum_lu(self, E, w, contact: Optional[int] = None):
        """gless_sum on route('gless', spectral=False), after the
        near-pole guard (the JAX package's _gless_sum_lu)."""
        self._near_pole_guard(E)
        route = self.route("gless", spectral=False)
        return self._finish(self._sum(self._plan("gless", route, contact),
                                      E, w, False, route.m), route.m)

    def density_neq_sum(self, E_eq, w_eq, E_neq, w_neq,
                        contact: Optional[int] = None):
        """Im(sum w G) over the eq grid + sum w [G Gamma G+] over the bias
        window (scale factors belong in the weights), on
        route('density_neq'): on the fused LU the two sums combine on the
        device into one reduction and one copy to the host (span
        density_neq); otherwise gr_sum(eq, 'im') + gless_sum(window), one
        after the other."""
        route = self.route("density_neq")
        if route.name == "gr+gless":
            return (self.gr_sum(E_eq, w_eq, epilog="im")
                    + self.gless_sum(E_neq, w_neq, contact))
        eq = self._plan("gr", route)
        with perf_span("density_neq", nE=np.size(E_eq) + np.size(E_neq)):
            out = self._sum(eq, E_eq, w_eq, True, route.m) \
                + self._sum(self._plan("gless", route, contact), E_neq,
                            w_neq, False, route.m)
            return self._finish(out, route.m)

    def density_eq_split(self, E_real, w_real, E_contour, w_contour):
        """Im(sum w G) over the real-axis and contour grids, on
        route('density_eq_split'): 'lu+chain' runs the real segment on
        the batched LU and the contour on the Newton-Schulz chain, reduced
        once (span density_eq_split); otherwise the two grids run as one
        gr_sum."""
        if self.route("density_eq_split").name != "lu+chain":
            E = np.concatenate([np.asarray(E_real, complex),
                                np.asarray(E_contour, complex)])
            w = np.concatenate([np.asarray(w_real, complex),
                                np.asarray(w_contour, complex)])
            return self.gr_sum(E, w, epilog="im")
        real = self._plan("gr", Route("lu"))
        with perf_span("density_eq_split",
                       nE=np.size(E_real) + np.size(E_contour)):
            acc = self._sum(real, E_real, w_real, True) \
                + self._sum(self._plan("gr", Route("chain")), E_contour,
                            w_contour, True)
            return self._finish(acc)

    # --- per-energy maps -------------------------------------------------
    def transmission(self, E):
        """T(E) over the grid, float64 (n,), on route('transmission').
        The spectral route evaluates T in the contact subspace (O(N k^2)
        per point); points it must not serve are computed by the
        exact-tier LU and put back in place."""
        out = self._spectral_split("transmission", E)
        return self._transmission_lu(E) if out is None else out

    def _transmission_lu(self, E):
        """T(E) on route('transmission', spectral=False) (the JAX
        package's _transmission_lu without its double-word engines):
        contact-column solves when both contacts have a small static
        support, the full G otherwise, each split over 'm' where the route
        says; on the warm interface each energy's contact sigmas are
        solved once and serve Sigma_total and both Gammas."""
        route = self.route("transmission", spectral=False)
        return self._map(self._plan("transmission", route), E)

    def map_engine(self, point_fn, fns, E):
        """Run a custom observable over the grid:
        point_fn(E_chunk, H, S, params, *fns, exec_cfg) -> (b, ...), with
        the provider's total params on the device; sharded over 'e'."""
        _, params = self._total()
        p = self._params(params)
        return self._map((lambda e, _: point_fn(e, self.H, self.S, p, *fns,
                                                self.exec_cfg), None, None), E)

    def gr_diag(self, E):
        """diag G(E) over the grid (DOS building block): complex (n, N),
        on route('gr_diag'), the replicated LU map."""
        return self._map((partial(_gr_diag, H=self.H, S=self.S,
                                  exec_cfg=self.exec_cfg), self._cold(),
                          None), E)

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
