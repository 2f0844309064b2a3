"""Transport analysis: transmission, DOS, Landauer current.

Port of ``gaunegf_tpu/transport.py``: SigmaSource over static arrays or
energy-dependent providers (spin-expanded where the matrices are 2N x 2N
and the sigmas N x N), the T(E) and DOS sweeps with the npz checkpoint
resume, the Landauer current, the single-energy probes and the legacy
API, for the four spin layouts.  Every batch of remaining energies runs
through ``ops/greens.EnergyEngine`` on the device, and checkpoints are
written per batch.  'u', 'ro' and 'g' return the four spin-block channels
of T(E) and the up/down DOS beside the totals; 'g' is solved in block
layout (a fixed permutation of the spinor-interleaved one) and its
per-site results are returned in the original ordering.

Every function takes an explicit ``device``.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from gaunegf_tpu_torch import spin as spinmod
from gaunegf_tpu_torch.config import (
    ENERGY_STEP, N_KT, TEMPERATURE, ExecutionConfig)
from gaunegf_tpu_torch.models.selfenergy import _host_eval
from gaunegf_tpu_torch.ops.greens import EnergyEngine, _gamma, _gr_point
from gaunegf_tpu_torch.units import EOVERH, KB

__all__ = [
    "SigmaSource", "calculate_transmission", "calculate_dos",
    "calculate_current", "transmission_single_energy", "dos_single_energy",
    "current", "currentSpin", "currentE", "currentF", "cohTrans",
    "cohTransSpin", "DOS", "cohTransE", "cohTransSpinE", "DOSE",
]

_DEFAULT_EXEC = ExecutionConfig()
_SPIN_LAYOUTS = ("u", "ro", "g")


def _check_spin(spin) -> str:
    spin = spin or "r"
    if spin != "r" and spin not in _SPIN_LAYOUTS:
        raise ValueError(f"unknown spin {spin!r}")
    return spin


# ---------------------------------------------------------------------------
# Static-array provider + unified sigma source (SigmaCalculator parity)
# ---------------------------------------------------------------------------

class _StaticSigma:
    """Provider over two constant self-energy matrices."""

    def __init__(self, sig1, sig2):
        def to_mat(s):
            s = np.asarray(s)
            return np.diag(s) if s.ndim == 1 else s
        self._sigs = np.stack([to_mat(sig1), to_mat(sig2)]).astype(complex)

    def params(self):
        return {"sigs": self._sigs}

    def total_apply(self):
        return _static_total, self.params()

    def contact_apply(self, i):
        return _static_contact(i % 2), self.params()

    REL_SUPPORT_TOL = 1e-6      # relative Gamma row cutoff (see below)

    def contact_inds(self, i=None):
        """Support of Gamma_i for the low-rank contact fast path.

        A row belongs to the support when its Gamma row-max exceeds
        ``REL_SUPPORT_TOL`` (1e-6) of the global peak -- above the
        formSigma ``-1j*1e-9*S`` broadening background for any physical
        coupling scale.  Rows below the cutoff are truncated from the
        low-rank solve; their relative contribution to T(E) is bounded by
        the same 1e-6.  Returns None (dense path) for an empty Gamma or
        when the support exceeds half the orbitals (no low-rank win); set
        ``ExecutionConfig(use_lowrank=False)`` to force dense exactly."""
        sigs = self._sigs if i is None else self._sigs[i % 2:i % 2 + 1]
        gam = np.abs(1j * (sigs - np.conj(np.swapaxes(sigs, -1, -2))))
        rowmax = gam.max(axis=(0, 2))
        peak = rowmax.max()
        if peak == 0:
            return None
        support = np.where(rowmax > self.REL_SUPPORT_TOL * peak)[0]
        if len(support) > len(rowmax) // 2:
            return None
        return tuple(int(j) for j in support)

    def num_contacts(self):
        return 2


def _static_total(params, E):
    return params["sigs"][0] + params["sigs"][1]


@lru_cache(maxsize=None)
def _static_contact(i: int):
    def fn(params, E):
        return params["sigs"][i]
    return fn


class SigmaSource:
    """Unified interface over static arrays and energy-dependent providers.

    Parity with transport.SigmaCalculator (transport.py:40-146), including
    auto-detection of energy dependence (duck-typing on .sigma/.sigmaTot
    or the native total_apply protocol) and spin expansion when the device
    matrices are 2N x 2N but the sigmas are N x N."""

    def __init__(self, sig1, sig2=None, energy_dependent: Optional[bool] = None):
        self.raw1, self.raw2 = sig1, sig2
        if energy_dependent is None:
            energy_dependent = hasattr(sig1, "total_apply") or (
                hasattr(sig1, "sigma") and hasattr(sig1, "sigmaTot"))
        self.energy_dependent = bool(energy_dependent)
        if self.energy_dependent:
            if sig2 is not None:
                raise ValueError("For energy-dependent calculations, provide "
                                 "only the provider as sig1")
            self.provider = sig1
        else:
            if sig2 is None:
                raise ValueError("For energy-independent calculations, "
                                 "provide both sig1 and sig2")
            self.provider = _StaticSigma(sig1, sig2)

    def provider_for(self, spin: str, matrix_size: int):
        """The provider whose sigmas act at the full matrix size."""
        spin = _check_spin(spin)
        base = self.provider
        if spin in _SPIN_LAYOUTS and matrix_size == 2 * _sigma_size(
                base, matrix_size):
            return _ExpandedProvider(base, spin)
        return base

    # reference-compatible helpers (one energy, complex128 NumPy, computed
    # on ``device``) -------------------------------------------------------
    def get_sigma_total(self, E, spin=None, matrix_size=None, *, device):
        fn, params = self.provider_for(spin, matrix_size or 0).total_apply()
        return _host_eval(fn, params, E, device)

    def get_sigma(self, E, contact_index, spin=None, matrix_size=None, *,
                  device):
        prov = self.provider_for(spin, matrix_size or 0)
        fn, params = prov.contact_apply(contact_index)
        return _host_eval(fn, params, E, device)

    def get_gamma(self, E, contact_index, spin=None, matrix_size=None, *,
                  device):
        s = self.get_sigma(E, contact_index, spin, matrix_size,
                           device=device)
        return 1j * (s - np.conj(s).T)


def _sigma_size(base, default):
    """Orbital count the provider's sigmas act on: a static provider's
    matrix size, else the provider's Fock size, else ``default``."""
    if isinstance(base, _StaticSigma):
        return base.params()["sigs"].shape[-1]
    if hasattr(base, "F"):
        return np.asarray(base.F).shape[0]
    return default


def _mapped_inds(base, i, mapping):
    """mapping(inds) of the base provider's contact support, sorted, or
    None where the base has none."""
    getter = getattr(base, "contact_inds", None)
    inds = None if getter is None else getter(i)
    if inds is None:
        return None
    return tuple(int(j) for j in np.sort(mapping(np.asarray(inds, dtype=int))))


class _WrappedProvider:
    """A provider whose sigmas are those of ``base`` passed through
    ``_wrap`` (stable fn ids).  Keyword arguments (the ``conv`` that the
    engines pass to an ``iterated`` base on the high tiers) go through to
    the base."""

    base = None

    @property
    def iterated(self):
        return getattr(self.base, "iterated", False)

    def _wrap(self, fn):
        raise NotImplementedError

    def params(self):
        return self.base.params()

    def total_apply(self, **kw):
        fn, params = self.base.total_apply(**kw)
        return self._wrap(fn), params

    def contact_apply(self, i, **kw):
        fn, params = self.base.contact_apply(i, **kw)
        return self._wrap(fn), params

    def num_contacts(self):
        return self.base.num_contacts()


class _ExpandedProvider(_WrappedProvider):
    """Wraps a provider with the spin kron-expansion."""

    def __init__(self, base, spin: str):
        self.base = base
        self.spin = spin

    def _wrap(self, fn):
        return spinmod.wrap_expand_fn(fn, self.spin)

    def contact_inds(self, i=None):
        if self.spin == "g":                # spinor interleave
            return _mapped_inds(self.base, i, lambda c: np.concatenate(
                [2 * c, 2 * c + 1]))
        nF = _sigma_size(self.base, None)
        return _mapped_inds(self.base, i, lambda c: np.concatenate(
            [c, c + nF]))


class _PermutedProvider(_WrappedProvider):
    """Wraps a provider of spinor-interleaved sigmas with the spinor ->
    block permutation."""

    def __init__(self, base, n_orb):
        self.base = base
        self.n_orb = n_orb

    def _wrap(self, fn):
        return spinmod.wrap_permute_fn(fn, self.n_orb)

    def contact_inds(self, i=None):
        inv = np.argsort(spinmod.spinor_block_perm(self.n_orb))
        return _mapped_inds(self.base, i, lambda c: inv[c])


def _prep_spin(F, S, sigma_source, spin):
    """Host matrices and provider for the layout: 'g' is permuted from
    spinor-interleaved to block layout so the block kernels apply."""
    F = np.asarray(F)
    S = np.asarray(S)
    matrix_size = F.shape[0]
    prov = sigma_source.provider_for(spin, matrix_size)
    if spin == "g":
        perm = spinmod.spinor_block_perm(matrix_size // 2)
        ix = np.ix_(perm, perm)
        F = F[ix]
        S = S[ix]
        prov = _PermutedProvider(prov, matrix_size // 2)
    return F, S, prov


# ---------------------------------------------------------------------------
# Spin-resolved transmission point function
# ---------------------------------------------------------------------------

def _point_transmission_spin(E, H, S, params, sig_tot_fn, g1_fn, g2_fn,
                             exec_cfg):
    """4-channel spin-block transmission (transport.py:159-181 pattern) of
    a batch of energies: (b, 4) float64, channels uu, ud, du, dd.  Channel
    (r, c) is Re tr(Gamma1[r, r] Gr[r, c] Gamma2[c, c] Ga[r, c]) with
    Ga = Gr^+ taken before the blocks are cut, as the reference does."""
    Gr = _gr_point(E, H, S, sig_tot_fn(params, E), exec_cfg)
    Ga = Gr.conj().transpose(-1, -2)
    g1 = _gamma(g1_fn(params, E)).to(Gr.dtype)
    g2 = _gamma(g2_fn(params, E)).to(Gr.dtype)
    N = H.shape[-1] // 2
    up, dn = slice(None, N), slice(N, None)
    blocks = ((up, up), (up, dn), (dn, up), (dn, dn))
    T = [torch.einsum("bij,bji->b",
                      torch.matmul(g1[..., r, r], Gr[:, r, c]),
                      torch.matmul(g2[..., c, c], Ga[:, r, c])).real
         for r, c in blocks]
    return torch.stack(T, dim=-1).to(torch.float64)


# ---------------------------------------------------------------------------
# Checkpointed sweeps
# ---------------------------------------------------------------------------

def _load_or_init(checkpoint_file, energy_list, keys_shapes, mesh=None):
    """-1-placeholder checkpoint init/load (transport.py:421-449 scheme).
    Under a mesh rank 0 reads the file and every rank gets what it read,
    so that every rank sweeps the same remaining energies."""
    if mesh is not None and checkpoint_file:
        state = (_load_or_init(checkpoint_file, energy_list, keys_shapes)
                 if mesh.rank == 0 else None)
        return mesh.share(state)
    fresh = {k: -1 * np.ones(s) for k, s in keys_shapes.items()}
    if checkpoint_file and os.path.exists(checkpoint_file):
        data = np.load(checkpoint_file, allow_pickle=True)
        if ("energy_list" in data
                and data["energy_list"].shape == np.shape(energy_list)
                and np.allclose(data["energy_list"], energy_list, rtol=1e-10)):
            return {k: data[k] if k in data else fresh[k]
                    for k in keys_shapes}
        print("Warning: energy_list in checkpoint doesn't match. "
              "Starting fresh.")
    return fresh


def _save(checkpoint_file, energy_list, arrays, mesh=None):
    """Write the checkpoint (under a mesh, rank 0 writes it: every rank
    holds the same arrays)."""
    if checkpoint_file and (mesh is None or mesh.rank == 0):
        np.savez(checkpoint_file, energy_list=energy_list, **arrays)


def _batched_sweep(remaining, batch):
    """Yield index batches of remaining energies."""
    for i in range(0, len(remaining), batch):
        yield remaining[i:i + batch]


def _sweep(F, S, sigma_source, energy_list, spin, checkpoint_file,
           checkpoint_interval, exec_cfg, device, mesh, shapes, key, fill):
    """Fill the -1 placeholders of state[key] batch by batch with
    fill(engine, E, idx, state), saving the checkpoint after each batch.
    The engine holds the layout's matrices and provider (_prep_spin)."""
    state = _load_or_init(checkpoint_file, energy_list, shapes, mesh)
    remaining = np.where(state[key] == -1)[0]
    if len(remaining):
        Fx, Sx, prov = _prep_spin(F, S, sigma_source, spin)
        eng = EnergyEngine(Fx, Sx, prov, exec_cfg, mesh, device=device)
        batch = max(checkpoint_interval, eng.exec_cfg.energy_chunk) \
            if checkpoint_file else len(remaining)
        for idx in _batched_sweep(remaining, batch):
            fill(eng, energy_list[idx], idx, state)
            _save(checkpoint_file, energy_list, state, mesh)
    _save(checkpoint_file, energy_list, state, mesh)
    if checkpoint_file and mesh is not None:
        mesh.barrier()                  # the file is in place on return
    return state


def calculate_transmission(F, S, sigma_source, energy_list, spin=None,
                           checkpoint_file=None, checkpoint_interval=10,
                           exec_cfg=_DEFAULT_EXEC, *, device, mesh=None):
    """T(E) sweep with -1-placeholder checkpointing.

    Returns transmission (n,) for 'r', or (transmission, spin_transmission
    (n, 4)) for 'u'/'ro'/'g' -- matching transport.calculate_transmission.
    The spin channels come from the full G of the LU route (a custom
    observable of the engine), the restricted T(E) from whichever route
    the engine takes."""
    spin = _check_spin(spin)
    energy_list = np.asarray(energy_list, dtype=float)
    n = len(energy_list)
    is_spin = spin in _SPIN_LAYOUTS
    shapes = {"transmission": (n,)}
    if is_spin:
        shapes["spin_transmission"] = (n, 4)

    def fill(eng, E, idx, state):
        if not is_spin:
            state["transmission"][idx] = eng.transmission(E)
            return
        fns = (eng._total()[0], eng._contact(0)[0], eng._contact(-1)[0])
        out = eng.map_engine(_point_transmission_spin, fns, E)
        state["spin_transmission"][idx] = out
        state["transmission"][idx] = out.sum(axis=-1)

    state = _sweep(F, S, sigma_source, energy_list, spin, checkpoint_file,
                   checkpoint_interval, exec_cfg, device, mesh, shapes,
                   "transmission", fill)
    if is_spin:
        return state["transmission"], state["spin_transmission"]
    return state["transmission"]


def calculate_dos(F, S, sigma_source, energy_list, spin=None,
                  checkpoint_file=None, checkpoint_interval=10,
                  exec_cfg=_DEFAULT_EXEC, *, device, mesh=None):
    """DOS sweep with checkpointing (transport.py:486-607 parity).

    Returns (dos_total (n,), dos_per_site (n, N)[, dos_spin (n, 2)]) with
    dos_per_site in the *original* orbital ordering (for 'g' the spinor
    interleaving is restored after the block-form solve)."""
    spin = _check_spin(spin)
    energy_list = np.asarray(energy_list, dtype=float)
    n = len(energy_list)
    n_sites = np.asarray(F).shape[0]
    is_spin = spin in _SPIN_LAYOUTS
    shapes = {"dos_total": (n,), "dos_per_site": (n, n_sites)}
    if is_spin:
        shapes["dos_spin"] = (n, 2)
    if spin == "g":
        inv_perm = np.argsort(spinmod.spinor_block_perm(n_sites // 2))

    def fill(eng, E, idx, state):
        per_site = -np.imag(eng.gr_diag(E)) / np.pi   # block layout for 'g'
        if spin == "g":
            per_site = per_site[:, inv_perm]
        state["dos_per_site"][idx] = per_site
        state["dos_total"][idx] = per_site.sum(axis=-1)
        if is_spin:
            up, dn = _split_spin(per_site, spin)
            state["dos_spin"][idx] = np.stack(
                [up.sum(axis=-1), dn.sum(axis=-1)], axis=-1)

    state = _sweep(F, S, sigma_source, energy_list, spin, checkpoint_file,
                   checkpoint_interval, exec_cfg, device, mesh, shapes,
                   "dos_total", fill)
    if is_spin:
        return state["dos_total"], state["dos_per_site"], state["dos_spin"]
    return state["dos_total"], state["dos_per_site"]


def _split_spin(per_site, spin):
    """(up, down) halves of per-site values (..., 2N) in the original
    ordering: even/odd spinor components for 'g', the two blocks else."""
    if spin == "g":
        return per_site[..., 0::2], per_site[..., 1::2]
    n2 = per_site.shape[-1] // 2
    return per_site[..., :n2], per_site[..., n2:]


def transmission_single_energy(E, F, S, sigma_source, spin=None,
                               exec_cfg=_DEFAULT_EXEC, *, device, mesh=None):
    """Single-point T(E) (reference transport.py:193-273 contract),
    through the batched sweep: a float for 'r'; (total, [T_uu, T_ud, T_du,
    T_dd]) for 'u'/'ro'/'g'."""
    res = calculate_transmission(F, S, sigma_source, [float(E)], spin=spin,
                                 exec_cfg=exec_cfg, device=device, mesh=mesh)
    if not isinstance(res, tuple):
        return float(np.asarray(res)[0])
    tot, tspin = res
    return float(tot[0]), [float(x) for x in np.asarray(tspin)[0]]


def dos_single_energy(E, F, S, sigma_source, spin=None,
                      exec_cfg=_DEFAULT_EXEC, *, device, mesh=None):
    """Single-point DOS (reference transport.py:274-375 contract).

    'r' -> (total_dos, dos_per_site); 'u'/'ro'/'g' -> (total_dos,
    dos_per_site, dos_up_per_site, dos_down_per_site), with dos_per_site
    in the original orbital ordering (up/down are the even/odd spinor
    components for 'g')."""
    spin = _check_spin(spin)
    res = calculate_dos(F, S, sigma_source, [float(E)], spin=spin,
                        exec_cfg=exec_cfg, device=device, mesh=mesh)
    per = np.asarray(res[1])[0]
    if spin == "r":
        return float(res[0][0]), per
    up, dn = _split_spin(per, spin)
    return float(res[0][0]), per, up, dn


def calculate_current(F, S, sigma_source, fermi, qV, T=TEMPERATURE,
                      spin=None, dE=ENERGY_STEP, exec_cfg=_DEFAULT_EXEC, *,
                      device, mesh=None, **kwargs):
    """Landauer current at bias qV (transport.py:610-720 parity).

    Grid conventions match the reference exactly: muL = fermi - qV/2,
    muR = fermi + qV/2, np.arange grid with dE sign following qV, +/-
    N_KT*kT spread at finite T, trapezoid integration, x2 spin factor for
    restricted spin.  Returns a float for 'r', (total, [I_uu, I_ud, I_du,
    I_dd]) for 'u'/'ro'/'g'."""
    spin = _check_spin(spin)
    if fermi is None or qV is None:
        raise ValueError("fermi and qV must be provided for current "
                         "calculations")
    if np.allclose(0, qV):
        return 0.0 if spin == "r" else (0.0, [0.0, 0.0, 0.0, 0.0])
    dE = -abs(dE) if qV < 0 else abs(dE)
    muL = fermi - qV / 2
    muR = fermi + qV / 2
    if T == 0:
        E = np.arange(muL, muR, dE)
    else:
        spread = np.sign(dE) * N_KT * KB * T
        E = np.arange(muL - spread, muR + spread, dE)
    if len(E) == 0:
        raise ValueError("No energies in integration window. Check fermi, "
                         "qV, and dE.")
    res = calculate_transmission(F, S, sigma_source, E, spin=spin,
                                 exec_cfg=exec_cfg, device=device, mesh=mesh,
                                 **kwargs)
    if T == 0:
        df = np.ones_like(E)
    else:
        df = np.abs(1 / (np.exp((E - muR) / (KB * T)) + 1)
                    - 1 / (np.exp((E - muL) / (KB * T)) + 1))
    if isinstance(res, tuple):
        Tspin = np.asarray(res[1])
        I_spin = [EOVERH * np.trapezoid(Tspin[:, i] * df, E)
                  for i in range(4)]
        return float(sum(I_spin)), I_spin
    return float(2 * EOVERH * np.trapezoid(np.asarray(res) * df, E))


# ---------------------------------------------------------------------------
# Legacy API (transport.py:723-1107); ``device`` goes in the keywords
# ---------------------------------------------------------------------------

def current(F, S, sig1, sig2, fermi, qV, T=TEMPERATURE, spin="r",
            dE=ENERGY_STEP, **kw):
    return calculate_current(F, S, SigmaSource(sig1, sig2, False),
                             fermi=fermi, qV=qV, T=T, spin=spin, dE=dE, **kw)


def currentSpin(F, S, sig1, sig2, fermi, qV, T=TEMPERATURE, spin="r",
                dE=ENERGY_STEP, **kw):
    res = calculate_current(F, S, SigmaSource(sig1, sig2, False),
                            fermi=fermi, qV=qV, T=T, spin=spin, dE=dE, **kw)
    if isinstance(res, tuple):
        return res[1]
    return [0, 0, 0, 0]


def currentE(F, S, g, fermi, qV, T=TEMPERATURE, spin="r", dE=ENERGY_STEP,
             **kw):
    return calculate_current(F, S, SigmaSource(g, energy_dependent=True),
                             fermi=fermi, qV=qV, T=T, spin=spin, dE=dE, **kw)


def currentF(fn, dE=ENERGY_STEP, T=TEMPERATURE, **kw):
    """Current from a saved SCF .mat file (transport.py:847-875)."""
    import scipy.io as sio
    m = sio.loadmat(fn)
    return current(m["F"], m["S"], m["sig1"], m["sig2"], m["fermi"][0, 0],
                   m["qV"][0, 0], T, str(m["spin"][0]), dE=dE, **kw)


def cohTrans(Elist, F, S, sig1, sig2, **kw):
    T = calculate_transmission(F, S, SigmaSource(sig1, sig2, False),
                               Elist, spin="r", **kw)
    for E, t in zip(Elist, T):
        print("Energy:", E, "eV, Transmission=", t)
    return list(T)


def cohTransSpin(Elist, F, S, sig1, sig2, spin="u", **kw):
    res = calculate_transmission(F, S, SigmaSource(sig1, sig2, False),
                                 Elist, spin=spin, **kw)
    if isinstance(res, tuple):
        return list(res[0]), res[1]
    return list(res), np.zeros((len(Elist), 4))


def DOS(Elist, F, S, sig1, sig2, **kw):
    d, site = calculate_dos(F, S, SigmaSource(sig1, sig2, False), Elist,
                            spin="r", **kw)
    return list(d), site


def cohTransE(Elist, F, S, g, **kw):
    T = calculate_transmission(F, S, SigmaSource(g, energy_dependent=True),
                               Elist, spin="r", **kw)
    return list(T)


def cohTransSpinE(Elist, F, S, g, spin="u", **kw):
    res = calculate_transmission(F, S, SigmaSource(g, energy_dependent=True),
                                 Elist, spin=spin, **kw)
    if isinstance(res, tuple):
        return res
    return res, np.zeros((len(Elist), 4))


def DOSE(Elist, F, S, g, **kw):
    d, site = calculate_dos(F, S, SigmaSource(g, energy_dependent=True),
                            Elist, spin="r", **kw)
    return list(d), site
