"""Transport analysis: transmission, DOS, Landauer current.

Port of ``gaunegf_tpu/transport.py`` for restricted spin ('r'):
SigmaSource over static arrays or energy-dependent providers, the T(E)
and DOS sweeps with the npz checkpoint resume, the Landauer current, the
single-energy probes and the legacy API.  Every batch of remaining
energies runs through ``ops/greens.EnergyEngine`` (per-chunk batched
blocked LU on the device), and checkpoints are written per batch.

Every function takes an explicit ``device``.  The spin layouts 'u', 'ro'
and 'g' raise NotImplementedError until spin.py is ported.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional

import numpy as np

from gaunegf_tpu_torch.config import (
    ENERGY_STEP, N_KT, TEMPERATURE, ExecutionConfig)
from gaunegf_tpu_torch.models.selfenergy import _host_eval
from gaunegf_tpu_torch.ops.greens import EnergyEngine
from gaunegf_tpu_torch.units import EOVERH, KB

__all__ = [
    "SigmaSource", "calculate_transmission", "calculate_dos",
    "calculate_current", "transmission_single_energy", "dos_single_energy",
    "current", "currentE", "currentF", "cohTrans", "DOS", "cohTransE",
    "DOSE",
]

_DEFAULT_EXEC = ExecutionConfig()


def _check_spin(spin) -> str:
    spin = spin or "r"
    if spin in ("u", "ro", "g"):
        raise NotImplementedError(
            f"spin={spin!r} is not ported yet (ROADMAP section 1, item 9: "
            "spin.py); this package runs spin='r'")
    if spin != "r":
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
    or the native total_apply protocol)."""

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
        _check_spin(spin)
        return self.provider

    # reference-compatible helpers (host, complex128) ---------------------
    def get_sigma_total(self, E, spin=None, matrix_size=None):
        fn, params = self.provider_for(spin, matrix_size or 0).total_apply()
        return _host_eval(fn, params, E)

    def get_sigma(self, E, contact_index, spin=None, matrix_size=None):
        prov = self.provider_for(spin, matrix_size or 0)
        fn, params = prov.contact_apply(contact_index)
        return _host_eval(fn, params, E)

    def get_gamma(self, E, contact_index, spin=None, matrix_size=None):
        s = self.get_sigma(E, contact_index, spin, matrix_size)
        return 1j * (s - np.conj(s).T)


# ---------------------------------------------------------------------------
# Checkpointed sweeps
# ---------------------------------------------------------------------------

def _load_or_init(checkpoint_file, energy_list, keys_shapes):
    """-1-placeholder checkpoint init/load (transport.py:421-449 scheme)."""
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


def _save(checkpoint_file, energy_list, arrays):
    if checkpoint_file:
        np.savez(checkpoint_file, energy_list=energy_list, **arrays)


def _batched_sweep(remaining, batch):
    """Yield index batches of remaining energies."""
    for i in range(0, len(remaining), batch):
        yield remaining[i:i + batch]


def _sweep(F, S, sigma_source, energy_list, spin, checkpoint_file,
           checkpoint_interval, exec_cfg, device, shapes, key, fill):
    """Fill the -1 placeholders of state[key] batch by batch with
    fill(engine, E, idx, state), saving the checkpoint after each batch."""
    _check_spin(spin)
    state = _load_or_init(checkpoint_file, energy_list, shapes)
    remaining = np.where(state[key] == -1)[0]
    if len(remaining):
        prov = sigma_source.provider_for(spin, np.asarray(F).shape[0])
        eng = EnergyEngine(np.asarray(F), np.asarray(S), prov, exec_cfg,
                           device=device)
        batch = max(checkpoint_interval, eng.exec_cfg.energy_chunk) \
            if checkpoint_file else len(remaining)
        for idx in _batched_sweep(remaining, batch):
            fill(eng, energy_list[idx], idx, state)
            _save(checkpoint_file, energy_list, state)
    _save(checkpoint_file, energy_list, state)
    return state


def calculate_transmission(F, S, sigma_source, energy_list, spin=None,
                           checkpoint_file=None, checkpoint_interval=10,
                           exec_cfg=_DEFAULT_EXEC, *, device):
    """T(E) sweep with -1-placeholder checkpointing; returns (n,)."""
    energy_list = np.asarray(energy_list, dtype=float)

    def fill(eng, E, idx, state):
        state["transmission"][idx] = eng.transmission(E)

    state = _sweep(F, S, sigma_source, energy_list, spin, checkpoint_file,
                   checkpoint_interval, exec_cfg, device,
                   {"transmission": (len(energy_list),)}, "transmission",
                   fill)
    return state["transmission"]


def calculate_dos(F, S, sigma_source, energy_list, spin=None,
                  checkpoint_file=None, checkpoint_interval=10,
                  exec_cfg=_DEFAULT_EXEC, *, device):
    """DOS sweep with checkpointing (transport.py:486-607 parity).
    Returns (dos_total (n,), dos_per_site (n, N))."""
    energy_list = np.asarray(energy_list, dtype=float)
    n = len(energy_list)

    def fill(eng, E, idx, state):
        per_site = -np.imag(eng.gr_diag(E)) / np.pi
        state["dos_per_site"][idx] = per_site
        state["dos_total"][idx] = per_site.sum(axis=-1)

    state = _sweep(F, S, sigma_source, energy_list, spin, checkpoint_file,
                   checkpoint_interval, exec_cfg, device,
                   {"dos_total": (n,),
                    "dos_per_site": (n, np.asarray(F).shape[0])},
                   "dos_total", fill)
    return state["dos_total"], state["dos_per_site"]


def transmission_single_energy(E, F, S, sigma_source, spin=None,
                               exec_cfg=_DEFAULT_EXEC, *, device):
    """Single-point T(E) (reference transport.py:193-273 contract): a
    float, through the batched sweep."""
    res = calculate_transmission(F, S, sigma_source, [float(E)], spin=spin,
                                 exec_cfg=exec_cfg, device=device)
    return float(np.asarray(res)[0])


def dos_single_energy(E, F, S, sigma_source, spin=None,
                      exec_cfg=_DEFAULT_EXEC, *, device):
    """Single-point DOS (reference transport.py:274-375 contract):
    (total_dos, dos_per_site)."""
    tot, per_site = calculate_dos(F, S, sigma_source, [float(E)], spin=spin,
                                  exec_cfg=exec_cfg, device=device)
    return float(tot[0]), np.asarray(per_site)[0]


def calculate_current(F, S, sigma_source, fermi, qV, T=TEMPERATURE,
                      spin=None, dE=ENERGY_STEP, exec_cfg=_DEFAULT_EXEC, *,
                      device, **kwargs):
    """Landauer current at bias qV (transport.py:610-720 parity).

    Grid conventions match the reference exactly: muL = fermi - qV/2,
    muR = fermi + qV/2, np.arange grid with dE sign following qV, +/-
    N_KT*kT spread at finite T, trapezoid integration, x2 spin factor for
    restricted spin."""
    _check_spin(spin)
    if fermi is None or qV is None:
        raise ValueError("fermi and qV must be provided for current "
                         "calculations")
    if np.allclose(0, qV):
        return 0.0
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
    Ttot = np.asarray(calculate_transmission(
        F, S, sigma_source, E, spin=spin, exec_cfg=exec_cfg, device=device,
        **kwargs))
    if T == 0:
        df = np.ones_like(E)
    else:
        df = np.abs(1 / (np.exp((E - muR) / (KB * T)) + 1)
                    - 1 / (np.exp((E - muL) / (KB * T)) + 1))
    return float(2 * EOVERH * np.trapezoid(Ttot * df, E))


# ---------------------------------------------------------------------------
# Legacy API (transport.py:723-1107); ``device`` goes in the keywords
# ---------------------------------------------------------------------------

def current(F, S, sig1, sig2, fermi, qV, T=TEMPERATURE, spin="r",
            dE=ENERGY_STEP, **kw):
    return calculate_current(F, S, SigmaSource(sig1, sig2, False),
                             fermi=fermi, qV=qV, T=T, spin=spin, dE=dE, **kw)


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


def DOS(Elist, F, S, sig1, sig2, **kw):
    d, site = calculate_dos(F, S, SigmaSource(sig1, sig2, False), Elist,
                            spin="r", **kw)
    return list(d), site


def cohTransE(Elist, F, S, g, **kw):
    T = calculate_transmission(F, S, SigmaSource(g, energy_dependent=True),
                               Elist, spin="r", **kw)
    return list(T)


def DOSE(Elist, F, S, g, **kw):
    d, site = calculate_dos(F, S, SigmaSource(g, energy_dependent=True),
                            Elist, spin="r", **kw)
    return list(d), site
