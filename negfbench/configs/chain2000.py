"""chain2000: a disordered tight-binding chain with a Hubbard mean field
between constant (wide-band) contacts, as the README's quick start builds
it, at n = 2000.  ``chain2000.json`` beside this file holds its sizes.

inputs() makes the junction from the seed; program() hands it to the
program; reference() works out its Fock rebuild, starting density and
self-energies again (plain NumPy and PyTorch, nothing of the program).
"""

from __future__ import annotations

import numpy as np
import torch

from negfbench.reference import negf as rn


def inputs(spec, seed):
    n = int(spec["n"])
    rng = np.random.default_rng([int(seed), 0])
    H0 = spec["hopping_eV"] * (np.eye(n, k=1) + np.eye(n, k=-1)) \
        + np.diag(spec["disorder_eV"] * rng.standard_normal(n))
    return {"H0": H0, "S": np.eye(n), "U": np.full(n, spec["U_eV"]),
            "n0": np.full(n, spec["n0"]),
            "n_electrons": float(spec["n_electrons"]),
            "contacts": [list(c) for c in spec["contacts"]]}


def program(spec, inp, *, device, name, exec_cfg):
    """The program's NEGFE on this junction, contacts set."""
    from gaunegf_tpu_torch.models.fock import TightBindingFock
    from gaunegf_tpu_torch.scfe import NEGFE
    backend = TightBindingFock(inp["H0"], n_electrons=inp["n_electrons"],
                               U=spec["U_eV"], n0=inp["n0"])
    negfe = NEGFE(backend, name=name, exec_cfg=exec_cfg, device=device,
                  verbose=False)
    negfe.setSigma(*inp["contacts"], sig=1j * spec["sigma_imag_eV"],
                   T=spec["temperature_K"])
    return negfe


def band_center(spec, inp):
    return 0.0


class Reference:
    """The junction worked out again: constant contact self-energies (the
    contact value on each contact's sites over a -1e-9j S background),
    the mean-field Fock rebuild and the aufbau start."""

    def __init__(self, spec, inp, device, mu):
        self.spec, self.inp, self.device = spec, inp, device
        n = inp["H0"].shape[0]
        self.S = inp["S"]
        self.F0 = inp["H0"]
        sigs = []
        for atoms in inp["contacts"]:
            s = spec["background_imag"] * 1j * np.asarray(self.S, complex)
            idx = np.asarray(atoms) - 1
            s[idx, idx] = 1j * spec["sigma_imag_eV"]
            sigs.append(s)
        self._sigs = sigs
        self._dev = [torch.as_tensor(s, device=device) for s in sigs]
        # the window's Gamma on the contacts' union support, as the
        # spectral route takes it
        self.window_support = np.sort(np.concatenate(
            [np.asarray(a) - 1 for a in inp["contacts"]]))
        self.n = n

    def sigmas(self, E_all):
        def fn(Eb):
            return [s.expand(len(Eb), self.n, self.n) for s in self._dev]
        return fn

    def total_at(self, e):
        return sum(self._sigs)

    def P0(self, dtype=np.float64):
        return rn.aufbau_density(self.F0, self.S, self.inp["n_electrons"],
                                 dtype)

    def fock(self, P, dtype=np.float64):
        return rn.mean_field_fock(self.inp["H0"], self.inp["U"],
                                  self.inp["n0"], self.S, P, dtype)


def reference(spec, inp, *, device, mu):
    return Reference(spec, inp, device, mu)
