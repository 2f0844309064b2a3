"""au_bethe1000: a disordered chain between two 3-atom Au(111) contact
triangles on Bethe-lattice electrodes (``Au.bethe``, orthogonal), N = 1000
orbitals.  ``au_bethe1000.json`` beside this file holds its sizes.

The junction: triangles of side d = 2.88 A with 9 orbitals an atom
carrying the lattice's onsite block, the chain's sites 1.8 A apart below
the left triangle and 2.2 A from each triangle's plane, the chain's level
``chain_offset_eV`` above the lattice's s level, its hopping
``chain_hopping_eV``, the chain's ends coupled to the triangles' s
orbitals by ``contact_coupling_eV``, a Hubbard U on the chain only.
"""

from __future__ import annotations

import os

import numpy as np

from negfbench.reference import bethe as rb
from negfbench.reference import negf as rn

HERE = os.path.dirname(os.path.abspath(__file__))
DIM = 9


def inputs(spec, seed):
    n_chain = int(spec["n_chain"])
    d = spec["bond_A"]
    u1 = np.array([1.0, 0.0, 0.0]) * d
    u2 = np.array([0.5, np.sqrt(3) / 2, 0.0]) * d
    left = [np.zeros(3), u1, u2]
    chain = [np.array([0.8, 0.5, -2.2 - 1.8 * k]) for k in range(n_chain)]
    right = [c + np.array([0, 0, chain[-1][2] - 2.2]) for c in left]
    coords = np.stack(left + chain + right)
    n_atoms = len(coords)
    metal = set(range(1, 4)) | set(range(n_atoms - 2, n_atoms + 1))
    orb_atoms = np.asarray([a for a in range(1, n_atoms + 1)
                            for _ in range(DIM if a in metal else 1)])
    N = len(orb_atoms)
    params = rb.read_params(os.path.join(HERE, spec["lattice_file"]))
    eps = params["onsite"]["s"] + spec["chain_offset_eV"]
    rng = np.random.default_rng([int(seed), 0])
    H = np.zeros((N, N))
    i0, i1 = 3 * DIM, 3 * DIM + n_chain - 1
    for a in list(range(0, i0, DIM)) + list(range(i1 + 1, N, DIM)):
        H[a:a + DIM, a:a + DIM] = rb.onsite_block(params)
    idx = np.arange(i0, i1 + 1)
    H[idx, idx] = eps + spec["disorder_eV"] * rng.standard_normal(n_chain)
    H[idx[:-1], idx[1:]] = H[idx[1:], idx[:-1]] = spec["chain_hopping_eV"]
    t = spec["contact_coupling_eV"]
    for a in range(0, i0, DIM):
        H[a, i0] = H[i0, a] = t
    for a in range(i1 + 1, N, DIM):
        H[a, i1] = H[i1, a] = t
    U = np.zeros(N)
    U[idx] = spec["U_eV"]
    return {"H0": H, "S": np.eye(N), "U": U, "n0": np.zeros(N),
            "n_electrons": float(n_chain), "coords": coords,
            "orb_atoms": orb_atoms, "params": params, "eps": eps,
            "contacts": [[1, 2, 3], [n_atoms - 2, n_atoms - 1, n_atoms]]}


def program(spec, inp, *, device, name, exec_cfg):
    """The program's NEGFE on this junction, Bethe contacts set."""
    from gaunegf_tpu_torch.models.bethe import BetheGeometry
    from gaunegf_tpu_torch.models.fock import TightBindingFock
    from gaunegf_tpu_torch.scfe import NEGFE
    backend = TightBindingFock(inp["H0"], n_electrons=inp["n_electrons"],
                               U=inp["U"], n0=inp["n0"],
                               coords=inp["coords"], locs=inp["orb_atoms"])
    negfe = NEGFE(backend, name=name, exec_cfg=exec_cfg, device=device,
                  verbose=False)
    negfe.setContactBethe(
        inp["contacts"], lat_file=os.path.join(HERE, spec["lattice_file"]),
        eta=spec["eta_eV"], T=spec["temperature_K"],
        geometry=BetheGeometry(inp["coords"], inp["orb_atoms"], None),
        fermi=spec["lattice_fermi_eV"])
    return negfe


def band_center(spec, inp):
    """The chain's level, inside the lattice's s band."""
    return inp["eps"]


class Reference:
    """The junction worked out again: the Bethe contacts from the copied
    parameters (each lattice shifted to its contact's potential ``mu``),
    the mean-field Fock rebuild and the aufbau start."""

    def __init__(self, spec, inp, device, mu):
        self.inp = inp
        self.S = inp["S"]
        self.F0 = inp["H0"]
        self.contacts = rb.BetheContacts(
            inp["params"], inp["coords"], inp["orb_atoms"], inp["contacts"],
            inp["S"], spec["eta_eV"],
            [m - spec["lattice_fermi_eV"] for m in mu], device)
        self.window_support = None

    def sigmas(self, E_all):
        return self.contacts.table(E_all)

    def total_at(self, e):
        return self.contacts.total_at(e)

    def P0(self, dtype=np.float64):
        return rn.aufbau_density(self.F0, self.S, self.inp["n_electrons"],
                                 dtype)

    def fock(self, P, dtype=np.float64):
        return rn.mean_field_fock(self.inp["H0"], self.inp["U"],
                                  self.inp["n0"], self.S, P, dtype)


def reference(spec, inp, *, device, mu):
    return Reference(spec, inp, device, mu)
