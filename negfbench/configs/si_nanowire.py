"""si_nanowire: a hydrogen-free, sp3-passivated [100] Si nanowire of six
periods between two semi-infinite leads of the same wire, in Vogl's sp3s*
tight binding.  ``si_nanowire.json`` beside this file holds its constants.

The wire: diamond Si (lattice constant a), the atoms with
0 <= x, y < width * a, periodic along z with period a; atoms with fewer
than two neighbours are removed until none is left, so a 2a x 2a wire
keeps 30 atoms (150 orbitals) a period.  Each atom carries s, px, py, pz,
s*; nearest neighbours couple by Slater-Koster two-centre integrals from
Vogl's combined hoppings; each bond an atom lacks adds the sp3-hybrid
shift of Lee et al. to its on-site block.  The junction is ``periods``
periods; the two central ones carry seeded on-site disorder; every energy
is shifted so that the lead's mid-gap is 0 eV.  The leads continue the
clean wire on both sides: periods 1 and 6 are the contact cells, 2 and 5
the cells next to them (setContact1D's tau cells).
"""

from __future__ import annotations

import numpy as np

from negfbench.reference import decimation as rd
from negfbench.reference import negf as rn

ORB = 5                         # s, px, py, pz, s*
# the four bonds of an atom of the first sublattice, in units of a/4;
# the second sublattice's are their opposites
BONDS = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]])
FCC = np.array([[0, 0, 0], [0, 2, 2], [2, 0, 2], [2, 2, 0]])


def two_centre(spec):
    """Slater-Koster two-centre integrals (eV) from Vogl's combined
    hoppings (V_ss = 4 Vss_sigma, V_sp = (4 / sqrt 3) Vsp_sigma,
    V_xx = (4 / 3)(Vpp_sigma + 2 Vpp_pi), V_xy = (4 / 3)(Vpp_sigma -
    Vpp_pi)), solved for the integrals."""
    v = spec["vogl_eV"]
    r3 = np.sqrt(3.0)
    return {"ss": v["ss"] / 4, "ss*": v["ss*"] / 4, "s*s*": v["s*s*"] / 4,
            "sp": r3 * v["sp"] / 4, "s*p": r3 * v["s*p"] / 4,
            "pps": (v["xx"] + 2 * v["xy"]) / 4,
            "ppp": (v["xx"] - v["xy"]) / 4}


def onsite(spec):
    e = spec["onsite_eV"]
    return np.diag([e["s"], e["p"], e["p"], e["p"], e["s*"]])


def bond_block(tc, d):
    """The 5 x 5 hopping block <orbital of atom i| H |orbital of atom j>
    for the bond from i to j along d (any length): E_{s,x} = l Vsp_sigma,
    E_{x,s} = -l Vsp_sigma, E_{x,y} = l m (Vpp_sigma - Vpp_pi)
    + delta_xy Vpp_pi; s* as s with Vs*p_sigma."""
    u = np.asarray(d, dtype=float) / np.linalg.norm(d)
    h = np.zeros((ORB, ORB))
    h[0, 0] = tc["ss"]
    h[4, 4] = tc["s*s*"]
    h[0, 4] = h[4, 0] = tc["ss*"]
    h[0, 1:4] = u * tc["sp"]
    h[1:4, 0] = -u * tc["sp"]
    h[4, 1:4] = u * tc["s*p"]
    h[1:4, 4] = -u * tc["s*p"]
    h[1:4, 1:4] = np.outer(u, u) * (tc["pps"] - tc["ppp"]) \
        + np.eye(3) * tc["ppp"]
    return h


def hybrid(d):
    """The sp3 hybrid pointing along d: (1/2) s + (sqrt(3)/2) d.p."""
    u = np.asarray(d, dtype=float) / np.linalg.norm(d)
    return np.concatenate([[0.5], np.sqrt(3.0) / 2 * u, [0.0]])


def passivation(delta, missing):
    """The on-site shift of an atom that lacks the bonds ``missing``:
    delta |h_d><h_d| summed over them."""
    out = np.zeros((ORB, ORB))
    for d in missing:
        h = hybrid(d)
        out += delta * np.outer(h, h)
    return out


def bulk_hamiltonian(spec, k):
    """The 10 x 10 bulk sp3s* Hamiltonian at the wave vector k (in
    units of 2 pi / a): the atom at 0, its partner at a/4 (1, 1, 1)."""
    tc = two_centre(spec)
    ab = np.zeros((ORB, ORB), dtype=complex)
    for d in BONDS:
        ab += bond_block(tc, d) * np.exp(2j * np.pi * np.dot(k, d) / 4)
    H = np.zeros((2 * ORB, 2 * ORB), dtype=complex)
    H[:ORB, :ORB] = H[ORB:, ORB:] = onsite(spec)
    H[:ORB, ORB:] = ab
    H[ORB:, :ORB] = ab.conj().T
    return H


def _bonds_of(p):
    """The four bond vectors (a/4 units) of the atom at integer p."""
    return BONDS if p[0] % 2 == 0 else -BONDS


def wire_period(width):
    """(positions (m, 3) in units of a/4, one period of z in [0, 4)) of
    the [100] wire of width x width cells, with atoms of fewer than two
    neighbours removed until none is left; sorted by (z, x, y)."""
    side = 4 * width
    pts = [tuple(c + s + np.array([4 * i, 4 * j, 0]))
           for i in range(width) for j in range(width)
           for c in FCC for s in (np.zeros(3, int), np.ones(3, int))]
    atoms = {p for p in pts if 0 <= p[0] < side and 0 <= p[1] < side}

    def wrap(q):
        return (q[0], q[1], q[2] % 4)
    while True:
        few = {p for p in atoms
               if sum(wrap(np.add(p, d)) in atoms for d in _bonds_of(p)) < 2}
        if not few:
            break
        atoms -= few
    return np.array(sorted(atoms, key=lambda p: (p[2], p[0], p[1])))


def wire_blocks(spec, width):
    """(h00, h01, positions, bonds a period, missing bonds an atom) of
    the infinite wire: h00 the period's block with the passivation, h01
    the coupling of a period (rows) to the next one along +z (columns)."""
    pos = wire_period(width)
    index = {tuple(p): i for i, p in enumerate(pos)}
    m = len(pos)
    tc = two_centre(spec)
    h00 = np.zeros((m * ORB, m * ORB))
    h01 = np.zeros((m * ORB, m * ORB))
    delta = spec["passivation_eV"]
    nbonds, missing = np.zeros(m, int), []
    for i, p in enumerate(pos):
        s = slice(i * ORB, (i + 1) * ORB)
        lack = []
        for d in _bonds_of(p):
            q = np.add(p, d)
            j = index.get((q[0], q[1], q[2] % 4))
            if j is None:
                lack.append(d)
                continue
            nbonds[i] += 1
            blk = bond_block(tc, d)
            t = slice(j * ORB, (j + 1) * ORB)
            if 0 <= q[2] < 4:
                h00[s, t] += blk
            elif q[2] >= 4:
                h01[s, t] += blk
        h00[s, s] += onsite(spec) + passivation(delta, lack)
        missing.append(lack)
    return h00, h01, pos, nbonds, missing


def lead_bands(h00, h01, nk):
    """Eigenvalues (nk, n) of h00 + h01 e^{ik} + h01^T e^{-ik}, k in
    [0, pi]."""
    ks = np.linspace(0.0, np.pi, nk)
    return np.stack([np.linalg.eigvalsh(h00 + h01 * np.exp(1j * k)
                                        + h01.T * np.exp(-1j * k))
                     for k in ks])


def inputs(spec, seed):
    width, periods = int(spec["width_cells"]), int(spec["periods"])
    h00, h01, pos, _, missing = wire_blocks(spec, width)
    m = len(pos)
    n = m * ORB
    # the electrons of a period: each missing bond's electron belongs to
    # the Si-H bond, which the shifted hybrid stands for outside the basis
    electrons = int(spec["electrons_per_atom"]) * m - sum(map(len, missing))
    occ = electrons // 2
    bands = lead_bands(h00, h01, int(spec["band_k_points"]))
    vbm, cbm = float(bands[:, occ - 1].max()), float(bands[:, occ].min())
    mid = 0.5 * (vbm + cbm)
    h00 = h00 - mid * np.eye(n)
    N = periods * n
    H = np.zeros((N, N))
    for k in range(periods):
        H[k * n:(k + 1) * n, k * n:(k + 1) * n] = h00
        if k + 1 < periods:
            H[k * n:(k + 1) * n, (k + 1) * n:(k + 2) * n] = h01
            H[(k + 1) * n:(k + 2) * n, k * n:(k + 1) * n] = h01.T
    rng = np.random.default_rng([int(seed), 0])
    for k in spec["disordered_periods"]:
        i = np.arange((k - 1) * n, k * n)
        H[i, i] += spec["disorder_eV"] * rng.standard_normal(n)
    a = spec["lattice_A"]
    coords = np.concatenate([(pos + [0, 0, 4 * k]) * a / 4
                             for k in range(periods)])

    def atoms(period):
        return list(range((period - 1) * m + 1, period * m + 1))
    return {"H0": H, "S": np.eye(N), "U": np.zeros(N), "n0": np.zeros(N),
            "n_electrons": float(electrons * periods),
            "coords": coords,
            "orb_atoms": np.repeat(np.arange(1, m * periods + 1), ORB),
            "contacts": [atoms(p) for p in spec["contact_periods"]],
            "taus": [atoms(p) for p in spec["tau_periods"]],
            "h00": h00, "h01": h01, "cell": n, "vbm": vbm - mid,
            "cbm": cbm - mid}


def program(spec, inp, *, device, name, exec_cfg):
    """The program's NEGFE on this junction, its leads taken from the
    contact and tau cells (setContact1D, Sancho-Rubio)."""
    from gaunegf_tpu_torch.models.fock import TightBindingFock
    from gaunegf_tpu_torch.scfe import NEGFE
    backend = TightBindingFock(inp["H0"], n_electrons=inp["n_electrons"],
                               U=inp["U"], n0=inp["n0"],
                               coords=inp["coords"], locs=inp["orb_atoms"])
    negfe = NEGFE(backend, name=name, exec_cfg=exec_cfg, device=device,
                  verbose=False)
    negfe.setContact1D(inp["contacts"], tau_list=inp["taus"],
                       eta=spec["eta_eV"], T=spec["temperature_K"])
    return negfe


def band_center(spec, inp):
    """0.4 eV above the lead's conduction-band minimum."""
    return inp["cbm"] + 0.4


class Reference:
    """The junction worked out again: each lead's surface Green's function
    by the textbook decimation from the wire's own blocks (the left lead
    couples to the first contact cell through h01^T, the right to the
    second through h01), the mean-field Fock rebuild (U = 0: the Hamiltonian)
    and the aufbau start."""

    def __init__(self, spec, inp, device, mu):
        self.inp = inp
        self.S = inp["S"]
        self.F0 = inp["H0"]
        N, n = inp["H0"].shape[0], inp["cell"]
        cells = [np.arange((p - 1) * n, p * n)
                 for p in spec["contact_periods"]]
        self.leads = rd.Leads(inp["h00"], [inp["h01"].T, inp["h01"]], cells,
                              N, spec["eta_eV"], device)
        self.window_support = None

    def sigmas(self, E_all):
        return self.leads.table(E_all)

    def total_at(self, e):
        return self.leads.total_at(e)

    def P0(self, dtype=np.float64):
        return rn.aufbau_density(self.F0, self.S, self.inp["n_electrons"],
                                 dtype)

    def fock(self, P, dtype=np.float64):
        return rn.mean_field_fock(self.inp["H0"], self.inp["U"],
                                  self.inp["n0"], self.S, P, dtype)


def reference(spec, inp, *, device, mu):
    return Reference(spec, inp, device, mu)
