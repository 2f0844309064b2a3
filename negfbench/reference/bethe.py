"""Bethe-lattice contact self-energies of an FCC(111) electrode, worked out
again: Slater-Koster blocks from a .bethe parameter file, the contact
geometry, the plain Jacobi map of the bulk and surface self-energies
iterated far past the program's stop, and the embedding into the device
matrix.

Frozen copies of the textbook constructions (ANT.Gaussian's Bethe lattice;
gauNEGF surfGBethe.py: readBetheParams, constructMat, genNeighbors,
sigmaK, the surface relaxation): the 9-orbital basis [s, px, py, pz,
d3z2-r2, dxz, dyz, dx2-y2, dxy], twelve nearest-neighbour directions with
the opposites at (k + 6) % 12, the first nine slots on the surface.
"""

from __future__ import annotations

import numpy as np
import torch

HAR_TO_EV = 27.211386
DIM = 9
NN = 12
PAIR = tuple((k + 6) % NN for k in range(NN))
PLANE = (0, 1, 2, 6, 7, 8)
KEYS = ("ne", "es", "ep", "edd", "edt", "sss", "sps", "pps", "ppp", "sds",
        "pds", "pdp", "dds", "ddp", "ddd", "Ssss", "Ssps", "Spps", "Sppp",
        "Ssds", "Spds", "Spdp", "Sdds", "Sddp", "Sddd")


def read_params(path):
    """{'onsite', 'hopping' (eV), 'overlap', 'ne'} of a .bethe file."""
    raw = {}
    with open(path) as f:
        for line in f:
            line = line.replace(" ", "").strip()
            if line and not line.startswith("#"):
                k, v = line.split("=")
                raw[k] = float(v)
    if set(raw) != set(KEYS):
        raise ValueError(f"{path}: keys {sorted(set(raw) ^ set(KEYS))}")
    return {"ne": raw["ne"],
            "onsite": {k[1:]: raw[k] * HAR_TO_EV for k in raw
                       if k.startswith("e")},
            "hopping": {k: raw[k] * HAR_TO_EV for k in raw
                        if not k.startswith(("e", "S")) and k != "ne"},
            "overlap": {k[1:]: raw[k] for k in raw if k.startswith("S")}}


def onsite_block(p):
    o = p["onsite"]
    return np.diag([o["s"], o["p"], o["p"], o["p"], o["dd"], o["dt"],
                    o["dt"], o["dd"], o["dt"]])


def _canonical(M):
    out = np.zeros((DIM, DIM))
    out[0, 0] = M["sss"]
    out[0, 3], out[3, 0] = M["sps"], -M["sps"]
    out[1, 1] = out[2, 2] = M["ppp"]
    out[3, 3] = M["pps"]
    out[0, 4] = out[4, 0] = M["sds"]
    out[1, 5] = out[2, 6] = M["pdp"]
    out[5, 1] = out[6, 2] = -M["pdp"]
    out[3, 4], out[4, 3] = M["pds"], -M["pds"]
    out[4, 4] = M["dds"]
    out[5, 5] = out[6, 6] = M["ddp"]
    out[7, 7] = out[8, 8] = M["ddd"]
    return out


def _rotation(direction):
    x, y, z = np.asarray(direction, dtype=float)
    t = np.arccos(np.clip(z, -1.0, 1.0))
    ph = np.arctan2(y, x)
    ct, st, cp, sp = np.cos(t), np.sin(t), np.cos(ph), np.sin(ph)
    tr = np.zeros((DIM, DIM))
    tr[0, 0] = 1.0
    tr[1:4, 1:4] = [[ct * cp, -sp, st * cp], [ct * sp, cp, st * sp],
                    [-st, 0.0, ct]]
    s2t, c2t, c2p, s2p = np.sin(2 * t), np.cos(2 * t), np.cos(2 * ph), \
        np.sin(2 * ph)
    r3 = np.sqrt(3.0)
    d = np.zeros((5, 5))
    d[0, 0] = (3 * z ** 2 - 1) / 2
    d[0, 1] = -r3 * s2t / 2
    d[0, 3] = r3 * st ** 2 / 2
    d[1, 0] = r3 * s2t * cp / 2
    d[1, 1] = c2t * cp
    d[1, 2] = -ct * sp
    d[1, 3] = -d[1, 0] / r3
    d[1, 4] = st * sp
    d[2, 0] = r3 * s2t * sp / 2
    d[2, 1] = c2t * sp
    d[2, 2] = ct * cp
    d[2, 3] = -d[2, 0] / r3
    d[2, 4] = -st * cp
    d[3, 0] = r3 * st ** 2 * c2p / 2
    d[3, 1] = s2t * c2p / 2
    d[3, 2] = -st * s2p
    d[3, 3] = (1 + ct ** 2) * c2p / 2
    d[3, 4] = -ct * s2p
    d[4, 0] = r3 * st ** 2 * s2p / 2
    d[4, 1] = s2t * s2p / 2
    d[4, 2] = st * c2p
    d[4, 3] = (1 + ct ** 2) * s2p / 2
    d[4, 4] = ct * c2p
    tr[4:, 4:] = d
    return tr


def bond(M, direction):
    tr = _rotation(direction)
    return tr @ _canonical(M) @ tr.T


def _rot(axis, angle):
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def fcc111_directions(normal, first):
    """Twelve unit vectors: three in-plane, three out of the plane on the
    normal's side, then their opposites."""
    n = np.asarray(normal, float) / np.linalg.norm(normal)
    f = np.asarray(first, float)
    f = f - np.dot(f, n) * n
    f = f / np.linalg.norm(f)
    vecs = [_rot(n, i * np.pi / 3) @ f for i in range(3)]
    vecs = [v / np.linalg.norm(v) for v in vecs]
    a = np.arccos(1 / np.sqrt(3))
    base = _rot(n, np.pi / 6) @ f
    base = np.cos(a) * base + np.sin(a) * n
    vecs += [_rot(n, i * 2 * np.pi / 3) @ base for i in range(3)]
    vecs += [-v for v in vecs[:6]]
    return np.asarray(vecs)


def contact_geometry(coords, orbital_atoms, atoms):
    """(orbitals per atom, the 12 directions, matched slots per atom) of
    one contact: the surface normal from the atoms' plane, pointing away
    from the device's centre; one in-plane bond; each atom's explicit
    neighbours in the device matched to the nearest direction."""
    orb = np.asarray(orbital_atoms)
    inds = [np.where(orb == a)[0] for a in atoms]
    c = np.asarray([coords[a - 1] for a in atoms])
    _, _, vt = np.linalg.svd(c - c.mean(0))
    normal = vt[-1]
    if np.dot(c.mean(0) - coords.mean(0), normal) < 0:
        normal = -normal
    d = np.linalg.norm(c[1:] - c[0], axis=1)
    v = c[int(np.argmin(d)) + 1] - c[0]
    dist = float(np.linalg.norm(v))
    set1 = fcc111_directions(normal, v / dist)
    set2 = fcc111_directions(normal, -v / dist)
    matched = []
    for ci in c:
        nb = [(c2 - ci) / np.linalg.norm(c2 - ci) for c2 in coords
              if 0.8 * dist < np.linalg.norm(c2 - ci) < 1.2 * dist]
        dirs = set1
        for u in nb:
            vals = set2 @ u
            k = int(np.argmax(vals))
            if k in (3, 4, 5, 9, 10, 11) and vals[k] > 0.9:
                dirs = set2
                break
        m = []
        for u in nb:
            vals = dirs @ u
            k = int(np.argmax(vals))
            if vals[k] > 0.9:
                m.append(k)
        matched.append(m)
    return inds, dirs, matched


def surface_stack(H, Sl, Vl, eta, E, conv=1e-13, max_iter=5000):
    """The (b, 9, 9, 9) surface slots at the energies E (b,) by the plain
    Jacobi map, complex128: the bulk twelve directions with the opposite
    slot excluded, mixed half and half, then the six in-plane slots
    relaxed on top; each loop until the largest relative change over the
    whole batch is below conv (looked at every 10th sweep)."""
    dev = E.device
    c = lambda x: torch.as_tensor(np.asarray(x), device=dev).to(
        torch.complex128)
    H, Sl, Vl = c(H), c(Sl), c(Vl)
    z = E.to(torch.complex128) - 1j * eta
    eye = torch.eye(DIM, dtype=torch.complex128, device=dev)
    A = z[:, None, None] * eye - H
    B = z[:, None, None, None] * Sl - Vl
    Bd = B.conj().transpose(-1, -2)
    sig = (-1j * eye).expand(E.shape[0], NN, DIM, DIM).clone()

    def change(new, old):
        return float(((new - old).abs().amax(dim=(1, 2, 3))
                      / old.abs().amax(dim=(1, 2, 3)).clamp(min=1e-30)).max())

    for it in range(max_iter):
        g = torch.linalg.inv((A - sig.sum(1))[:, None] + sig[:, list(PAIR)])
        new = 0.5 * (B @ g @ Bd) + 0.5 * sig
        done = it % 10 == 9 and change(new, sig) < conv
        sig = new
        if done:
            break
    surf = sig[:, :9].clone()
    plane = list(PLANE)
    for it in range(max_iter):
        g = torch.linalg.inv(A - surf.sum(1))
        new = surf.clone()
        new[:, plane] = 0.5 * (B[:, plane] @ g[:, None] @ Bd[:, plane]) \
            + 0.5 * surf[:, plane]
        done = it % 10 == 9 and change(new, surf) < conv
        surf = new
        if done:
            break
    return surf


class BetheContacts:
    """The contacts' self-energies of a device on Bethe-lattice
    electrodes.  params: read_params' dict; contacts: atoms (1-based) of
    each contact; mu: each contact's potential, by which its lattice's
    onsite block and hoppings are shifted (the lattice's own Fermi level
    at 0); S: the device overlap, whose square root de-orthogonalizes the
    self-energy of an orthogonal parameter set."""

    def __init__(self, params, coords, orbital_atoms, contacts, S, eta, mu,
                 device):
        self.device = device
        self.eta = float(eta)
        self.N = np.shape(S)[0]
        ov = params["overlap"]
        self.orthogonal = ov["sss"] == 0
        w, v = np.linalg.eigh(np.asarray(S, dtype=float))
        self.Xi = (v * np.sqrt(w)) @ v.T
        self.contacts = []
        for atoms, m in zip(contacts, mu):
            inds, dirs, matched = contact_geometry(np.asarray(coords),
                                                   orbital_atoms, atoms)
            Sl = np.stack([bond(ov, d) for d in dirs])
            Vl = np.stack([bond(params["hopping"], d) for d in dirs])
            H = onsite_block(params) + m * np.eye(DIM)
            self.contacts.append({"H": H, "S": Sl, "V": Vl + m * Sl,
                                  "inds": inds, "matched": matched})

    def blocks(self, E, conv=1e-13):
        """Per contact, its (b, k, k) block over its own orbitals at the
        energies E (complex tensor): each atom's nine slots summed, less
        the slots of its explicit neighbours."""
        out = []
        for c in self.contacts:
            surf = surface_stack(c["H"], c["S"], c["V"], self.eta, E, conv)
            na = len(c["inds"])
            blk = torch.zeros((E.shape[0], na * DIM, na * DIM),
                              dtype=torch.complex128, device=E.device)
            for a, m in enumerate(c["matched"]):
                atom = surf.sum(1)
                for k in m:
                    if k < 9:
                        atom = atom - surf[:, k]
                blk[:, a * DIM:(a + 1) * DIM, a * DIM:(a + 1) * DIM] = atom
            out.append(blk)
        return out

    def embed(self, blocks):
        """The (b, N, N) self-energies of the blocks."""
        sigs = []
        for c, blk in zip(self.contacts, blocks):
            f = torch.as_tensor(np.concatenate(c["inds"]), device=blk.device)
            sig = torch.zeros((blk.shape[0], self.N, self.N),
                              dtype=torch.complex128, device=blk.device)
            sig[:, f[:, None], f[None, :]] = blk
            if self.orthogonal:
                X = torch.as_tensor(self.Xi, device=blk.device).to(
                    torch.complex128)
                sig = X @ sig @ X
            sigs.append(sig)
        return sigs

    def table(self, E_all):
        """sigmas(E) for density / transmission over energies that all lie
        in E_all: the blocks of every energy from one fixed point per
        contact, embedded a chunk at a time."""
        E_all = np.asarray(E_all, dtype=complex).ravel()
        Et = torch.as_tensor(E_all, device=self.device)
        blocks = self.blocks(Et)
        where = {complex(e): i for i, e in enumerate(E_all)}

        def sigmas(Eb):
            idx = torch.as_tensor([where[complex(e)] for e in
                                   Eb.cpu().numpy()], device=self.device)
            return self.embed([b[idx] for b in blocks])
        return sigmas

    def total_at(self, e):
        """The (N, N) total self-energy at one energy, NumPy."""
        Et = torch.as_tensor(np.array([e], dtype=complex), device=self.device)
        return sum(self.embed(self.blocks(Et)))[0].cpu().numpy()
