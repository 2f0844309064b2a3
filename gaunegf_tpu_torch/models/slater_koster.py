"""Slater-Koster two-center matrices for a minimal s+p+d basis.

Capability parity with surfGBethe.constructMat / readBetheParams
(surfGBethe.py:300-477): the 9-orbital basis ordering is
[s, px, py, pz, d3z2-r2, dxz, dyz, dx2-y2, dxy]; a bond along an arbitrary
direction is built by rotating the canonical [0,0,1]-bond matrix with the
p- and d-orbital rotation blocks.

Design difference vs the reference: the canonical matrix and both rotation
blocks are assembled as closed-form NumPy expressions on the host (geometry
runs once per contact, SURVEY.md section 7.2 layer 3); only the resulting (12, 9, 9)
stacks are shipped to the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict

import numpy as np

from gaunegf_tpu_torch.units import HAR_TO_EV

DIM = 9   # 1 s + 3 p + 5 d

BETHE_KEYS = [
    "ne", "es", "ep", "edd", "edt",
    "sss", "sps", "pps", "ppp", "sds", "pds", "pdp", "dds", "ddp", "ddd",
    "Ssss", "Ssps", "Spps", "Sppp", "Ssds", "Spds", "Spdp", "Sdds", "Sddp",
    "Sddd",
]

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")


@dataclass(frozen=True)
class BetheParams:
    """Parsed .bethe parameter set (25 keys, surfGBethe.py:341-343)."""
    ne: float
    onsite: Dict[str, float]      # es/ep/edd/edt, in eV
    hopping: Dict[str, float]     # sss..ddd, in eV
    overlap: Dict[str, float]     # Ssss..Sddd, dimensionless

    @property
    def orthogonal(self) -> bool:
        """All-zero overlaps trigger the ANT de-orthogonalization branch
        (surfGBethe.py:530-533 tests Sdict['sss'] == 0)."""
        return self.overlap["sss"] == 0

    def h0(self) -> np.ndarray:
        """Onsite 9x9: diag([es, ep*3, edd, edt, edt, edd, edt])
        (surfGBethe.py:352-355 layout)."""
        d = [self.onsite["s"]] + [self.onsite["p"]] * 3 + \
            [self.onsite["dd"], self.onsite["dt"], self.onsite["dt"],
             self.onsite["dd"], self.onsite["dt"]]
        return np.diag(np.asarray(d, dtype=float))


def parse_bethe_file(path_or_name: str) -> BetheParams:
    """Read a 'key = value' .bethe file; Hartree -> eV for energies."""
    path = path_or_name
    if not os.path.exists(path):
        for cand in (path_or_name + ".bethe",
                     os.path.join(_DATA_DIR, path_or_name + ".bethe")):
            if os.path.exists(cand):
                path = cand
                break
    params = {}
    with open(path) as f:
        for line in f:
            line = line.replace(" ", "").strip()
            if not line or line.startswith("#"):
                continue
            key, value = line.split("=")
            params[key] = float(value)
    missing = set(BETHE_KEYS) - set(params)
    extra = set(params) - set(BETHE_KEYS)
    assert not missing and not extra, \
        f"Bad .bethe file: missing {missing}, unexpected {extra}"
    return bethe_params_from_dict(params)


def bethe_params_from_dict(params: Dict[str, float]) -> BetheParams:
    onsite = {k[1:]: params[k] * HAR_TO_EV for k in params
              if k.startswith("e")}
    overlap = {k[1:]: params[k] for k in params if k.startswith("S")}
    hopping = {k: params[k] * HAR_TO_EV for k in params
               if not k.startswith(("e", "S")) and k != "ne"}
    return BetheParams(ne=params["ne"], onsite=onsite, hopping=hopping,
                       overlap=overlap)


def canonical_bond_matrix(M: Dict[str, float]) -> np.ndarray:
    """9x9 interaction matrix for a bond along +z (surfGBethe.py:387-420
    sparsity pattern): only the Slater-Koster channels that survive the
    [0,0,1] geometry are populated, with s-p and p-d antisymmetry."""
    out = np.zeros((DIM, DIM))
    out[0, 0] = M["sss"]
    out[0, 3] = M["sps"]
    out[3, 0] = -M["sps"]
    out[1, 1] = M["ppp"]
    out[2, 2] = M["ppp"]
    out[3, 3] = M["pps"]
    out[0, 4] = M["sds"]
    out[4, 0] = M["sds"]
    out[1, 5] = M["pdp"]
    out[2, 6] = M["pdp"]
    out[3, 4] = M["pds"]
    out[5, 1] = -M["pdp"]
    out[6, 2] = -M["pdp"]
    out[4, 3] = -M["pds"]
    out[4, 4] = M["dds"]
    out[5, 5] = M["ddp"]
    out[6, 6] = M["ddp"]
    out[7, 7] = M["ddd"]
    out[8, 8] = M["ddd"]
    return out


def rotation_matrix(direction) -> np.ndarray:
    """9x9 orbital rotation taking a +z bond into `direction`.

    p block: standard vector rotation in the (px, py, pz) basis; d block:
    the real-spherical-harmonic l=2 rotation (ANT.Gaussian convention,
    surfGBethe.py:441-474)."""
    x, y, z = np.asarray(direction, dtype=float)
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    phi = np.arctan2(y, x)
    ct, st = np.cos(theta), np.sin(theta)
    cp, sp = np.cos(phi), np.sin(phi)

    tr = np.zeros((DIM, DIM))
    tr[0, 0] = 1.0
    tr[1:4, 1:4] = np.array([
        [ct * cp, -sp, st * cp],
        [ct * sp, cp, st * sp],
        [-st, 0.0, ct],
    ])

    s2t = np.sin(2 * theta)
    c2t = np.cos(2 * theta)
    c2p = np.cos(2 * phi)
    s2p = np.sin(2 * phi)
    r3 = np.sqrt(3.0)
    d = np.zeros((5, 5))
    d[0, 0] = (3 * z ** 2 - 1) / 2
    d[0, 1] = -r3 * s2t / 2
    d[0, 3] = r3 * st ** 2 / 2
    d10 = r3 * s2t * cp / 2
    d[1, 0] = d10
    d[1, 1] = c2t * cp
    d[1, 2] = -ct * sp
    d[1, 3] = -d10 / r3
    d[1, 4] = st * sp
    d20 = r3 * s2t * sp / 2
    d[2, 0] = d20
    d[2, 1] = c2t * sp
    d[2, 2] = ct * cp
    d[2, 3] = -d20 / r3
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
    tr[4:9, 4:9] = d
    return tr


def bond_matrix(M: Dict[str, float], direction) -> np.ndarray:
    """Slater-Koster matrix for a bond along `direction`
    (constructMat parity, surfGBethe.py:357-477)."""
    tr = rotation_matrix(direction)
    return tr @ canonical_bond_matrix(M) @ tr.T


def fcc111_neighbor_directions(plane_normal, first_neighbor) -> np.ndarray:
    """12 FCC nearest-neighbour unit vectors for a [111] surface
    (genNeighbors parity, surfGBethe.py:223-298).

    Layout: [0:3] in-plane (60-degree fan), [3:6] out-of-plane (+normal side),
    [6:12] the opposites at (k+6)%12.
    """
    n = np.asarray(plane_normal, dtype=float)
    n = n / np.linalg.norm(n)
    f = np.asarray(first_neighbor, dtype=float)
    f = f - np.dot(f, n) * n
    f = f / np.linalg.norm(f)

    def rot(axis, angle):
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)

    in_plane = [rot(n, i * np.pi / 3) @ f for i in range(3)]
    in_plane = [v / np.linalg.norm(v) for v in in_plane]

    oop_angle = np.arccos(1 / np.sqrt(3))
    base = rot(n, np.pi / 6) @ f
    base = np.cos(oop_angle) * base + np.sin(oop_angle) * n
    out_plane = [rot(n, i * 2 * np.pi / 3) @ base for i in range(3)]

    vecs = in_plane + out_plane
    vecs += [-v for v in vecs[:6]]
    return np.asarray(vecs)


# ---------------------------------------------------------------------------
# Self-tests (parity with surfGB.runAllTests, surfGBethe.py:648-829)
# ---------------------------------------------------------------------------

def validate_slater_koster(params: BetheParams, atol=1e-10) -> None:
    """Angular identities of the SK construction; raises on failure."""
    V = params.hopping
    M = bond_matrix(V, [1, 0, 0])
    assert abs(M[0, 8]) < atol, "dxy not zero along x-axis"
    assert abs(M[0, 7] - np.sqrt(3) / 2 * V["sds"]) < atol
    assert abs(M[0, 4] + 0.5 * V["sds"]) < atol
    assert abs(M[1, 8]) < atol, "px-dxy along x-axis"
    assert abs(M[6, 6] - V["ddd"]) < atol, "dyz-dyz along x should be delta"

    Mz = bond_matrix(V, [0, 0, 1])
    assert abs(Mz[3, 4] - V["pds"]) < atol
    assert abs(Mz[4, 4] - V["dds"]) < atol

    M1 = bond_matrix(V, [1 / np.sqrt(2), 1 / np.sqrt(2), 0])
    M2 = bond_matrix(V, [-1 / np.sqrt(2), -1 / np.sqrt(2), 0])
    assert np.allclose(M1[4:, 4:], M2[4:, 4:], atol=atol), \
        "d-d block not inversion symmetric"

    mag = abs(V["sps"])
    for direction in ([0, 0, 1], [1, 0, 0], [0, 1, 0],
                      [1 / np.sqrt(2), 0, 1 / np.sqrt(2)],
                      [0, 1 / np.sqrt(2), 1 / np.sqrt(2)],
                      [1 / np.sqrt(2), 1 / np.sqrt(2), 0]):
        Md = bond_matrix(V, direction)
        for i in range(1, 4):
            assert abs(Md[0, i] + Md[i, 0]) < atol, "s-p antisymmetry"
        total = np.sqrt(Md[0, 1] ** 2 + Md[0, 2] ** 2 + Md[0, 3] ** 2)
        assert abs(total - mag) < 1e-8, "s-p magnitude not preserved"
