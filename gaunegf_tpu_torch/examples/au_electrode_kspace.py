"""Gold-electrode transmission: Bethe lattice vs k-integrated half-space.

Demonstrates the bundled Harrison-rule Au parameter set
(gaunegf_tpu_torch/data/Au.bethe) and the beyond-Gamma k-space contact
mode (models/kspace.py) on a small fcc(111) contact plane + chain
junction.  Run: python -m gaunegf_tpu_torch.examples.au_electrode_kspace
"""

import time

import numpy as np

from gaunegf_tpu_torch.examples import cli
from gaunegf_tpu_torch.models.bethe import BetheGeometry
from gaunegf_tpu_torch.models.harrison import ELEMENTS
from gaunegf_tpu_torch.models.lattice3d import Lattice3DSelfEnergy


def fcc_plane_geometry(d, n_chain=4):
    """4-atom fcc(111) contact plane + an n_chain-site molecular chain."""
    u1 = np.array([1.0, 0.0, 0.0]) * d
    u2 = np.array([0.5, np.sqrt(3) / 2, 0.0]) * d
    plane = [np.zeros(3), u1, u2, u1 + u2]
    chain = [np.array([0.75, 0.45, -2.0 - 1.5 * i]) for i in range(n_chain)]
    coords = np.stack(plane + chain)
    orb_atoms = []
    for atom in range(1, len(coords) + 1):
        orb_atoms += [atom] * (9 if atom <= len(plane) else 1)
    return BetheGeometry(coords, np.asarray(orb_atoms), None)


def main(device):
    """The largest eigenvalue of Gamma at E_F for the Bethe (Gamma-point)
    and the k-space (nk=4) contact, and their relative difference."""
    d = ELEMENTS["Au"]["a"] / np.sqrt(2.0)
    geom = fcc_plane_geometry(d)
    n_orb = 4 * 9 + 4

    # device: plane orbitals uncoupled onsite + a TB chain below, with a
    # weak WBL drain on the far end so transmission is two-terminal
    F = np.zeros((n_orb, n_orb))
    chain = np.arange(36, 40)
    F[chain[:-1], chain[1:]] = F[chain[1:], chain[:-1]] = -1.0
    F[36, 0] = F[0, 36] = -0.8        # chain head couples to the Au s-orbital
    S = np.eye(n_orb)

    results = {}
    for label, kw in (("Bethe (Gamma)", {}),
                      ("k-space nk=4", dict(gamma_point_only=False, nk=4))):
        t0 = time.time()
        prov = Lattice3DSelfEnergy(F, S, [[1, 2, 3, 4]], geom,
                                   lat_file="Au", eta=1e-5, T=0.0,
                                   fermi=-9.7, verbose=False, device=device,
                                   **kw)
        sig = prov.sigmaTot(-9.7)
        gam = 1j * (sig - sig.conj().T)
        results[label] = float(np.linalg.eigvalsh(gam).max())
        print(f"{label:14s}: max Gamma eigval at E_F = "
              f"{results[label]:.4f} eV  ({time.time() - t0:.1f}s)")
    rel = abs(results["k-space nk=4"] - results["Bethe (Gamma)"]) \
        / results["Bethe (Gamma)"]
    print(f"Bethe vs k-integrated half-space difference: {100 * rel:.1f}%")
    return {"bethe_gamma_max": results["Bethe (Gamma)"],
            "kspace_gamma_max": results["k-space nk=4"], "rel_diff": rel}


if __name__ == "__main__":
    cli(main, __doc__)
