"""Zero-change migration from the reference gauNEGF package.

Registers gaunegf_tpu_torch.compat as the ``gauNEGF`` package on the given
device, then runs an unmodified reference-style workflow: a 1D
tight-binding chain with surfG1D contacts, coherent transmission, DOS, and
an equilibrium contour density (reference API surface: surfG1D.py /
transport.py / density.py).
Run: python -m gaunegf_tpu_torch.examples.reference_migration
"""

import numpy as np

from gaunegf_tpu_torch import compat
from gaunegf_tpu_torch.examples import cli


def main(device):
    """T(0) with surfG1D contacts and with static sigmas, the DOS at
    E = 0 and the electron count below mu = 0."""
    compat.install(device=device)

    # --- from here on, verbatim reference imports -------------------------
    from gauNEGF.density import densityComplexN
    from gauNEGF.matTools import formSigma
    from gauNEGF.surfG1D import surfG
    from gauNEGF.transport import DOSE, cohTrans, cohTransE

    n = 20
    rng = np.random.default_rng(7)
    H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1)) + np.diag(
        0.05 * rng.standard_normal(n))
    S = np.eye(n)
    left, right = list(range(0, 3)), list(range(n - 3, n))

    # End contacts on an open chain need explicit adjacent-cell taus (the
    # default assumes the reference's 2-cell periodic convention).
    g = surfG(H, S, [left, right],
              taus=[np.arange(3, 6), np.arange(n - 6, n - 3)])

    # Energy-dependent transmission (reference cohTransE returns a list)
    Elist = np.linspace(-2.0, 2.0, 21)
    T = np.asarray(cohTransE(Elist, H, S, g))
    print(f"mid-band transmission T(0) = {T[10]:.4f} (clean chain: ~1)")

    # Static-sigma transmission via formSigma (full N x N, as the reference)
    sig1 = formSigma(left, -0.1j, n)
    sig2 = formSigma(right, -0.1j, n)
    T2 = np.asarray(cohTrans(Elist, H, S, sig1, sig2))
    print(f"static-sigma T(0) = {T2[10]:.4f}")

    # Site-resolved DOS
    dos, _ = DOSE(np.linspace(-1.0, 1.0, 7), H, S, g)
    print(f"DOS at E=0: {dos[3]:.4f} states/eV")

    # Equilibrium density from the semicircle contour
    P = np.asarray(densityComplexN(H, S, g, -4.0, 0.0, N=24,
                                   showText=False))
    ne = float(np.trace(P @ S).real)
    print(f"electrons below mu=0: {ne:.3f} (half filling: {n / 2})")
    return {"T0": float(T[10]), "T0_static": float(T2[10]),
            "dos0": float(dos[3]), "ne": ne}


if __name__ == "__main__":
    cli(main, __doc__)
