"""NEGF (analytic) vs NEGFE (contour) comparison + I-V sweep.

Gaussian-free analog of the reference's IntegralDemo notebook: the same
junction solved with the energy-independent analytic SCF (NEGF) and the
energy-dependent contour SCF (NEGFE), then a small I-V sweep with
per-point SCF.
Run: python -m gaunegf_tpu_torch.examples.integral_demo
"""

import tempfile
import time

import numpy as np

from gaunegf_tpu_torch import transport as tr
from gaunegf_tpu_torch.examples import cli
from gaunegf_tpu_torch.models.fock import TightBindingFock
from gaunegf_tpu_torch.scf import NEGF
from gaunegf_tpu_torch.scfe import NEGFE


def make_backend(n=16, U=0.4):
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    return TightBindingFock(H0, n_electrons=n, U=U, n0=0.5 * np.ones(n))


def main(device):
    """Both SCF runs' convergence, Fermi level and electron count, their
    largest density difference, and the current at each bias of the
    sweep."""
    n = 16
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # --- energy-independent (analytic) SCF ----------------------------
        t0 = time.time()
        negf = NEGF(make_backend(n), name=f"{tmp}/demo_negf", device=device,
                    verbose=False)
        negf.setSigma([1, 2], [n - 1, n], sig=-0.1j)
        negf.setVoltage(0.0)                   # Fermi search each cycle
        negf.SCF(conv=1e-4, damping=0.05, max_cycles=200)
        print(f"NEGF  (analytic): conv {negf.conv_level:.1e}, "
              f"fermi {negf.fermi:+.3f} eV, nelec {negf.nelec:.2f}, "
              f"{time.time() - t0:.1f}s")

        # --- energy-dependent (contour) SCF -------------------------------
        t0 = time.time()
        negfe = NEGFE(make_backend(n), name=f"{tmp}/demo_negfe",
                      device=device, verbose=False)
        negfe.setSigma([1, 2], [n - 1, n], sig=-0.1j, T=0)
        negfe.setIntegralLimits(N1=128, N2=64)
        negfe.setVoltage(0.0, fermi_method="secant")
        negfe.SCF(conv=1e-4, damping=0.05, max_cycles=200)
        print(f"NEGFE (contour):  conv {negfe.conv_level:.1e}, "
              f"fermi {negfe.fermi:+.3f} eV, nelec {negfe.nelec:.2f}, "
              f"{time.time() - t0:.1f}s")
        dP = float(np.max(np.abs(negf.P - negfe.P)))
        print(f"max |P_NEGF - P_NEGFE| = {dP:.2e}")
        for key, run in (("negf", negf), ("negfe", negfe)):
            out[key] = {"conv": float(run.conv_level),
                        "fermi": float(run.fermi),
                        "nelec": float(run.nelec)}
        out["dP"] = dP

        # --- I-V sweep with per-point SCF ----------------------------------
        print("\nI-V sweep:")
        out["iv"] = []
        for qV in [0.1, 0.2, 0.3]:
            t0 = time.time()
            negfe.setVoltage(qV, fermi=negfe.fermi)
            negfe.SCF(conv=1e-3, damping=0.05, max_cycles=100,
                      checkpoint=False)
            current = tr.calculate_current(
                negfe.F_eV, negfe.S, tr.SigmaSource(negfe.g),
                fermi=negfe.fermi, qV=qV, T=0, dE=0.005, device=device)
            print(f"  V = {qV:.1f} V: I = {current:+.3e} A  "
                  f"({time.time() - t0:.1f}s)")
            out["iv"].append((qV, float(current)))
    return out


if __name__ == "__main__":
    cli(main, __doc__)
