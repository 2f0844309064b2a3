"""Nanowire junction with 1D-chain decimation contacts + SCF.

Gaussian-free analog of the reference's examples/SiNEGF.py workflow
(SiNEGF.py:20-77): a periodic-chain device whose semi-infinite leads are
extracted from two interior unit cells, contact Fermi level from the
2-cell periodic trick, transmission before and after a mean-field SCF
with Pulay mixing, at zero and room temperature.
Run: python -m gaunegf_tpu_torch.examples.si_nanowire_scf
"""

import tempfile

import numpy as np

from gaunegf_tpu_torch import transport as tr
from gaunegf_tpu_torch.examples import cli
from gaunegf_tpu_torch.fermi import get_fermi_contact
from gaunegf_tpu_torch.models.chain1d import Chain1DSelfEnergy
from gaunegf_tpu_torch.models.fock import TightBindingFock
from gaunegf_tpu_torch.scfe import NEGFE


def main(device):
    """The contact Fermi level and max T(E) of part 1, the SCF
    convergence and max T(E) of part 2, and part 3's convergence."""
    # ------------------------------------------------------------------
    # Part 1: transport without SCF (two interior cells -> infinite chain)
    # ------------------------------------------------------------------
    cell = 4
    n = 2 * cell
    H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1)) \
        + 0.3 * np.eye(n)
    S = np.eye(n) + 0.05 * (np.eye(n, k=1) + np.eye(n, k=-1))
    inds1 = np.arange(cell)
    inds2 = np.arange(cell, n)

    g = Chain1DSelfEnergy(H, S, [inds1, inds2], eta=1e-4, device=device)
    ne = cell / 2
    fermi = get_fermi_contact(g, ne, device=device, verbose=False)
    E = np.linspace(-5, 5, 500)
    T = tr.calculate_transmission(H, S, tr.SigmaSource(g), E + fermi,
                                  device=device)
    print(f"Part 1: contact fermi = {fermi:.3f} eV, max T = {T.max():.3f}")
    out = {"fermi": float(fermi), "max_T1": float(T.max())}

    # ------------------------------------------------------------------
    # Part 2: transport with SCF (mean-field backend, chain contacts)
    # ------------------------------------------------------------------
    n_dev = 12
    H0 = -1.0 * (np.eye(n_dev, k=1) + np.eye(n_dev, k=-1))
    backend = TightBindingFock(H0, n_electrons=n_dev, U=0.3,
                               n0=0.5 * np.ones(n_dev))
    with tempfile.TemporaryDirectory() as tmp:
        negfe = NEGFE(backend, name=f"{tmp}/nanowire", device=device,
                      verbose=False)
        # leads continue the chain: each contact couples to its adjacent
        # cell
        negfe.setContact1D([[1, 2], [11, 12]], tau_list=[[3, 4], [9, 10]],
                           eta=1e-4)
        negfe.setIntegralLimits(N1=64, N2=32)
        negfe.setVoltage(0.0, fermi=0.0)
        negfe.SCF(conv=1e-3, damping=0.02, max_cycles=50)
        T2 = tr.calculate_transmission(negfe.F_eV, negfe.S,
                                       tr.SigmaSource(negfe.g), E,
                                       device=device)
        print(f"Part 2: SCF conv {negfe.conv_level:.2e}, "
              f"max T = {T2.max():.3f}")
        out.update(conv2=float(negfe.conv_level), max_T2=float(T2.max()))

        # room temperature
        negfe.setSigma([1, 2], [11, 12], sig=-0.1j, T=300.0)
        negfe.setIntegralLimits(N1=64, N2=32)
        negfe.setVoltage(0.0, fermi=0.0)
        negfe.SCF(conv=1e-3, damping=0.02, max_cycles=50)
        print(f"Part 3 (300K): SCF conv {negfe.conv_level:.2e}")
        out["conv3"] = float(negfe.conv_level)
        negfe.saveMAT(f"{tmp}/nanowire_scf.mat")
    return out


if __name__ == "__main__":
    cli(main, __doc__)
