"""Energy-dependent NEGF-SCF driver: the biased density build.

Port of ``gaunegf_tpu/scfe.py``'s NEGFE class (reference scfE.py) for
constant-sigma contacts at a fixed Fermi level: under bias one
FockToP is ONE fused device dispatch (real-axis lower segment +
equilibrium contour + G< window, density.density_neq_n), without bias the
fused equilibrium build (density.density_eq_n).

Contacts: constant sigma (``setSigma``) and 1D chains (``setContact1D``
without ``alphas``).  Not ported yet: the Fermi searches
(``upd_fermi=True`` and ``setContact1D(alphas=...)`` raise
NotImplementedError until fermi.py is ported), the Bethe contacts
(``setContactBethe``) and ``integralCheck``.
"""

from __future__ import annotations

import numpy as np

from gaunegf_tpu_torch.config import ADAPTIVE_INTEGRATION_TOL, ETA, TEMPERATURE
from gaunegf_tpu_torch import density as dens
from gaunegf_tpu_torch.models.chain1d import Chain1DSelfEnergy
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
from gaunegf_tpu_torch.scf import NEGF

__all__ = ["NEGFE"]


class NEGFE(NEGF):
    """NEGF driver with energy-dependent self-energies."""

    energy_dep = True

    def setContact1D(self, contact_list, tau_list=None, stau_list=None,
                     alphas=None, a_overlaps=None, betas=None,
                     b_overlaps=None, ne_list=None, eta=ETA, T=TEMPERATURE,
                     method="sancho"):
        """1D-chain contacts (setContact1D, scfE.py:96-149).

        The fully specified form (``alphas`` given) places each lead's
        Fermi level by a search over its electron count (``ne_list``),
        which is not ported yet and raises NotImplementedError."""
        if alphas is not None:
            raise NotImplementedError(
                "setContact1D with alphas needs the contact Fermi search, "
                "which is not ported yet (ROADMAP section 1, item 7: "
                "fermi.py)")
        inds = self.setContacts(contact_list[0], contact_list[-1])
        self.l_ind, self.r_ind = inds
        if tau_list is not None and len(np.shape(tau_list[0])) == 1:
            ind1 = np.where(np.isin(np.abs(self.locs), tau_list[0]))[0]
            ind2 = np.where(np.isin(np.abs(self.locs), tau_list[-1]))[0]
            tau_list = (ind1, ind2)
        self.g = Chain1DSelfEnergy(self.F_eV, self.S, inds, taus=tau_list,
                                   staus=stau_list, eta=eta, method=method)
        self.setIntegralLimits()
        self.T = T
        return inds

    def setSigma(self, l_contact=None, r_contact=None, sig=-0.1j, sig2=None,
                 T=TEMPERATURE):
        """Constant-sigma contacts usable at finite T (scfE.py:152-181)."""
        super().setSigma(l_contact, r_contact, sig, sig2)
        inds = (self.l_ind, self.r_ind)
        self.g = ConstantSelfEnergy(self.F_eV, self.S, inds,
                                    self._sig1, self._sig2)
        self.setIntegralLimits()
        self.T = T
        return inds

    def setVoltage(self, qV, fermi=np.nan, Emin=None, Eminf=None,
                   fermi_method="muller"):
        """Bias + Fermi-search method selection (scfE.py:184-208)."""
        super().setVoltage(qV, fermi, Emin, Eminf)
        self.g.set_fock(self.F_eV, self.mu1, self.mu2)
        if self.mu1 != self.mu2 and getattr(self, "N1", None) is not None:
            self.Nnegf = 50  # default bias-window grid (scfE.py:204-206)
        if self.upd_fermi:
            self.fermi_method = fermi_method

    def setIntegralLimits(self, N1=None, N2=None, Nnegf=None,
                          tol=ADAPTIVE_INTEGRATION_TOL, Emin=None):
        """(scfE.py:210-235)"""
        if Emin is None and tol is not None:
            self.Emin = dens.calc_emin(self.F_eV, self.S, self.g,
                                       verbose=self.verbose)
        else:
            self.Emin = Emin
        self.tol = tol
        self.N1 = N1
        self.N2 = N2
        self.Nnegf = Nnegf

    def getSigma(self, E):
        return self.g.sigma(E, 0), self.g.sigma(E, -1)

    # ------------------------------------------------------------------
    def FockToP(self):
        """Energy-dependent density build at a fixed Fermi level
        (scfE.py:301-462): real-axis lower segment + equilibrium contour,
        plus the G< window under bias, in one engine dispatch."""
        if self.upd_fermi:
            raise NotImplementedError(
                "the Fermi searches (upd_fermi=True) are not ported yet "
                "(ROADMAP section 1, fermi.py); pass a fixed fermi= to "
                "setVoltage")
        if self.N1 is None or self.N2 is None:
            raise NotImplementedError(
                "the adaptive grids (N1 or N2 None) are not ported yet; "
                "set them with setIntegralLimits(N1=..., N2=...)")
        if self.mu1 != self.mu2:
            if self.Nnegf is None:
                raise NotImplementedError(
                    "the adaptive bias window (Nnegf None) is not ported "
                    "yet; set it with setIntegralLimits(Nnegf=...)")
            if self.verbose:
                print("Calculating equilibrium + non-equilibrium "
                      "density matrix (fused):")
            P = dens.density_neq_n(
                self.F_eV, self.S, self.g, self.Eminf, self.Emin,
                self.mu1, self.mu2, N1=self.N1, N2=self.N2,
                Nnegf=self.Nnegf, T=self.T, T_real=0.0, ind=-1,
                exec_cfg=self.exec_cfg, device=self.device,
                verbose=self.verbose)
        else:
            P = dens.density_eq_n(
                self.F_eV, self.S, self.g, self.Eminf, self.Emin,
                self.mu1, N1=self.N1, N2=self.N2, T=self.T, T_real=0.0,
                exec_cfg=self.exec_cfg, device=self.device,
                verbose=self.verbose)
        self.P = np.asarray(P).copy()
        if not self.verbose:
            return None, None
        return self.level_occupations()

    def level_occupations(self, P=None):
        """(energies, occupations) of the current density in the
        orthogonalized Fock eigenbasis (scfE.py:448-455)."""
        P = self.P if P is None else P
        D, V = np.linalg.eigh(self.X @ self.F_eV @ self.X)
        if not hasattr(self, "_Xi"):
            self._Xi = np.linalg.inv(self.X)   # X is fixed for the run
        pshift = V.conj().T @ (self._Xi @ P @ self._Xi) @ V
        occ = np.diag(np.real(pshift))
        energies = np.real(D).flatten()
        order = np.argsort(energies)
        return energies[order], occ[order]

    def PToFock(self):
        """Backend Fock rebuild + self-energy Fock refresh
        (scfE.py:466-479)."""
        dE = super().PToFock()
        self.g.set_fock(self.F_eV, self.mu1, self.mu2)
        return dE
