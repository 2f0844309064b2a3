"""Energy-dependent NEGF-SCF loop.

Port of ``gaunegf_tpu/scfe.py``'s NEGFE class (reference scfE.py):
energy-dependent self-energies (Bethe lattice / 1D-chain decimation /
constant-with-T),
finite-temperature contour integration, five Fermi-search strategies with
bisection fallback, the fixed-grid and adaptive density routes and grid
auto-tuning -- over the FockProvider backend seam, on the device given
to the constructor (and over its ``mesh``, where one is given).
Reference call stack: SURVEY.md section 3.3
(scfE.py:301-462).

At a fixed Fermi level with fixed grids one FockToP is one fused engine
dispatch (density.density_neq_n under bias, density.density_eq_n without).
"""

from __future__ import annotations

import numpy as np

from gaunegf_tpu_torch.config import (
    ADAPTIVE_INTEGRATION_TOL, ETA, FERMI_CALCULATION_TOL, TEMPERATURE)
from gaunegf_tpu_torch import density as dens
from gaunegf_tpu_torch import fermi as fsearch
from gaunegf_tpu_torch.models.bethe import BetheSelfEnergy
from gaunegf_tpu_torch.models.chain1d import Chain1DSelfEnergy
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
from gaunegf_tpu_torch.scf import NEGF

__all__ = ["NEGFE"]


class NEGFE(NEGF):
    """NEGF driver with energy-dependent self-energies."""

    energy_dep = True

    # ------------------------------------------------------------------
    # Contact setup
    # ------------------------------------------------------------------
    def setContact1D(self, contact_list, tau_list=None, stau_list=None,
                     alphas=None, a_overlaps=None, betas=None,
                     b_overlaps=None, ne_list=None, eta=ETA, T=TEMPERATURE,
                     method="sancho"):
        """1D-chain contacts (setContact1D, scfE.py:96-149)."""
        inds = self.setContacts(contact_list[0], contact_list[-1])
        self.l_ind, self.r_ind = inds
        if tau_list is not None and len(np.shape(tau_list[0])) == 1:
            ind1 = np.where(np.isin(np.abs(self.locs), tau_list[0]))[0]
            ind2 = np.where(np.isin(np.abs(self.locs), tau_list[-1]))[0]
            tau_list = (ind1, ind2)
        self.g = Chain1DSelfEnergy(
            self.F_eV, self.S, inds, taus=tau_list, staus=stau_list,
            alphas=alphas, a_overlaps=a_overlaps, betas=betas,
            b_overlaps=b_overlaps, eta=eta, method=method,
            device=self.device)
        if alphas is not None:
            muL = fsearch.get_fermi_1d_contact(
                self.g, ne_list[0], 0, exec_cfg=self.exec_cfg,
                device=self.device, mesh=self.mesh, verbose=self.verbose)[0]
            muR = fsearch.get_fermi_1d_contact(
                self.g, ne_list[-1], -1, exec_cfg=self.exec_cfg,
                device=self.device, mesh=self.mesh, verbose=self.verbose)[0]
            self.g.set_fock(self.g.F, muL, muR)
        self.setIntegralLimits()
        self.T = T
        return inds

    def setContactBethe(self, contact_list, lat_file="Au", eta=ETA,
                        T=TEMPERATURE, geometry=None, fermi=None):
        """Bethe-lattice contacts (setContactBethe, scfE.py:63-93).

        geometry: optional BetheGeometry spec; defaults to extracting atom
        coordinates and the orbital map from the backend.
        fermi: optional known lattice Fermi level; skips the contact
        Fermi-level determination (integral_fit + bisection).
        """
        inds = self.setContacts(contact_list[0], contact_list[-1])
        self.l_ind, self.r_ind = inds
        self.g = BetheSelfEnergy.from_backend(
            self.F_eV, self.S, contact_list, self.backend, lat_file,
            self.spin, eta, T, geometry=geometry, fermi=fermi,
            exec_cfg=self.exec_cfg, device=self.device, mesh=self.mesh,
            verbose=self.verbose)
        self.setIntegralLimits()
        self.T = T
        return inds

    def setSigma(self, l_contact=None, r_contact=None, sig=-0.1j, sig2=None,
                 T=TEMPERATURE):
        """Constant-sigma contacts usable at finite T (scfE.py:152-181)."""
        super().setSigma(l_contact, r_contact, sig, sig2)
        inds = (self.l_ind, self.r_ind)
        # Use the spin-expanded sigmas stored by the base class: a
        # half-length vector sigma for 'u'/'ro'/'g' has already been
        # kron-expanded there and would crash form_sigma if passed raw.
        self.g = ConstantSelfEnergy(self.F_eV, self.S, inds,
                                    self._sig1, self._sig2,
                                    device=self.device)
        self.setIntegralLimits()
        self.T = T
        return inds

    # ------------------------------------------------------------------
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
                                       device=self.device,
                                       verbose=self.verbose)
        else:
            self.Emin = Emin
        self.tol = tol
        self.N1 = N1
        self.N2 = N2
        self.Nnegf = Nnegf

    def integralCheck(self, cycles=10, damp=0.02, pause_fermi=False):
        """Warm-up SCF then grid auto-tuning (scfE.py:237-279)."""
        if self.upd_fermi and pause_fermi:
            self.upd_fermi = False
            if cycles > 0:
                print(f"RUNNING SCF FOR {cycles} CYCLES USING DEFAULT GRID:")
                self.SCF(1e-10, damp, cycles)
            self.upd_fermi = True
        elif cycles > 0:
            print(f"RUNNING SCF FOR {cycles} CYCLES USING DEFAULT GRID:")
            self.SCF(1e-10, damp, cycles)
        print("SETTING INTEGRATION LIMITS... ")
        self.Emin, self.N1, self.N2 = dens.integral_fit(
            self.F_eV, self.S, self.g, self.fermi, self.Eminf, self.tol,
            T=self.T, exec_cfg=self.exec_cfg, device=self.device,
            mesh=self.mesh,
            verbose=self.verbose)
        P_lower = dens.density_real_n(self.F_eV, self.S, self.g, self.Eminf,
                                      self.Emin, self.N2, T=self.T,
                                      exec_cfg=self.exec_cfg,
                                      device=self.device, mesh=self.mesh)
        n_lower = float(np.einsum("ij,ji->", self.S, P_lower).real)
        if self.mu1 != self.mu2:
            self.Nnegf = dens.integral_fit_negf(
                self.F_eV, self.S, self.g, self.fermi, self.qV, self.Eminf,
                self.tol, self.T, exec_cfg=self.exec_cfg, device=self.device,
                mesh=self.mesh,
                verbose=self.verbose)
        if self.upd_fermi:
            print("CALCULATING FERMI ENERGY")
            ne = self.nae if self.spin == "r" else self.nae + self.nbe
            self.fermi, dE, P, _ = fsearch.calc_fermi_secant(
                self.g, ne - n_lower, self.Emin, self.fermi, self.N1,
                tol=self.tol, max_cycles=20, exec_cfg=self.exec_cfg,
                device=self.device, mesh=self.mesh)
            print(f"Fermi Energy set to {self.fermi:.2f} eV, "
                  f"error = {dE:.2E} eV ")
            self.setVoltage(self.qV, fermi_method=self.fermi_method)
            self.P = P
        print("INTEGRATION LIMITS SET!")

    def getSigma(self, E):
        return self.g.sigma(E, 0), self.g.sigma(E, -1)

    # ------------------------------------------------------------------
    def FockToP(self):
        """Energy-dependent density build (scfE.py:301-462):
        P = real-axis lower segment + equilibrium contour (+ G< window under
        bias), with the configured Fermi-update strategy."""
        if (not self.upd_fermi and self.N1 is not None
                and self.N2 is not None):
            # fixed Fermi level: fuse the lower real-axis segment, the
            # equilibrium contour AND (under fixed-grid bias) the G<
            # window into one engine dispatch
            if self.mu1 != self.mu2 and self.Nnegf is not None:
                if self.verbose:
                    print("Calculating equilibrium + non-equilibrium "
                          "density matrix (fused):")
                P = dens.density_neq_n(
                    self.F_eV, self.S, self.g, self.Eminf, self.Emin,
                    self.mu1, self.mu2, N1=self.N1, N2=self.N2,
                    Nnegf=self.Nnegf, T=self.T, T_real=0.0, ind=-1,
                    exec_cfg=self.exec_cfg, device=self.device, mesh=self.mesh,
                    verbose=self.verbose)
            else:
                P = dens.density_eq_n(
                    self.F_eV, self.S, self.g, self.Eminf, self.Emin,
                    self.mu1, N1=self.N1, N2=self.N2, T=self.T, T_real=0.0,
                    exec_cfg=self.exec_cfg, device=self.device, mesh=self.mesh,
                    verbose=self.verbose)
                if self.mu1 != self.mu2:
                    if self.verbose:
                        print("Calculating non-equilibrium density matrix:")
                    P = P + dens.density_grid(
                        self.F_eV, self.S, self.g, self.mu1, self.mu2,
                        ind=-1, tol=self.tol, T=self.T,
                        exec_cfg=self.exec_cfg, device=self.device,
                        mesh=self.mesh)
            self.P = np.asarray(P).copy()
            if not self.verbose:
                return None, None
            return self.level_occupations()

        if self.verbose:
            print("Calculating lower density matrix:")
        if self.N2 is None:
            self.Emin = dens.calc_emin(self.F_eV, self.S, self.g,
                                       device=self.device,
                                       verbose=self.verbose)
            P = dens.density_real(self.F_eV, self.S, self.g, self.Eminf,
                                  self.Emin, self.tol, T=0,
                                  exec_cfg=self.exec_cfg, device=self.device,
                                  mesh=self.mesh,
                                  verbose=self.verbose)
        else:
            P = dens.density_real_n(self.F_eV, self.S, self.g, self.Eminf,
                                    self.Emin, self.N2, T=0,
                                    exec_cfg=self.exec_cfg, device=self.device,
                                    mesh=self.mesh)
        n_lower = float(np.einsum("ij,ji->", self.S, P).real)

        def contour_P(mu):
            if self.N1 is not None:
                return dens.density_complex_n(
                    self.F_eV, self.S, self.g, self.Emin, mu, N=self.N1,
                    T=self.T, exec_cfg=self.exec_cfg, device=self.device,
                    mesh=self.mesh)
            return dens.density_complex(
                self.F_eV, self.S, self.g, self.Emin, mu, tol=self.tol,
                T=self.T, exec_cfg=self.exec_cfg, device=self.device,
                mesh=self.mesh,
                verbose=self.verbose)

        if self.upd_fermi:
            fermi_old = self.fermi + 0.0
            conv = min(self.conv_level, FERMI_CALCULATION_TOL)
            ne = self.backend.n_electrons
            if self.spin == "r":
                ne /= 2
            method = self.fermi_method.lower()
            method_fail = False
            u_bound = l_bound = None

            if method == "predict":
                # constant-self-energy approximation step (scfE.py:333-361)
                sig1, sig2 = self.getSigma(self.fermi)
                X = self.X
                Fbar = X @ (self.F_eV + sig1 + sig2) @ X
                Gam = 1j * (sig1 - sig1.conj().T) + 1j * (sig2 - sig2.conj().T)
                GamBar = X @ Gam @ X
                D, V = np.linalg.eig(Fbar)
                Vc = np.linalg.inv(V.conj().T)
                n_curr = float(np.trace(dens.density_analytic(
                    V, Vc, D, GamBar, self.Eminf, self.fermi)).real)
                dN = self.backend.n_electrons - self.nelec
                if self.spin == "r":
                    dN /= 2
                dN -= n_lower
                n_search = n_curr + dN
                print("CONSTANT SELF-ENERGY APPROXIMATION:")
                if 0 < n_search < len(self.F):
                    self.fermi = dens.bisect_fermi(
                        V, Vc, D, GamBar, n_curr + dN, conv, self.Eminf,
                        verbose=self.verbose)
                    print(f"Fermi Energy set to {self.fermi:.2f} eV, "
                          f"shifting by {dN:.2E} electrons ")
                else:
                    print("Warning: Local sigma approximation not valid, "
                          "Fermi energy not updated...")
                P = P + contour_P(self.mu1)
            elif method in ("poly", "muller", "secant"):
                label = {"poly": "POLYNOMIAL REGRESSION", "muller": "MULLER",
                         "secant": "SECANT"}[method]
                print(f"{label} METHOD:")
                if method == "poly":
                    self.fermi, dE, P2, dN, u_bound, l_bound = \
                        fsearch.calc_fermi_poly_fit(
                            self.g, ne - n_lower, self.Emin, fermi_old,
                            self.N1, tol=self.tol, conv=conv, T=self.T,
                            exec_cfg=self.exec_cfg, device=self.device,
                            mesh=self.mesh)
                elif method == "muller":
                    self.fermi, dE, P2, dN, u_bound, l_bound = \
                        fsearch.calc_fermi_muller(
                            self.g, ne - n_lower, self.Emin, fermi_old,
                            self.N1, tol=self.tol, conv=conv, T=self.T,
                            exec_cfg=self.exec_cfg, device=self.device,
                            mesh=self.mesh)
                else:
                    self.fermi, dE, P2, dN = fsearch.calc_fermi_secant(
                        self.g, ne - n_lower, self.Emin, fermi_old,
                        self.N1, tol=self.tol, conv=conv, T=self.T,
                        exec_cfg=self.exec_cfg, device=self.device,
                        mesh=self.mesh)
                method_fail = dN > conv
                if method_fail:
                    print(f"Switching to BISECT method "
                          f"(Fermi error = {dE:.2E} eV)")
                    fermi_old = self.fermi + 0.0
                else:
                    print(f"Fermi Energy set to {self.fermi:.2f} eV, "
                          f"error = {dE:.2E} eV ")
                    P = P + P2 if self.mu1 == self.mu2 \
                        else P + contour_P(self.mu1)
            elif method != "bisect":
                raise ValueError(
                    "Error: invalid Fermi search method, needs to be "
                    "'muller', 'secant', 'bisect', 'predict' or 'poly'")

            if method == "bisect" or method_fail:
                print("BISECT METHOD:")
                self.fermi, dE, P2 = fsearch.calc_fermi_bisect(
                    self.g, ne - n_lower, self.Emin, fermi_old, self.N1,
                    tol=self.tol, conv=conv, T=self.T, u_bound=u_bound,
                    l_bound=l_bound, exec_cfg=self.exec_cfg,
                    device=self.device, mesh=self.mesh)
                print(f"Fermi Energy set to {self.fermi:.2f} eV, "
                      f"error = {dE:.2E} eV ")
                P = P + P2 if self.mu1 == self.mu2 \
                    else P + contour_P(self.mu1)

            # shift integration window with the Fermi level (scfE.py:429-432)
            self.setVoltage(self.qV, fermi_method=self.fermi_method)
            self.Emin += self.fermi - fermi_old
            self.g.set_fock(self.F_eV, self.mu1, self.mu2)
        else:
            if self.verbose:
                print("Calculating equilibrium density matrix:")
            P = P + contour_P(self.mu1)

        if self.mu1 != self.mu2:
            if self.verbose:
                print("Calculating non-equilibrium density matrix:")
            if self.Nnegf is not None:
                P = P + dens.density_grid_n(
                    self.F_eV, self.S, self.g, self.mu1, self.mu2, ind=-1,
                    N=self.Nnegf, T=self.T, exec_cfg=self.exec_cfg,
                    device=self.device, mesh=self.mesh)
            else:
                P = P + dens.density_grid(
                    self.F_eV, self.S, self.g, self.mu1, self.mu2, ind=-1,
                    tol=self.tol, T=self.T, exec_cfg=self.exec_cfg,
                    device=self.device, mesh=self.mesh)

        # occupations in the orthogonalized Fock eigenbasis (scfE.py:448-455).
        # A pure diagnostic (only the verbose SCF printout consumes it) of
        # one host eigh and three N^3 complex products: skipped when not
        # verbose.
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
