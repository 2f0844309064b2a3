"""NEGF-SCF driver base: state, contacts, mixing and the SCF loop.

Port of ``gaunegf_tpu/scf.py``'s NEGF class (reference scf.py:134-813)
over the FockProvider protocol.  Host-side state (F, P, S, the Pulay
window) stays NumPy; the density builds of the subclasses run on the
device named by ``device``.

All four spin layouts ('r', 'u', 'ro', 'g'; see spin.py) are carried.
``NEGF.FockToP`` is the analytic energy-independent density route
(``density_analytic`` / ``bisect_fermi``), host NumPy as in the JAX
package; the energy-dependent class ``scfe.NEGFE`` replaces it with the
contour integrals on the device.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gaunegf_tpu_torch import spin as spinmod
from gaunegf_tpu_torch.config import (
    ENERGY_MIN, FERMI_CALCULATION_TOL, PULAY_MIXING_SIZE, SCF_CONVERGENCE_TOL,
    SCF_DAMPING, SCF_MAX_CYCLES, ExecutionConfig)
from gaunegf_tpu_torch.density import bisect_fermi, density_analytic
from gaunegf_tpu_torch.io import checkpoint as ckpt
from gaunegf_tpu_torch.models.selfenergy import form_sigma
from gaunegf_tpu_torch.ops import zlinalg as zl
from gaunegf_tpu_torch.ops.greens import resolve_device
from gaunegf_tpu_torch.units import V_TO_AU
from gaunegf_tpu_torch.utils.logging import perf_span

__all__ = ["NEGF"]


class NEGF:
    """Self-consistent NEGF driver state and loop.

    Parameters
    ----------
    backend : FockProvider
        Electronic-structure backend (TightBindingFock / MatrixFock /
        GaussianFock).
    spin : {'r', 'u', 'ro', 'g'}
    name : checkpoint base name (default 'negf')
    device : torch device of the density builds ('cuda', 'cpu', ...);
        required, never chosen by the driver.
    mesh : optional ('e', 'm') mesh (parallel/mesh.energy_mesh) over which
        the energy integrals shard; ``device`` must then be the rank's
        (``mesh.device``).

    Under a mesh every rank runs this same host program, and the engines
    hand every rank the same bits (one reduction over 'e' per sum, the
    same gathers).  So every host decision is taken on replicated values
    and every rank issues the same sequence of collectives: the Pulay
    gate, the SCF convergence test, each step of a Fermi search, the
    stopping tests of the adaptive routes, and the routing between the
    spectral route and the LU.  Code that decides on anything a rank
    holds alone (its share of the grid, its device's clock) breaks that.
    """

    def __init__(self, backend, spin="r", name="negf",
                 n_pulay=PULAY_MIXING_SIZE, exec_cfg=None, *, device,
                 mesh=None, verbose=True):
        if spin not in ("r", "u", "ro", "g"):
            raise ValueError(f"unknown spin {spin!r}")
        self.device = resolve_device(device, mesh)
        self.mesh = mesh
        self.backend = backend
        self.spin = spin
        self.name = name
        self.verbose = verbose
        self.exec_cfg = exec_cfg or ExecutionConfig()
        self.energy_dep = False

        self.Eminf = ENERGY_MIN
        self.fermi = None
        self.upd_fermi = False
        self.qV = 0.0

        self.start_time = time.time()
        self.S = np.asarray(backend.overlap())
        self.P = np.asarray(backend.initial_density())
        self.F = np.asarray(backend.initial_fock())
        self.locs = np.asarray(backend.locs)
        self.nsto = self.S.shape[0]
        self.f_to_eV = float(backend.f_to_eV)
        S_t = torch.as_tensor(self.S, dtype=torch.float64, device=self.device)
        self.X = zl.fractional_matrix_power(S_t, -0.5).cpu().numpy()

        ne = backend.n_electrons
        multip = getattr(backend, "multiplicity", 1)
        self.nae = int(ne / 2 + (multip - 1) / 2)
        self.nbe = int(ne / 2 - (multip - 1) / 2)

        orbs, _ = np.linalg.eig(self.X @ self.F @ self.X)
        self.Emin = float(np.min(orbs.real)) * self.f_to_eV - 5
        self.Emax = float(np.max(orbs.real)) * self.f_to_eV
        self.conv_level = 9999.0
        self.MaxDP = 9999.0
        self.total_E = getattr(backend, "initial_energy", 0.0)

        # Pulay/DIIS buffers (scf.py:191-196 layout).  Python lists of
        # (N, N) arrays, so the per-cycle window shift moves pointers, not
        # matrices; the Gram block of the untouched init slots (constant
        # 1e4 arrays) is analytic, so PMix computes only the new row.
        self.p_list = [self.P.astype(complex) for _ in range(n_pulay)]
        self.dp_list = [np.full((self.nsto, self.nsto), 1e4 + 0j)
                        for _ in range(n_pulay)]
        self.p_mat = np.ones((n_pulay + 1, n_pulay + 1), dtype=complex) * -1
        self.p_mat[-1, -1] = 0
        self.p_mat[:n_pulay, :n_pulay] = 1e8 * self.nsto ** 2
        self.p_b = np.zeros(n_pulay + 1)
        self.p_b[-1] = -1
        self._P_stored = self.P.copy()
        self.backend.store_density(self.P)
        self.updateN()

    # ------------------------------------------------------------------
    @property
    def F_eV(self):
        return self.F * self.f_to_eV

    def updateN(self):
        # trace(P @ S) without the GEMM: O(N^2)
        n_occ = float(np.real(np.einsum("ij,ji->", self.P, self.S)))
        self.nelec = 2 * n_occ if self.spin == "r" else n_occ
        return self.nelec

    def setDen(self, P):
        self.P = np.asarray(P)
        self.backend.store_density(self.P)
        self._P_stored = self.P.copy()
        self.updateN()
        if self.verbose:
            print(f"Density matrix loaded, nelec = {self.nelec:.2f} electrons")
        self.PToFock()

    def setFock(self, F_):
        """Set the Fock matrix from eV units (reference scf.py:268-277):
        the stored unit is the backend's, so input / f_to_eV."""
        self.F = np.asarray(F_) / self.f_to_eV

    def runDFT(self, fullSCF=True):
        """Re-run the backend's initial SCF / Harris guess and reload F
        (reference scf.py:210-246).

        For GaussianFock this replays the checkpoint-or-SCF bootstrap
        (dofock=True falling back to dofock='scf', or the GUESS route);
        synthetic backends just hand back their initial Fock.  Returns
        the refreshed Fock matrix (backend units).
        """
        run = getattr(self.backend, "_run_initial", None)
        if run is not None:
            run(fullSCF)
        self.F = np.asarray(self.backend.initial_fock())
        locs = getattr(self.backend, "locs", None)
        if locs is not None:
            self.locs = np.asarray(locs)
        return self.F

    def getHOMOLUMO(self):
        orbs, _ = np.linalg.eig(self.X @ self.F @ self.X)
        orbs = np.sort(orbs) * self.f_to_eV
        if self.spin == "r":
            return orbs[self.nae - 1:self.nae + 1].real
        return orbs[self.nae + self.nbe - 1:self.nae + self.nbe + 1].real

    # ------------------------------------------------------------------
    def setContacts(self, l_contact=None, r_contact=None):
        """Resolve contact atom numbers to orbital indices via locs
        (scf.py:392-423)."""
        n_atoms = int(np.max(np.abs(self.locs)))
        self.l_contact = (np.arange(n_atoms) + 1 if l_contact is None
                          else np.asarray(l_contact))
        self.r_contact = (np.arange(n_atoms) + 1 if r_contact is None
                          else np.asarray(r_contact))
        l_ind = np.where(np.isin(np.abs(self.locs), self.l_contact))[0]
        r_ind = np.where(np.isin(np.abs(self.locs), self.r_contact))[0]
        return l_ind, r_ind

    def setSigma(self, l_contact=None, r_contact=None, sig=-0.1j, sig2=None):
        """Constant self-energies with spin-aware shape handling
        (scf.py:426-521): a vector or matrix sigma matches the contact's
        orbital count, or half of it, and the half-length form is expanded
        over both spins of the layout."""
        l_ind, r_ind = self.setContacts(l_contact, r_contact)
        if sig2 is None:
            sig2 = sig + 0.0
        sig = np.asarray(sig)
        sig2 = np.asarray(sig2)
        if sig.ndim != sig2.ndim:
            raise ValueError("Sigma matrix dimension mismatch!")
        if sig.ndim in (1, 2):
            full = len(sig) == len(l_ind) and len(sig2) == len(r_ind)
            half = (len(sig) == len(l_ind) / 2
                    and len(sig2) == len(r_ind) / 2)
            if not (full or half):
                raise ValueError("Sigma matrix dimension mismatch!")
            if not full:
                expand = (spinmod.expand_vector if sig.ndim == 1
                          else spinmod.expand_matrix)
                sig = expand(sig, self.spin)
                sig2 = expand(sig2, self.spin)
        self.l_ind = l_ind
        self.r_ind = r_ind
        # the expanded values, kept for NEGFE's provider
        self._sig1 = sig
        self._sig2 = sig2
        self.sigma1 = form_sigma(l_ind, sig, self.nsto, self.S)
        self.sigma2 = form_sigma(r_ind, sig2, self.nsto, self.S)
        self.sigma12 = self.sigma1 + self.sigma2
        if self.verbose:
            print("Max imag sigma:",
                  np.max(np.abs(np.imag(self.sigma12))))
        self.Gam1 = 1j * (self.sigma1 - self.sigma1.conj().T)
        self.Gam2 = 1j * (self.sigma2 - self.sigma2.conj().T)
        return l_ind, r_ind

    def getSigma(self, E=0):
        return self.sigma1, self.sigma2

    def setVoltage(self, qV, fermi=np.nan, Emin=None, Eminf=None):
        """Bias + chemical potentials + contact-dipole E-field
        (scf.py:318-390)."""
        if not (hasattr(self, "l_ind") and hasattr(self, "r_ind")):
            raise RuntimeError("Contacts not set!")
        if np.isnan(fermi):
            self.upd_fermi = True
            if self.fermi is None:
                hl = self.getHOMOLUMO()
                if self.verbose:
                    print(f"Setting initial Fermi energy between HOMO "
                          f"({hl[0]:.2f} eV) and LUMO ({hl[1]:.2f} eV)")
                fermi = float(np.sum(hl) / 2)
            else:
                fermi = self.fermi
        else:
            self.upd_fermi = False
        if Emin is not None:
            self.Emin = Emin
        if Eminf is not None:
            self.Eminf = Eminf
        self.fermi = fermi
        self.qV = qV
        self.mu1 = fermi + qV / 2
        self.mu2 = fermi - qV / 2

        coords = self.backend.atom_coords()
        if coords is not None:
            l_at = coords[np.asarray(self.l_contact, dtype=int) - 1]
            r_at = coords[np.asarray(self.r_contact, dtype=int) - 1]
            vec = np.mean(l_at, axis=0) - np.mean(r_at, axis=0)
            dist = np.linalg.norm(vec)
            if dist == 0:
                print("WARNING: left and right contact atoms identical, "
                      "E-field set to zero!")
                field = np.zeros(3)
            else:
                field = -vec / dist * qV * V_TO_AU / (dist * 1e-4)
            self.backend.set_field(field)

    # ------------------------------------------------------------------
    def FockToP(self):
        """Analytic density from the orthogonalized Fock eigensystem
        (scf.py:527-595).  Runs on the host in NumPy, as in the JAX
        package: one general eigendecomposition of a complex
        non-Hermitian N x N matrix per cycle and closed-form sums."""
        X = self.X
        Fbar = X @ (self.F_eV + self.sigma12) @ X
        GamBar1 = X @ self.Gam1 @ X
        GamBar2 = X @ self.Gam2 @ X
        D, V = np.linalg.eig(Fbar)
        Vc = np.linalg.inv(V.conj().T)

        if self.upd_fermi:
            n_exp = self.backend.n_electrons
            conv = min(self.conv_level, FERMI_CALCULATION_TOL)
            if self.spin == "r":
                n_exp /= 2
            self.fermi = bisect_fermi(V, Vc, D, GamBar1 + GamBar2, n_exp,
                                      conv, self.Eminf,
                                      verbose=self.verbose)
            self.setVoltage(self.qV)
            if self.verbose:
                print(f"Fermi Energy set to {self.fermi:.2f} eV")

        if self.mu1 == self.mu2:
            P = density_analytic(V, Vc, D, GamBar1 + GamBar2, self.Eminf,
                                 self.fermi)
        else:
            P1 = density_analytic(V, Vc, D, GamBar1, self.Eminf, self.mu1)
            P2 = density_analytic(V, Vc, D, GamBar2, self.Eminf, self.mu2)
            P = P1 + P2
        pshift = V.conj().T @ P @ V
        self.P = X @ P @ X
        occ = np.diag(np.real(pshift))
        energies = np.real(D).flatten()
        order = np.argsort(energies)
        return energies[order], occ[order]

    def PMix(self, damping, pulay=False):
        """Damped + Pulay/DIIS density mixing (scf.py:597-661)."""
        P_back = self._P_stored
        dense_diff = np.abs(np.diag(self.P) - np.diag(P_back))
        self.p_list.insert(0, P_back + damping * (self.P - P_back))
        self.p_list.pop()
        dp_new = self.P - P_back
        self.dp_list.insert(0, dp_new)
        self.dp_list.pop()
        # incremental DIIS Gram update: the window shifts by one per cycle,
        # so only the new residual's products change -- O(w N^2) instead
        # of O(w^2 N^2).  Unconjugated sums, matching the reference's
        # np.sum(v1 * v2) convention (scf.py:640-644).
        w = len(self.dp_list)
        self.p_mat[1:w, 1:w] = self.p_mat[:w - 1, :w - 1].copy()
        row = np.array([np.sum(dp_new * v) for v in self.dp_list])
        self.p_mat[0, :w] = row
        self.p_mat[1:w, 0] = row[1:]
        if pulay:
            # a singular or ill-conditioned DIIS window (residuals equal to
            # noise once converged) takes the damped step instead
            try:
                coeff = np.linalg.solve(self.p_mat, self.p_b)[:-1]
            except np.linalg.LinAlgError:
                coeff = None
            if coeff is not None and np.all(np.isfinite(coeff)) \
                    and np.sum(np.abs(coeff)) < 1e3:
                if self.verbose:
                    print("Applying Pulay Coeff: ", coeff)
                self.P = sum(self.p_list[i] * coeff[i]
                             for i in range(len(coeff)))
                self.p_list[0] = self.P
            else:
                if self.verbose:
                    print("Pulay window degenerate (converged to noise "
                          "floor); applying damping value=", damping)
                self.P = self.p_list[0]
        else:
            if self.verbose:
                print("Applying Damping value=", damping)
            self.P = self.p_list[0]
        self.backend.store_density(self.P)
        self._P_stored = self.P.copy()
        self.updateN()
        if self.verbose:
            print(f"Total number of electrons (NEGF): {self.nelec:.2f}")
        self.MaxDP = float(np.max(dense_diff))
        rmsdp = float(np.sqrt(np.mean(dense_diff ** 2)))
        if self.verbose:
            print(f"MaxDP: {self.MaxDP:.2E} | RMSDP: {rmsdp:.2E}")
        return rmsdp, self.MaxDP

    def PToFock(self):
        """Rebuild F from the stored density via the backend
        (scf.py:664-687).

        A transient backend failure invalidates the cycle (previous Fock
        and energy kept, flagged ``_fock_failed`` so SCF() never takes its
        dE=0 as convergence); 3 consecutive failures re-raise."""
        total_E_old = self.total_E
        self._fock_failed = False
        try:
            with perf_span("fock.build"):
                F, total_E = self.backend.fock(self._P_stored)
        except Exception as e:
            self._fock_failed = True
            self._fock_fail_streak = getattr(self, "_fock_fail_streak", 0) + 1
            if self._fock_fail_streak >= 3:
                print("ERROR: BACKEND FOCK BUILD FAILED 3 CYCLES IN A ROW")
                raise
            print("WARNING: BACKEND FOCK BUILD FAILED, CYCLE INVALID:")
            print(e)
            print("CONTINUING TO NEXT CYCLE...")
            return 0.0
        self._fock_fail_streak = 0
        self.F = np.asarray(F)
        self.total_E = total_E
        dE = self.total_E - total_E_old
        if self.verbose:
            print("SCF energy: ", self.total_E)
            print(f"Energy difference is: {dE:.3E}")
        return dE

    # ------------------------------------------------------------------
    def SCF(self, conv=SCF_CONVERGENCE_TOL, damping=SCF_DAMPING,
            max_cycles=SCF_MAX_CYCLES, checkpoint=True, pulay=True,
            callback=None):
        """Main Fock <-> density loop (scf.py:691-813): convergence when
        max(RMSDP, MaxDP, |dE|) < conv; density checkpoint saved whenever
        the convergence level improves and promoted to *_Final.mat.

        callback(self), if given, runs after each cycle's convergence
        update.  Each iteration is a span scf.cycle, the recorder's unit,
        with the spans scf.FockToP, scf.PMix and scf.PToFock inside
        (utils/logging)."""
        if not (hasattr(self, "mu1") and hasattr(self, "mu2")):
            raise RuntimeError("Voltage not set!")
        checkpoint_file = f"{self.name}_P.mat"
        final_file = f"{self.name}_Final.mat"
        # under a mesh rank 0 alone reads and writes the files, and every
        # rank starts from the density it read: ranks share the name and
        # the directory, and one that read a torn or missing file alone
        # would build another Fock matrix
        root = self.mesh is None or self.mesh.rank == 0
        if checkpoint:
            P = None
            if root and os.path.exists(checkpoint_file):
                try:
                    if self.verbose:
                        print(f"Found checkpoint file {checkpoint_file}, "
                              "loading...")
                    P, _ = ckpt.load_density(checkpoint_file)
                except Exception as e:  # a bad checkpoint must not stop SCF
                    print(f"Warning: checkpoint not loaded - Error: {e}")
            if self.mesh is not None:
                P = self.mesh.share(P)
            if P is not None:
                try:
                    self.setDen(P)
                except Exception as e:
                    print(f"Warning: checkpoint not loaded - Error: {e}")

        n_iter = 0
        min_conv = 9999.0
        counts, electrons, energies_hist = [], [], []
        if self.verbose:
            print("Entering NEGF-SCF loop at: " + time.asctime())
        occ_list = e_list = None
        while True:
            with perf_span("scf.cycle"):
                if self.verbose:
                    print(f"\nIteration {n_iter}:")
                is_pulay = pulay and (
                    (n_iter + 1) % (len(self.p_list) + 1) == 0)
                with perf_span("scf.FockToP"):
                    e_list, occ_list = self.FockToP()
                with perf_span("scf.PMix"):
                    rmsdp, maxdp = self.PMix(damping, is_pulay)
                with perf_span("scf.PToFock"):
                    dE = self.PToFock()
                energies_hist.append(self.total_E)
                counts.append(n_iter)
                electrons.append(self.nelec)
                self.conv_level = max(rmsdp, maxdp, abs(dE))
                if callback is not None:
                    callback(self)
                if getattr(self, "_fock_failed", False):
                    if n_iter >= max_cycles:
                        print("WARNING: Convergence criterion not met, "
                              "maxcycles reached!")
                        break
                    n_iter += 1
                    continue
                # checkpoint BEFORE the exit checks (scf.py:781-795)
                if self.conv_level < min_conv and checkpoint:
                    if root:
                        ckpt.save_density(checkpoint_file, self.P,
                                          self.conv_level)
                    min_conv = self.conv_level + 0.0
                if self.conv_level < conv:
                    if self.verbose:
                        print(f"Convergence achieved after {n_iter} "
                              "iterations!")
                    break
                if n_iter >= max_cycles:
                    print("WARNING: Convergence criterion not met, "
                          "maxcycles reached!")
                    break
                n_iter += 1

        if self.conv_level < conv and checkpoint and root:
            ckpt.promote_final(checkpoint_file, final_file)
        if checkpoint and self.mesh is not None:
            self.mesh.barrier()         # the files are in place on return
        if self.verbose:
            print("--- %s seconds ---" % (time.time() - self.start_time))
            hl = self.getHOMOLUMO()
            print(f"Predicted HOMO: {hl[0]:.2f} eV , Predicted LUMO "
                  f"{hl[1]:.2f} eV, Fermi: {self.fermi:0.2f}")
            if occ_list is not None:
                print("ENERGY LEVEL OCCUPATION:")
                for o, e in zip(occ_list, e_list):
                    print(f"Energy = {e:9.3f} eV | Occ = {o:5.3f}")
        return counts, electrons, energies_hist

    # ------------------------------------------------------------------
    def saveMAT(self, matfile="out.mat"):
        sigma1, sigma2 = self.getSigma(self.fermi)
        if self.mesh is None or self.mesh.rank == 0:    # one writer
            ckpt.save_results(matfile, F=self.F_eV, sig1=sigma1, sig2=sigma2,
                              S=self.S, fermi=self.fermi, qV=self.qV,
                              spin=self.spin, P=self.P, conv=self.conv_level)
        if self.mesh is not None:
            self.mesh.barrier()
        return self.X @ self.F @ self.X

    def writeChk(self):
        """Write the backend's checkpoint (GaussianFock: the .chk file);
        other backends have none."""
        if hasattr(self.backend, "write_chk"):
            self.backend.write_chk()
