"""Build this package's objects from plain NumPy state.

The functions take NumPy arrays and numbers only -- never objects of the
JAX package -- so a system set up anywhere (for instance in
``gaunegf_tpu``, then read out as arrays) can be rebuilt here and the two
packages compared like with like.
"""

from __future__ import annotations

import numpy as np

from gaunegf_tpu_torch.config import (
    ADAPTIVE_INTEGRATION_TOL, ENERGY_MIN, ETA, SURFACE_GREEN_CONVERGENCE,
    TEMPERATURE)
from gaunegf_tpu_torch.models.chain1d import Chain1DSelfEnergy
from gaunegf_tpu_torch.models.fock import MatrixFock
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy, form_sigma
from gaunegf_tpu_torch.scfe import NEGFE

__all__ = ["constant_self_energy_from_arrays",
           "chain1d_self_energy_from_arrays", "negfe_from_arrays"]


def constant_self_energy_from_arrays(F, S, inds, sig1, sig2):
    """ConstantSelfEnergy over (F, S) with contacts inds = (l_ind, r_ind)
    (orbital indices) and their sigma values (scalar, vector or matrix)."""
    return ConstantSelfEnergy(np.asarray(F), np.asarray(S),
                              [np.asarray(i, dtype=int) for i in inds],
                              np.asarray(sig1), np.asarray(sig2))


def chain1d_self_energy_from_arrays(F, S, inds_list, taus=None, staus=None,
                                    alphas=None, a_overlaps=None, betas=None,
                                    b_overlaps=None, eta=ETA, method="sancho",
                                    conv=SURFACE_GREEN_CONVERGENCE):
    """Chain1DSelfEnergy over (F, S) from the arrays a 1D-chain provider
    is built from: contact orbital indices, and optionally the coupling
    indices or matrices (taus/staus) and the lead blocks (alphas,
    a_overlaps, betas, b_overlaps)."""
    def arrays(xs):
        return None if xs is None else [np.asarray(x) for x in xs]
    return Chain1DSelfEnergy(
        np.asarray(F), np.asarray(S),
        [np.asarray(i, dtype=int) for i in inds_list], taus=arrays(taus),
        staus=arrays(staus), alphas=arrays(alphas),
        a_overlaps=arrays(a_overlaps), betas=arrays(betas),
        b_overlaps=arrays(b_overlaps), eta=float(eta), method=method,
        conv=float(conv))


def negfe_from_arrays(F, S, P, locs, n_electrons, inds, sig1, sig2, fermi,
                      qV, Emin, N1, N2, Nnegf, *, device, backend=None,
                      T=TEMPERATURE, Eminf=ENERGY_MIN, exec_cfg=None,
                      name="negf", verbose=False, spin="r",
                      fermi_method="muller", tol=ADAPTIVE_INTEGRATION_TOL):
    """A NEGFE in the given state.

    F, S, P: Fock (eV), overlap and density in the layout of ``spin``;
    locs: orbital -> atom map; inds = (l_ind, r_ind) contact orbital
    indices with sigmas sig1, sig2 (full size); qV: the bias; Emin, N1,
    N2, Nnegf: the grids, each None for its adaptive route, with
    tolerance ``tol``.  fermi: the fixed Fermi level, or None for a level
    updated every cycle by ``fermi_method`` (upd_fermi=True), starting
    between HOMO and LUMO as setVoltage does.
    backend: the FockProvider of later Fock rebuilds (default: a
    MatrixFock holding F fixed)."""
    F = np.asarray(F)
    S = np.asarray(S)
    P = np.asarray(P)
    if backend is None:
        backend = MatrixFock(F=F, S=S, P=P, n_electrons=n_electrons,
                             locs=np.asarray(locs))
    negfe = NEGFE(backend, spin, name, exec_cfg=exec_cfg, device=device,
                  verbose=verbose)
    negfe.F = F / negfe.f_to_eV
    negfe.locs = np.asarray(locs)
    negfe.P = P.copy()
    negfe._P_stored = P.copy()
    backend.store_density(P)
    negfe.updateN()

    l_ind, r_ind = (np.asarray(i, dtype=int) for i in inds)
    negfe.l_ind, negfe.r_ind = l_ind, r_ind
    negfe.l_contact = np.unique(np.abs(negfe.locs[l_ind]))
    negfe.r_contact = np.unique(np.abs(negfe.locs[r_ind]))
    negfe._sig1, negfe._sig2 = np.asarray(sig1), np.asarray(sig2)
    negfe.sigma1 = form_sigma(l_ind, sig1, negfe.nsto, S)
    negfe.sigma2 = form_sigma(r_ind, sig2, negfe.nsto, S)
    negfe.sigma12 = negfe.sigma1 + negfe.sigma2
    negfe.Gam1 = 1j * (negfe.sigma1 - negfe.sigma1.conj().T)
    negfe.Gam2 = 1j * (negfe.sigma2 - negfe.sigma2.conj().T)
    negfe.g = constant_self_energy_from_arrays(F, S, (l_ind, r_ind),
                                               sig1, sig2)

    negfe.Emin, negfe.Eminf = float(Emin), float(Eminf)
    negfe.N1, negfe.N2, negfe.Nnegf = N1, N2, Nnegf
    negfe.tol = tol
    negfe.T = T
    negfe.upd_fermi = fermi is None
    if negfe.upd_fermi:
        negfe.fermi_method = fermi_method
        fermi = np.sum(negfe.getHOMOLUMO()) / 2
    negfe.fermi = float(fermi)
    negfe.qV = float(qV)
    negfe.mu1 = negfe.fermi + negfe.qV / 2
    negfe.mu2 = negfe.fermi - negfe.qV / 2
    negfe.g.set_fock(negfe.F_eV, negfe.mu1, negfe.mu2)
    return negfe
