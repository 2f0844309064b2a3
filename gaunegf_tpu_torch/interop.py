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
from gaunegf_tpu_torch.models import slater_koster as sk
from gaunegf_tpu_torch.models.bethe import BetheSelfEnergy
from gaunegf_tpu_torch.models.chain1d import Chain1DSelfEnergy
from gaunegf_tpu_torch.models.fock import MatrixFock
from gaunegf_tpu_torch.models.lattice3d import Lattice3DSelfEnergy
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy, form_sigma
from gaunegf_tpu_torch.scfe import NEGFE

__all__ = ["constant_self_energy_from_arrays",
           "chain1d_self_energy_from_arrays",
           "bethe_self_energy_from_arrays",
           "lattice3d_self_energy_from_arrays", "negfe_from_arrays"]


def constant_self_energy_from_arrays(F, S, inds, sig1, sig2, *,
                                     device=None):
    """ConstantSelfEnergy over (F, S) with contacts inds = (l_ind, r_ind)
    (orbital indices) and their sigma values (scalar, vector or matrix);
    ``device`` is where its one-energy methods evaluate."""
    return ConstantSelfEnergy(np.asarray(F), np.asarray(S),
                              [np.asarray(i, dtype=int) for i in inds],
                              np.asarray(sig1), np.asarray(sig2),
                              device=device)


def chain1d_self_energy_from_arrays(F, S, inds_list, taus=None, staus=None,
                                    alphas=None, a_overlaps=None, betas=None,
                                    b_overlaps=None, eta=ETA, method="sancho",
                                    conv=SURFACE_GREEN_CONVERGENCE, *,
                                    device=None):
    """Chain1DSelfEnergy over (F, S) from the arrays a 1D-chain provider
    is built from: contact orbital indices, and optionally the coupling
    indices or matrices (taus/staus) and the lead blocks (alphas,
    a_overlaps, betas, b_overlaps); ``device`` is where its one-energy
    methods evaluate."""
    def arrays(xs):
        return None if xs is None else [np.asarray(x) for x in xs]
    return Chain1DSelfEnergy(
        np.asarray(F), np.asarray(S),
        [np.asarray(i, dtype=int) for i in inds_list], taus=arrays(taus),
        staus=arrays(staus), alphas=arrays(alphas),
        a_overlaps=arrays(a_overlaps), betas=arrays(betas),
        b_overlaps=arrays(b_overlaps), eta=float(eta), method=method,
        conv=float(conv), device=device)


def _bethe_from_arrays(cls, F, S, ne, onsite, hopping, overlap, inds_lists,
                       n_ind_lists, dir_lists, fermi, spin, eta, T, device):
    """A provider of class ``cls`` with the detected geometry given, not
    detected: the constructor runs on no contact, then each contact is
    added from its arrays."""
    params_sk = sk.BetheParams(
        ne=float(ne), onsite={k: float(v) for k, v in onsite.items()},
        hopping={k: float(v) for k, v in hopping.items()},
        overlap={k: float(v) for k, v in overlap.items()})
    prov = cls(np.asarray(F), np.asarray(S), [], None, lat_file=params_sk,
               spin=spin, eta=float(eta), T=float(T), fermi=float(fermi),
               device=device, verbose=False)
    for inds_list, n_inds, n_vecs in zip(inds_lists, n_ind_lists, dir_lists):
        prov._add_contact(inds_list, n_inds, np.asarray(n_vecs, dtype=float))
    for g in prov.g_list:
        g.fermi = float(fermi)
    return prov


def bethe_self_energy_from_arrays(F, S, ne, onsite, hopping, overlap,
                                  inds_lists, n_ind_lists, dir_lists, fermi,
                                  spin="r", eta=ETA, T=TEMPERATURE, *,
                                  device):
    """BetheSelfEnergy over (F, S) from a Bethe provider's host state:
    the parameter set (electron count ``ne`` and the onsite / hopping /
    overlap dictionaries, in eV), per contact the atoms' orbital indices
    (inds_lists), their matched direction slots (n_ind_lists) and the 12
    neighbour directions (dir_lists), the lattice Fermi level, the spin
    layout, eta and T.  No geometry is detected.  ``device`` is the
    provider's (where S^(1/2) of an orthogonal set is computed)."""
    return _bethe_from_arrays(BetheSelfEnergy, F, S, ne, onsite, hopping,
                              overlap, inds_lists, n_ind_lists, dir_lists,
                              fermi, spin, eta, T, device)


def lattice3d_self_energy_from_arrays(F, S, ne, onsite, hopping, overlap,
                                      inds_lists, n_ind_lists, dir_lists,
                                      fermi, spin="r", eta=ETA,
                                      T=TEMPERATURE, phases=None, syms=None,
                                      nk=4, *, device):
    """Lattice3DSelfEnergy from a 3D-lattice provider's host state: the
    arrays of bethe_self_energy_from_arrays and, for the k-space mode, per
    contact the Bloch phases (plane_ph (Nk, 6), down_ph (Nk, 3)) and the
    symmetry data ((mask, D) or None); phases=None gives the gamma-point
    mode."""
    prov = _bethe_from_arrays(Lattice3DSelfEnergy, F, S, ne, onsite, hopping,
                              overlap, inds_lists, n_ind_lists, dir_lists,
                              fermi, spin, eta, T, device)
    if phases is not None:
        prov.kspace = True
        prov.nk = int(nk)
        prov._phases = [(np.asarray(pp, dtype=np.complex128),
                         np.asarray(dp, dtype=np.complex128))
                        for pp, dp in phases]
        syms = syms if syms is not None else [None] * len(prov._phases)
        prov._syms = [None if sy is None else
                      (np.asarray(sy[0], dtype=float),
                       np.asarray(sy[1], dtype=float)) for sy in syms]
    return prov


def negfe_from_arrays(F, S, P, locs, n_electrons, inds, sig1, sig2, fermi,
                      qV, Emin, N1, N2, Nnegf, *, device, backend=None,
                      T=TEMPERATURE, Eminf=ENERGY_MIN, exec_cfg=None,
                      name="negf", verbose=False, spin="r",
                      fermi_method="muller", tol=ADAPTIVE_INTEGRATION_TOL,
                      provider=None):
    """A NEGFE in the given state.

    F, S, P: Fock (eV), overlap and density in the layout of ``spin``;
    locs: orbital -> atom map; inds = (l_ind, r_ind) contact orbital
    indices with sigmas sig1, sig2 (full size); qV: the bias; Emin, N1,
    N2, Nnegf: the grids, each None for its adaptive route, with
    tolerance ``tol``.  fermi: the fixed Fermi level, or None for a level
    updated every cycle by ``fermi_method`` (upd_fermi=True), starting
    between HOMO and LUMO as setVoltage does.
    backend: the FockProvider of later Fock rebuilds (default: a
    MatrixFock holding F fixed).
    provider: the Bethe contact form -- a self-energy provider built over
    (F, S), e.g. by bethe_self_energy_from_arrays, which becomes the
    contacts instead of the constant sig1, sig2 (pass those as None)."""
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
    if provider is not None:
        negfe.g = provider
    else:
        negfe._sig1, negfe._sig2 = np.asarray(sig1), np.asarray(sig2)
        negfe.sigma1 = form_sigma(l_ind, sig1, negfe.nsto, S)
        negfe.sigma2 = form_sigma(r_ind, sig2, negfe.nsto, S)
        negfe.sigma12 = negfe.sigma1 + negfe.sigma2
        negfe.Gam1 = 1j * (negfe.sigma1 - negfe.sigma1.conj().T)
        negfe.Gam2 = 1j * (negfe.sigma2 - negfe.sigma2.conj().T)
        negfe.g = constant_self_energy_from_arrays(F, S, (l_ind, r_ind),
                                                   sig1, sig2,
                                                   device=negfe.device)

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
