"""Semi-infinite 1D-chain surface Green's function self-energy.

Port of ``gaunegf_tpu/models/chain1d.py`` (reference surfG1D.surfG,
surfG1D.py:13-399): the construction patterns (auto-extraction from F/S,
custom coupling, fully specified contacts), chemical-potential shifting
via set_fock, and the provider protocol.

Both fixed-point solvers take a batch of energies -- A and B are
(b, n, n) -- and converge per energy: a lane stops once its own
convergence metric passes ``conv`` (the JAX package's vmapped while_loop),
the loop once every lane has stopped or ``max_iter`` is reached.

* ``surface_g_sancho``: Lopez Sancho-Rubio decimation with balanced
  couplings and a joint power-of-two exponent (quadratic convergence; the
  balancing keeps the doubling transients from overflowing).
* ``surface_g_dyson``: the reference's relaxed fixed point
  g <- relax * inv(A - B g B+) + (1 - relax) * g.

The providers evaluate the surface fixed points in complex128 whatever
the operator dtype of the tier (contact blocks are small): on the card
one launch of the kernel ``csrc/sancho_rubio.cu`` per call runs the whole
loop, on the CPU the plain loop of ``ops/kernels/sancho_rubio.py`` inverts
with ``torch.linalg.inv``; the double-word provider (``*_dw``) of the JAX
package is not ported.  The warm interface (``contacts_warm_apply``) is:
one fixed-point solve per contact and energy serves Sigma_total and both
Gammas, with no seeding from the previous energy.  ``warm_profitable`` is
False, as in the JAX package, so the warm-started engines take chains only
under ``ExecutionConfig(warm_start="force")``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from gaunegf_tpu_torch.config import (
    ETA, SURFACE_GREEN_CONVERGENCE, SURFACE_MAX_ITER_1D,
    SURFACE_RELAXATION_FACTOR)
from gaunegf_tpu_torch.models.selfenergy import _CompatMixin, tree_map
from gaunegf_tpu_torch.ops.greens import resolve_device
from gaunegf_tpu_torch.ops.kernels import sancho_rubio as _srk
from gaunegf_tpu_torch.utils.logging import perf_count, perf_span

__all__ = ["Chain1DSelfEnergy", "surface_g_sancho", "surface_g_dyson"]


def _dagger(M):
    return M.conj().transpose(-1, -2)


def surface_g_sancho(A, B, conv=SURFACE_GREEN_CONVERGENCE, max_iter=64):
    """Surface GF g = inv(A - B g B+) by Sancho-Rubio decimation, for a
    batch A, B (b, n, n).

    A = (E + i*eta) * S_alpha - alpha   (renormalized "omega - h" block)
    B = (E + i*eta) * S_beta - beta     (renormalized hopping block)

    Each iteration doubles the effective chain length.  Near a band
    feature the doubling drives al and be in opposite exponential
    directions while only their products enter the eps updates, so both
    are renormalized to max-norm 1 each step (a power of two, so exactly)
    and the joint log2 scale c is carried: agb = (al g be) * 2^c,
    c' = 2c + log2(sa * sb).  On a CUDA tensor the whole loop is one launch
    of the kernel ``csrc/sancho_rubio.cu`` (complex128); on a CPU tensor
    the plain loop runs (``ops/kernels/sancho_rubio.py``)."""
    return _srk.decimate(A, B, conv, max_iter, "sancho")[0]


def surface_g_dyson(A, B, conv=SURFACE_GREEN_CONVERGENCE,
                    relax=SURFACE_RELAXATION_FACTOR,
                    max_iter=SURFACE_MAX_ITER_1D):
    """Reference-faithful relaxed Dyson fixed point (surfG1D.py:264-295)
    for a batch A, B (b, n, n): g <- relax * inv(A - B g B+) +
    (1 - relax) * g from g0 = inv(A), with the reference's relative-change
    convergence metric.  Kernel or plain loop as ``surface_g_sancho``."""
    return _srk.decimate(A, B, conv, max_iter, "dyson", relax)[0]


def _surface_g(contact, E, eta, method, conv):
    """Surface GF of one contact at the energies E (b,), complex128; the
    b lanes it hands the decimation are the counter chain.lanes."""
    perf_count("chain.lanes", E.shape[0])
    zE = (E + 1j * eta)[:, None, None]
    A = zE * contact["Salpha"] - contact["alpha"]
    B = zE * contact["Sbeta"] - contact["beta"]
    if method == "dyson":
        return surface_g_dyson(A, B, conv)
    return surface_g_sancho(A, B, conv)


def _sigma_block(contact, E, eta, conv, method):
    """t g_surf t+ with t = E stau - tau, for the energies E (b,),
    evaluated in complex128 and returned in the params' dtype; the span
    chain.sigma."""
    with perf_span("chain.sigma"):
        dt = contact["alpha"].dtype
        c = tree_map(lambda v: v.to(torch.complex128), contact)
        E = E.to(torch.complex128)
        g = _surface_g(c, E, eta, method, conv)
        t = E[:, None, None] * c["stau"] - c["tau"]
        return (t @ g @ _dagger(t)).to(dt)


def _embed(blks, inds, N):
    """The blocks blks[k] (b, n_k, n_k) added, in order, into one zero
    (b, N, N) self-energy at the orbitals inds[k]; the span chain.embed."""
    with perf_span("chain.embed"):
        sig = torch.zeros((blks[0].shape[0], N, N), dtype=blks[0].dtype,
                          device=blks[0].device)
        for blk, ind in zip(blks, inds):
            i = torch.as_tensor(ind, device=blk.device)
            sig[:, i[:, None], i[None, :]] += blk
        return sig


@lru_cache(maxsize=None)
def _chain_contact_fn(static_key, i: int):
    """Pure sigma_i(params, E) -> (b, N, N), with identity cached on the
    static geometry."""
    inds, N, eta, method, conv = static_key

    def fn(params, E):
        blk = _sigma_block(params["contacts"][i], E, eta, conv, method)
        return _embed([blk], [inds[i]], N)

    return fn


@lru_cache(maxsize=None)
def _chain_total_fn(static_key):
    inds, N, eta, method, conv = static_key

    def fn(params, E):
        return _embed([_sigma_block(params["contacts"][i], E, eta, conv,
                                    method) for i in range(len(inds))],
                      inds, N)

    return fn


@lru_cache(maxsize=None)
def _chain_contacts_warm_fn(static_key):
    """Warm provider fn: (params, E, state) -> (per-contact sigmas, state).

    Each contact's surface fixed point is solved once per energy and
    shared by Sigma_tot and both Gammas in the warm engines.  The state is
    passed through untouched: there is deliberately no cross-energy
    seeding.  The defect iteration g <- inv(A - B g B+) has spurious
    attracting fixed points near surface band features; the JAX package
    caught one at E=1.4231 (perfect chain, eta=1e-4), where the previous
    energy's seed converged to a solution 2.8 away from the retarded g and
    T(E) came out wrong by 0.47.  Sancho-Rubio decimation constructs the
    retarded branch and converges quadratically, so seeding buys little."""
    fns = [_chain_contact_fn(static_key, i)
           for i in range(len(static_key[0]))]

    def fn(params, E, state):
        return tuple(f(params, E) for f in fns), state

    return fn


class Chain1DSelfEnergy(_CompatMixin):
    """1D-chain contact self-energy provider.

    Construction patterns (mirroring surfG1D.py:83-165):

    a) ``Chain1DSelfEnergy(F, S, [inds1, inds2])`` -- onsite and coupling
       blocks extracted from F/S; the adjacent-cell indices default to
       ``[inds2, inds1]`` (periodic 2-cell assumption).
    b) ``Chain1DSelfEnergy(F, S, inds_list, taus=[ind1c, ind2c])`` -- contact
       connection indices given; tau blocks read from F/S.
    c) full specification with ``taus/staus`` as matrices and
       ``alphas/a_overlaps/betas/b_overlaps``.

    ``device`` is where the one-energy methods (``surface_g``, ``sigma``,
    ``sigmaTot``) evaluate; the engines take theirs from the caller.
    """

    # chain contacts do not profit from warm-started fixed points (the JAX
    # package measured them slower); the engines take the warm interface
    # only under ExecutionConfig(warm_start="force")
    warm_profitable = False

    def __init__(self, Fock, Overlap, inds_list, taus=None, staus=None,
                 alphas=None, a_overlaps=None, betas=None, b_overlaps=None,
                 eta: float = ETA, method: str = "sancho",
                 conv: float = SURFACE_GREEN_CONVERGENCE, *, device=None):
        self.device = device
        self.F = np.asarray(Fock, dtype=complex)
        self.S = np.asarray(Overlap)
        self.inds_list = [np.asarray(i, dtype=int) for i in inds_list]
        self.eta = float(eta)
        self.method = method
        self.conv = float(conv)
        self.fermi_list = [None] * len(self.inds_list)
        if method == "dyson":
            # no warm interface for the reference-faithful Dyson fixed
            # point: the engines take the cold path, as in the JAX package
            self.contacts_warm_apply = None

        if taus is None:
            taus = [self.inds_list[-1], self.inds_list[0]]
        taus = [np.asarray(t) for t in taus]
        if taus[0].ndim == 1:
            self.tau_from_fock = True
            self.tau_inds = [t.astype(int) for t in taus]
            self._extract_taus()
        else:
            self.tau_from_fock = False
            self.tau_list = [np.asarray(t, dtype=complex) for t in taus]
            self.stau_list = [np.asarray(st) for st in staus]

        if alphas is None:
            self.contact_from_fock = True
            self._extract_contacts()
        else:
            self.contact_from_fock = False
            self.a_list = [np.asarray(a, dtype=complex) for a in alphas]
            self.aS_list = [np.asarray(a) for a in a_overlaps]
            self.b_list = [np.asarray(b, dtype=complex) for b in betas]
            self.bS_list = [np.asarray(b) for b in b_overlaps]

    # -- construction helpers ------------------------------------------
    def _extract_taus(self):
        t0, t1 = self.tau_inds
        i0, i1 = self.inds_list[0], self.inds_list[-1]
        self.tau_list = [self.F[np.ix_(t0, i0)], self.F[np.ix_(t1, i1)]]
        self.stau_list = [self.S[np.ix_(t0, i0)], self.S[np.ix_(t1, i1)]]

    def _extract_contacts(self):
        self.a_list = [self.F[np.ix_(i, i)] for i in self.inds_list]
        self.aS_list = [self.S[np.ix_(i, i)] for i in self.inds_list]
        self.b_list = [np.asarray(t) for t in self.tau_list]
        self.bS_list = [np.asarray(t) for t in self.stau_list]

    # -- pure API -------------------------------------------------------
    def params(self):
        """Host-side NumPy params, one dict per contact."""
        return {
            "contacts": tuple(
                {
                    "alpha": np.asarray(self.a_list[i], dtype=complex),
                    "Salpha": np.asarray(self.aS_list[i]),
                    "beta": np.asarray(self.b_list[i], dtype=complex),
                    "Sbeta": np.asarray(self.bS_list[i]),
                    "tau": np.asarray(self.tau_list[i] if i < len(self.tau_list)
                                      else self.tau_list[-1], dtype=complex),
                    "stau": np.asarray(self.stau_list[i] if i < len(self.stau_list)
                                       else self.stau_list[-1]),
                }
                for i in range(len(self.inds_list))
            ),
        }

    def _static_key(self):
        return (tuple(tuple(int(j) for j in i) for i in self.inds_list),
                self.F.shape[0], self.eta, self.method, self.conv)

    def num_contacts(self) -> int:
        return len(self.inds_list)

    def surface_g(self, E, i, conv=None):
        """Surface Green's function of contact i at (possibly complex) E,
        computed on ``self.device``, as a complex128 NumPy array."""
        conv = self.conv if conv is None else conv
        device = resolve_device(self.device)
        contact = tree_map(
            lambda v: torch.as_tensor(np.asarray(v, dtype=np.complex128),
                                      device=device),
            self.params()["contacts"][i % len(self.inds_list)])
        E_t = torch.tensor([complex(E)], dtype=torch.complex128,
                           device=device)
        return _surface_g(contact, E_t, self.eta, self.method,
                          float(conv))[0].cpu().numpy()

    def total_apply(self):
        """(pure_fn(params, E), params) with a cache-stable fn identity."""
        return _chain_total_fn(self._static_key()), self.params()

    def contact_apply(self, i: int):
        i = i % len(self.inds_list)
        return _chain_contact_fn(self._static_key(), i), self.params()

    def contact_inds(self, i=None):
        """Static contact support for the low-rank fast path."""
        if i is None:
            return tuple(sorted({int(j) for inds in self.inds_list
                                 for j in inds}))
        return tuple(int(j) for j in self.inds_list[i % len(self.inds_list)])

    def _warm_init(self):
        """Per-contact states -1j * I (the JAX package's seeds), which the
        chain's warm fn carries without reading."""
        return tuple(-1j * np.eye(len(a), dtype=np.complex128)
                     for a in self.a_list)

    def contacts_warm_apply(self, conv=None):
        """(fn(params, E, state) -> (sigs_tuple, state), params, init):
        every contact's sigma from one Sancho-Rubio solve per energy, at
        ``conv`` where given, else the provider's own."""
        key = self._static_key()
        if conv is not None:
            key = key[:-1] + (float(conv),)
        return (_chain_contacts_warm_fn(key), self.params(),
                self._warm_init())

    def set_fock(self, F, mu1=None, mu2=None):
        """Update F; replicate surfG1D.setF semantics (surfG1D.py:297-342).

        * auto-extracted couplings: the contact onsite blocks are overwritten
          by the adjacent-cell blocks (periodicity enforcement), then tau and
          stau re-extracted;
        * fully-specified contacts: onsite alpha shifted by (mu - fermi) * I
          and beta by (mu - fermi) * S_beta to realign the lead Fermi level.
        """
        self.F = np.asarray(F, dtype=complex)
        if self.tau_from_fock:
            t0, t1 = self.tau_inds
            i0, i1 = self.inds_list[0], self.inds_list[-1]
            self.F[np.ix_(i0, i0)] = self.F[np.ix_(t0, t0)]
            self.F[np.ix_(i1, i1)] = self.F[np.ix_(t1, t1)]
            self._extract_taus()
        if self.contact_from_fock:
            self._extract_contacts()
        else:
            if self.fermi_list[0] is None:
                self.fermi_list[0] = mu1
                self.fermi_list[-1] = mu2
            else:
                for i, mu in zip([0, -1], [mu1, mu2]):
                    fermi = self.fermi_list[i]
                    if fermi is not None and mu is not None and fermi != mu:
                        dmu = mu - fermi
                        self.a_list[i] = self.a_list[i] + dmu * np.eye(
                            len(self.a_list[i]))
                        self.b_list[i] = self.b_list[i] + dmu * self.bS_list[i]
                        self.fermi_list[i] = mu

    def set_contacts(self, alphas=None, a_overlaps=None, betas=None,
                     b_overlaps=None):
        """Re-set contact parameters (surfG1D.py:167-222 semantics).

        Contacts extracted from F/S (patterns a/b) are re-extracted and
        any provided arguments are ignored; fully-specified contacts
        (pattern c) require all four arguments together.
        """
        if self.contact_from_fock:
            self._extract_contacts()
            return
        if any(x is None for x in (alphas, a_overlaps, betas, b_overlaps)):
            raise ValueError(
                "fully-specified contacts require alphas, aOverlaps, betas "
                "and bOverlaps together (partial updates unsupported)")
        self.a_list = [np.asarray(a, dtype=complex) for a in alphas]
        self.aS_list = [np.asarray(a) for a in a_overlaps]
        self.b_list = [np.asarray(b, dtype=complex) for b in betas]
        self.bS_list = [np.asarray(b) for b in b_overlaps]

    # aliases used by Fermi-search helpers on sub-providers
    @property
    def aList(self):
        return self.a_list

    @property
    def aSList(self):
        return self.aS_list

    @property
    def bList(self):
        return self.b_list

    @property
    def bSList(self):
        return self.bS_list
