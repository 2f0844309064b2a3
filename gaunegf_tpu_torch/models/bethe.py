"""Bethe-lattice metallic-electrode self-energies (FCC [111] surface).

Port of ``gaunegf_tpu/models/bethe.py`` (reference surfGBethe.py):
geometry auto-detection from the contact atom coordinates (SVD surface
normal, 12-NN direction matching with orientation disambiguation),
Slater-Koster spd parameterization from .bethe files, bulk + surface
self-energy fixed points, contact Fermi-level determination, ANT-style
de-orthogonalization for orthogonal parameter sets, and spin expansion.

* All geometry runs once on the host (NumPy).
* The fixed points take a batch of energies E (b,): the bulk one iterates
  the 12 direction self-energies of every energy as one (b, 12, 9, 9)
  stack and converges per energy: a lane that has met ``conv`` is frozen,
  so the result does not depend on the other lanes.  On the card the
  bulk and the surface loop of a call run in one launch of the kernel
  ``csrc/fixed_point.cu`` (``ops/kernels/fixed_point.py``); on the CPU
  the plain loop there runs, one ``torch.linalg.inv`` on (b*12, 9, 9) a
  sweep.
* They are evaluated in complex128 whatever the operator dtype of the
  tier and returned in the params' dtype.  The 'high', 'exact' and
  'strict' tiers ask for the fixed point at ``TIGHT_CONV`` = 1e-11 through
  the ``conv`` argument of ``total_apply`` / ``contact_apply`` (the JAX
  package iterates a double-word copy of the same map to that bound
  there): stopped at the default 1e-5 the self-energy would break those
  tiers' contracts.
* Provider params are nested dicts of NumPy arrays with cache-stable pure
  functions, so SCF iterations and Fermi probes reuse every closure.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np
import torch

from gaunegf_tpu_torch.config import (
    ENERGY_MIN, ETA, FERMI_CALCULATION_TOL, SURFACE_BETHE_MIX,
    SURFACE_GREEN_CONVERGENCE, SURFACE_MAX_ITER_BETHE, TEMPERATURE,
    TIGHT_CONV, ExecutionConfig)
from gaunegf_tpu_torch.models import slater_koster as sk
from gaunegf_tpu_torch.models.selfenergy import _CompatMixin, tree_map
from gaunegf_tpu_torch.ops import zlinalg as zl
from gaunegf_tpu_torch.ops.greens import resolve_device
from gaunegf_tpu_torch.ops.kernels import fixed_point as _fpk
from gaunegf_tpu_torch.ops.kernels.fixed_point import NN, PAIR, PLANE_DIRS
from gaunegf_tpu_torch.ops.transfer import to_device, to_host
from gaunegf_tpu_torch.units import BOHR_TO_ANG

DIM = sk.DIM

_C128 = torch.complex128

__all__ = ["BetheGeometry", "BetheAtomGF", "BetheSelfEnergy",
           "bethe_sigma_k", "bethe_sigma_surface", "SweepCounter",
           "TIGHT_CONV"]


# ---------------------------------------------------------------------------
# Fixed points (bulk + surface), batched over the energies
# ---------------------------------------------------------------------------

class SweepCounter:
    """Records the sweeps of every fixed-point call made inside its
    ``with`` block: per call, the (b,) count of sweeps each energy's lane
    was active, kept on the device until ``counts()`` reads them (the
    caller's one synchronisation).  Counters nest; the innermost records."""

    _active = None

    def __init__(self):
        self._sweeps = []

    def __enter__(self):
        self._outer = SweepCounter._active
        SweepCounter._active = self
        return self

    def __exit__(self, *exc):
        SweepCounter._active = self._outer

    def counts(self):
        """Sweeps per energy of every recorded call, one 1-D array."""
        if not self._sweeps:
            return np.zeros(0)
        return torch.cat([s.reshape(-1).cpu() for s in self._sweeps]).numpy()


def _record(*sweeps):
    """Hand each loop's (b,) sweep counts to the active SweepCounter."""
    counter = SweepCounter._active
    if counter is not None:
        counter._sweeps.extend(sweeps)


def _operators(E, H, Slist, Vlist, eta):
    """A (b, 9, 9) and B (b, 12, 9, 9) of A = (E - i*eta) - H,
    B_k = (E - i*eta) S_k - V_k in complex128, and the dtype to return."""
    H = torch.as_tensor(H)
    dev = H.device
    out_dtype = H.dtype if H.dtype.is_complex else _C128
    H = H.to(_C128)
    Slist = torch.as_tensor(Slist, device=dev).to(_C128)
    Vlist = torch.as_tensor(Vlist, device=dev).to(_C128)
    eta = torch.as_tensor(eta, device=dev)
    eta = (eta.real if eta.dtype.is_complex else eta).to(torch.float64)
    E = torch.as_tensor(E, device=dev).to(_C128).reshape(-1)
    z = E - 1j * eta
    eye = torch.eye(DIM, dtype=_C128, device=dev)
    A = z[:, None, None] * eye - H
    B = z[:, None, None, None] * Slist - Vlist
    return A, B, out_dtype


def _bulk_seed(sig0, b, dev):
    """The bulk loop's (b, 12, 9, 9) seed: -1j on the diagonal of every
    slot, or sig0 ((12, 9, 9) for every lane or (b, 12, 9, 9))."""
    if sig0 is None:
        sig0 = -1j * torch.eye(DIM, dtype=_C128, device=dev)
    elif not isinstance(sig0, torch.Tensor):
        sig0 = to_device(np.array(sig0, dtype=np.complex128), dev)
    return torch.broadcast_to(sig0.to(device=dev, dtype=_C128),
                              (b, NN, DIM, DIM)).clone()


def bethe_sigma_k(E, H, Slist, Vlist, eta,
                  conv=SURFACE_GREEN_CONVERGENCE, mix=SURFACE_BETHE_MIX,
                  max_iter=SURFACE_MAX_ITER_BETHE, update="jacobi",
                  sig0=None, exclusion=True):
    """Bulk 12-direction Dyson fixed point (surfGBethe.py:957-1030) for a
    batch of energies E (b,) -> (b, 12, 9, 9).

    sigma_k[k] satisfies: sigma_k[k] = B_k g_k B_k+ with
    g_k = inv(A - sum_j sigma_k[j] + sigma_k[opposite(k)]), A = (E - i*eta)
    - H.  The -1j seed selects the retarded branch (Im sigma <= 0) despite
    the E - i*eta notation.

    update='jacobi' (default): all 12 directions of every energy refreshed
    together per sweep.  update='seidel': the reference's within-sweep
    order (0..11 with the opposite slot already refreshed for k >= 6) for
    bitwise comparison.  Both converge to the same fixed point.

    exclusion=False drops the opposite-direction term: g is the same for
    every direction (one inverse per sweep) -- the explicit all-neighbour
    lattice closure of surfG3D.surfGAt.sigmaK (surfG3D.py:843-903), as
    opposed to surfGBethe's tree closure.

    sig0 (12, 9, 9) or (b, 12, 9, 9): start from a previous energy's
    solution instead of the -1j seed.  On a CUDA tensor the whole loop is
    one launch of the kernel ``csrc/fixed_point.cu``; on a CPU tensor the
    plain loop runs (``ops/kernels/fixed_point.py``)."""
    A, B, out_dtype = _operators(E, H, Slist, Vlist, eta)
    sig = _bulk_seed(sig0, A.shape[0], A.device)
    bulk, _, counts, _ = _fpk.fixed_point(A, B, sig, conv, mix, max_iter,
                                          bulk=update, exclusion=exclusion)
    _record(counts[:, 0])
    return bulk.to(out_dtype)


def bethe_sigma_surface(E, H, Slist, Vlist, eta,
                        conv=SURFACE_GREEN_CONVERGENCE,
                        mix=SURFACE_BETHE_MIX,
                        max_iter=SURFACE_MAX_ITER_BETHE, sig0=None,
                        exclusion=True):
    """Surface self-energies for a batch of energies E (b,): re-relax only
    the 6 in-plane directions on top of the bulk solution
    (surfGBethe.py:1032-1108); the 3 downward out-of-plane slots keep
    their bulk values.  Returns (b, 9, 9, 9).

    With sig0, the bulk fixed point starts from a previous energy's
    solution, and the converged bulk state (b, 12, 9, 9) is returned too,
    for chaining.  exclusion=False selects surfG3D.surfGAt's all-neighbour
    bulk closure (the surface sweep itself is identical in both
    references).  Both loops run in one call of ``fixed_point`` (one
    kernel launch on a CUDA tensor), the surface one from the complex128
    bulk state."""
    A, B, out_dtype = _operators(E, H, Slist, Vlist, eta)
    sig = _bulk_seed(sig0, A.shape[0], A.device)
    sig_bulk, surf, counts, _ = _fpk.fixed_point(
        A, B, sig, conv, mix, max_iter, bulk="jacobi", exclusion=exclusion,
        surface=True)
    _record(counts[:, 0], counts[:, 1])
    surf = surf.to(out_dtype)
    if sig0 is not None:
        return surf, sig_bulk.to(out_dtype)
    return surf


# ---------------------------------------------------------------------------
# Per-contact atomic Bethe-lattice object (surfGBAt parity)
# ---------------------------------------------------------------------------

def _conv(conv):
    """The fixed points' bound: the default where none is asked for."""
    return SURFACE_GREEN_CONVERGENCE if conv is None else float(conv)


def _host_params(params, device):
    return tree_map(lambda v: to_device(
        np.asarray(v, dtype=np.complex128), device), params)


def _host_E(E, device):
    return to_device(np.array([complex(E)], dtype=np.complex128), device)


class BetheAtomGF(_CompatMixin):
    """Single-atom Bethe-lattice Green's function (surfGBethe.py:832-1186).

    Holds the 9x9 onsite block and 12 (S, V) neighbour matrices; exposes the
    13-site extended (117x117) F/S so the generic density/Fermi machinery
    can treat the lattice as a closed system.  ``device`` is where the
    one-energy methods (``sigma_k``, ``sigma``, ``sigmaTot``) evaluate.
    """

    def __init__(self, H, Slist, Vlist, eta=ETA, T=TEMPERATURE,
                 closure="bethe", *, device=None):
        self.device = device
        H = np.asarray(H, dtype=float)
        Slist = np.asarray(Slist, dtype=float)
        Vlist = np.asarray(Vlist, dtype=float)
        if H.shape != (DIM, DIM) or Slist.shape != (NN, DIM, DIM) \
                or Vlist.shape != (NN, DIM, DIM):
            raise ValueError(f"expected H ({DIM}, {DIM}) and Slist, Vlist "
                             f"({NN}, {DIM}, {DIM}); got {H.shape}, "
                             f"{Slist.shape}, {Vlist.shape}")
        # 'bethe': opposite-direction exclusion in the bulk Dyson equation
        # (surfGBethe.py:957-1030); 'lattice': explicit all-neighbour sums
        # (surfG3D.py:843-903, surfGAt's closure)
        if closure not in ("bethe", "lattice"):
            raise ValueError(f"unknown closure {closure!r}")
        self.H = H
        self.Slist = Slist
        self.Vlist = Vlist
        self.eta = float(eta)
        self.T = float(T)
        self.closure = closure
        self.fermi = None
        self._rebuild_extended()

    def _rebuild_extended(self):
        """13-site extended F/S: 12 neighbour blocks then the centre site,
        coupled by V / S (surfGBethe.py:914-955 layout)."""
        n = DIM * (NN + 1)
        F = np.kron(np.eye(NN + 1), self.H)
        S = np.eye(n)
        for i in range(NN):
            sl = slice(i * DIM, (i + 1) * DIM)
            S[-DIM:, sl] = self.Slist[i]
            S[sl, -DIM:] = self.Slist[i].T
            F[-DIM:, sl] = self.Vlist[i]
            F[sl, -DIM:] = self.Vlist[i].conj().T
        self.F = F
        self.S = S

    def update_h(self, fermi=None):
        """Shift the lattice onsite/hopping terms to a new Fermi level
        (surfGBethe.py:914-946)."""
        if fermi is not None and self.fermi is not None \
                and fermi != self.fermi:
            d = fermi - self.fermi
            self.H = self.H + d * np.eye(DIM)
            self.Vlist = self.Vlist + d * self.Slist
            self.fermi = fermi
        self._rebuild_extended()

    # pure-fn provider API ---------------------------------------------
    def params(self):
        return {"H": np.asarray(self.H), "S": np.asarray(self.Slist),
                "V": np.asarray(self.Vlist), "eta": np.float64(self.eta)}

    @property
    def _exclusion(self):
        return self.closure == "bethe"

    # sigma is an iterated fixed point: the engines pass conv=TIGHT_CONV
    # on the high, exact and strict tiers
    iterated = True

    def total_apply(self, conv=None):
        return _atom_total_fn(self._exclusion, _conv(conv)), self.params()

    def contact_apply(self, i, conv=None):
        return self.total_apply(conv)

    def num_contacts(self):
        return 1

    # host-facing methods (one energy, complex128 NumPy, on ``device``) --
    def sigma_k(self, E, conv=SURFACE_GREEN_CONVERGENCE,
                mix=SURFACE_BETHE_MIX, sig0=None):
        device = resolve_device(self.device)
        p = _host_params(self.params(), device)
        if sig0 is not None:
            sig0 = to_device(np.asarray(sig0, dtype=np.complex128), device)
        return to_host(bethe_sigma_k(_host_E(E, device), p["H"], p["S"],
                                     p["V"], p["eta"], conv, mix, sig0=sig0,
                                     exclusion=self._exclusion)[0])

    def sigma(self, E, conv=SURFACE_GREEN_CONVERGENCE,
              mix=SURFACE_BETHE_MIX, sig0=None):
        """Surface self-energies (9, 9, 9); with sig0 (a previous energy's
        bulk state) also the converged bulk state (12, 9, 9)."""
        device = resolve_device(self.device)
        p = _host_params(self.params(), device)
        out = bethe_sigma_surface(_host_E(E, device), p["H"], p["S"],
                                  p["V"], p["eta"], conv, mix, sig0=sig0,
                                  exclusion=self._exclusion)
        if sig0 is None:
            return to_host(out[0])
        return tuple(to_host(x[0]) for x in out)

    def sigmaTot(self, E, conv=SURFACE_GREEN_CONVERGENCE):
        """Extended-system total self-energy for density.py-style use
        (surfGBethe.py:1129-1136)."""
        fn, params = self.total_apply(conv)
        device = resolve_device(self.device)
        return to_host(fn(_host_params(params, device),
                          _host_E(E, device))[0])

    def setF(self, F, mu1, mu2):
        """Bulk lattice properties are intrinsic -- no-op
        (surfGBethe.py:1111-1126)."""

    def set_fock(self, F, mu1=None, mu2=None):
        pass

    def DOS(self, E):
        sig = self.sigma(E)
        A = (E - 1j * self.eta) * np.eye(DIM) - self.H - sig.sum(axis=0)
        Gr = np.linalg.inv(A)
        return float(-np.trace(Gr).imag / np.pi)

    def calc_fermi(self, ne, f_guess=5.0, tol=FERMI_CALCULATION_TOL,
                   exec_cfg=None, *, device, mesh=None, verbose=True):
        """The lattice's Fermi level at ``ne`` electrons per site, from
        the extended system's density on ``device`` (integral_fit, then a
        bracketed bisection counting the centre site's electrons), sharded
        over ``mesh`` where one is given."""
        from gaunegf_tpu_torch.fermi import get_fermi_contact
        self.fermi = get_fermi_contact(
            self, ne, tol, ENERGY_MIN, 1000, T=self.T, n_orbs=DIM,
            exec_cfg=exec_cfg or ExecutionConfig(), device=device, mesh=mesh,
            verbose=verbose)
        return self.fermi

    calcFermi = calc_fermi


def _atom_total_embed(sig_k):
    """Extended-system embedding of (b, 12, 9, 9): per-site diagonal blocks
    sum(sigma_k) - sigma_k[opposite] (surfGBethe.py:1129-1136 ==
    surfG3D.py:1024-1031 -- both references keep the exclusion in the
    embedding even though their bulk closures differ)."""
    tot = sig_k.sum(dim=1)
    n = DIM * (NN + 1)
    out = torch.zeros((sig_k.shape[0], n, n), dtype=sig_k.dtype,
                      device=sig_k.device)
    for k in range(NN):
        sl = slice(k * DIM, (k + 1) * DIM)
        out[:, sl, sl] = tot - sig_k[:, PAIR[k]]
    return out


@lru_cache(maxsize=None)
def _atom_total_fn(exclusion: bool, conv: float):
    def fn(params, E):
        return _atom_total_embed(bethe_sigma_k(
            E, params["H"], params["S"], params["V"], params["eta"],
            conv=conv, exclusion=exclusion))
    return fn


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

@dataclass
class BetheGeometry:
    """Host-side geometry spec decoupled from any QC backend.

    coords: (n_atoms, 3) in Angstrom; orbital_atoms: orbital -> 1-based atom
    number; orbital_types: per-orbital type code (sorted by abs(type)//1000
    within an atom to get s,p,d ordering -- surfGBethe.py:132).
    """
    coords: np.ndarray
    orbital_atoms: np.ndarray
    orbital_types: Optional[np.ndarray] = None

    @classmethod
    def from_backend(cls, backend):
        if hasattr(backend, "ibfatm"):        # gauopen QCBinAr duck type
            orb_map = np.asarray(backend.ibfatm)
            orb_typ = np.asarray(backend.ibftyp)
            coords = np.asarray(backend.c, dtype=float).reshape(-1, 3) \
                * BOHR_TO_ANG
            return cls(coords, orb_map, orb_typ)
        coords = backend.atom_coords()
        if coords is None:
            raise ValueError("Backend provides no atomic coordinates; pass "
                             "a BetheGeometry explicitly")
        return cls(np.asarray(coords), np.asarray(backend.locs), None)


def _detect_contact(geom: BetheGeometry, contact_atoms: Sequence[int]):
    """Geometry detection for one contact: orbital indices per atom, surface
    normal, 12 NN directions and per-atom connected-direction lists
    (surfGBethe.py:120-188 behaviour)."""
    coords = geom.coords
    orb_map = np.asarray(geom.orbital_atoms)
    pos_mask = orb_map > 0
    orb_map_pos = orb_map[pos_mask]
    orb_typ = (np.asarray(geom.orbital_types)[pos_mask]
               if geom.orbital_types is not None else None)

    inds_list = []
    c_list = []
    for atom in contact_atoms:
        inds = np.where(orb_map_pos == atom)[0]
        if len(inds) != DIM:
            raise ValueError(f"Atom {atom} has {len(inds)} basis functions, "
                             f"expecting {DIM}")
        if orb_typ is not None:
            inds = inds[np.argsort(np.abs(orb_typ[inds]) // 1000)]
        inds_list.append(inds)
        c_list.append(coords[atom - 1])
    c_list = np.asarray(c_list)

    centred = c_list - c_list.mean(axis=0)
    _, _, Vt = np.linalg.svd(centred)
    normal = Vt[-1]
    outward = c_list.mean(axis=0) - coords.mean(axis=0)
    if np.dot(outward, normal) < 0:
        normal = -normal

    # one lattice direction: nearest neighbour within the contact
    d = np.linalg.norm(c_list[1:] - c_list[0], axis=1)
    v_ind = int(np.argmin(d)) + 1
    lat_vec = c_list[v_ind] - c_list[0]
    lat_dist = float(np.linalg.norm(lat_vec))
    lat_unit = lat_vec / lat_dist

    n_vecs1 = sk.fcc111_neighbor_directions(normal, lat_unit)
    n_vecs2 = sk.fcc111_neighbor_directions(normal, -lat_unit)
    out_of_plane = {3, 4, 5, 9, 10, 11}

    n_ind_list = []
    n_vecs = n_vecs1
    for c in c_list:
        # all physical neighbours of this atom (within 0.8-1.2 of NN dist)
        n_at_vecs = []
        for c2 in coords:
            l = np.linalg.norm(c2 - c)
            if 0.8 * lat_dist < l < 1.2 * lat_dist and not np.allclose(c2, c):
                n_at_vecs.append((c2 - c) / l)
        # orientation disambiguation: if any neighbour aligns with an
        # out-of-plane direction of the mirrored set, use the mirrored set
        n_vecs = n_vecs1
        for vec in n_at_vecs:
            vals = n_vecs2 @ vec
            best = int(np.argmax(vals))
            if best in out_of_plane and vals[best] > 0.9:
                n_vecs = n_vecs2
                break
        n_inds = []
        for vec in n_at_vecs:
            vals = n_vecs @ vec
            best = int(np.argmax(vals))
            if vals[best] > 0.9:
                n_inds.append(best)
            else:
                print(f"Warning: neighbor direction does not match lattice "
                      f"vector #{best} (dot {vals[best]:.3f} <= 0.9); "
                      "skipping this neighbor")
        n_ind_list.append(n_inds)
    return inds_list, normal, lat_unit, n_vecs, n_ind_list


# ---------------------------------------------------------------------------
# Full Bethe self-energy provider (surfGB parity)
# ---------------------------------------------------------------------------

class BetheSelfEnergy(_CompatMixin):
    """Bethe-lattice contact self-energy provider for a device F/S.

    ``device`` (required: 'cuda', 'cpu', a torch.device) is where
    S^(1/2) is computed for an orthogonal parameter set and where the
    contact Fermi-level search runs when no ``fermi`` is given."""

    iterated = True         # as BetheAtomGF: conv=TIGHT_CONV on the high tiers

    # geometry-detection hook (overridden by Lattice3DSelfEnergy)
    _detector = staticmethod(_detect_contact)

    @property
    def _stack_fn(self):
        """fn(contact_params, E, conv) -> the (b, 9, 9, 9) slot stack that
        the embedding takes (total_block_apply)."""
        return _surface

    def __init__(self, F, S, contacts: Sequence[Sequence[int]],
                 geometry: BetheGeometry, lat_file: str = "Au",
                 spin: str = "r", eta: float = ETA, T: float = TEMPERATURE,
                 fermi: Optional[float] = None, exec_cfg=None, *, device,
                 mesh=None, verbose=True):
        self.F = np.asarray(F)
        self.S = np.asarray(S)
        self.spin = spin
        self.eta = float(eta)
        self.T = float(T)
        self.params_sk = (sk.parse_bethe_file(lat_file)
                          if isinstance(lat_file, str) else lat_file)
        sk.validate_slater_koster(self.params_sk, atol=1e-8)
        self.orthogonal = self.params_sk.orthogonal
        self.N = (self.S.shape[0] if spin == "r" else self.S.shape[0] // 2)

        self.device = device = resolve_device(device, mesh)
        # S^(1/2) de-orthogonalizes an orthogonal set's sigma (Xi sig Xi);
        # a non-orthogonal set embeds its sigma as it is and has no Xi
        self.Xi = None
        if self.orthogonal:
            S_t = to_device(np.asarray(self.S, dtype=np.float64), device)
            Xi_full = to_host(zl.fractional_matrix_power(S_t, 0.5))
            self.Xi = Xi_full if spin == "r" else Xi_full[::2, ::2]
        self._xi_key = None if self.Xi is None else _HashableArray(self.Xi)

        self.inds_lists: List[List[np.ndarray]] = []
        self.n_ind_lists = []
        self.dir_lists = []
        self.c_vecs = []
        self.lat_vecs = []
        self.g_list: List[BetheAtomGF] = []
        for contact in contacts:
            inds_list, normal, lat, n_vecs, n_inds = type(self)._detector(
                geometry, contact)
            self._add_contact(inds_list, n_inds, n_vecs, normal, lat)
        if fermi is None:
            fermi = self.g_list[0].calc_fermi(
                self.params_sk.ne / 2, exec_cfg=exec_cfg, device=device,
                mesh=mesh, verbose=verbose)
        for g in self.g_list:
            g.fermi = fermi
        self.fermi = fermi

    def _add_contact(self, inds_list, n_inds, n_vecs, normal=None, lat=None):
        self.inds_lists.append([np.asarray(i, dtype=int) for i in inds_list])
        self.c_vecs.append(normal)
        self.lat_vecs.append(lat)
        self.dir_lists.append(np.asarray(n_vecs, dtype=float))
        self.n_ind_lists.append([list(int(k) for k in n) for n in n_inds])
        Slist = np.stack([sk.bond_matrix(self.params_sk.overlap, d)
                          for d in n_vecs])
        Vlist = np.stack([sk.bond_matrix(self.params_sk.hopping, d)
                          for d in n_vecs])
        self.g_list.append(BetheAtomGF(self.params_sk.h0(), Slist, Vlist,
                                       self.eta, self.T, device=self.device))

    @classmethod
    def from_backend(cls, F, S, contacts, backend, lat_file="Au", spin="r",
                     eta=ETA, T=TEMPERATURE, geometry=None, **kw):
        if geometry is None:
            geometry = BetheGeometry.from_backend(
                getattr(backend, "bar", backend))
        return cls(F, S, contacts, geometry, lat_file, spin, eta, T, **kw)

    # ------------------------------------------------------------------
    def num_contacts(self):
        return len(self.g_list)

    def getSigma(self, Elist=(None, None), conv=SURFACE_GREEN_CONVERGENCE):
        E0 = self.g_list[0].fermi if Elist[0] is None else Elist[0]
        E1 = self.g_list[-1].fermi if Elist[1] is None else Elist[1]
        return self.sigma(E0, 0, conv), self.sigma(E1, -1, conv)

    def update_fermi(self, i, Ef):
        self.g_list[i].update_h(Ef)

    updateFermi = update_fermi

    def set_fock(self, F, muL=None, muR=None):
        """Track the device Fock matrix; realign contact Fermi levels
        (surfGBethe.py:625-645)."""
        self.F = np.asarray(F)
        if muL is not None and self.g_list[0].fermi != muL:
            self.update_fermi(0, muL)
        if muR is not None and self.g_list[-1].fermi != muR:
            self.update_fermi(-1, muR)

    # pure-fn provider API for the energy engines ----------------------
    def params(self):
        return {
            "contacts": tuple(g.params() for g in self.g_list),
        }

    def _static_key(self, conv=None):
        inds = tuple(tuple(tuple(int(x) for x in a) for a in il)
                     for il in self.inds_lists)
        nind = tuple(tuple(tuple(n) for n in nl) for nl in self.n_ind_lists)
        return (inds, nind, self.N, self.spin, self.orthogonal, _conv(conv))

    def _xi(self):
        """S^(1/2) as the closures' cache key (hashed once, at
        construction); None for a non-orthogonal set."""
        return self._xi_key

    def total_apply(self, conv=None):
        """(fn, params) of Sigma_total with the fixed points iterated to
        ``conv`` (default SURFACE_GREEN_CONVERGENCE; the engines ask for
        TIGHT_CONV on the high, exact and strict tiers)."""
        return _bethe_total_fn(self._static_key(conv),
                               self._xi()), self.params()

    def contact_apply(self, i, conv=None):
        i = i % len(self.g_list)
        return _bethe_contact_fn(self._static_key(conv), self._xi(),
                                 i), self.params()

    def _warm_init(self):
        return tuple(
            np.broadcast_to(-1j * np.eye(DIM, dtype=np.complex128),
                            (NN, DIM, DIM)).copy()
            for _ in self.g_list)

    def total_apply_warm(self, conv=None):
        """(fn(params, E, state) -> (Sigma, state'), params, init_state)."""
        return (_bethe_total_warm_fn(self._static_key(conv), self._xi()),
                self.params(), self._warm_init())

    def contacts_warm_apply(self, conv=None):
        """(fn(params, E, state) -> (sigs_tuple, state'), params, init):
        every contact's sigma from one fixed-point solve per energy.  From
        ``init`` the solve is the cold one."""
        return (_bethe_contacts_warm_fn(self._static_key(conv), self._xi()),
                self.params(), self._warm_init())

    def contact_inds(self, i=None):
        """Static contact support; None when the de-orthogonalization
        (Xi sig Xi) or a spin expansion densifies the embedding."""
        if self.orthogonal or self.spin != "r":
            return None
        lists = (self.inds_lists if i is None
                 else [self.inds_lists[i % len(self.g_list)]])
        return tuple(sorted({int(j) for il in lists
                             for inds in il for j in inds}))

    def total_block_apply(self, c):
        """fn(params, E) -> Sigma_total[c, c] (b, k, k) without building
        the (b, N, N) total (the spectral route's per-point block); only
        where contact_inds is static."""
        if self.contact_inds() is None:
            raise ValueError("no static contact support: the embedding of "
                             "this parameter set is dense")
        return _total_block_fn(self._static_key(), self._xi(),
                               tuple(int(j) for j in c), self._stack_fn)


class _HashableArray:
    """Hash wrapper so host-side constants can key lru_cached closures."""

    def __init__(self, arr):
        self.arr = np.asarray(arr)
        self._key = (self.arr.shape, self.arr.dtype.str,
                     hash(self.arr.tobytes()))

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, _HashableArray) and \
            self._key == other._key and np.array_equal(self.arr, other.arr)


# ---------------------------------------------------------------------------
# Embedding of the (b, 9, 9, 9) surface stacks into the device matrix
# ---------------------------------------------------------------------------

class _Embedding:
    """Static part of one contact's embedding, with its tensors made once
    per device: per-atom slot coefficients (sum of the 9 slots minus the
    slots matched to explicit neighbours), the atoms' orbital indices, and
    for orthogonal sets the columns Xi[:, inds] of S^(1/2)."""

    def __init__(self, static_key, Xi_h, i):
        inds, nind, N, spin, orthogonal = static_key[:5]
        self.N, self.spin, self.orthogonal = N, spin, orthogonal
        self.flat = np.concatenate([np.asarray(a, dtype=np.int64)
                                    for a in inds[i]])
        coef = np.ones((len(inds[i]), 9))
        for a, n_inds in enumerate(nind[i]):
            for k in n_inds:
                if k < 9:
                    coef[a, k] -= 1.0
        self.coef = coef
        self.Xi_h = Xi_h
        self._dev = {}

    def tensors(self, device):
        hit = self._dev.get(device)
        if hit is None:
            flat = to_device(self.flat, device)
            coef = to_device(self.coef, device, _C128)
            Xc = None
            if self.orthogonal:
                Xc = to_device(
                    np.ascontiguousarray(self.Xi_h.arr[:, self.flat]),
                    device, _C128)
            hit = self._dev[device] = (flat, coef, Xc)
        return hit

    def atoms(self, sig_surf):
        """(b, n_atoms, 9, 9): each atom's sum of slots minus its matched
        slots, in complex128."""
        _, coef, _ = self.tensors(sig_surf.device)
        return torch.einsum("ak,bkij->baij", coef, sig_surf.to(_C128))

    def block(self, sig_surf):
        """The contact's (b, k, k) block over its own orbitals ``flat``
        (block diagonal over the atoms)."""
        at = self.atoms(sig_surf)
        b, na = at.shape[:2]
        blk = torch.zeros((b, na, DIM, na, DIM), dtype=_C128,
                          device=at.device)
        for a in range(na):
            blk[:, a, :, a, :] = at[:, a]
        return blk.reshape(b, na * DIM, na * DIM)

    def full(self, sig_surf):
        """The embedded (b, N', N') self-energy in sig_surf's dtype, N' =
        N for spin 'r' and 2N otherwise."""
        flat, _, Xc = self.tensors(sig_surf.device)
        blk = self.block(sig_surf)
        if self.orthogonal:
            # Xi sig Xi with sig supported on the contact block
            sig = Xc @ blk @ Xc.transpose(-1, -2)
        else:
            sig = torch.zeros((blk.shape[0], self.N, self.N), dtype=_C128,
                              device=blk.device)
            sig[:, flat[:, None], flat[None, :]] = blk
        sig = sig.to(sig_surf.dtype)
        if self.spin in ("u", "ro"):            # kron(eye(2), sig)
            out = torch.zeros((sig.shape[0], 2 * self.N, 2 * self.N),
                              dtype=sig.dtype, device=sig.device)
            out[:, :self.N, :self.N] = sig
            out[:, self.N:, self.N:] = sig
            return out
        if self.spin == "g":                    # kron(sig, eye(2))
            out = torch.zeros((sig.shape[0], 2 * self.N, 2 * self.N),
                              dtype=sig.dtype, device=sig.device)
            out[:, 0::2, 0::2] = sig
            out[:, 1::2, 1::2] = sig
            return out
        return sig


@lru_cache(maxsize=None)
def _embedding(static_key, Xi_h, i: int) -> _Embedding:
    return _Embedding(static_key, Xi_h, i)


def _bethe_embed_fn(static_key, Xi_h, i: int):
    """Embedding of precomputed surface sigmas into the device matrix."""
    return _embedding(static_key[:5], Xi_h, i).full


def _surface(p, E, conv, sig0=None):
    return bethe_sigma_surface(E, p["H"], p["S"], p["V"], p["eta"],
                               conv=conv, sig0=sig0)


@lru_cache(maxsize=None)
def _bethe_contact_fn(static_key, Xi_h, i: int):
    embed = _bethe_embed_fn(static_key, Xi_h, i)
    conv = static_key[5]

    def fn(params, E):
        return embed(_surface(params["contacts"][i], E, conv))

    return fn


@lru_cache(maxsize=None)
def _bethe_total_fn(static_key, Xi_h):
    n_contacts = len(static_key[0])

    def fn(params, E):
        tot = _bethe_contact_fn(static_key, Xi_h, 0)(params, E)
        for i in range(1, n_contacts):
            tot = tot + _bethe_contact_fn(static_key, Xi_h, i)(params, E)
        return tot

    return fn


@lru_cache(maxsize=None)
def _total_block_fn(static_key, Xi_h, c: tuple, stack_fn):
    """Sigma_total[c, c] for a non-orthogonal spin-'r' set, whose
    embedding is block diagonal over the contact atoms.
    stack_fn(contact_params, E, conv) -> the (b, 9, 9, 9) slot stack."""
    n_contacts = len(static_key[0])
    conv = static_key[5]
    pos = {j: n for n, j in enumerate(c)}
    embs = [_embedding(static_key[:5], Xi_h, i) for i in range(n_contacts)]
    where = [np.asarray([pos[int(j)] for j in e.flat], dtype=np.int64)
             for e in embs]
    dev_idx = {}

    def fn(params, E):
        out = None
        for i, e in enumerate(embs):
            blk = e.block(stack_fn(params["contacts"][i], E, conv))
            if out is None:
                out = torch.zeros((blk.shape[0], len(c), len(c)),
                                  dtype=_C128, device=blk.device)
            key = (i, blk.device)
            w = dev_idx.get(key)
            if w is None:
                w = dev_idx[key] = to_device(where[i], blk.device)
            out[:, w[:, None], w[None, :]] += blk
        return out.to(params["contacts"][0]["H"].dtype)

    return fn


@lru_cache(maxsize=None)
def _bethe_contacts_warm_fn(static_key, Xi_h):
    """Warm-started per-contact sigmas: fn(params, E, state) ->
    (sigs_tuple, state').  One fixed-point solve per contact per energy
    (the cold path re-solves per sigma_tot/gamma1/gamma2 request).

    state = per-contact bulk sigma_k stacks, one per lane (b, 12, 9, 9)
    (or (12, 9, 9) for all lanes): each evaluation starts the bulk fixed
    point from the lane's previous energy's solution."""
    n_contacts = len(static_key[0])
    conv = static_key[5]

    def fn(params, E, state):
        sigs = []
        new_state = []
        for i in range(n_contacts):
            sig_surf, sig_bulk = _surface(params["contacts"][i], E, conv,
                                          sig0=state[i])
            new_state.append(sig_bulk)
            sigs.append(_bethe_embed_fn(static_key, Xi_h, i)(sig_surf))
        return tuple(sigs), tuple(new_state)

    return fn


@lru_cache(maxsize=None)
def _bethe_total_warm_fn(static_key, Xi_h):
    """Warm-started total-sigma: fn(params, E, state) -> (Sigma, state')."""
    contacts_fn = _bethe_contacts_warm_fn(static_key, Xi_h)

    def fn(params, E, state):
        sigs, new_state = contacts_fn(params, E, state)
        tot = sigs[0]
        for s in sigs[1:]:
            tot = tot + s
        return tot, new_state

    return fn
