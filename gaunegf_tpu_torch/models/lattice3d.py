"""3D-lattice surface self-energies (surfG3D equivalent + k-space).

Port of ``gaunegf_tpu/models/lattice3d.py``.  Capability parity with
gauNEGF/surfG3D.py, which is the reference's work-in-progress NumPy twin of
the Bethe-lattice model ("need to implement k-space integration (Gamma
only)", surfG3D.py:21-23).  Differences from the Bethe geometry path,
mirrored here:

* neighbour search runs over the *contact atoms only* (surfG3D.py:94-100:
  within 1.5x the nearest-neighbour distance), i.e. the contact layer is
  assumed to be a single crystal plane;
* only in-plane matches (direction slots 0,1,2,6,7,8) are legal -- a
  mismatch raises (surfG3D.py:101-105);
* no orientation disambiguation pass.

The fixed points, Slater-Koster construction and device embedding are the
shared batched machinery of models/bethe.py.

Beyond the reference: ``gamma_point_only=False`` enables true 2D
Brillouin-zone integration (``nk x nk`` Monkhorst-Pack) for the crystal
half-space behind the contact plane -- the reference's open TODO --
via per-k Sancho-Rubio decimation batched on the device
(models/kspace.py; approximations documented there).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np

from gaunegf_tpu_torch.config import ETA, TEMPERATURE
from gaunegf_tpu_torch.models import slater_koster as sk
from gaunegf_tpu_torch.models.bethe import (
    DIM, PLANE_DIRS, BetheGeometry, BetheSelfEnergy, _bethe_embed_fn)
from gaunegf_tpu_torch.models.kspace import (
    DOWN_DIRS, bz_reduce, kspace_phases, kspace_sigma_surface,
    phases_for_frac)

__all__ = ["Lattice3DSelfEnergy"]


def _detect_contact_3d(geom: BetheGeometry, contact_atoms: Sequence[int]):
    """Contact-plane geometry detection with the surfG3D rules."""
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
    # orient the normal away from the structure centroid (toward the
    # missing electrode bulk) -- the SVD sign is arbitrary, and the
    # k-space half-space attaches on the +normal side (slots 3,4,5)
    outward = c_list.mean(axis=0) - coords.mean(axis=0)
    if np.dot(outward, normal) < 0:
        normal = -normal

    d = np.linalg.norm(c_list[1:] - c_list[0], axis=1)
    v_ind = int(np.argmin(d)) + 1
    lat_vec = c_list[v_ind] - c_list[0]
    lat_dist = float(np.linalg.norm(lat_vec))
    n_vecs = sk.fcc111_neighbor_directions(normal, lat_vec / lat_dist)

    plane_ok = set(PLANE_DIRS)
    n_ind_list = []
    for c in c_list:
        n_inds = []
        for c2 in c_list:                      # contact atoms only
            l = np.linalg.norm(c2 - c)
            if 0 < l < 1.5 * lat_dist and not np.allclose(c2, c):
                vec = (c2 - c) / l
                vals = n_vecs @ vec
                best = int(np.argmax(vals))
                if not (vals[best] > 0.9 and best in plane_ok):
                    raise ValueError("Lattice mismatch in contact atoms: "
                                     "contact layer is not a single "
                                     "crystal plane")
                n_inds.append(best)
        n_ind_list.append(n_inds)
    return inds_list, normal, lat_vec / lat_dist, n_vecs, n_ind_list


def _kspace_stack(p, E, conv, sig0=None, with_dirs=False):
    """The 9-slot stack of one contact: the relaxed in-plane slots and the
    k-averaged half-space term in slot DOWN_DIRS[0]; with_dirs also
    returns the in-plane stack alone (the warm state)."""
    sig_dirs, sig_down = kspace_sigma_surface(
        E, p["H"], p["S"], p["V"], p["plane_ph"], p["down_ph"], p["eta"],
        conv=conv, sig0=sig0, sym_mask=p.get("sym_mask"),
        sym_D=p.get("sym_D"))
    stack = sig_dirs.clone()
    stack[:, DOWN_DIRS[0]] = sig_down
    return (stack, sig_dirs) if with_dirs else stack


def _kspace_parts(static_key, Xi_h, i, params, E, st=None):
    """One contact evaluation at the energies E (b,): (embedded sigma
    (b, N, N), converged in-plane Jacobi stack (b, 9, 9, 9)).

    Synthesizes a 9-slot directional stack -- in-plane slots from the
    Bethe relaxation (seeded from ``st`` when given), the k-averaged
    half-space term parked in one (otherwise zero) bulk-side slot -- and
    reuses the Bethe embedding for the per-atom subtraction /
    de-orthogonalization / spin expansion (matched slots are in-plane by
    the surfG3D detector's assertion, so they never touch the half-space
    slot).  The per-k Sancho half-space term is re-solved cold at each
    energy (see kspace.kspace_sigma_surface for why only the relaxation
    is seeded)."""
    stack, sig_dirs = _kspace_stack(params["contacts"][i], E, static_key[5],
                                    st, with_dirs=True)
    return _bethe_embed_fn(static_key, Xi_h, i)(stack), sig_dirs


@lru_cache(maxsize=None)
def _kspace_contact_fn(static_key, Xi_h, i: int):
    """Per-contact sigma with the k-integrated half-space embedding."""
    def fn(params, E):
        return _kspace_parts(static_key, Xi_h, i, params, E)[0]

    return fn


@lru_cache(maxsize=None)
def _kspace_total_fn(static_key, Xi_h):
    n_contacts = len(static_key[0])

    def fn(params, E):
        tot = _kspace_contact_fn(static_key, Xi_h, 0)(params, E)
        for i in range(1, n_contacts):
            tot = tot + _kspace_contact_fn(static_key, Xi_h, i)(params, E)
        return tot

    return fn


@lru_cache(maxsize=None)
def _kspace_contacts_warm_fn(static_key, Xi_h):
    """fn(params, E, state) -> (sigs_tuple, state'): ONE k-integrated
    surface solve per contact per energy, shared across the engine's
    sigma_tot/Gamma requests (the cold path re-solves per request)."""
    n_contacts = len(static_key[0])

    def fn(params, E, state):
        sigs, new_state = [], []
        for i in range(n_contacts):
            emb, st = _kspace_parts(static_key, Xi_h, i, params, E,
                                    state[i])
            sigs.append(emb)
            new_state.append(st)
        return tuple(sigs), tuple(new_state)

    return fn


@lru_cache(maxsize=None)
def _kspace_total_warm_fn(static_key, Xi_h):
    """fn(params, E, state) -> (Sigma_total, state') (warm sum engines)."""
    contacts_fn = _kspace_contacts_warm_fn(static_key, Xi_h)

    def fn(params, E, state):
        sigs, new_state = contacts_fn(params, E, state)
        tot = sigs[0]
        for s in sigs[1:]:
            tot = tot + s
        return tot, new_state

    return fn


class Lattice3DSelfEnergy(BetheSelfEnergy):
    """Surface self-energy for an explicit 3D-lattice contact plane.

    gamma_point_only=True (default): the reference-parity mode -- the
    half-space uses the Bethe-lattice fixed point (surfG3D's actual
    behaviour).  gamma_point_only=False: the crystal half-space is
    BZ-integrated on an nk x nk surface-BZ grid (beyond the reference).
    With bz_symmetry=True (default) the grid is GAMMA-CENTRED and folded
    by the plane's validated little group (exact vs that grid, ~3-6x
    fewer decimations); bz_symmetry=False keeps the shifted
    Monkhorst-Pack grid.  The two grid flavours differ at finite nk
    (~5% at nk=4) and converge to the same integral.  Both modes support
    the warm-started engine family; in k-space mode only the in-plane
    Jacobi relaxation carries across energies (the per-k decimation
    re-solves cold -- see kspace.kspace_sigma_surface).  On the high,
    exact and strict tiers both modes iterate to TIGHT_CONV in
    complex128: gamma-point through the Bethe fixed point, k-space through
    the per-k decimation and the in-plane relaxation.
    """

    _detector = staticmethod(_detect_contact_3d)

    def __init__(self, F, S, contacts, geometry: BetheGeometry,
                 lat_file: str = "Au", spin: str = "r", eta: float = ETA,
                 T: float = TEMPERATURE, gamma_point_only: bool = True,
                 nk: int = 4, bz_symmetry: bool = True, **kw):
        super().__init__(F, S, contacts, geometry, lat_file, spin, eta, T,
                         **kw)
        self.kspace = not gamma_point_only
        self.nk = int(nk)
        if self.kspace:
            # bz_symmetry: fold the surface BZ by the plane's validated
            # little group (C3v for fcc(111): ~3-6x fewer decimations,
            # exact -- kspace.bz_reduce).  Falls back to the full
            # Monkhorst-Pack grid when no reduction validates.
            reds = [bz_reduce(nv, self.nk) if bz_symmetry else None
                    for nv in self.dir_lists]
            if any(r is None for r in reds):
                # all-or-nothing: never mix Gamma-centred (reduced) and
                # Monkhorst-Pack (fallback) grid flavours between the
                # contacts of one system
                reds = [None] * len(reds)
            self._phases, self._syms = [], []
            for nv, red in zip(self.dir_lists, reds):
                if red is None:
                    self._phases.append(kspace_phases(nv, self.nk))
                    self._syms.append(None)
                else:
                    frac_reps, mask, D, _ = red
                    self._phases.append(phases_for_frac(nv, frac_reps))
                    self._syms.append((mask, D))

    def params(self):
        base = super().params()
        if not self.kspace:
            return base
        contacts = []
        for p, (plane_ph, down_ph), sym in zip(base["contacts"],
                                               self._phases, self._syms):
            q = dict(p)
            q["plane_ph"] = plane_ph.astype(np.complex128)
            q["down_ph"] = down_ph.astype(np.complex128)
            if sym is not None:
                q["sym_mask"], q["sym_D"] = sym
            contacts.append(q)
        return {"contacts": tuple(contacts)}

    def total_apply(self, conv=None):
        if not self.kspace:
            return super().total_apply(conv)
        return _kspace_total_fn(self._static_key(conv),
                                self._xi()), self.params()

    def contact_apply(self, i, conv=None):
        if not self.kspace:
            return super().contact_apply(i, conv)
        i = i % len(self.g_list)
        return _kspace_contact_fn(self._static_key(conv), self._xi(),
                                  i), self.params()

    @property
    def _stack_fn(self):
        return _kspace_stack if self.kspace else super()._stack_fn

    # warm-started sweeps (k-space mode): carry the in-plane Jacobi stack
    # across energies; zero seed == the cold path's first iteration
    def _warm_init(self):
        if not self.kspace:
            return super()._warm_init()
        return tuple(np.zeros((9, DIM, DIM), dtype=np.complex128)
                     for _ in self.g_list)

    def total_apply_warm(self, conv=None):
        if not self.kspace:
            return super().total_apply_warm(conv)
        return (_kspace_total_warm_fn(self._static_key(conv), self._xi()),
                self.params(), self._warm_init())

    def contacts_warm_apply(self, conv=None):
        if not self.kspace:
            return super().contacts_warm_apply(conv)
        return (_kspace_contacts_warm_fn(self._static_key(conv), self._xi()),
                self.params(), self._warm_init())
