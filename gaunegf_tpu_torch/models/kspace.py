"""k-space surface Green's functions for crystalline contact planes.

Port of ``gaunegf_tpu/models/kspace.py``.  Closes the reference's open TODO
(surfG3D.py:21-23 "need to implement k-space integration (Gamma only)"):
the half-space of crystal BELOW the contact plane is treated exactly by 2D
Brillouin-zone integration instead of the Bethe-lattice approximation.

Construction (fcc(111) stacking, 9-orbital spd blocks):

* per surface-BZ point k, the layered crystal has the Bloch blocks
      A(k, E) = (E + i eta) S00(k) - H00(k)        (intra-layer)
      B(k, E) = (E + i eta) S01(k) - H01(k)        (layer n -> n+1 below)
  (+i eta: decimation converges to the branch Im(z) selects, and the
  RETARDED sigma (Im <= 0) is what the Bethe fixed points produce --
  their -1j seed picks that branch despite bethe_sigma_k's E - i eta
  notation -- so the two must match here to be summable)
  with H00(k) = H_onsite + sum_{6 in-plane R} e^{i k.R} V_R and
  H01(k) = sum_{3 below-plane R} e^{i k.R} V_R;
* Sancho-Rubio decimation (models/chain1d.surface_g_sancho, quadratic
  convergence) gives the subsurface-stack surface GF g00(k, E), for all
  energies of a batch and all k points as one (b*Nk, 9, 9) batch (on the
  card one launch of the kernel csrc/sancho_rubio.cu);
* the contact atom's missing-half-space self-energy is the BZ average
      Sigma_down(E) = (1/Nk) sum_k B(k, E) g00(k, E) B(k, E)^+ .

Approximations, stated: the per-atom embedding keeps the k-average only
(local / site-diagonal approximation -- inter-atom coherence within the
contact plane is dropped, consistent with the Bethe-style per-atom
embedding it extends), and the plane's own lateral semi-infinity (the
unmatched IN-plane neighbour slots) still uses the Bethe directional
fixed point.  Both errors vanish as the explicit contact cluster grows;
the perpendicular direction -- where Gamma-only was worst -- is exact and
convergent in nk.

The functions on tensors take a batch of energies E (b,), evaluate in
complex128 and return in the params' dtype, as models/bethe.py does; the
in-plane relaxation around Sigma_down is one launch of the kernel
csrc/fixed_point.cu on the card (its surface mode with a per-lane A).
"""

from __future__ import annotations

import numpy as np
import torch

from gaunegf_tpu_torch.config import (
    ETA, SURFACE_BETHE_MIX, SURFACE_GREEN_CONVERGENCE, SURFACE_MAX_ITER_BETHE)
from gaunegf_tpu_torch.models.bethe import DIM, PLANE_DIRS, _record
from gaunegf_tpu_torch.models.chain1d import surface_g_sancho
from gaunegf_tpu_torch.ops.kernels import fixed_point as _fpk

__all__ = ["monkhorst_pack_2d", "kspace_phases", "phases_for_frac",
           "little_group", "bz_reduce", "kspace_sigma_down",
           "kspace_sigma_surface", "DOWN_DIRS"]

DOWN_DIRS = (3, 4, 5)                  # below-plane neighbour slots
_UP_DIRS = (9, 10, 11)

_C128 = torch.complex128


def monkhorst_pack_2d(nk: int):
    """nk x nk Monkhorst-Pack fractional coordinates in the surface BZ."""
    f = (np.arange(nk) + 0.5) / nk - 0.5
    k1, k2 = np.meshgrid(f, f, indexing="ij")
    return np.stack([k1.ravel(), k2.ravel()], axis=1)      # (nk^2, 2)


def _recip_basis(n_vecs: np.ndarray):
    """(normal, b1, b2): unit surface normal and the 2D reciprocal basis
    of the in-plane lattice vectors (slots 0/1), b_i . a_j = 2 pi d_ij."""
    n_vecs = np.asarray(n_vecs, float)
    normal = np.cross(n_vecs[0], n_vecs[1])
    normal /= np.linalg.norm(normal)
    a1, a2 = n_vecs[0], n_vecs[1]
    M = np.array([[a1 @ a1, a1 @ a2], [a2 @ a1, a2 @ a2]])
    Minv = np.linalg.inv(M)
    b1 = 2 * np.pi * (Minv[0, 0] * a1 + Minv[0, 1] * a2)
    b2 = 2 * np.pi * (Minv[1, 0] * a1 + Minv[1, 1] * a2)
    return normal, b1, b2


def phases_for_frac(n_vecs: np.ndarray, frac: np.ndarray):
    """Bloch phases e^{i k.R} at the given fractional surface-BZ points.

    Returns (plane_phases (Nk, 6), down_phases (Nk, 3)); see
    kspace_phases."""
    n_vecs = np.asarray(n_vecs, float)
    normal, b1, b2 = _recip_basis(n_vecs)

    def in_plane(v):
        return v - np.dot(v, normal) * normal

    frac = np.asarray(frac, float)
    kvecs = frac[:, :1] * b1[None, :] + frac[:, 1:] * b2[None, :]  # (Nk, 3)
    plane_R = np.stack([n_vecs[d] for d in PLANE_DIRS])             # (6, 3)
    down_R = np.stack([in_plane(n_vecs[d]) for d in DOWN_DIRS])     # (3, 3)
    plane_ph = np.exp(1j * kvecs @ plane_R.T)
    down_ph = np.exp(1j * kvecs @ down_R.T)
    return plane_ph, down_ph


def kspace_phases(n_vecs: np.ndarray, nk: int):
    """Bloch phases e^{i k.R} for the 6 in-plane + 3 below-plane slots.

    The in-plane lattice vectors are slots 0 and 1 of the matched fcc
    direction set (unit NN distance -- phases are scale-free); reciprocal
    vectors satisfy b_i . a_j = 2 pi delta_ij within the plane.  Returns
    (plane_phases (Nk, 6), down_phases (Nk, 3)) complex arrays.
    """
    return phases_for_frac(n_vecs, monkhorst_pack_2d(nk))


# ---------------------------------------------------------------------------
# Surface-BZ symmetry reduction (C3v little group of the fcc(111) plane)
# ---------------------------------------------------------------------------

def _orbital_rep(R: np.ndarray) -> np.ndarray:
    """9x9 orbital representation of a 3x3 orthogonal transform R.

    Basis order (s, px, py, pz, dz2, dxz, dyz, dx2-y2, dxy) -- the
    project's Slater-Koster convention (slater_koster.rotation_matrix).
    The l=2 block is derived numerically: the real d harmonics are
    quadratic forms, so evaluating f_i(R^T u) on generic unit vectors and
    least-squares-fitting back onto the basis gives the representation
    matrix exactly (to rounding).  Works for improper ops (mirrors) too,
    where the two-angle constructor cannot."""
    R = np.asarray(R, float)

    def dharm(u):
        x, y, z = u
        r3 = np.sqrt(3.0)
        return np.array([
            (3 * z * z - 1.0) / 2.0,
            r3 * x * z,
            r3 * y * z,
            r3 * (x * x - y * y) / 2.0,
            r3 * x * y,
        ])

    rng = np.random.default_rng(12345)
    U = rng.standard_normal((12, 3))
    U /= np.linalg.norm(U, axis=1, keepdims=True)
    Phi = np.stack([dharm(u) for u in U], axis=1)          # (5, 12)
    # active convention (f_i(R u) = sum_j D[i,j] f_j(u)): matches
    # rotation_matrix's blocks (verified against its analytic l=2 block)
    Phi_rot = np.stack([dharm(R @ u) for u in U], axis=1)
    D5 = Phi_rot @ np.linalg.pinv(Phi)

    out = np.zeros((DIM, DIM))
    out[0, 0] = 1.0
    out[1:4, 1:4] = R
    out[4:9, 4:9] = D5
    return out


def _match_set(ops_img: np.ndarray, ref: np.ndarray, tol=1e-8):
    """Permutation p with ops_img[i] == ref[p[i]], or None."""
    p = []
    for v in ops_img:
        d = np.linalg.norm(ref - v[None, :], axis=1)
        j = int(np.argmin(d))
        if d[j] > tol or j in p:
            return None
        p.append(j)
    return p


def little_group(n_vecs: np.ndarray):
    """Point-group ops of the contact plane that fix the neighbour sets.

    Candidates: rotations about the surface normal by multiples of 60
    degrees and mirrors through planes containing the normal and each
    in-plane neighbour / bond bisector.  An op survives only if it
    permutes BOTH the 6 in-plane and the 3 below-plane neighbour vectors
    (empirical gate -- for fcc(111) with ABC stacking the survivors form
    C3v, 6 ops).  Returns a list of 3x3 matrices including the identity.
    """
    n_vecs = np.asarray(n_vecs, float)
    normal, _, _ = _recip_basis(n_vecs)
    plane_R = np.stack([n_vecs[d] for d in PLANE_DIRS])
    down_R = np.stack([n_vecs[d] for d in DOWN_DIRS])

    def axis_rot(axis, ang):
        axis = axis / np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)

    cands = [np.eye(3)]
    for k in range(1, 6):
        cands.append(axis_rot(normal, k * np.pi / 3))
    for v in plane_R:
        u = v / np.linalg.norm(v)
        # mirror through the plane spanned by (normal, u)
        m = np.cross(normal, u)
        cands.append(np.eye(3) - 2 * np.outer(m, m))
    for i in range(len(plane_R)):
        v = plane_R[i] + plane_R[(i + 1) % len(plane_R)]
        if np.linalg.norm(v) < 1e-9:
            continue
        u = v / np.linalg.norm(v)
        m = np.cross(normal, u)
        cands.append(np.eye(3) - 2 * np.outer(m, m))

    ops, seen = [], []
    for R in cands:
        if any(np.max(np.abs(R - S)) < 1e-8 for S in seen):
            continue
        seen.append(R)
        if _match_set(plane_R @ R.T, plane_R) is None:
            continue
        if _match_set(down_R @ R.T, down_R) is None:
            continue
        ops.append(R)
    return ops


def bz_reduce(n_vecs: np.ndarray, nk: int):
    """Symmetry-reduced Gamma-centred surface-BZ grid.

    Returns (frac_reps (n_reps, 2), mask (n_reps, n_ops), D (n_ops, 9, 9),
    nk_full) such that for any k-resolved 9x9 quantity M(k) that
    transforms as M(g k) = D_g M(k) D_g^T (Bloch blocks, half-space
    sigmas), the full-grid average equals

        (1/nk_full) sum_r sum_o mask[r, o] * D_o M(k_r) D_o^T.

    The Gamma-centred grid (i/nk fractions) is closed under the little
    group's integer action on fractional coordinates; ops whose action
    does not land on the grid (or with no nontrivial partner) are
    dropped.  Returns None when no reduction is available (caller falls
    back to the full Monkhorst-Pack grid)."""
    n_vecs = np.asarray(n_vecs, float)
    normal, b1, b2 = _recip_basis(n_vecs)
    a1, a2 = n_vecs[0], n_vecs[1]
    ops3 = little_group(n_vecs)
    if len(ops3) <= 1:
        return None

    # fractional action: frac' = (R k) . a_j / (2 pi); keep ops whose
    # action is an integer matrix on the k-lattice (grid-closure)
    kept, W = [], []
    for R in ops3:
        Wg = np.array([[(R @ b1) @ a1, (R @ b2) @ a1],
                       [(R @ b1) @ a2, (R @ b2) @ a2]]) / (2 * np.pi)
        Wi = np.rint(Wg)
        if np.max(np.abs(Wg - Wi)) < 1e-8:
            kept.append(R)
            W.append(Wi.astype(int))
    if len(kept) <= 1:
        return None

    D = np.stack([_orbital_rep(R) for R in kept])

    idx = np.arange(nk * nk)
    ii, jj = idx // nk, idx % nk
    visited = np.zeros(nk * nk, bool)
    reps, masks = [], []
    for p in range(nk * nk):
        if visited[p]:
            continue
        images = {}
        for o, Wg in enumerate(W):
            f2 = Wg @ np.array([ii[p], jj[p]])
            q = int((f2[0] % nk) * nk + (f2[1] % nk))
            if q not in images:
                images[q] = o
        for q in images:
            visited[q] = True
        row = np.zeros(len(kept))
        for q, o in images.items():
            row[o] = 1.0
        reps.append(p)
        masks.append(row)
    frac_reps = np.stack([ii[reps] / nk, jj[reps] / nk], axis=1)
    frac_reps = (frac_reps + 0.5) % 1.0 - 0.5
    return frac_reps, np.stack(masks), D, nk * nk


def _c128(x, device):
    return torch.as_tensor(x, device=device).to(_C128)


def _real_scalar(x, device):
    x = torch.as_tensor(x, device=device)
    return (x.real if x.dtype.is_complex else x).to(torch.float64)


def _bloch_blocks(H, Slist, Vlist, plane_ph, down_ph):
    """H00(k)/S00(k) intra-layer and H01(k)/S01(k) inter-layer blocks.

    Shapes: (Nk, 9, 9) each; Slist/Vlist are the 12 directional SK
    matrices in slot order."""
    plane = list(PLANE_DIRS)
    down = list(DOWN_DIRS)
    eye = torch.eye(DIM, dtype=plane_ph.dtype, device=plane_ph.device)
    H00 = H[None] + torch.einsum("kd,dij->kij", plane_ph, Vlist[plane])
    S00 = eye[None] + torch.einsum("kd,dij->kij", plane_ph, Slist[plane])
    H01 = torch.einsum("kd,dij->kij", down_ph, Vlist[down])
    S01 = torch.einsum("kd,dij->kij", down_ph, Slist[down])
    return H00, S00, H01, S01


def kspace_sigma_down(E, H, Slist, Vlist, plane_ph, down_ph, eta=ETA,
                      conv=SURFACE_GREEN_CONVERGENCE, max_iter=64,
                      sym_mask=None, sym_D=None, nk_full=None):
    """BZ-averaged half-space self-energy Sigma_down(E) for a batch of
    energies E (b,) -> (b, 9, 9).

    One Sancho-Rubio decimation per energy and k point, all b*Nk of them
    one batch of surface_g_sancho.

    With (sym_mask (n_reps, n_ops), sym_D (n_ops, 9, 9), nk_full) from
    ``bz_reduce``, the phases cover only the symmetry-reduced
    representatives (~nk^2/6 for fcc(111)'s C3v) and the full-grid
    average is reassembled exactly by the orbital-rotation sandwich
    sum_r sum_o mask[r,o] D_o M(k_r) D_o^T / nk_full."""
    H = torch.as_tensor(H)
    dev = H.device
    out_dtype = H.dtype if H.dtype.is_complex else _C128
    E = torch.as_tensor(E, device=dev).to(_C128).reshape(-1)
    # retarded branch (see the module docstring: matches the branch the
    # Bethe fixed points' -1j seed selects)
    z = (E + 1j * _real_scalar(eta, dev))[:, None, None, None]
    H00, S00, H01, S01 = _bloch_blocks(
        H.to(_C128), _c128(Slist, dev), _c128(Vlist, dev),
        _c128(plane_ph, dev), _c128(down_ph, dev))
    A = z * S00 - H00                           # (b, Nk, 9, 9)
    B = z * S01 - H01
    b, nk = A.shape[:2]
    A = A.reshape(b * nk, DIM, DIM)
    B = B.reshape(b * nk, DIM, DIM)
    g = surface_g_sancho(A, B, conv, max_iter)
    sig = (B @ g @ B.conj().transpose(-1, -2)).reshape(b, nk, DIM, DIM)
    if sym_mask is None:
        return sig.mean(dim=1).to(out_dtype)
    D = _c128(sym_D, dev)
    m = _c128(sym_mask, dev)
    out = torch.einsum("ro,oij,brjk,olk->bil", m, D, sig, D)
    denom = m.sum() if nk_full is None else nk_full
    return (out / denom).to(out_dtype)


def kspace_sigma_surface(E, H, Slist, Vlist, plane_ph, down_ph, eta=ETA,
                         conv=SURFACE_GREEN_CONVERGENCE,
                         mix=SURFACE_BETHE_MIX,
                         max_iter=SURFACE_MAX_ITER_BETHE, sig0=None,
                         sym_mask=None, sym_D=None, nk_full=None):
    """Surface sigmas for a k-integrated contact atom at the energies E
    (b,): (sig_dirs (b, 9, 9, 9), sig_down (b, 9, 9)).

    sig_down is the exact BZ-averaged half-space term (no fixed point);
    the 6 in-plane directional sigmas re-relax around it with the Bethe
    Jacobi iteration (models/bethe.bethe_sigma_surface pattern), seeded
    from zero -- or from ``sig0`` (a previous energy's converged stack,
    (9, 9, 9) or per lane (b, 9, 9, 9)) for warm-started sweeps.
    Warm-seeding is restricted to THIS relaxed Jacobi loop on purpose:
    seeding the per-k Sancho decimation with a previous-energy g is
    unsound for chain contacts (spurious attracting fixed points near band
    features), while the mix<1 Jacobi relaxation is the basin-preserving
    Bethe warm path.
    sig_dirs has the DOWN slots zeroed; the embedding's per-atom sigma is
    sig_down + sum(in-plane sig_dirs) - matched in-plane slots.
    """
    sig_down = kspace_sigma_down(E, H, Slist, Vlist, plane_ph, down_ph,
                                 eta, conv, sym_mask=sym_mask, sym_D=sym_D,
                                 nk_full=nk_full)
    out_dtype = sig_down.dtype
    dev = sig_down.device
    sig_down = sig_down.to(_C128)
    E = torch.as_tensor(E, device=dev).to(_C128).reshape(-1)
    z = E + 1j * _real_scalar(eta, dev)
    eye = torch.eye(DIM, dtype=_C128, device=dev)
    A = z[:, None, None] * eye - _c128(H, dev) - sig_down
    B = z[:, None, None, None] * _c128(Slist, dev) - _c128(Vlist, dev)
    b = E.shape[0]
    if sig0 is None:
        seed = torch.zeros((b, 9, DIM, DIM), dtype=_C128, device=dev)
    else:
        if not isinstance(sig0, torch.Tensor):
            sig0 = np.array(sig0, dtype=np.complex128)
        seed = torch.broadcast_to(_c128(sig0, dev),
                                  (b, 9, DIM, DIM)).clone()
    _, sig, counts, _ = _fpk.fixed_point(A, B, seed, conv, mix, max_iter,
                                         bulk=None, surface=True)
    _record(counts[:, 1])
    return sig.to(out_dtype), sig_down.to(out_dtype)
