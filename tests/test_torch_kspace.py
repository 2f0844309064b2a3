"""gaunegf_tpu_torch's k-space surface self-energies against the JAX
package (x64, CPU): the host geometry is a copy (1e-12); the sigmas on
tensors agree to 1e-10 of their size, a batch of energies equals the same
energies one at a time to 1e-13, and the symmetry-reduced grid equals the
full Gamma-centred grid (1e-12 in complex128; the JAX test allows its
f32 path 1e-6)."""

import numpy as np
import pytest
import torch

from gaunegf_tpu.models import kspace as jks
from gaunegf_tpu_torch.models import harrison as hr
from gaunegf_tpu_torch.models import kspace as ks
from gaunegf_tpu_torch.models import slater_koster as sk

torch.set_num_threads(1)
ES = np.array([-12.0, -9.5 + 0.02j, -6.0, 1.0])


def _rel(x, ref):
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


def _lattice(lat="Au"):
    p = hr.bethe_params("Au") if lat == "Au" else sk.parse_bethe_file(lat)
    n_vecs = sk.fcc111_neighbor_directions(np.array([0, 0, 1.0]),
                                           np.array([1.0, 0, 0]))
    Sl = np.stack([sk.bond_matrix(p.overlap, d) for d in n_vecs])
    Vl = np.stack([sk.bond_matrix(p.hopping, d) for d in n_vecs])
    return p.h0(), n_vecs, Sl, Vl


@pytest.mark.parametrize("nk", [1, 3, 4])
def test_grid_and_phases_are_copies(nk):
    _, n_vecs, _, _ = _lattice()
    assert np.array_equal(ks.monkhorst_pack_2d(nk), jks.monkhorst_pack_2d(nk))
    for a, b in zip(ks.kspace_phases(n_vecs, nk),
                    jks.kspace_phases(n_vecs, nk)):
        assert np.abs(a - b).max() < 1e-12
    for a, b in zip(ks._recip_basis(n_vecs), jks._recip_basis(n_vecs)):
        assert np.abs(a - b).max() < 1e-12
    pp, dp = ks.kspace_phases(n_vecs, nk)
    assert pp.shape == (nk * nk, 6) and dp.shape == (nk * nk, 3)
    assert np.allclose(np.abs(pp), 1) and np.allclose(np.abs(dp), 1)
    if nk == 1:                       # Monkhorst-Pack nk=1 is Gamma
        assert np.allclose(pp, 1) and np.allclose(dp, 1)


def test_symmetry_helpers_are_copies():
    _, n_vecs, _, _ = _lattice()
    ops, jops = ks.little_group(n_vecs), jks.little_group(n_vecs)
    assert len(ops) == len(jops) == 6              # C3v
    for R, Rj in zip(ops, jops):
        assert np.abs(R - Rj).max() < 1e-12
        assert np.abs(ks._orbital_rep(R) - jks._orbital_rep(Rj)).max() < 1e-12
    dets = sorted(round(float(np.linalg.det(R))) for R in ops)
    assert dets == [-1, -1, -1, 1, 1, 1]
    assert ks._match_set(np.eye(3)[[1, 0, 2]], np.eye(3)) == [1, 0, 2]
    assert ks._match_set(np.ones((1, 3)), np.eye(3)) is None


@pytest.mark.parametrize("nk", [2, 4, 6])
def test_bz_reduce_is_a_copy(nk):
    _, n_vecs, _, _ = _lattice()
    a, b = ks.bz_reduce(n_vecs, nk), jks.bz_reduce(n_vecs, nk)
    assert a[3] == b[3] == nk * nk
    for x, y in zip(a[:3], b[:3]):
        assert np.abs(np.asarray(x) - np.asarray(y)).max() < 1e-12
    assert int(a[1].sum()) == nk * nk              # every point once


@pytest.mark.parametrize("lat", ["Au", "demo"])
def test_sigma_down_matches_jax(lat):
    H, n_vecs, Sl, Vl = _lattice(lat)
    pp, dp = ks.kspace_phases(n_vecs, 2)
    got = ks.kspace_sigma_down(torch.as_tensor(ES), H, Sl, Vl, pp, dp,
                               eta=1e-5).numpy()
    assert got.shape == (len(ES), 9, 9)
    ref = np.stack([np.asarray(jks.kspace_sigma_down(
        np.complex128(e), H, Sl, Vl, pp, dp, eta=1e-5)) for e in ES])
    assert _rel(got, ref) < 1e-10
    one = np.stack([ks.kspace_sigma_down(
        torch.as_tensor([e]), H, Sl, Vl, pp, dp, eta=1e-5).numpy()[0]
        for e in ES])
    assert np.abs(got - one).max() < 1e-13
    for s in got:                                  # retarded branch
        assert np.linalg.eigvalsh(1j * (s - s.conj().T)).min() > -1e-6


def test_sigma_down_symmetry_reduced_matches_jax_and_full_grid():
    """test_kspace.py::test_bz_reduction_exact: the reduced grid's
    symmetrized sigma equals the full Gamma-centred grid's."""
    H, n_vecs, Sl, Vl = _lattice()
    nk = 6
    frac_reps, mask, D, nk_full = ks.bz_reduce(n_vecs, nk)
    assert len(frac_reps) <= 12                    # 36 -> 10 at nk = 6
    ii, jj = np.meshgrid(np.arange(nk), np.arange(nk), indexing="ij")
    frac_full = np.stack([ii.ravel() / nk, jj.ravel() / nk], axis=1)
    frac_full = (frac_full + 0.5) % 1.0 - 0.5
    E = torch.as_tensor(np.array([-5.0, 1.0 + 0j]))
    ph_f = ks.phases_for_frac(n_vecs, frac_full)
    ph_r = ks.phases_for_frac(n_vecs, frac_reps)
    full = ks.kspace_sigma_down(E, H, Sl, Vl, *ph_f).numpy()
    red = ks.kspace_sigma_down(E, H, Sl, Vl, *ph_r, sym_mask=mask, sym_D=D,
                               nk_full=nk_full).numpy()
    assert _rel(red, full) < 1e-12
    red2 = ks.kspace_sigma_down(E, H, Sl, Vl, *ph_r, sym_mask=mask,
                                sym_D=D).numpy()  # nk_full from the mask
    assert _rel(red2, red) < 1e-14
    ref = np.stack([np.asarray(jks.kspace_sigma_down(
        np.complex128(e), H, Sl, Vl, *ph_r, sym_mask=mask, sym_D=D,
        nk_full=nk_full)) for e in E.numpy()])
    assert _rel(red, ref) < 1e-10


@pytest.mark.parametrize("sym", [False, True])
def test_sigma_surface_matches_jax(sym):
    H, n_vecs, Sl, Vl = _lattice("demo")
    kw = {}
    if sym:
        frac_reps, mask, D, _ = ks.bz_reduce(n_vecs, 4)
        pp, dp = ks.phases_for_frac(n_vecs, frac_reps)
        kw = {"sym_mask": mask, "sym_D": D}
    else:
        pp, dp = ks.kspace_phases(n_vecs, 2)
    dirs, down = ks.kspace_sigma_surface(torch.as_tensor(ES), H, Sl, Vl,
                                         pp, dp, eta=1e-5, **kw)
    assert dirs.shape == (len(ES), 9, 9, 9) and down.shape == (len(ES), 9, 9)
    assert float(dirs[:, [3, 4, 5]].abs().max()) == 0.0   # DOWN slots zero
    ref = [jks.kspace_sigma_surface(np.complex128(e), H, Sl, Vl, pp, dp,
                                    eta=1e-5, **kw) for e in ES]
    assert _rel(dirs.numpy(), np.stack([np.asarray(r[0]) for r in ref])) \
        < 1e-10
    assert _rel(down.numpy(), np.stack([np.asarray(r[1]) for r in ref])) \
        < 1e-10
    one = np.stack([ks.kspace_sigma_surface(
        torch.as_tensor([e]), H, Sl, Vl, pp, dp, eta=1e-5,
        **kw)[0].numpy()[0] for e in ES])
    assert np.abs(dirs.numpy() - one).max() < 1e-13


def test_sigma_surface_warm_seed_matches_jax():
    """sig0 seeds only the in-plane relaxation; (9, 9, 9) for every lane
    or (b, 9, 9, 9) per lane."""
    H, n_vecs, Sl, Vl = _lattice("demo")
    pp, dp = ks.kspace_phases(n_vecs, 2)
    seed = np.asarray(jks.kspace_sigma_surface(
        np.complex128(-9.0), H, Sl, Vl, pp, dp, eta=1e-5)[0])
    got = ks.kspace_sigma_surface(torch.as_tensor(ES), H, Sl, Vl, pp, dp,
                                  eta=1e-5, sig0=seed)[0].numpy()
    ref = np.stack([np.asarray(jks.kspace_sigma_surface(
        np.complex128(e), H, Sl, Vl, pp, dp, eta=1e-5, sig0=seed)[0])
        for e in ES])
    assert _rel(got, ref) < 1e-10
    per_lane = np.stack([seed * (1 + 0.01 * k) for k in range(len(ES))])
    got = ks.kspace_sigma_surface(torch.as_tensor(ES), H, Sl, Vl, pp, dp,
                                  eta=1e-5, sig0=per_lane)[0].numpy()
    ref = np.stack([np.asarray(jks.kspace_sigma_surface(
        np.complex128(e), H, Sl, Vl, pp, dp, eta=1e-5, sig0=s)[0])
        for e, s in zip(ES, per_lane)])
    assert _rel(got, ref) < 1e-10


def test_dtype_follows_the_params():
    H, n_vecs, Sl, Vl = _lattice("demo")
    pp, dp = ks.kspace_phases(n_vecs, 2)
    E = torch.as_tensor(ES[:2])
    ref = ks.kspace_sigma_down(E, H, Sl, Vl, pp, dp)
    out = ks.kspace_sigma_down(E.to(torch.complex64),
                               torch.as_tensor(H).to(torch.complex64),
                               Sl, Vl, pp, dp)
    assert ref.dtype == torch.complex128 and out.dtype == torch.complex64
    assert _rel(out.numpy(), ref.numpy()) < 1e-5
