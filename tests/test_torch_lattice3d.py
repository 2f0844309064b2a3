"""gaunegf_tpu_torch's 3D-lattice contact provider against the JAX package
(x64, CPU): geometry detection is a copy (1e-12); sigmas in gamma-point
and k-space mode agree to 1e-10 of their size, built by the port's own
detection and rebuilt from the JAX provider's host state; the warm
interface to 1e-9 along a lane; warm against cold at the JAX tests' bounds
(5e-4 of sigma along a sweep, T to rtol 1e-4); the complex128 tiers within
2e-7 of a tightly converged reference."""

import numpy as np
import pytest
import torch

from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models import bethe as jbt
from gaunegf_tpu.models.lattice3d import Lattice3DSelfEnergy as JaxLattice3D
from gaunegf_tpu.models.lattice3d import _detect_contact_3d as jax_detect
from gaunegf_tpu.ops.greens import EnergyEngine as JaxEngine
from gaunegf_tpu_torch import interop
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models import bethe as bt
from gaunegf_tpu_torch.models.lattice3d import (
    Lattice3DSelfEnergy, _detect_contact_3d)
from gaunegf_tpu_torch.ops import greens
from gaunegf_tpu_torch.ops.greens import EnergyEngine, Route

torch.set_num_threads(1)
CPU = torch.device("cpu")
N_ORB = 4 * 9 + 4
MODES = {"gamma": {},
         "kspace": {"gamma_point_only": False, "nk": 2},
         "kspace_sym4": {"gamma_point_only": False, "nk": 4},
         "kspace_mp4": {"gamma_point_only": False, "nk": 4,
                        "bz_symmetry": False}}


def _rel(x, ref):
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


def _plane_geometry(cls, d=2.88, z_dev=-5.0):
    """tests/test_lattice3d.py's single hexagonal contact plane of 4 atoms
    and a device atom."""
    u1 = np.array([1.0, 0.0, 0.0]) * d
    u2 = np.array([0.5, np.sqrt(3) / 2, 0.0]) * d
    coords = np.stack([np.zeros(3), u1, u2, u1 + u2,
                       np.array([1.0, 0.6, z_dev])])
    orb_atoms = np.repeat(np.arange(1, 6), [9, 9, 9, 9, 4])
    return cls(coords, orb_atoms, None)


def _system():
    rng = np.random.default_rng(3)
    F = np.zeros((N_ORB, N_ORB))
    F[36:, 36:] = np.diag(rng.uniform(-9, -7, 4))
    F[0, 36] = F[36, 0] = -0.4
    F[27, 39] = F[39, 27] = -0.3
    return F, np.eye(N_ORB)


def _pair(mode, lat="demo", eta=1e-6, spin="r"):
    """(port provider by its own detection, port provider rebuilt from the
    JAX provider's host state, JAX provider)."""
    F, S = _system()
    if spin != "r":
        F, S = np.kron(np.eye(2), F), np.eye(2 * N_ORB)
    kw = dict(lat_file=lat, spin=spin, eta=eta, T=0.0, fermi=0.0,
              verbose=False, **MODES[mode])
    jp = JaxLattice3D(F, S, [[1, 2, 3, 4]],
                      _plane_geometry(jbt.BetheGeometry), **kw)
    own = Lattice3DSelfEnergy(F, S, [[1, 2, 3, 4]],
                              _plane_geometry(bt.BetheGeometry),
                              device="cpu", **kw)
    ps = jp.params_sk
    arr = interop.lattice3d_self_energy_from_arrays(
        F, S, ps.ne, ps.onsite, ps.hopping, ps.overlap, jp.inds_lists,
        jp.n_ind_lists, jp.dir_lists, jp.fermi, jp.spin, jp.eta, jp.T,
        phases=jp._phases if jp.kspace else None,
        syms=jp._syms if jp.kspace else None, nk=jp.nk, device="cpu")
    return F, S, own, arr, jp


@pytest.mark.parametrize("z_dev", [-5.0, 5.0])
def test_detection_matches_and_points_outward(z_dev):
    a = _detect_contact_3d(_plane_geometry(bt.BetheGeometry, z_dev=z_dev),
                           [1, 2, 3, 4])
    b = jax_detect(_plane_geometry(jbt.BetheGeometry, z_dev=z_dev),
                   [1, 2, 3, 4])
    for x, y in zip(a[0], b[0]):
        assert np.array_equal(x, y)
    for i in (1, 2, 3):
        assert np.abs(np.asarray(a[i]) - np.asarray(b[i])).max() < 1e-12
    assert a[4] == b[4]
    normal, n_vecs = a[1], a[3]
    assert normal[2] * z_dev < 0            # away from the structure
    for d in (3, 4, 5):                     # bulk-side slots on +normal
        assert n_vecs[d] @ normal > 0.5


def test_rejects_non_planar():
    geom = _plane_geometry(bt.BetheGeometry)
    coords = geom.coords.copy()
    coords[1, 2] += 2.5
    bad = bt.BetheGeometry(coords, geom.orbital_atoms, None)
    F, S = _system()
    with pytest.raises(ValueError, match="Lattice mismatch"):
        Lattice3DSelfEnergy(F, S, [[1, 2, 3, 4]], bad, lat_file="demo",
                            fermi=0.0, device="cpu", verbose=False)


@pytest.mark.parametrize("lat", ["demo", "Au"])
@pytest.mark.parametrize("mode", list(MODES))
def test_sigma_matches_jax(mode, lat):
    F, S, own, arr, jp = _pair(mode, lat)
    assert own.kspace == jp.kspace == (mode != "gamma")
    assert own._static_key()[:5] == jp._static_key()
    for E in (-2.0, -8.0 + 0.03j):
        ref = jp.sigmaTot(E)
        assert _rel(own.sigmaTot(E), ref) < 1e-10
        assert _rel(arr.sigmaTot(E), ref) < 1e-10
        assert _rel(own.sigma(E, 0), jp.sigma(E, 0)) < 1e-10
    blk = own.sigmaTot(-2.0)[:36, :36]
    assert np.max(np.abs(blk)) > 1e-3
    assert np.linalg.eigvalsh(1j * (blk - blk.conj().T)).min() > -1e-6
    assert own.contact_inds() == jp.contact_inds()
    assert (own.contact_inds() is None) == (lat == "Au")


def test_sigma_matches_jax_unrestricted():
    F, S, own, arr, jp = _pair("kspace", spin="u")
    assert _rel(own.sigmaTot(-8.0), jp.sigmaTot(-8.0)) < 1e-10
    assert own.sigmaTot(-8.0).shape == (2 * N_ORB, 2 * N_ORB)
    assert own.contact_inds() is None


def test_grid_rule_and_params():
    """bz_symmetry folds the grid (16 -> 5 representatives at nk = 4) or,
    switched off, keeps the shifted Monkhorst-Pack grid; the contacts of
    one system never mix the two flavours; the two differ at finite nk."""
    _, _, sym, _, jsym = _pair("kspace_sym4")
    _, _, mp, _, _ = _pair("kspace_mp4")
    c = sym.params()["contacts"][0]
    cj = jsym.params()["contacts"][0]
    assert c["plane_ph"].shape == cj["plane_ph"].shape
    assert c["plane_ph"].shape[0] < 16 and "sym_mask" in c and "sym_D" in c
    for k in ("plane_ph", "down_ph", "sym_mask", "sym_D", "H", "S", "V"):
        assert np.abs(np.asarray(c[k]) - np.asarray(cj[k])).max() < 1e-12
    cm = mp.params()["contacts"][0]
    assert cm["plane_ph"].shape[0] == 16 and "sym_mask" not in cm
    d = _rel(sym.sigmaTot(-2.0), mp.sigmaTot(-2.0))
    assert 1e-6 < d < 0.15
    assert all(s is not None for s in sym._syms)
    assert all(s is None for s in mp._syms)
    gam = _pair("gamma")[2]
    assert "plane_ph" not in gam.params()["contacts"][0]


@pytest.mark.parametrize("mode", ["gamma", "kspace"])
def test_block_function(mode):
    """total_block_apply in both modes: the contact block of the total."""
    _, _, own, _, _ = _pair(mode)
    fn, params = own.total_apply()
    p = bt._host_params(params, "cpu")
    E = torch.as_tensor(np.array([-8.0 + 0j, -2.0 + 0.1j]))
    c = own.contact_inds()
    ci = np.asarray(c)
    full = fn(p, E).numpy()
    blk = own.total_block_apply(c)(p, E).numpy()
    assert np.abs(blk - full[:, ci[:, None], ci[None, :]]).max() < 1e-14
    assert np.abs(full[:, 36:, 36:]).max() == 0.0


@pytest.mark.parametrize("mode", ["gamma", "kspace", "kspace_sym4"])
def test_warm_interface_matches_jax_along_a_lane(mode):
    """k-space mode carries the in-plane Jacobi stack (zero seed), the
    gamma-point mode the Bethe bulk stack."""
    _, _, own, arr, jp = _pair(mode, eta=1e-5)
    wfn, params, state = arr.contacts_warm_apply()
    jfn, jparams, jstate = jp.contacts_warm_apply()
    shape = (12, 9, 9) if mode == "gamma" else (9, 9, 9)
    assert state[0].shape == shape == np.shape(jstate[0])
    if mode != "gamma":
        assert not np.any(state[0])
    p = bt._host_params(params, "cpu")
    jstate = tuple(np.asarray(s, dtype=np.complex128) for s in jstate)
    state = tuple(torch.as_tensor(s)[None] for s in state)
    for E in np.linspace(-9.0, -8.0, 4):
        sigs, state = wfn(p, torch.tensor([E + 0j]), state)
        jsigs, jstate = jfn(jparams, np.complex128(E), jstate)
        assert _rel(sigs[0][0].numpy(), np.asarray(jsigs[0])) < 1e-9
        assert _rel(state[0][0].numpy(), np.asarray(jstate[0])) < 1e-9
    E1 = torch.tensor([-8.0 + 0j])
    tot, _ = arr.total_apply_warm()[0](p, E1, state)
    assert _rel(tot[0].numpy(), wfn(p, E1, state)[0][0][0].numpy()) < 1e-12


def test_kspace_warm_matches_cold_sweep():
    """test_lattice3d.py::test_lattice3d_kspace_warm_matches_cold_sweep:
    only the basin-preserving relaxation carries, so warm and cold land on
    the same sigma across the band (both stop at conv 1e-5; 5e-4)."""
    _, _, own, _, _ = _pair("kspace")
    wfn, params, state = own.contacts_warm_apply()
    p = bt._host_params(params, "cpu")
    cold_fn = own.contact_apply(0)[0]
    state = tuple(torch.as_tensor(s)[None] for s in state)
    worst = 0.0
    for E in np.linspace(-14.0, -2.0, 24):
        Et = torch.tensor([E + 0j])
        sigs, state = wfn(p, Et, state)
        cold = cold_fn(p, Et)[0].numpy()
        worst = max(worst, _rel(sigs[0][0].numpy(), cold))
    assert worst < 5e-4


@pytest.mark.parametrize("mode", ["gamma", "kspace"])
def test_warm_engine_matches_jax_and_cold(mode, monkeypatch):
    """T(E) and gr_sum of the warm engines against the JAX package on the
    same lane layout (1e-9; the port's complex128 LU on the default tier's
    policy, as the JAX engines run under x64), and against the cold path
    (rtol 1e-4, the JAX test's bound)."""
    monkeypatch.setattr(greens, "_TIGHT_TIERS", ())
    F, S, own, arr, jp = _pair(mode, eta=1e-5)
    E = np.linspace(-11.0, -7.0, 8)
    w = np.cos(np.arange(8)) + 0j
    cfg = dict(energy_chunk=4, solver="lu")
    warm = EnergyEngine(F, S, arr, ExecutionConfig(precision="exact", **cfg),
                        device=CPU)
    cold = EnergyEngine(F, S, arr, ExecutionConfig(
        precision="exact", warm_start=False, **cfg), device=CPU)
    jwarm = JaxEngine(F, S, jp, JaxConfig(**cfg))
    assert warm.route("gr") == Route("warm") and jwarm._use_warm()
    assert cold.route("gr") == Route("lu")
    Tw, Tc, Tj = (e.transmission(E) for e in (warm, cold, jwarm))
    assert np.abs(Tw - Tj).max() < 1e-9 * max(1.0, np.abs(Tj).max())
    np.testing.assert_allclose(Tw, Tc, rtol=1e-4, atol=1e-9)
    Ez = E + 0.05j
    assert _rel(warm.gr_sum(Ez, w), jwarm.gr_sum(Ez, w)) < 1e-9
    assert _rel(warm.gr_sum(Ez, w), cold.gr_sum(Ez, w)) < 1e-5


@pytest.mark.parametrize("tier", ["high", "exact", "strict"])
def test_high_tiers_use_the_tight_kspace_sigma(tier):
    """The complex128 tiers iterate the per-k decimation and the in-plane
    relaxation to 1e-11: gr_sum within 2e-7 of a reference built from the
    functions run to 1e-13, at least 10 times closer than the default
    tier's sigma gets."""
    from gaunegf_tpu_torch.models.lattice3d import _kspace_stack
    F, S, own, _, _ = _pair("kspace", eta=1e-6)
    E = np.array([-9.3 + 0.05j, -8.4 + 0.05j, -7.9 + 0.05j])
    w = np.array([0.7, 1.1, 0.3], dtype=complex)
    inds, nind, N, _, _, _ = own._static_key()
    p = bt._host_params(own.params(), "cpu")["contacts"][0]
    sums = {}
    for conv in (1e-13, 1e-5):
        stack = _kspace_stack(p, torch.as_tensor(E), conv).numpy()
        acc = np.zeros((N, N), dtype=np.complex128)
        for s, Ek, wk in zip(stack, E, w):
            sig = np.zeros((N, N), dtype=np.complex128)
            for n_inds, f_inds in zip(nind[0], inds[0]):
                atom = s[:9].sum(axis=0)
                for k in n_inds:
                    if k < 9:
                        atom = atom - s[k]
                sig[np.ix_(np.asarray(f_inds), np.asarray(f_inds))] = atom
            acc += wk * np.linalg.inv(Ek * S - F - sig)
        sums[conv] = acc
    eng = EnergyEngine(F, S, own, ExecutionConfig(
        precision=tier, energy_chunk=3), device=CPU)
    err = _rel(eng.gr_sum(E, w), sums[1e-13])
    assert err < 2e-7
    assert err < _rel(sums[1e-5], sums[1e-13]) / 10   # not the default's
    tight = bt.TIGHT_CONV
    assert own.total_apply(conv=tight)[0] is not own.total_apply()[0]
    assert own.contact_apply(0, conv=tight)[0] is not own.contact_apply(0)[0]
    # T(E) on these tiers: one cold solve per contact at the tight conv
    T = eng.transmission(E.real)
    fn = own.total_apply(conv=tight)[0]
    g1 = own.contact_apply(0, conv=tight)[0]
    Et, p = torch.as_tensor(E.real + 0j), bt._host_params(own.params(), "cpu")
    sig = greens._Sigmas(lambda i: (fn if i is None else g1)(p, Et))
    sep = greens._transmission(Et, sig, eng.H, eng.S, eng.exec_cfg).numpy()
    assert np.abs(T - sep).max() < 1e-10 * max(1.0, np.abs(sep).max())


def test_spectral_route_takes_the_non_orthogonal_plane():
    """36 of 40 orbitals are contact orbitals here, more than N / 2, so
    both packages decline the spectral route and run the warm LU; on a
    wider device the support is accepted."""
    F, S, own, _, jp = _pair("kspace")
    et = EnergyEngine(F, S, own, ExecutionConfig(), device=CPU)
    ej = JaxEngine(F, S, jp, JaxConfig())
    assert et.route("gr") == Route("warm") and ej._spectral_runner() is None
    assert ej._use_warm()
    n = 80
    Fw = np.zeros((n, n))
    Fw[:N_ORB, :N_ORB] = F
    Fw[np.arange(N_ORB, n), np.arange(N_ORB, n)] = -8.0
    Fw[N_ORB - 1, N_ORB] = Fw[N_ORB, N_ORB - 1] = -0.5
    geom = _plane_geometry(bt.BetheGeometry)
    geom = bt.BetheGeometry(geom.coords, np.concatenate(
        [geom.orbital_atoms, np.full(n - N_ORB, 5)]), None)
    wide = Lattice3DSelfEnergy(Fw, np.eye(n), [[1, 2, 3, 4]], geom,
                               lat_file="demo", eta=1e-5, fermi=0.0,
                               device="cpu", verbose=False,
                               gamma_point_only=False, nk=2)
    sp = EnergyEngine(Fw, np.eye(n), wide, ExecutionConfig(), device=CPU)
    lu = EnergyEngine(Fw, np.eye(n), wide, ExecutionConfig(
        solver="lu", warm_start=False), device=CPU)
    assert sp.route("gr") == Route("spectral")
    E = np.linspace(-9, -7, 6) + 0.05j
    w = np.ones(6) + 0j
    assert _rel(sp.gr_sum(E, w), lu.gr_sum(E, w)) < 1e-5
