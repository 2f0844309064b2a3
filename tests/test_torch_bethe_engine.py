"""The energy engines of gaunegf_tpu_torch on Bethe-lattice contacts
against the JAX package (x64, CPU): the warm-started engines on the same
lane layout (1e-9), warm against cold (1e-4 for T, 1e-5 for a density:
the JAX tests' bounds), the complex128 tiers' tight sigma (2e-7 against a
reference iterated to 1e-13), and which route serves which parameter set.
tests/test_torch_bethe.py says how the 1e-9 comparisons are set up
(``_default_policy``, one explicit energy chunk)."""

from gaunegf_tpu.ops.greens import _layout_lane_major
from gaunegf_tpu_torch.ops.greens import _lane_major
import numpy as np
import pytest
import torch

from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models import bethe as jbt
from gaunegf_tpu.models.fock import TightBindingFock as JaxFock
from gaunegf_tpu.ops.greens import EnergyEngine as JaxEngine
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models import bethe as bt
from gaunegf_tpu_torch.models.fock import TightBindingFock
from gaunegf_tpu_torch.ops import greens
from gaunegf_tpu_torch.ops.greens import EnergyEngine, Route
from test_torch_bethe import (                      # helpers, no tests
    _default_policy, _fcc_slab, _junction, _pair, _rel)

torch.set_num_threads(1)
CPU = torch.device("cpu")

# ---------------------------------------------------------------------------
# Engines: warm, cold, tight
# ---------------------------------------------------------------------------

def _engine_system(lat, eta=1e-5):
    n = 12 * 9 + 4
    rng = np.random.default_rng(5)
    F = np.zeros((n, n))
    F[:27, :27] += 0.05 * np.diag(np.cos(np.arange(27)))
    F[27:, 27:] += np.diag(rng.uniform(-1, 1, n - 27))
    F[0, -1] = F[-1, 0] = -0.5
    S = np.eye(n)
    _, arr, jp = _pair(lat, eta=eta, F=F, S=S)
    return F, S, arr, jp


@pytest.mark.parametrize("n,chunk", [(13, 4), (12, 4), (3, 8), (9, 1)])
def test_lane_major_layout_matches_jax(n, chunk):
    """Which energy seeds which decides the iterate: lane j of the port
    owns the same contiguous segment as in the JAX package (whose lanes
    are padded to the chunk; the port drops the padding)."""
    E = np.arange(n, dtype=float)
    lanes, n_chunks, index = _lane_major(n, chunk)
    E_lay, n_jax, _ = _layout_lane_major(E, None, min(chunk, n))
    assert n_jax == n and E_lay.shape == (1, n_chunks, lanes)
    valid = index < n
    assert np.array_equal(E_lay[0][valid], E[index[valid]])
    for c in range(n_chunks):                   # valid lanes are a prefix
        k = int(valid[c].sum())
        assert valid[c, :k].all() and not valid[c, k:].any()


@pytest.mark.parametrize("lat", ["demo", "Au"])
def test_warm_interface_matches_jax_along_a_lane(lat):
    """contacts_warm_apply carried along one lane's segment: sigmas and
    state to 1e-9 of the JAX package's."""
    F, S, arr, jp = _engine_system(lat)
    wfn, params, state = arr.contacts_warm_apply()
    jfn, jparams, jstate = jp.contacts_warm_apply()
    assert len(state) == len(jstate) and state[0].shape == (12, 9, 9)
    p = bt._host_params(params, "cpu")
    jstate = tuple(np.asarray(s, dtype=np.complex128) for s in jstate)
    state = tuple(torch.as_tensor(s)[None] for s in state)
    for E in np.linspace(-3.0, -2.0, 5):
        sigs, state = wfn(p, torch.tensor([E + 0j]), state)
        jsigs, jstate = jfn(jparams, np.complex128(E), jstate)
        assert _rel(sigs[0][0].numpy(), np.asarray(jsigs[0])) < 1e-9
        assert _rel(state[0][0].numpy(), np.asarray(jstate[0])) < 1e-9
    E1 = torch.tensor([-2.0 + 0j])
    tot, _ = arr.total_apply_warm()[0](p, E1, state)
    sigs, _ = wfn(p, E1, state)
    assert _rel(tot[0].numpy(), sum(sg[0] for sg in sigs).numpy()) < 1e-12


@pytest.mark.parametrize("lat", ["demo", "Au"])
def test_warm_engines_match_jax(lat, _default_policy):
    """gr_sum, gless_sum and T(E) of the warm engines on the same lane
    layout (13 points in chunks of 4: padding in the last lane) to 1e-9."""
    F, S, arr, jp = _engine_system(lat)
    rng = np.random.default_rng(1)
    E = np.linspace(-3, 1, 13) + 0.05j
    w = rng.standard_normal(13) + 0j
    et = EnergyEngine(F, S, arr, ExecutionConfig(
        energy_chunk=4, solver="lu", precision="exact"), device=CPU)
    ej = JaxEngine(F, S, jp, JaxConfig(energy_chunk=4, solver="lu"))
    assert et.route("gr") == Route("warm") and ej._use_warm()
    assert _rel(et.gr_sum(E, w), ej.gr_sum(E, w)) < 1e-9
    assert _rel(et.gr_sum(E, w, epilog="im"),
                ej.gr_sum(E, w, epilog="im")) < 1e-9
    assert _rel(et.gless_sum(E, w, 0), ej.gless_sum(E, w, 0)) < 1e-9
    assert _rel(et.gless_sum(E, w), ej.gless_sum(E, w)) < 1e-9
    Tt, Tj = et.transmission(E.real), ej.transmission(E.real)
    assert np.abs(Tt - Tj).max() < 1e-9 * max(1.0, np.abs(Tj).max())
    dn = et.density_neq_sum(E, w, E[:5], w[:5], 0)
    assert _rel(dn, ej.density_neq_sum(E, w, E[:5], w[:5], 0)) < 1e-9


@pytest.mark.parametrize("lat", ["demo", "Au"])
def test_cold_engines_match_jax(lat, _default_policy):
    F, S, arr, jp = _engine_system(lat)
    E = np.linspace(-3, 1, 9) + 0.05j
    w = np.cos(np.arange(9)) + 0j
    et = EnergyEngine(F, S, arr, ExecutionConfig(
        energy_chunk=4, solver="lu", precision="exact", warm_start=False),
        device=CPU)
    ej = JaxEngine(F, S, jp, JaxConfig(energy_chunk=4, solver="lu",
                                       warm_start=False))
    assert et.route("gr") == Route("lu") and not ej._use_warm()
    assert _rel(et.gr_sum(E, w), ej.gr_sum(E, w)) < 1e-9
    assert _rel(et.gless_sum(E, w, -1), ej.gless_sum(E, w, -1)) < 1e-9
    Tt, Tj = et.transmission(E.real), ej.transmission(E.real)
    assert np.abs(Tt - Tj).max() < 1e-9 * max(1.0, np.abs(Tj).max())


def _one_orbital_device():
    """tests/test_bethe.py's warm-against-cold system: the slab and one
    device orbital."""
    n = 12 * 9 + 1
    F = np.zeros((n, n))
    F[-1, -1] = -8.0
    F[0, -1] = F[-1, 0] = -0.5
    prov = bt.BetheSelfEnergy(F, np.eye(n), [[1, 2, 3]],
                              _fcc_slab(bt.BetheGeometry, n_dev_orb=1),
                              lat_file="demo", eta=1e-5, fermi=0.0,
                              device="cpu", verbose=False)
    return F, np.eye(n), prov


def test_warm_transmission_matches_cold():
    """Both stop at conv = 1e-5 of the same fixed point from different
    seeds; the JAX test's bound (1e-4, up to ~8 channels)."""
    F, S, prov = _one_orbital_device()
    E = np.linspace(-10, -6, 12)
    warm = EnergyEngine(F, S, prov, ExecutionConfig(
        energy_chunk=4, solver="lu"), device=CPU)
    cold = EnergyEngine(F, S, prov, ExecutionConfig(
        energy_chunk=4, solver="lu", warm_start=False), device=CPU)
    assert warm.route("transmission") == Route("warm")
    assert cold.route("transmission") == Route("cold")
    Tw, Tc = warm.transmission(E), cold.transmission(E)
    assert np.max(np.abs(Tw - Tc)) < 1e-4
    assert Tw.min() > -1e-8 and Tw.max() > 1e-6
    full = EnergyEngine(F, S, prov, ExecutionConfig(
        energy_chunk=4, solver="lu", use_lowrank=False), device=CPU)
    assert np.max(np.abs(full.transmission(E) - Tw)) < 1e-4   # full inverse
    # the cold sweep solves each contact once per energy, from the initial
    # state: the same numbers as the separate total / contact functions
    # (a converged lane is frozen, so the batch does not matter: 1e-12)
    fn, params = prov.total_apply()
    g1, g2 = prov.contact_apply(0)[0], prov.contact_apply(-1)[0]
    c = cold._contact_inds(0)
    Et, p = torch.as_tensor(E + 0j), bt._host_params(params, "cpu")
    sig = greens._Sigmas(lambda i: {None: fn, 0: g1, -1: g2}[i](p, Et))
    sep = greens._transmission_lowrank(Et, sig, cold.H, cold.S,
                                       cold.exec_cfg, c, c).numpy()
    assert np.max(np.abs(sep - Tc)) < 1e-12


def test_warm_density_matches_cold():
    """13 points in chunks of 4: the dropped padding lanes contribute
    nothing; the JAX test's bound (1e-5)."""
    from gaunegf_tpu_torch import density as dens
    F, S, prov = _one_orbital_device()
    Pw = dens.density_complex_n(F, S, prov, -12.0, -7.0, 13,
                                exec_cfg=ExecutionConfig(
                                    energy_chunk=4, solver="lu"), device=CPU)
    Pc = dens.density_complex_n(F, S, prov, -12.0, -7.0, 13,
                                exec_cfg=ExecutionConfig(
                                    energy_chunk=4, solver="lu",
                                    warm_start=False), device=CPU)
    assert np.max(np.abs(Pw - Pc)) < 1e-5
    Pa = dens.density_complex_n(F, S, prov, -12.0, -7.0, 13,
                                exec_cfg=ExecutionConfig(solver="lu"),
                                device=CPU)       # one chunk: every lane cold
    assert np.max(np.abs(Pa - Pc)) < 1e-5


def test_warm_start_settings():
    F, S, prov = _one_orbital_device()
    mk = lambda **kw: EnergyEngine(F, S, prov, ExecutionConfig(**kw),
                                   device=CPU)
    assert mk().route("gr", spectral=False) == Route("warm")
    assert mk(warm_start=False).route("gr", spectral=False) == Route("lu")
    for tier in ("high", "exact", "strict"):
        eng = mk(precision=tier)
        assert eng.route("gr") == Route("lu")
        assert eng.route("transmission") == Route("cold")
        assert eng._conv() == {"conv": bt.TIGHT_CONV}
        assert eng._total()[0].__wrapped__ \
            is prov.total_apply(conv=bt.TIGHT_CONV)[0]
    assert mk()._conv() == {} \
        and mk()._total()[0].__wrapped__ is prov.total_apply()[0]
    from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
    const = ConstantSelfEnergy(F, S, [[0], [1]], sig1=-0.1j)
    assert EnergyEngine(F, S, const, ExecutionConfig(precision="high"),
                        device=CPU)._conv() == {}      # nothing to iterate
    from gaunegf_tpu_torch.models.chain1d import Chain1DSelfEnergy
    assert Chain1DSelfEnergy.warm_profitable is False
    assert ExecutionConfig().warm_start is True


@pytest.mark.parametrize("tier", ["high", "exact", "strict"])
@pytest.mark.parametrize("lat", ["demo", "Au"])
def test_high_tiers_use_the_tight_sigma(lat, tier):
    """The complex128 tiers ask the provider for the fixed point at conv
    1e-11: gr_sum within 2e-7 of a reference with the map iterated to
    1e-13 and the embedding redone from _static_key (the bound of the JAX
    package's test_high_tier_engine_uses_bethe_dw); the default tier's
    sigma, stopped at 1e-5, would miss it."""
    F, S, prov, _ = _engine_system(lat, eta=1e-6)
    E = np.array([-1.3 + 0.05j, 0.4 + 0.05j, 1.9 + 0.05j])
    w = np.array([0.7, 1.1, 0.3], dtype=complex)
    inds, nind, N, spin, orthogonal, _ = prov._static_key()
    g0 = prov.g_list[0]
    truth = np.zeros((N, N), dtype=np.complex128)
    loose = np.zeros((N, N), dtype=np.complex128)
    for conv, acc in ((1e-13, truth), (1e-5, loose)):
        surf = bt.bethe_sigma_surface(torch.as_tensor(E), g0.H, g0.Slist,
                                      g0.Vlist, g0.eta, conv=conv,
                                      max_iter=5000).numpy()
        for s, Ek, wk in zip(surf, E, w):
            sig = np.zeros((N, N), dtype=np.complex128)
            for n_inds, f_inds in zip(nind[0], inds[0]):
                atom = s[:9].sum(axis=0)
                for k in n_inds:
                    if k < 9:
                        atom = atom - s[k]
                sig[np.ix_(np.asarray(f_inds), np.asarray(f_inds))] = atom
            if orthogonal:
                sig = prov.Xi @ sig @ prov.Xi
            acc += wk * np.linalg.inv(Ek * S - F - sig)
    eng = EnergyEngine(F, S, prov, ExecutionConfig(
        precision=tier, energy_chunk=3), device=CPU)
    assert _rel(eng.gr_sum(E, w), truth) < 2e-7
    assert _rel(loose, truth) > 2e-7
    assert _rel(eng.gless_sum(E, w, 0), _gless_ref(prov, F, S, E, w)) < 2e-7


def _gless_ref(prov, F, S, E, w):
    fn, params = prov.contact_apply(0, conv=bt.TIGHT_CONV)
    sig = fn(bt._host_params(params, "cpu"), torch.as_tensor(E)).numpy()
    out = 0
    for s, Ek, wk in zip(sig, E, w):
        G = np.linalg.inv(Ek * S - F - s)
        out = out + wk * G @ (1j * (s - s.conj().T)) @ G.conj().T
    return out


def test_which_route_serves_each_parameter_set():
    """In both packages gr_sum asks the spectral runner first and the warm
    engines serve what it declines (plus the LU's T(E)).  A non-orthogonal
    set with spin 'r' exposes contact_inds, so the spectral route takes
    the sums wherever its structure detection accepts the provider (a
    support of at most N/2 orbitals); an orthogonal set (Au, Ag, Cu: all
    Harrison, zero overlaps) has none -- the dense Xi sig Xi -- and its
    sums are full inverses on the warm-started LU.  (The spin layouts:
    tests/test_torch_spin.py::test_which_route_serves_each_layout.)"""
    F, S, demo, jdemo = _engine_system("demo")         # 27 of 112 orbitals
    et = EnergyEngine(F, S, demo, ExecutionConfig(), device=CPU)
    ej = JaxEngine(F, S, jdemo, JaxConfig())
    assert et.route("gr") == Route("spectral")
    assert ej._spectral_runner() is not None
    assert et.route("transmission", spectral=False) == Route("warm")
    assert ej._use_warm()                          # serves the LU's T(E)
    assert et._contact_inds(0) == ej._contact_inds(0) is not None
    F, S, au, jau = _engine_system("Au")
    et = EnergyEngine(F, S, au, ExecutionConfig(), device=CPU)
    ej = JaxEngine(F, S, jau, JaxConfig())
    assert et.route("gr") == Route("warm") and ej._spectral_runner() is None
    assert ej._use_warm()
    assert et._contact_inds(0) is None and ej._contact_inds(0) is None
    # the 56-orbital junction: 54 contact orbitals > N / 2, declined
    be, geom = _junction(TightBindingFock, bt.BetheGeometry)
    jbe, jgeom = _junction(JaxFock, jbt.BetheGeometry)
    Fj = be.H0
    own = bt.BetheSelfEnergy(Fj, np.eye(56), [[1, 2, 3], [6, 7, 8]], geom,
                             lat_file="demo", fermi=0.0, device="cpu",
                             verbose=False)
    jp = jbt.BetheSelfEnergy(Fj, np.eye(56), [[1, 2, 3], [6, 7, 8]], jgeom,
                             lat_file="demo", fermi=0.0, verbose=False)
    et = EnergyEngine(Fj, np.eye(56), own, ExecutionConfig(), device=CPU)
    ej = JaxEngine(Fj, np.eye(56), jp, JaxConfig())
    assert et.route("gr") == Route("warm") and ej._spectral_runner() is None
    assert ej._use_warm()


def test_spectral_route_with_bethe_contacts():
    """The spectral route on a Bethe provider (through total_block_apply)
    against the warm LU: both stop at conv 1e-5 from different seeds."""
    F, S, demo, _ = _engine_system("demo")
    E = np.linspace(-3, 1, 9) + 0.05j
    w = np.cos(np.arange(9)) + 0j
    sp = EnergyEngine(F, S, demo, ExecutionConfig(), device=CPU)
    lu = EnergyEngine(F, S, demo, ExecutionConfig(solver="lu",
                                                  warm_start=False),
                      device=CPU)
    assert sp.route("gr") == Route("spectral")
    assert _rel(sp.gr_sum(E, w), lu.gr_sum(E, w)) < 1e-5
    assert _rel(sp.gless_sum(E, w, 0), lu.gless_sum(E, w, 0)) < 1e-5
    assert np.abs(sp.transmission(E.real) - lu.transmission(E.real)).max() \
        < 1e-4


