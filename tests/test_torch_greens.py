"""The port's EnergyEngine (LU route) vs the JAX package's.

A junction of N=64 orbitals with 4+4 constant contact orbitals, built
from the same NumPy arrays in both packages.  The JAX engine runs under
x64 (conftest), i.e. complex128 LAPACK solves: the truth to ~1e-14.  The
port runs its mixed tier on the CPU: complex64 blocked LU (the strip
kernel's plain version) refined once against the complex128 operator, so
each G(E) holds ~6e-8 (its complex64 storage) away from poles; sums over
~48 points are held to 1e-6 of their largest entry.  Real-axis points
carry an imaginary offset of 1e-2, which keeps them off the poles.
"""

import warnings

import numpy as np
import pytest
import scipy.linalg
import torch

from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models.selfenergy import ConstantSelfEnergy as JaxSigma
from gaunegf_tpu.ops.greens import EnergyEngine as JaxEngine
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.interop import constant_self_energy_from_arrays
from gaunegf_tpu_torch.ops import greens as tg
from gaunegf_tpu_torch.ops import spectral as sp
from gaunegf_tpu_torch.ops.greens import EnergyEngine, Route
from torch_recording import recording  # noqa: F401  (a fixture)

N = 64
SUM_REL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def junction():
    rng = np.random.default_rng(11)
    H = -1.0 * (np.eye(N, k=1) + np.eye(N, k=-1)) \
        + np.diag(0.3 * rng.standard_normal(N))
    S = np.eye(N) + 0.05 * (np.eye(N, k=1) + np.eye(N, k=-1))
    inds = (np.arange(4), np.arange(N - 4, N))
    sig1 = -0.2j * np.ones(4) + 0.05 * rng.standard_normal(4)
    sig2 = -0.1j
    E = np.linspace(-2.2, 2.2, 48) + 1e-2j
    w = rng.standard_normal(48) * 0.1
    return H, S, inds, sig1, sig2, E, w


def _engines(junction, chunk=16, **cfg):
    H, S, inds, sig1, sig2, _, _ = junction
    g_j = JaxSigma(H, S, list(inds), sig1=sig1, sig2=sig2)
    g_t = constant_self_energy_from_arrays(H, S, inds, sig1, sig2)
    jax_eng = JaxEngine(H, S, g_j, JaxConfig(solver="lu", energy_chunk=8))
    port = EnergyEngine(H, S, g_t, ExecutionConfig(
        solver="lu", lu_panel="pstrip", energy_chunk=chunk, **cfg),
        device="cpu")
    return jax_eng, port


def _rel(x, ref):
    return np.max(np.abs(x - ref)) / np.max(np.abs(ref))


def test_gr_sum_im_matches_jax(junction):
    *_, E, w = junction
    jax_eng, port = _engines(junction)
    ref = jax_eng.gr_sum(E, w, epilog="im")
    got = port.gr_sum(E, w, epilog="im")
    assert got.dtype == np.float64
    assert _rel(got, ref) < SUM_REL


def test_gr_sum_complex_matches_jax(junction):
    *_, E, w = junction
    jax_eng, port = _engines(junction, chunk=7)     # ragged last chunk
    assert _rel(port.gr_sum(E, w), jax_eng.gr_sum(E, w)) < SUM_REL


@pytest.mark.parametrize("lowrank", [True, False])
def test_gless_sum_matches_jax(junction, lowrank):
    *_, E, w = junction
    jax_eng, port = _engines(junction, use_lowrank=lowrank)
    ref = jax_eng.gless_sum(E.real, w, contact=-1)
    got = port.gless_sum(E.real, w, contact=-1)
    # the low-rank path neglects the 1e-9 broadening background's Gamma
    assert _rel(got, ref) < SUM_REL


def test_density_neq_sum_matches_jax(junction):
    *_, E, w = junction
    jax_eng, port = _engines(junction)
    En = np.linspace(-0.3, 0.3, 20)
    wn = np.full(20, 0.03)
    ref = jax_eng.density_neq_sum(E, w, En, wn, contact=-1)
    got = port.density_neq_sum(E, w, En, wn, contact=-1)
    assert _rel(got, ref) < SUM_REL


def test_density_eq_split_matches_jax(junction):
    *_, E, w = junction
    jax_eng, port = _engines(junction)
    Er = np.linspace(-30.0, -3.0, 10)
    wr = np.full(10, 0.1)
    ref = jax_eng.density_eq_split(Er, wr, E, w)
    got = port.density_eq_split(Er, wr, E, w)
    assert _rel(got, ref) < SUM_REL


@pytest.mark.parametrize("precision,bound", [("fast", 1e-4), ("strict", 1e-12)])
def test_precision_tiers(junction, precision, bound):
    """'fast' is the complex64 blocked LU alone (~cond * u32); 'strict'
    solves in complex128 (torch.linalg.solve)."""
    *_, E, w = junction
    jax_eng, port = _engines(junction, precision=precision)
    assert _rel(port.gr_sum(E, w), jax_eng.gr_sum(E, w)) < bound


def test_solver_routing(junction):
    """'auto' (the default) and 'spectral' engage the spectral route on
    the fast and mixed tiers, 'lu' forces the LU route, and the high and
    exact tiers keep their complex128 LU under 'auto'; every route agrees
    with the complex128 strict tier."""
    H, S, inds, sig1, sig2, E, w = junction
    g = constant_self_energy_from_arrays(H, S, inds, sig1, sig2)
    ref = EnergyEngine(H, S, g, ExecutionConfig(precision="strict"),
                       device="cpu").gr_sum(E, w)
    auto = EnergyEngine(H, S, g, ExecutionConfig(), device="cpu")
    assert auto.exec_cfg.solver == "auto"
    assert auto.route("gr") == Route("spectral")
    assert _rel(auto.gr_sum(E, w), ref) < 1e-12
    spectral = EnergyEngine(H, S, g, ExecutionConfig(solver="spectral"),
                            device="cpu")
    assert spectral.route("gr") == Route("spectral")
    assert np.array_equal(spectral.gr_sum(E, w), auto.gr_sum(E, w))
    lu = EnergyEngine(H, S, g, ExecutionConfig(solver="lu"), device="cpu")
    assert lu.route("gr") == Route("lu")
    assert _rel(lu.gr_sum(E, w), ref) < SUM_REL
    with pytest.raises(ValueError, match="solver"):
        EnergyEngine(H, S, g, ExecutionConfig(solver="newton"), device="cpu")
    # high/exact: the complex128 blocked LU (swap-pivoted panel), held to
    # complex128 (torch.linalg.solve, the strict tier)
    for tier in ("high", "exact"):
        eng = EnergyEngine(H, S, g, ExecutionConfig(precision=tier),
                           device="cpu")
        assert eng.route("gr") == Route("lu")
        assert _rel(eng.gr_sum(E, w), ref) < 1e-12


class _MeshStub:
    """A mesh of one 'e' rank and two 'm' ranks, for routing only."""
    shape = {"e": 1, "m": 2}
    coords = {"e": 0, "m": 0}
    rank = 0
    device = torch.device("cpu")


# kind, ExecutionConfig keywords, provider ('const', 'warm': a warm
# interface that it recommends), mesh, route: one case per row of
# EnergyEngine.route's table, in its order
ROUTE_TABLE = [
    ("gr", {}, "const", False, Route("spectral")),
    ("gr", {"solver": "lu"}, "warm", False, Route("warm")),
    ("gr", {"solver": "lu", "continuation": True}, "const", False,
     Route("chain")),
    ("gr", {"solver": "lu", "precision": "high"}, "const", True,
     Route("lu", 2)),
    ("gless", {}, "const", False, Route("spectral")),
    ("gless", {"solver": "lu"}, "warm", False, Route("warm")),
    ("gless", {"solver": "lu", "continuation": True}, "const", True,
     Route("lu")),
    ("density_neq", {"solver": "lu", "continuation": True}, "const", False,
     Route("gr+gless")),
    ("density_neq", {"solver": "lu"}, "const", True, Route("lu", 2)),
    ("density_eq_split", {"solver": "lu"}, "const", False,
     Route("lu+chain")),
    ("density_eq_split", {}, "const", False, Route("spectral")),
    ("transmission", {}, "const", False, Route("spectral")),
    ("transmission", {"solver": "lu"}, "warm", False, Route("warm")),
    ("transmission", {"solver": "lu", "warm_start": False}, "warm", False,
     Route("cold")),
    ("transmission", {"solver": "lu"}, "const", True, Route("lu", 2)),
    ("gr_diag", {"solver": "lu"}, "const", True, Route("lu")),
    ("map", {}, "const", False, Route("lu")),
]


@pytest.mark.parametrize("kind,cfg,provider,mesh,want", ROUTE_TABLE)
def test_route_table(kind, cfg, provider, mesh, want):
    """route(kind) gives each row of its docstring's table."""
    from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
    n = 16
    H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    S = np.eye(n)
    g = ConstantSelfEnergy(H, S, [np.arange(2), np.arange(n - 2, n)],
                           sig1=-0.1j, device="cpu")
    if provider == "warm":
        g.contacts_warm_apply = lambda **kw: None
        g.warm_profitable = True
    cfg = ExecutionConfig(energy_chunk=4, **cfg)
    eng = (EnergyEngine(H, S, g, cfg, _MeshStub()) if mesh
           else EnergyEngine(H, S, g, cfg, device="cpu"))
    assert eng.route(kind) == want


@pytest.mark.parametrize("field", [
    "lu_trail", "spectral_dw", "spectral_basis",
    "spectral_basis_device_min_n", "spectral_warm_basis"])
def test_execution_config_rejects_the_tpu_fields(field):
    """The JAX package's ExecutionConfig keeps five fields that choose
    among its TPU emulations; the port has no such paths and rejects
    them."""
    value = getattr(JaxConfig(), field)
    with pytest.raises(TypeError, match=field):
        ExecutionConfig(**{field: value})


def test_device_is_explicit(junction):
    H, S, inds, sig1, sig2, _, _ = junction
    g = constant_self_energy_from_arrays(H, S, inds, sig1, sig2)
    with pytest.raises(TypeError, match="device"):
        EnergyEngine(H, S, g, device=None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            EnergyEngine(H, S, g, device="cuda")


def test_auto_chunk_rule():
    """chunk = largest power of two with chunk * bytes/lane within the
    budget, clamped to [1, _CHUNK_MAX]."""
    cfg = ExecutionConfig()
    for n in (64, 1000, 2000, 8000, 40000):
        c = tg._auto_chunk_cfg(cfg, n).energy_chunk
        assert 1 <= c <= tg._CHUNK_MAX and c & (c - 1) == 0
        assert c == 1 or c * tg._LANE_BYTES_PER_N2 * n * n \
            <= tg._CHUNK_BUDGET_BYTES
        assert c == tg._CHUNK_MAX or 2 * c * tg._LANE_BYTES_PER_N2 * n * n \
            > tg._CHUNK_BUDGET_BYTES


def test_near_pole_guard_values_once_per_engine(junction, recording,
                                                monkeypatch):
    """The guard computes the pencil's eigenvalues once per engine, for
    its first grid with real-axis points, and serves every later grid
    from them; a contour grid computes nothing.  Its path never digests
    the pencil and leaves spectral_basis's cache as it was."""
    H, S, inds, sig1, sig2, _, _ = junction
    g = constant_self_energy_from_arrays(H, S, inds, sig1, sig2)

    def refuse(*a, **k):
        raise AssertionError("the guard digested the pencil")
    monkeypatch.setattr(sp, "content_digest", refuse)
    cache = dict(sp._BASIS_CACHE)
    eng = EnergyEngine(H, S, g, ExecutionConfig(solver="lu"), device="cpu")
    eng._near_pole_guard(np.array([0.5 + 0.3j]))
    assert recording.count("guard.eigvals") == 0
    lam = scipy.linalg.eigh(H, S, eigvals_only=True)
    with pytest.warns(RuntimeWarning, match="bare eigenvalue"):
        eng._near_pole_guard(np.array([lam[10] + 1e-6, 0.5 + 0.3j]))
    with pytest.warns(RuntimeWarning, match="bare eigenvalue"):
        eng._near_pole_guard(np.array([lam[20] - 1e-6]))
    assert recording.count("guard.eigvals") == 1
    assert recording.count("guard.reuse") == 1
    assert sp._BASIS_CACHE.keys() == cache.keys()
    assert all(sp._BASIS_CACHE[k] is v for k, v in cache.items())


def _guard_pencil(overlap):
    """A random real-symmetric H of N orbitals; S = I, or a non-orthogonal
    definite S."""
    rng = np.random.default_rng(5)
    H = -1.0 * (np.eye(N, k=1) + np.eye(N, k=-1)) \
        + np.diag(0.3 * rng.standard_normal(N))
    S = np.eye(N)
    if overlap:
        S = S + 0.08 * (np.eye(N, k=1) + np.eye(N, k=-1)) \
            + 0.01 * (np.eye(N, k=3) + np.eye(N, k=-3))
    return H, S


def _guard_engine(H, S, precision):
    g = constant_self_energy_from_arrays(
        H, S, (np.arange(4), np.arange(N - 4, N)), -0.1j, -0.1j)
    return EnergyEngine(H, S, g, ExecutionConfig(
        solver="lu", precision=precision), device="cpu")


@pytest.mark.parametrize("precision", ["fast", "mixed"])
@pytest.mark.parametrize("overlap", [False, True])
def test_near_pole_guard_against_scipy(precision, overlap):
    """The guard's values are scipy.linalg.eigvalsh's: the same count of
    points within spectral_dist_f32 and the same closest distance."""
    H, S = _guard_pencil(overlap)
    lam_ref = scipy.linalg.eigvalsh(H, S)
    z = np.array([lam_ref[5] + 3.7e-6, lam_ref[20] - 2.3e-5,
                  lam_ref[40] + 5e-4, 0.5 + 0.3j])
    d_ref = np.abs(z[:3, None] - lam_ref[None, :]).min(axis=1)
    eng = _guard_engine(H, S, precision)
    with pytest.warns(RuntimeWarning, match="bare eigenvalue") as rec:
        eng._near_pole_guard(z)
    (w,) = rec
    assert f"{int((d_ref < 1e-4).sum())} grid point(s)" in str(w.message)
    assert f"closest {d_ref.min():.2e}" in str(w.message)
    d = np.abs(z[:3, None] - eng._pole_lam[None, :]).min(axis=1)
    assert np.max(np.abs(d - d_ref)) < 1e-10
    assert np.max(np.abs(eng._pole_lam - lam_ref)) < 1e-10


@pytest.mark.parametrize("precision", ["fast", "mixed"])
@pytest.mark.parametrize("pencil", ["complex_H", "nonsymmetric_H",
                                    "indefinite_S"])
def test_near_pole_guard_skips_unfit_pencils(precision, pencil, recording):
    """A pencil spectral_basis refuses is skipped without a warning: H
    with an imaginary part, H off symmetry by more than 1e-10 of its
    largest entry, S not positive definite."""
    H, S = _guard_pencil(False)
    lam = np.linalg.eigvalsh(H)
    if pencil == "complex_H":
        H = H + 1e-3j * (np.eye(N, k=1) - np.eye(N, k=-1))
    elif pencil == "nonsymmetric_H":
        H = H + 1e-7 * np.triu(np.ones((N, N)), 1)
    else:
        S = S.copy()
        S[N // 2, N // 2] = -1.0
    eng = _guard_engine(H, S, precision)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng._near_pole_guard(np.array([lam[10] + 1e-6, lam[30] - 1e-6]))
    assert eng._pole_lam is None
    assert recording.count("guard.eigvals") == 1


def _pole_system():
    """tests/test_near_pole_warn.py's junction."""
    rng = np.random.default_rng(0)
    H = -1.0 * (np.eye(N, k=1) + np.eye(N, k=-1)) \
        + np.diag(0.2 * rng.standard_normal(N))
    S = np.eye(N)
    g = constant_self_energy_from_arrays(
        H, S, (np.arange(4), np.arange(N - 4, N)), -0.1j, -0.1j)
    lam = np.linalg.eigvalsh(H)
    return H, S, g, np.array([lam[N // 2] + 4.4e-7, lam[0] - 1.0])


def _pole_engine(**cfg):
    H, S, g, E = _pole_system()
    cfg = {"solver": "lu", "energy_chunk": 2, **cfg}
    return EnergyEngine(H, S, g, ExecutionConfig(**cfg), device="cpu"), E


def test_guard_fires_on_near_pole_lu_grid():
    eng, E = _pole_engine()
    with pytest.warns(RuntimeWarning, match="solver='auto'"):
        eng.gr_sum(E, np.ones(E.size))


def test_guard_fires_once_per_grid():
    eng, E = _pole_engine()
    with pytest.warns(RuntimeWarning):
        eng.gr_sum(E, np.ones(E.size))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng.gr_sum(E, np.ones(E.size))          # same grid: silent
    with pytest.warns(RuntimeWarning):          # a new near-pole grid warns
        eng.gr_sum(E + 1e-9, np.ones(E.size))


def test_guard_on_the_gless_path():
    eng, E = _pole_engine()
    with pytest.warns(RuntimeWarning, match="bare eigenvalue"):
        eng.gless_sum(E, np.ones(E.size), contact=0)


def test_guard_silent_on_an_off_axis_contour():
    eng, E = _pole_engine()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng.gr_sum(E + 0.3j, np.ones(E.size))


def test_guard_silent_on_the_spectral_default():
    """solver='auto' serves near-pole points in contract (deflation, or
    the exact-tier fallback), so the default configuration never warns."""
    for defl in (8, 0):
        eng, E = _pole_engine(solver="auto", spectral_deflate=defl)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            eng.gr_sum(E, np.ones(E.size))


def test_guard_silent_on_high_tier_or_disabled():
    for cfg in ({"precision": "high"}, {"near_pole_warn": False}):
        eng, E = _pole_engine(**cfg)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            eng.gr_sum(E, np.ones(E.size))
