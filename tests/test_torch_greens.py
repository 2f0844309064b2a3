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
from gaunegf_tpu_torch.ops.greens import EnergyEngine

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
    assert auto._spectral_runner() is not None
    assert _rel(auto.gr_sum(E, w), ref) < 1e-12
    spectral = EnergyEngine(H, S, g, ExecutionConfig(solver="spectral"),
                            device="cpu")
    assert spectral._spectral_runner() is not None
    assert np.array_equal(spectral.gr_sum(E, w), auto.gr_sum(E, w))
    lu = EnergyEngine(H, S, g, ExecutionConfig(solver="lu"), device="cpu")
    assert lu._spectral_runner() is None
    assert _rel(lu.gr_sum(E, w), ref) < SUM_REL
    with pytest.raises(ValueError, match="solver"):
        EnergyEngine(H, S, g, ExecutionConfig(solver="newton"), device="cpu")
    # high/exact: the complex128 blocked LU (swap-pivoted panel), held to
    # complex128 (torch.linalg.solve, the strict tier)
    for tier in ("high", "exact"):
        eng = EnergyEngine(H, S, g, ExecutionConfig(precision=tier),
                           device="cpu")
        assert eng._spectral_runner() is None
        assert _rel(eng.gr_sum(E, w), ref) < 1e-12


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


def test_near_pole_guard_reads_only_the_cache(junction):
    """The guard takes its eigenvalues from spectral_basis's cache, which
    the spectral route shares: after the guard has run, the spectral
    runner of the same (H, S) finds the basis cached and does no second
    eigh.  A contour grid needs no eigenvalues at all."""
    H, S, inds, sig1, sig2, _, _ = junction
    g = constant_self_energy_from_arrays(H, S, inds, sig1, sig2)
    H = H + 1e-3 * np.eye(N)               # a pencil no other test caches
    sp._BASIS_CACHE.pop((sp.content_digest(H, S), "cpu"), None)
    eng = EnergyEngine(H, S, g, ExecutionConfig(solver="lu"), device="cpu")
    eng._near_pole_guard(np.array([0.5 + 0.3j]))
    assert (sp.content_digest(H, S), "cpu") not in sp._BASIS_CACHE
    lam = scipy.linalg.eigh(H, S, eigvals_only=True)
    with pytest.warns(RuntimeWarning, match="bare eigenvalue"):
        eng._near_pole_guard(np.array([lam[10] + 1e-6, 0.5 + 0.3j]))
    cached = sp._BASIS_CACHE[(sp.content_digest(H, S), "cpu")]
    assert np.allclose(cached[0], lam, atol=1e-12)
    auto = EnergyEngine(H, S, g, ExecutionConfig(), device="cpu")
    assert auto._spectral_runner().C is cached[1]


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
