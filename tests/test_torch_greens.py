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
import torch

from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models.selfenergy import ConstantSelfEnergy as JaxSigma
from gaunegf_tpu.ops.greens import EnergyEngine as JaxEngine
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.interop import constant_self_energy_from_arrays
from gaunegf_tpu_torch.ops import greens as tg
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
    H, S, inds, sig1, sig2, E, w = junction
    g = constant_self_energy_from_arrays(H, S, inds, sig1, sig2)
    auto = EnergyEngine(H, S, g, ExecutionConfig(solver="auto"),
                        device="cpu")
    lu = EnergyEngine(H, S, g, ExecutionConfig(solver="lu"), device="cpu")
    assert np.array_equal(auto.gr_sum(E, w), lu.gr_sum(E, w))
    with pytest.raises(NotImplementedError, match="spectral"):
        EnergyEngine(H, S, g, ExecutionConfig(solver="spectral"),
                     device="cpu")
    for tier in ("high", "exact"):
        with pytest.raises(NotImplementedError):
            EnergyEngine(H, S, g, ExecutionConfig(precision=tier),
                         device="cpu")


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


def test_near_pole_guard_reads_only_the_cache(junction, monkeypatch):
    """Silent with no cached eigenvalues (nothing computed for the check);
    warns once per grid when a cached eigenvalue sits within
    spectral_dist_f32 of a real-axis point."""
    H, S, inds, sig1, sig2, _, _ = junction
    g = constant_self_energy_from_arrays(H, S, inds, sig1, sig2)
    eng = EnergyEngine(H, S, g, ExecutionConfig(solver="lu"), device="cpu")
    lam = np.linalg.eigvalsh(H)          # stand-in "cached" eigenvalues
    grid = np.array([lam[10] + 1e-6, 0.5 + 0.3j])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng._near_pole_guard(grid)                     # empty cache
    monkeypatch.setitem(tg._PENCIL_EIGENVALUES,
                        tg._content_digest(H, S), lam)
    eng._pole_checked.clear()
    with pytest.warns(RuntimeWarning, match="bare eigenvalue"):
        eng._near_pole_guard(grid)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng._near_pole_guard(grid)                     # once per grid
