"""Newton-Schulz continuation (ops/greens.EnergyEngine._chain_sum) against
the batched LU and against the JAX package's chain.

The JAX side runs under conftest's x64: its chain then takes the
complex128 branch (at least 3 Newton steps, the 5e-3 gate, the polish),
which is the port's 'strict' tier.  The port's 'mixed' and 'fast' tiers
iterate in complex64 with the JAX package's device settings (2 steps and
the 3e-2 gate, 3 steps and 5e-3) and are held to the JAX chain at their
tier contracts, 2e-6 and 1e-4 of the sum's largest entry.  Where both
take the same steps in complex128 they agree to rounding (1e-10).

The systems are tests/test_greens.py's and tests/test_density.py's.  The
gate reads r = max|A X - I|, the largest entry, as the JAX package does;
the square of a matrix's largest entry does not bound the largest entry
of its square, so on a dense real-axis grid near narrow levels the gate
passes steps that are further from the LU than the tier's contract, in
both packages alike (test_gate_passes_what_the_jax_chain_passes).
"""

import logging

import numpy as np
import pytest
import torch

from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models.selfenergy import ConstantSelfEnergy as JaxSigma
from gaunegf_tpu.ops.greens import EnergyEngine as JaxEngine
from gaunegf_tpu_torch import density as dens
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
from gaunegf_tpu_torch.ops import greens
from gaunegf_tpu_torch.ops.greens import EnergyEngine
from gaunegf_tpu_torch.ops.spectral import SpectralRunner
from gaunegf_tpu_torch.parallel.launch import spawn_ranks
import torch_chain_ranks as cr

C128 = 1e-10
TIER_REL = {"strict": C128, "mixed": 2e-6, "fast": 1e-4}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(x, ref):
    return float(np.max(np.abs(np.asarray(x) - np.asarray(ref)))
                 / np.max(np.abs(ref)))


def _system(n=60):
    """tests/test_greens.py's junction: a chain with random levels, a
    non-orthogonal S, constant contacts of 6 orbitals."""
    rng = np.random.default_rng(0)
    H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1)) \
        + np.diag(0.2 * rng.standard_normal(n))
    S = np.eye(n) + 0.02 * (lambda x: (x + x.T) / 2)(
        rng.standard_normal((n, n)))
    inds = [np.arange(6), np.arange(n - 6, n)]
    return H, S, inds, rng


# (points, Im E, chunk): test_greens.py's 75-point grid (the gate fails
# on every step there) and 9-point coarse grid, and a 400-point grid
# 0.05 above the axis where all steps but the first pass it
GRIDS = {"dense75": (75, 1e-3, 8), "coarse9": (9, 1e-3, 4),
         "dense400": (400, 0.05, 8)}


def _grid(name, rng):
    n_E, eta, chunk = GRIDS[name]
    lo, hi = (-3, 3) if name == "coarse9" else (-2.5, 2.5)
    return np.linspace(lo, hi, n_E) + 1j * eta, rng.random(n_E), chunk


@pytest.fixture(scope="module")
def jax_chain():
    """The JAX chain's sums (x64) on each grid, built once."""
    H, S, inds, rng = _system()
    g = JaxSigma(H, S, inds, sig1=-0.05j)
    out = {}
    for name in GRIDS:
        E, w, chunk = _grid(name, np.random.default_rng(len(name)))
        out[name] = JaxEngine(H, S, g, JaxConfig(
            energy_chunk=chunk, continuation=True)).gr_sum(E, w)
    return out


def _port(precision, chunk, **kw):
    H, S, inds, _ = _system()
    g = ConstantSelfEnergy(H, S, inds, sig1=-0.05j, device="cpu")
    return EnergyEngine(H, S, g, ExecutionConfig(
        precision=precision, energy_chunk=chunk, **kw), device="cpu")


@pytest.mark.parametrize("name", ["dense75", "coarse9", "dense400"])
def test_chain_matches_batched_lu(name):
    """test_greens.py::test_continuation_engine_matches_standard on the
    port's strict tier: the chain against the batched LU to 1e-10; on the
    coarse grid every step falls back."""
    E, w, chunk = _grid(name, np.random.default_rng(len(name)))
    std = _port("strict", chunk, solver="lu", continuation=False).gr_sum(E, w)
    greens.CHAIN_STEPS.update(newton=0, lu=0)
    chn = _port("strict", chunk, continuation=True).gr_sum(E, w)
    assert _rel(chn, std) < C128
    steps = dict(greens.CHAIN_STEPS)
    n_steps = -(-GRIDS[name][0] // chunk)
    assert steps["newton"] + steps["lu"] == n_steps
    if name == "dense400":
        assert steps == {"newton": n_steps - 1, "lu": 1}
    else:
        assert steps["newton"] == 0


@pytest.mark.parametrize("precision", ["strict", "mixed", "fast"])
@pytest.mark.parametrize("name", ["dense75", "coarse9", "dense400"])
def test_chain_matches_jax_chain(jax_chain, name, precision):
    E, w, chunk = _grid(name, np.random.default_rng(len(name)))
    out = _port(precision, chunk, continuation=True).gr_sum(E, w)
    assert np.isfinite(out).all()
    assert _rel(out, jax_chain[name]) < TIER_REL[precision]


def test_gate_passes_what_the_jax_chain_passes():
    """On a dense grid 0.01 above the axis the max-entry gate passes steps
    1e-9 or more from the batched LU in the JAX chain (x64), a fault of
    the reference that the port copies: the port's strict chain takes the
    same steps and agrees with the JAX chain to 1e-10."""
    H, S, inds, rng = _system()
    E = np.linspace(-2.5, 2.5, 1000) + 0.01j
    w = rng.random(1000)
    jg = JaxSigma(H, S, inds, sig1=-0.05j)
    j_chain = JaxEngine(H, S, jg, JaxConfig(
        energy_chunk=8, continuation=True)).gr_sum(E, w)
    j_lu = JaxEngine(H, S, jg, JaxConfig(energy_chunk=8,
                                         solver="lu")).gr_sum(E, w)
    greens.CHAIN_STEPS.update(newton=0, lu=0)
    port = _port("strict", 8, continuation=True).gr_sum(E, w)
    assert greens.CHAIN_STEPS["newton"] > 100
    assert _rel(j_chain, j_lu) > 1e-9
    assert _rel(port, j_chain) < C128


def test_chunk_not_dividing_the_grid_matches_jax():
    """397 points on 6 lanes: the last step holds one valid lane, the
    padding lanes are dropped (the JAX chain solves them at zero
    weight)."""
    H, S, inds, rng = _system()
    E = np.linspace(-2.5, 2.5, 397) + 0.05j
    w = rng.random(397)
    ref = JaxEngine(H, S, JaxSigma(H, S, inds, sig1=-0.05j), JaxConfig(
        energy_chunk=6, continuation=True)).gr_sum(E, w)
    greens.CHAIN_STEPS.update(newton=0, lu=0)
    out = _port("strict", 6, continuation=True).gr_sum(E, w)
    assert greens.CHAIN_STEPS == {"newton": 66, "lu": 1}
    assert _rel(out, ref) < C128


class _Steps:
    """Records, step by step, the chain's energies and whether the step
    ran the LU fallback (a counter patched onto greens._inv_tier) or kept
    its Newton iterates."""

    def __init__(self, monkeypatch):
        self.kinds, self.energies = [], []
        inv, assemble = greens._inv_tier, greens._assemble_A

        def counted_lu(A, cfg):
            self.kinds[-1] = "lu"
            return inv(A, cfg)

        def recorded_assemble(E, H, S, sigma):
            self.kinds.append("newton")
            self.energies.append(E.numpy().copy())
            return assemble(E, H, S, sigma)

        monkeypatch.setattr(greens, "_inv_tier", counted_lu)
        monkeypatch.setattr(greens, "_assemble_A", recorded_assemble)


def test_the_gate_routes_first_step_narrow_level_and_nan(monkeypatch):
    """The first step has no seed and runs the LU; a step across a level
    1e-4 wide fails the gate; a NaN seed fails it (r is NaN)."""
    n = 24
    H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    H[n // 2, n // 2 + 1] = H[n // 2 + 1, n // 2] = 0.0   # cut the chain
    H[n // 2, n // 2] = 0.3                                # a bound level
    H[n // 2 - 1, n // 2] = H[n // 2, n // 2 - 1] = 1e-3
    S = np.eye(n)
    g = ConstantSelfEnergy(H, S, [np.arange(3), np.arange(n - 3, n)],
                           sig1=-0.5j, device="cpu")
    E = np.linspace(0.0, 0.6, 121) + 1e-4j
    eng = EnergyEngine(H, S, g, ExecutionConfig(
        precision="strict", energy_chunk=1, continuation=True),
        device="cpu")
    steps = _Steps(monkeypatch)
    eng.gr_sum(E, np.ones(E.size))
    kinds = steps.kinds
    assert kinds[0] == "lu"
    at_level = [i for i, e in enumerate(steps.energies)
                if abs(e[0].real - 0.3) < 0.006]
    assert at_level and all(kinds[i] == "lu" for i in at_level)
    far = [i for i, e in enumerate(steps.energies)
           if abs(e[0].real - 0.3) > 0.1]
    assert all(kinds[i] == "newton" for i in far if i > 0)

    # a NaN seed: r is NaN, and NaN < gate is False
    A = torch.eye(4, dtype=torch.complex128)[None]
    X, r = greens._newton_chain(A, torch.full_like(A, float("nan")), 3)
    assert torch.isnan(r) and not bool(r < greens._CHAIN_GATE_FAST)


def test_nan_point_sends_the_next_step_to_the_lu(monkeypatch):
    """A Sigma that is NaN at one energy fails that step's gate (its
    iterates are NaN) and its LU gives a NaN G; the next step, seeded
    from it, fails the gate too and runs the LU; the steps after it are
    Newton steps again."""
    H, S, inds, _ = _system(32)
    g = ConstantSelfEnergy(H, S, inds, sig1=-0.05j, device="cpu")
    E = np.linspace(-1.0, 1.0, 201) + 0.1j
    bad = E[100]

    class NaNAt:
        def total_apply(self, **kw):
            fn, params = g.total_apply(**kw)

            def f(p, Eb):
                s = torch.as_tensor(fn(p, Eb)).expand(len(Eb), 32, 32)
                hit = (Eb == bad)[:, None, None]
                return torch.where(hit, torch.full_like(s, float("nan")), s)
            return f, params

    eng = EnergyEngine(H, S, NaNAt(), ExecutionConfig(
        precision="strict", energy_chunk=1, continuation=True),
        device="cpu")
    steps = _Steps(monkeypatch)
    eng._chain_sum(E, np.ones(E.size), imag=False)
    assert [i for i, k in enumerate(steps.kinds) if k == "lu"] == [0, 100,
                                                                    101]


def test_chain_lanes_follow_the_jax_rule():
    """An explicit energy_chunk is the lane count; an automatic one gives
    the LU's automatic chunk capped at 32."""
    H, S, inds, _ = _system(32)
    g = ConstantSelfEnergy(H, S, inds, sig1=-0.05j, device="cpu")
    auto = EnergyEngine(H, S, g, ExecutionConfig(energy_chunk=0),
                        device="cpu")
    assert auto.exec_cfg.energy_chunk == 128
    assert auto._chain_lanes() == 32
    for ch in (8, 100):
        assert EnergyEngine(H, S, g, ExecutionConfig(energy_chunk=ch),
                            device="cpu")._chain_lanes() == ch


# ---------------------------------------------------------------------------
# density_eq_split: tests/test_density.py:215-253 on the port
# ---------------------------------------------------------------------------

def test_density_eq_split_contour_matches_plain():
    H, S, g = cr.density_system()
    P = {}
    for cont in (False, "contour"):
        greens.CHAIN_STEPS.update(newton=0, lu=0)
        P[cont] = dens.density_eq_n(H, S, g, exec_cfg=ExecutionConfig(
            precision="strict", solver="lu", energy_chunk=8,
            continuation=cont), device="cpu", **cr.DENSITY_KW)
        if cont:
            assert greens.CHAIN_STEPS["newton"] > 0
        else:
            assert greens.CHAIN_STEPS == {"newton": 0, "lu": 0}
    np.testing.assert_allclose(P["contour"], P[False], rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def world_e(tmp_path_factory):
    return spawn_ranks(2, cr.density_checks, (), backend="gloo",
                       init_dir=str(tmp_path_factory.mktemp("chain_e")),
                       timeout=300)


def test_density_eq_split_sharded_matches_serial(world_e):
    """Two 'e' ranks, each on its own contiguous segment of the contour,
    each gating its own steps, reduced once: the serial density to
    1e-8, every rank the same result."""
    r0 = world_e[0]
    assert [r["coords"]["e"] for r in world_e] == [0, 1]
    for r in world_e:
        assert r["steps"]["newton"] > 0
        assert np.array_equal(r["sharded"], r0["sharded"])
    np.testing.assert_allclose(r0["sharded"], r0["serial"], rtol=0,
                               atol=1e-8)


# ---------------------------------------------------------------------------
# Routing: which path runs and which span it emits
# ---------------------------------------------------------------------------

class _MeshStub:
    """A mesh of one 'e' rank and two 'm' ranks, for routing only (the
    recorded paths return zeros, so no collective runs)."""
    shape = {"e": 1, "m": 2}
    coords = {"e": 0, "m": 0}
    rank = 0
    device = torch.device("cpu")

    def sum_e(self, x):
        return x

    def gather_m(self, x, dim):
        return torch.cat([x, x], dim=dim)


class _WarmStub(ConstantSelfEnergy):
    """A provider with a warm interface (its sums are recorded, never
    run)."""
    warm_profitable = True

    def contacts_warm_apply(self, **kw):
        raise AssertionError("recorded paths never call it")


# scenario -> (ExecutionConfig keywords, warm provider, mesh)
SCENARIOS = {
    "plain": (dict(solver="lu"), False, False),
    "spectral": (dict(solver="auto"), False, False),
    "warm": (dict(solver="lu"), True, False),
    "high": (dict(solver="lu", precision="high"), False, False),
    "exact": (dict(solver="lu", precision="exact"), False, False),
    "strict": (dict(solver="lu", precision="strict"), False, False),
    "mesh_m2": (dict(solver="lu"), False, True),
}
# The JAX engine's branches (gaunegf_tpu/ops/greens.py): gr_sum takes the
# spectral route first (:1755-1769; the runner declines for
# continuation=True, :1917-1918), then in _gr_sum_lu the warm engines
# (:1847-1848), the chain for continuation=True below the high tiers
# (:1850-1862), the LU otherwise.  density_eq_split splits for 'contour'
# and True below the high tiers, off the warm engines, with one 'm' shard
# (True forces one, :1953-1954) and no spectral runner (:2081-2084), else
# one gr_sum.  density_neq_sum runs gr_sum + gless_sum for True
# (:2047-2053), else the fused LU sum.  Each cell: (paths, spans).
_GR = {"spectral": (["spectral"], ["gr_sum_spectral"]),
       "chain": (["chain"], ["gr_sum_chain"]),
       "warm": (["warm"], ["gr_sum"]),
       "lu": (["lu"], ["gr_sum"])}
_SPLIT = (["lu", "chain"], ["density_eq_split"])
ROUTES = {
    # scenario: {continuation: (gr_sum, density_eq_split)}
    "plain": {False: (_GR["lu"], _GR["lu"]),
              "contour": (_GR["lu"], _SPLIT),
              True: (_GR["chain"], _SPLIT)},
    "spectral": {False: (_GR["spectral"], _GR["spectral"]),
                 "contour": (_GR["spectral"], _GR["spectral"]),
                 True: (_GR["chain"], _SPLIT)},
    "warm": {c: (_GR["warm"], _GR["warm"])
             for c in (False, "contour", True)},
    "high": {c: (_GR["lu"], _GR["lu"]) for c in (False, "contour", True)},
    "exact": {c: (_GR["lu"], _GR["lu"]) for c in (False, "contour", True)},
    "strict": {False: (_GR["lu"], _GR["lu"]),
               "contour": (_GR["lu"], _SPLIT),
               True: (_GR["chain"], _SPLIT)},
    "mesh_m2": {False: (_GR["lu"], _GR["lu"]),
                "contour": (_GR["lu"], _GR["lu"]),
                True: (_GR["chain"], _SPLIT)},
}


@pytest.fixture
def recorded(monkeypatch, caplog):
    """Replace every path's work by a recorder that returns zeros."""
    paths = []

    def zeros_dev(self, m=1, imag=False):
        N = self.H.shape[-1]
        return torch.zeros((N, N // m), dtype=torch.float64 if imag
                           else torch.complex128)

    def _sum(self, point, E, w, imag, m=1):
        paths.append("lu")
        return zeros_dev(self, m, imag)

    def _chain_sum(self, E, w, imag):
        paths.append("chain")
        return zeros_dev(self, 1, imag)

    def _warm_sum(self, kind, E, w, contact=None, imag=False):
        paths.append("warm")
        return zeros_dev(self, 1, imag).numpy()

    def sp_gr_sum(self, provider, E, w, epilog=None):
        paths.append("spectral")
        return np.zeros((provider.N, provider.N),
                        float if epilog == "im" else complex)

    def sp_gless_sum(self, provider, E, w, contact=None):
        paths.append("spectral")
        return np.zeros((provider.N, provider.N), complex)

    monkeypatch.setattr(EnergyEngine, "_sum", _sum)
    monkeypatch.setattr(EnergyEngine, "_chain_sum", _chain_sum)
    monkeypatch.setattr(EnergyEngine, "_warm_sum", _warm_sum)
    monkeypatch.setattr(SpectralRunner, "gr_sum", sp_gr_sum)
    monkeypatch.setattr(SpectralRunner, "gless_sum", sp_gless_sum)
    caplog.set_level(logging.DEBUG, logger="gaunegf_tpu_torch")
    return paths, caplog


def _engine(scenario, continuation):
    kw, warm, mesh = SCENARIOS[scenario]
    n = 16
    H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    S = np.eye(n)
    cls = _WarmStub if warm else ConstantSelfEnergy
    g = cls(H, S, [np.arange(2), np.arange(n - 2, n)], sig1=-0.1j,
            device="cpu")
    g.N = n
    cfg = ExecutionConfig(energy_chunk=4, continuation=continuation, **kw)
    if mesh:
        return EnergyEngine(H, S, g, cfg, _MeshStub())
    return EnergyEngine(H, S, g, cfg, device="cpu")


def _spans(caplog):
    return [r.getMessage().split(" took ")[0] for r in caplog.records
            if " took " in r.getMessage()]


@pytest.mark.parametrize("continuation", [False, "contour", True])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_routing_matches_the_jax_branches(recorded, scenario, continuation):
    paths, caplog = recorded
    E = np.linspace(-1.0, 1.0, 6) + 0.1j
    w = np.ones(6)
    want_gr, want_split = ROUTES[scenario][continuation]
    for call, want in (
            (lambda eng: eng.gr_sum(E, w), want_gr),
            (lambda eng: eng.density_eq_split(E[:3], w[:3], E[3:], w[3:]),
             want_split)):
        paths.clear()
        caplog.clear()
        call(_engine(scenario, continuation))
        assert (paths, _spans(caplog)) == (want[0], want[1])


@pytest.mark.parametrize("continuation,want", [
    (False, (["lu", "lu"], ["density_neq"])),
    ("contour", (["lu", "lu"], ["density_neq"])),
    (True, (["chain", "lu"], ["gr_sum_chain"]))])
def test_density_neq_routing(recorded, continuation, want):
    """The biased density: the fused LU sum under one density_neq span,
    or for continuation=True the chain's gr_sum then gless_sum."""
    paths, caplog = recorded
    E = np.linspace(-1.0, 1.0, 6) + 0.1j
    _engine("plain", continuation).density_neq_sum(
        E, np.ones(6), E[:2], np.ones(2), contact=-1)
    assert (paths, _spans(caplog)) == want
