"""Multi-device execution of gaunegf_tpu_torch over torch.distributed.

One gloo world per layout runs on the CPU, each rank a process of its own
(parallel/launch.spawn_ranks, the rendezvous a file under tmp_path): two
ranks as ('e', 'm') = (2, 1) and four as (2, 2).  Each rank runs
tests/torch_mesh_ranks.py's checks once and hands back its results; every
test below reads them.  The JAX counterparts run here, on conftest's 8
virtual CPU devices through ``energy_mesh(model_parallel=m)``, under x64,
on the same seeded NumPy inputs.

Tolerances, relative to the reference's largest entry:
* ranks against each other: bit for bit;
* port sharded against port serial: 1e-10 on the complex128 paths (the
  high and exact tiers, the spectral route, complex128 zsolve_dist), as
  the JAX dry run asserts in x64; the mixed tier's sums to 1e-6 and the
  fast tier's to 1e-4 (the bounds its serial sums meet against the JAX
  package in tests/test_torch_greens.py); the warm engines, whose fixed
  points start from other seeds once the grid is split, against the cold
  serial engine to 1e-5 (tests/test_torch_bethe_engine.py);
* port sharded against JAX sharded: the bound each serial pair already
  meets -- mixed sums 1e-6, T(E) 2e-6 (tests/test_torch_transport.py),
  the spectral route 5e-6 (tests/test_torch_spectral_jax.py), the high
  tier 5e-7 (the JAX double-word tier's own, tests/test_model_parallel.py),
  the column-sharded complex64 solves 1e-5 (twice the JAX tests' 5e-6
  against the truth).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models.fock import TightBindingFock as JaxFock
from gaunegf_tpu.models.selfenergy import ConstantSelfEnergy as JaxSigma
from gaunegf_tpu.ops import zlinalg as jzl
from gaunegf_tpu.ops.greens import EnergyEngine as JaxEngine
from gaunegf_tpu.parallel.mesh import MODEL_AXIS
from gaunegf_tpu.parallel.mesh import energy_mesh as jax_mesh
from gaunegf_tpu.scfe import NEGFE as JaxNEGFE
from gaunegf_tpu_torch.parallel.launch import spawn_ranks
import torch_mesh_ranks as tr

torch.set_num_threads(1)

C128 = 1e-10
SUM_REL = 1e-6


def _rel(x, ref):
    return float(np.max(np.abs(np.asarray(x) - np.asarray(ref)))
                 / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def world_e(tmp_path_factory):
    """Two ranks, ('e', 'm') = (2, 1), sharing one checkpoint directory."""
    shared = str(tmp_path_factory.mktemp("world_e_checkpoint"))
    return spawn_ranks(2, tr.world_checks, (1, shared), backend="gloo",
                       init_dir=str(tmp_path_factory.mktemp("world_e")),
                       timeout=300)


@pytest.fixture(scope="module")
def world_m(tmp_path_factory):
    """Four ranks, ('e', 'm') = (2, 2)."""
    return spawn_ranks(4, tr.world_checks, (2,), backend="gloo",
                       init_dir=str(tmp_path_factory.mktemp("world_m")),
                       timeout=300)


def _world(request, layout):
    return request.getfixturevalue("world_e" if layout == "e" else "world_m")


# ---------------------------------------------------------------------------
# Layouts, and the ranks agree bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout,shape", [("e", {"e": 2, "m": 1}),
                                          ("m", {"e": 2, "m": 2})])
def test_mesh_layout(request, layout, shape):
    ranks = _world(request, layout)
    assert all(r["shape"] == shape for r in ranks)
    coords = sorted((r["coords"]["e"], r["coords"]["m"]) for r in ranks)
    assert coords == sorted((i, j) for i in range(shape["e"])
                            for j in range(shape["m"]))


def _sharded(res):
    """{name: the rank's sharded result} of a rank's results."""
    out = {}
    for k, v in res.items():
        if isinstance(v, tuple):
            out[k] = v[0]
        elif isinstance(v, np.ndarray):
            out[k] = v
    return out


@pytest.mark.parametrize("layout", ["e", "m"])
def test_ranks_agree_bit_for_bit(request, layout):
    ranks = _world(request, layout)
    first = _sharded(ranks[0])
    assert len(first) > 5
    for res in ranks[1:]:
        other = _sharded(res)
        assert other.keys() == first.keys()
        for k in first:
            assert np.array_equal(other[k], first[k]), k


# ---------------------------------------------------------------------------
# Port sharded against port serial
# ---------------------------------------------------------------------------

SERIAL = {
    "e": {"e_gr_mixed": SUM_REL, "e_gless_mixed": SUM_REL,
          "e_T_mixed": SUM_REL, "e_gr_im_mixed": SUM_REL,
          "e_dos_mixed": SUM_REL, "e_scf_lu": SUM_REL,
          "e_gr_high": C128, "e_gless_high": C128, "e_T_high": C128,
          "e_gr_spectral": C128, "e_gless_spectral": C128,
          "e_T_spectral": C128},
    "m": {"m_gr_mixed": SUM_REL, "m_gless_mixed": SUM_REL,
          "m_neq_mixed": SUM_REL, "m_T_mixed": SUM_REL,
          "m_gr_fast": 1e-4, "m_gless_fast": 1e-4, "m_neq_fast": 1e-4,
          "m_T_fast": 1e-4,
          "m_gr_full": SUM_REL, "m_gless_full": SUM_REL,
          "m_neq_full": SUM_REL, "m_T_full": SUM_REL,
          "m_gr_dist": SUM_REL, "m_gless_dist": SUM_REL,
          "m_neq_dist": SUM_REL, "m_T_dist": SUM_REL,
          "m_gr_high": C128, "m_gr_exact": C128,
          "m_gless_uneven": SUM_REL, "m_gr_n33": SUM_REL,
          "zinv_cols": SUM_REL, "zsolve_dist_pstrip": SUM_REL,
          "zsolve_dist_pallas": C128},
}


@pytest.mark.parametrize("layout,key", [(lay, k) for lay in SERIAL
                                        for k in SERIAL[lay]])
def test_sharded_matches_serial(request, layout, key):
    sharded, serial = _world(request, layout)[0][key]
    assert np.all(np.isfinite(sharded))
    assert _rel(sharded, serial) < SERIAL[layout][key], key


def test_model_axis_shards_where_it_divides(world_m):
    """Every 'm' path shards (the high tiers' gr_sum too); N = 33 on m = 2
    falls back to the replicated solve (and still matches serial, above)."""
    shards = world_m[0]["shards"]
    assert shards.pop("n33") == 1
    assert set(shards.values()) == {2}


def test_warm_engines_keep_a_segment_per_rank(world_e):
    """The warm engines engage under the mesh and sweep each rank's
    contiguous segment: the serial warm engine run on the two segments in
    turn gives the same sum (to rounding, 1e-12) and the same T(E) bit
    for bit.  Split there, the fixed points start from other seeds than
    the whole serial sweep's, which the cold serial sum bounds (1e-5).
    tests/test_torch_mesh.py holds the segments to the JAX layout's."""
    res = world_e[0]
    ref = res["warm_serial"]
    assert res["warm_used"]
    assert _rel(res["warm_gr"], ref["segments_gr"]) < 1e-12
    assert np.array_equal(res["warm_T"], ref["segments_T"])
    assert _rel(res["warm_gr"], ref["cold"]) < 1e-5


def test_scf_checkpoint_shared_by_ranks(world_e):
    """Two ranks run SCF under one checkpoint name in one directory: rank
    0 alone writes and promotes the file, so the converged run ends with
    <name>_Final.mat in place and no rank fails on the rename; the restart
    hands every rank the density rank 0 read, bit for bit.  A T(E) sweep
    checkpointed to one shared file resumes from it on every rank."""
    first = world_e[0]["checkpoint"]
    assert first["files"] == ["shared_Final.mat"]
    assert first["calls"]["save_density"] >= 2
    assert first["calls"]["load_density"] == 1
    assert first["calls"]["promote_final"] == 1
    for res in world_e[1:]:
        assert set(res["checkpoint"]["calls"].values()) == {0}
    for res in world_e:
        c = res["checkpoint"]
        assert c["converged"] and c["files"] == first["files"]
        assert len(c["loaded"]) == 1
        assert np.array_equal(c["loaded"][0], first["saved"])
        assert np.array_equal(c["saved"], first["saved"])
        assert np.array_equal(c["P"], first["P"])
        assert np.array_equal(c["T"][0], first["T"][0])
        assert np.array_equal(c["T"][1], first["T"][0])


# ---------------------------------------------------------------------------
# Port sharded against JAX sharded
# ---------------------------------------------------------------------------

def _jax_chain(N, n_contact=4):
    H, S, inds = tr.chain(N, n_contact)
    return H, S, JaxSigma(H, S, inds, sig1=-0.1j)


def _jax_engine(cfg, m, N=64, n_contact=4):
    H, S, g = _jax_chain(N, n_contact)
    return JaxEngine(H, S, g, cfg, mesh=jax_mesh(model_parallel=m))


def _jax_lu(m, **kw):
    return _jax_engine(JaxConfig(energy_chunk=4, solver="lu", **kw), m)


def _jax_zinv_cols():
    m = 2
    mesh = jax_mesh(model_parallel=m)
    body = jax.jit(shard_map(
        lambda A: jzl.zinv_refined_cols(A, m, steps=1, bs=16), mesh=mesh,
        in_specs=P(), out_specs=P(None, MODEL_AXIS)))
    return np.stack([np.asarray(body(jnp.asarray(tr.square(64, s))))
                     for s in (1, 2)])


def _jax_zsolve_dist():
    m = 2
    mesh = jax_mesh(model_parallel=m)
    A = tr.square(36, 4)
    B = tr.square(36, 5)[:, :16]
    X = jax.jit(shard_map(lambda A, B: jzl.zsolve_dist(A, B, m, bs=8),
                          mesh=mesh, in_specs=(P(), P(None, MODEL_AXIS)),
                          out_specs=P(None, MODEL_AXIS)))(jnp.asarray(A),
                                                          jnp.asarray(B))
    return np.asarray(X)[None]


def _jax_scf():
    n = 16
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    backend = JaxFock(H0, n_electrons=n, U=0.2, n0=0.5 * np.ones(n))
    negfe = JaxNEGFE(backend, name="mp_test", verbose=False,
                     exec_cfg=JaxConfig(energy_chunk=4, solver="lu"),
                     mesh=jax_mesh())
    negfe.setSigma([1, 2], [n - 1, n], sig=-0.1j, T=0)
    negfe.setIntegralLimits(N1=32, N2=16)
    negfe.setVoltage(0.2, fermi=0.0)
    negfe.FockToP()
    negfe.PMix(0.05)
    negfe.PToFock()
    return negfe.P


def _grids():
    return tr.grids()


# name: (layout, key in the ranks' results, JAX reference, bound)
JAX_CASES = {
    "e_gr_mixed": ("e", "e_gr_mixed", lambda: _jax_lu(1).gr_sum(
        *_grids()[:2]), SUM_REL),
    "e_gless_mixed": ("e", "e_gless_mixed", lambda: _jax_lu(1).gless_sum(
        *_grids()[2:4], contact=0), SUM_REL),
    "e_gr_spectral": ("e", "e_gr_spectral", lambda: _jax_engine(
        JaxConfig(energy_chunk=4, solver="spectral"), 1).gr_sum(
            *_grids()[:2]), 5e-6),
    "e_scf_lu": ("e", "e_scf_lu", _jax_scf, SUM_REL),
    "m_gr_mixed": ("m", "m_gr_mixed", lambda: _jax_lu(2).gr_sum(
        *_grids()[:2]), SUM_REL),
    "m_gless_lowrank": ("m", "m_gless_mixed", lambda: _jax_lu(2).gless_sum(
        *_grids()[2:4], contact=0), SUM_REL),
    "m_gless_full": ("m", "m_gless_full", lambda: _jax_lu(
        2, use_lowrank=False).gless_sum(*_grids()[2:4], contact=0),
        SUM_REL),
    "m_neq": ("m", "m_neq_mixed", lambda: _jax_lu(2).density_neq_sum(
        *_grids()[:4], contact=0), SUM_REL),
    "m_T_lowrank": ("m", "m_T_mixed", lambda: _jax_lu(
        2, warm_start=False).transmission(_grids()[4]), 2e-6),
    "m_T_full": ("m", "m_T_full", lambda: _jax_lu(
        2, use_lowrank=False, warm_start=False).transmission(_grids()[4]),
        2e-6),
    "m_gr_high": ("m", "m_gr_high", lambda: _jax_engine(
        JaxConfig(energy_chunk=4, precision="high"), 2).gr_sum(
            *_grids()[:2]), 5e-7),
    "zinv_refined_cols": ("m", "zinv_cols", _jax_zinv_cols, 1e-5),
    "zsolve_dist": ("m", "zsolve_dist_pstrip", _jax_zsolve_dist, 1e-5),
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sharded_matches_jax_sharded(request, name):
    layout, key, jax_ref, bound = JAX_CASES[name]
    res = _world(request, layout)[0][key]
    got = res[0] if isinstance(res, tuple) else res
    assert _rel(got, jax_ref()) < bound, name
