"""gaunegf_tpu_torch/parallel/mesh.py: the pure functions against the JAX
package's copies on the same inputs (tests/test_mesh_multihost.py's
cases), the torch.distributed bootstrap's environment parsing (torchrun's
variables in place of the JAX ones), the device and backend checks of
``energy_mesh``, a world of one rank in this process, and the energy-grid
layouts against the JAX engines' ``_layout`` / ``_unlayout`` /
``_layout_lane_major``."""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gaunegf_tpu.ops import greens as jgreens
from gaunegf_tpu.parallel import mesh as jm
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
from gaunegf_tpu_torch.ops.greens import (EnergyEngine, _auto_chunk_cfg,
                                          _lane_major)
from gaunegf_tpu_torch.ops.greens import resolve_device
from gaunegf_tpu_torch.parallel import mesh as pm


class FakeDev:
    def __init__(self, i, proc):
        self.id = i
        self.process_index = proc


def _fleet(n_procs, per_proc):
    return [FakeDev(p * per_proc + i, p)
            for p in range(n_procs) for i in range(per_proc)]


def _ids(grid):
    return [[d.id for d in row] for row in grid]


@pytest.mark.parametrize("procs,per,m", [(1, 8, 2), (4, 4, 4), (2, 4, 2),
                                         (1, 8, 1), (2, 2, 1)])
def test_device_grid_matches_jax(procs, per, m):
    devs = _fleet(procs, per)
    assert _ids(pm.device_grid(devs, m)) == _ids(jm.device_grid(devs, m))


@pytest.mark.parametrize("n,m", [(8, 3), (5, 2)])
def test_device_grid_rejects_like_jax(n, m):
    with pytest.raises(ValueError) as a:
        pm.device_grid(_fleet(1, n), m)
    with pytest.raises(ValueError) as b:
        jm.device_grid(_fleet(1, n), m)
    assert str(a.value) == str(b.value)


def test_device_grid_m_axis_stays_within_a_host():
    with pytest.raises(ValueError, match="model axis"):
        pm.device_grid(_fleet(2, 4), 8)
    with pytest.raises(ValueError, match="model axis"):
        jm.device_grid(_fleet(2, 4), 8)


SHARED_ENVS = [
    {"GAUNEGF_COORDINATOR": "10.0.0.1:1234",
     "GAUNEGF_NUM_PROCESSES": "4", "GAUNEGF_PROCESS_ID": "2"},
    {"SLURM_JOB_NODELIST": "tpu[001-004]", "SLURM_NTASKS": "4",
     "SLURM_PROCID": "3"},
    {"SLURM_STEP_NODELIST": "gpu[3,5-9],cpu1", "SLURM_NTASKS": "8"},
    {"SLURM_JOB_NODELIST": "n1", "SLURM_NTASKS": "1"},
    {},
]


@pytest.mark.parametrize("env", SHARED_ENVS)
def test_distributed_env_matches_jax(env):
    assert pm.distributed_env(env) == jm.distributed_env(env)


def test_torchrun_variables_take_the_place_of_the_jax_ones():
    jax_env = {"JAX_COORDINATOR_ADDRESS": "head:99",
               "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"}
    torchrun = {"MASTER_ADDR": "head", "MASTER_PORT": "99",
                "WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1"}
    assert pm.distributed_env(torchrun) == jm.distributed_env(jax_env)
    assert pm.distributed_env(jax_env) is None
    # GAUNEGF_* wins over torchrun's, as over the JAX ones
    both = dict(torchrun, GAUNEGF_COORDINATOR="c:1",
                GAUNEGF_NUM_PROCESSES="4", GAUNEGF_PROCESS_ID="3")
    assert pm.distributed_env(both) == {
        "coordinator_address": "c:1", "num_processes": 4, "process_id": 3}
    # a MASTER_ADDR without its port is not a launch
    assert pm.distributed_env({"MASTER_ADDR": "h", "WORLD_SIZE": "2",
                               "RANK": "0"}) is None


@pytest.mark.parametrize("nodes", ["n1", "n[007-009]", "gpu[3,5-9],cpu1",
                                   "a-b[10-12],c"])
def test_first_slurm_node_matches_jax(nodes):
    assert pm._first_slurm_node(nodes) == jm._first_slurm_node(nodes)


@pytest.mark.parametrize("env,rank,local", [
    ({"LOCAL_RANK": "3"}, 7, 3), ({"SLURM_LOCALID": "1"}, 5, 1),
    ({"GAUNEGF_LOCAL_RANK": "2", "LOCAL_RANK": "0"}, 0, 2), ({}, 4, 4)])
def test_local_rank(env, rank, local):
    assert pm._local_rank(env, rank) == local


def test_initialize_distributed_calls_torch(monkeypatch):
    calls = []

    def fake_init(backend, init_method=None, world_size=-1, rank=-1):
        calls.append((backend, init_method, world_size, rank))

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(pm, "_initialized", False)
    env = {"MASTER_ADDR": "c", "MASTER_PORT": "1", "WORLD_SIZE": "2",
           "RANK": "1"}
    assert pm.initialize_distributed(env, backend="gloo") is True
    assert calls == [("gloo", "tcp://c:1", 2, 1)]
    # idempotent
    assert pm.initialize_distributed(env, backend="gloo") is True
    assert len(calls) == 1


def test_initialize_distributed_accepts_a_callers_group(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("initialized twice")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pm, "_initialized", False)
    env = {"GAUNEGF_COORDINATOR": "c:1", "GAUNEGF_NUM_PROCESSES": "2",
           "GAUNEGF_PROCESS_ID": "0"}
    assert pm.initialize_distributed(env, backend="nccl") is True


def test_initialize_distributed_noop_single_process(monkeypatch):
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: (_ for _ in ()).throw(
                            AssertionError("initialized")))
    assert pm.initialize_distributed({}, backend="gloo") is False


# ---------------------------------------------------------------------------
# energy_mesh: the device and the backend are the caller's, and checked
# ---------------------------------------------------------------------------

@pytest.fixture
def no_init(monkeypatch):
    """energy_mesh must raise before it touches torch.distributed."""
    def refuse(*a, **k):
        raise AssertionError("init_process_group reached")
    monkeypatch.setattr(dist, "init_process_group", refuse)


def test_nccl_without_a_gpu_raises(no_init, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.energy_mesh(device="cuda", backend="nccl", environ={})


def test_nccl_on_the_cpu_raises(no_init):
    with pytest.raises(ValueError, match="CUDA devices only"):
        pm.energy_mesh(device="cpu", backend="nccl", environ={})


def test_nccl_with_fewer_cards_than_local_ranks_raises(no_init, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    env = {"MASTER_ADDR": "h", "MASTER_PORT": "1", "WORLD_SIZE": "4",
           "RANK": "0", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "4"}
    with pytest.raises(ValueError, match="one card per local rank"):
        pm.energy_mesh(device="cuda", backend="nccl", environ=env)


@pytest.mark.parametrize("device,backend", [("meta", "gloo"),
                                            ("cpu", "mpi")])
def test_unknown_device_or_backend_raises(no_init, device, backend):
    with pytest.raises(ValueError):
        pm.energy_mesh(device=device, backend=backend, environ={})


@pytest.fixture
def world_of_one():
    """A world of one rank in this process (gloo, an in-process store)."""
    assert not dist.is_initialized()
    mesh = pm.energy_mesh(device="cpu", backend="gloo", environ={})
    yield mesh
    dist.destroy_process_group()


def test_world_of_one_changes_nothing(world_of_one):
    mesh = world_of_one
    assert mesh.shape == {"e": 1, "m": 1} and mesh.rank == 0
    assert mesh.coords == {"e": 0, "m": 0}
    assert mesh.device == torch.device("cpu")
    x = torch.randn(5, 3, dtype=torch.complex128)
    assert torch.equal(mesh.sum_e(x), x)
    assert torch.equal(mesh.gather_m(x), x)
    assert torch.equal(mesh.broadcast_m(x.clone(), 0), x)
    assert torch.equal(mesh.max_m(x.real.clone()), x.real)
    rng = np.random.default_rng(0)
    N = 32
    H = -np.eye(N, k=1) - np.eye(N, k=-1) \
        + np.diag(0.2 * rng.standard_normal(N))
    S = np.eye(N)
    g = ConstantSelfEnergy(H, S, [np.arange(4), np.arange(N - 4, N)],
                           sig1=-0.1j, device="cpu")
    E = np.linspace(-2, 2, 11) + 0.02j
    w = rng.standard_normal(11)
    torch.set_num_threads(1)
    for cfg in (ExecutionConfig(energy_chunk=4, solver="lu"),
                ExecutionConfig(energy_chunk=4),
                ExecutionConfig(energy_chunk=4, precision="high")):
        a = EnergyEngine(H, S, g, cfg, mesh)
        b = EnergyEngine(H, S, g, cfg, device="cpu")
        assert np.array_equal(a.gr_sum(E, w), b.gr_sum(E, w))
        assert np.array_equal(a.transmission(E.real), b.transmission(E.real))
        assert np.array_equal(a.gless_sum(E, w, 0), b.gless_sum(E, w, 0))


def test_mesh_device_and_a_different_device_raise():
    mesh = types.SimpleNamespace(device=torch.device("cpu"))
    assert resolve_device(None, mesh) == torch.device("cpu")
    assert resolve_device("cpu", mesh) == torch.device("cpu")
    with pytest.raises(ValueError, match="differs from the mesh"):
        resolve_device("meta", mesh)
    with pytest.raises(TypeError):
        resolve_device(None)


# ---------------------------------------------------------------------------
# Energy-grid layouts against the JAX engines'
# ---------------------------------------------------------------------------

def _mesh_view(n_e, d):
    return types.SimpleNamespace(shape={"e": n_e, "m": 1},
                                 coords={"e": d, "m": 0})


LAYOUTS = [(13, 2, 4), (16, 2, 4), (1, 4, 4), (40, 3, 8), (7, 4, 1)]


@pytest.mark.parametrize("n,n_e,chunk", LAYOUTS)
def test_grid_layout_matches_jax(n, n_e, chunk):
    """Rank d serves JAX device d's chunks, padding with the first node
    at zero weight."""
    E = np.arange(n, dtype=float) + 1.0
    w = np.arange(n, dtype=float) + 1.0
    E_lay, w_lay, n_jax, n_pad = jgreens._layout(E, w, _mesh_view(n_e, 0),
                                                 chunk)
    assert n_jax == n
    served = []
    for d in range(n_e):
        pos, pad = pm.grid_layout(n, _mesh_view(n_e, d), chunk)
        assert np.array_equal(E[pos], E_lay[d].ravel())
        assert np.array_equal(np.where(pad, 0.0, w[pos]), w_lay[d].ravel())
        served.append(np.where(pad, -1.0, E[pos]))
    assert sum(int(p.sum()) for p in
               (pm.grid_layout(n, _mesh_view(n_e, d), chunk)[1]
                for d in range(n_e))) == n_pad
    # undoing the layout of per-energy values gathered rank by rank
    vals = torch.as_tensor(np.concatenate(served))
    back = pm.grid_unlayout(vals, n, _mesh_view(n_e, 0), chunk).numpy()
    ref = jgreens._unlayout(np.asarray(served).reshape(n_e, -1, chunk), n)
    assert np.array_equal(back, ref) and np.array_equal(back, E)


@pytest.mark.parametrize("n,n_e,chunk", LAYOUTS)
def test_grid_segment_matches_jax_lane_major(n, n_e, chunk):
    """Each 'e' rank's warm segment holds JAX device d's real points; a
    full segment is laid out in the same lanes."""
    E = np.arange(n, dtype=float)
    E_lay, n_jax, _ = jgreens._layout_lane_major(E, _mesh_view(n_e, 0),
                                                 chunk, fill=-1.0)
    for d in range(n_e):
        lo, hi, per = pm.grid_segment(n, _mesh_view(n_e, d), chunk)
        assert per == E_lay.shape[1] * E_lay.shape[2]
        real = E_lay[d][E_lay[d] >= 0]
        assert np.array_equal(np.sort(real), np.arange(lo, hi))
        if hi - lo == per:
            lanes, n_chunks, index = _lane_major(per, chunk)
            assert np.array_equal(lo + index, E_lay[d].astype(int))


@pytest.mark.parametrize("n,n_e,chunk", LAYOUTS)
def test_warm_segment_is_the_jax_split_on_long_grids(n, n_e, chunk):
    """From n >= n_e * chunk on the warm engines split as the JAX layout
    does; below, every rank holds ceil(n / n_e) points or the rest."""
    for d in range(n_e):
        view = _mesh_view(n_e, d)
        lo, hi, per = pm.warm_segment(n, view, chunk)
        if n >= n_e * chunk:
            assert (lo, hi, per) == pm.grid_segment(n, view, chunk)
        else:
            share = -(-n // n_e)
            assert (lo, hi) == (min(d * share, n), min((d + 1) * share, n))


def test_warm_segment_gives_every_rank_a_share_at_the_default_chunk():
    """A 50-point bias window on 4 'e' ranks at the automatic chunk (128
    at N = 1000): every rank sweeps a contiguous share, where the JAX
    split hands the whole window to rank 0."""
    chunk = _auto_chunk_cfg(ExecutionConfig(), 1000).energy_chunk
    assert chunk == 128
    segs = [pm.warm_segment(50, _mesh_view(4, d), chunk)[:2]
            for d in range(4)]
    assert all(hi > lo for lo, hi in segs)
    assert [lo for lo, _ in segs[1:]] == [hi for _, hi in segs[:-1]]
    assert segs[0][0] == 0 and segs[-1][1] == 50
    jax_split = [pm.grid_segment(50, _mesh_view(4, d), chunk)[:2]
                 for d in range(4)]
    assert [hi > lo for lo, hi in jax_split] == [True, False, False, False]


def test_serial_layouts_are_the_grid():
    pos, pad = pm.grid_layout(9, None, 4)
    assert np.array_equal(pos, np.arange(9)) and not pad.any()
    assert pm.grid_segment(9, None, 4) == (0, 9, 9)
    assert pm.warm_segment(9, None, 4) == (0, 9, 9)
    assert pm.grid_layout(9, _mesh_view(1, 0), 4)[0].size == 9


@pytest.mark.parametrize("count", [0, 1, 4])
def test_local_device_count_is_the_cuda_count(monkeypatch, count):
    """The JAX package's local_device_count (its local devices) is the
    CUDA devices this process sees; re-exported from parallel as there."""
    import gaunegf_tpu_torch.parallel as tpar
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert pm.local_device_count() == count
    assert tpar.local_device_count is pm.local_device_count
    assert "local_device_count" in pm.__all__
    assert jm.local_device_count() == 8          # conftest's CPU devices
