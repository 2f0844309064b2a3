"""The ('e', 'm') mesh over torch.distributed: process groups, the
multi-host bootstrap, and the collectives of the sharded engines.

Port of ``gaunegf_tpu/parallel/mesh.py`` in PyTorch's SPMD idiom: one
process per rank, each on its own device, all running the same host
program.  The energy grid -- the workload's long axis -- shards over the
'e' axis; the engines reduce their partial weighted sums once per
dispatch over 'e' and gather per-energy observables over 'e'
(ops/greens.py).  The 'm' (model) axis column-shards the solve of one
energy point (ops/zlinalg.zinv_refined_cols, zsolve_dist).  'm' exchanges
O(N^2) bytes per refinement step, so its ranks stay within one host
('m' innermost); 'e' reduces once per dispatch and may span hosts.

Multi-host: ``initialize_distributed()`` bootstraps
``torch.distributed.init_process_group`` from the environment (explicit
GAUNEGF_* variables, torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE /
RANK, or a SLURM allocation); ``energy_mesh()`` then arranges the global
ranks.  Without any of them, ``energy_mesh()`` makes a world of one rank.

The collectives live here and nowhere else.  Complex tensors travel as
``torch.view_as_real`` views.  Every host decision that precedes a
collective must be taken on replicated values, so that every rank runs
the same sequence of collectives (see scf.py).
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "EnergyMesh", "energy_mesh", "local_device_count",
    "initialize_distributed",
    "distributed_env", "device_grid", "grid_layout", "grid_unlayout",
    "grid_segment", "warm_segment", "ENERGY_AXIS", "MODEL_AXIS",
]

ENERGY_AXIS = "e"
MODEL_AXIS = "m"

_initialized = False


def local_device_count() -> int:
    """The CUDA devices this process sees (0 without a GPU)."""
    return torch.cuda.device_count()


def distributed_env(environ=None) -> Optional[dict]:
    """Detect a multi-process launch from the environment.

    Recognized (first match wins):
    * explicit: GAUNEGF_COORDINATOR or torchrun's MASTER_ADDR:MASTER_PORT,
      with GAUNEGF_NUM_PROCESSES / WORLD_SIZE and GAUNEGF_PROCESS_ID /
      RANK (the JAX package reads JAX_COORDINATOR_ADDRESS,
      JAX_NUM_PROCESSES and JAX_PROCESS_ID in their place);
    * SLURM: SLURM_STEP_NODELIST/SLURM_JOB_NODELIST + SLURM_NTASKS +
      SLURM_PROCID (coordinator = first node, port 8476).

    Returns {"coordinator_address", "num_processes", "process_id"} or
    None for a single-process run.  A pure function of ``environ``.
    """
    env = os.environ if environ is None else environ
    coord = env.get("GAUNEGF_COORDINATOR")
    if not coord and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coord = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    nproc = env.get("GAUNEGF_NUM_PROCESSES") or env.get("WORLD_SIZE")
    pid = env.get("GAUNEGF_PROCESS_ID") or env.get("RANK")
    if coord and nproc is not None and pid is not None:
        return {"coordinator_address": coord,
                "num_processes": int(nproc),
                "process_id": int(pid)}
    nodelist = env.get("SLURM_STEP_NODELIST") or env.get(
        "SLURM_JOB_NODELIST")
    if nodelist and env.get("SLURM_NTASKS") and int(env["SLURM_NTASKS"]) > 1:
        first = _first_slurm_node(nodelist)
        return {"coordinator_address": f"{first}:8476",
                "num_processes": int(env["SLURM_NTASKS"]),
                "process_id": int(env.get("SLURM_PROCID", 0))}
    return None


def _first_slurm_node(nodelist: str) -> str:
    """First hostname of a SLURM nodelist ('n[001-004,007],m1' -> 'n001')."""
    base = nodelist.split(",")[0]
    if "[" not in base:
        return base
    prefix, rest = base.split("[", 1)
    first = rest.rstrip("]").split(",")[0].split("-")[0]
    return prefix + first


def _local_rank(environ, rank: int) -> int:
    """The rank's index among the ranks of its host: GAUNEGF_LOCAL_RANK,
    torchrun's LOCAL_RANK or SLURM_LOCALID, else the global rank (one
    host)."""
    for key in ("GAUNEGF_LOCAL_RANK", "LOCAL_RANK", "SLURM_LOCALID"):
        if environ.get(key) is not None:
            return int(environ[key])
    return rank


def _local_world(environ) -> Optional[int]:
    """Ranks on this host where the launcher says (torchrun's
    LOCAL_WORLD_SIZE, SLURM_NTASKS_PER_NODE as a plain count), else None."""
    for key in ("GAUNEGF_LOCAL_WORLD_SIZE", "LOCAL_WORLD_SIZE",
                "SLURM_NTASKS_PER_NODE"):
        val = environ.get(key)
        if val is not None and str(val).isdigit():
            return int(val)
    return None


def initialize_distributed(environ=None, force: bool = False, *,
                           backend: str) -> bool:
    """Bootstrap torch.distributed from the environment (idempotent).

    Returns True when running multi-process (after init_process_group),
    False for a plain single-process session.  A default process group
    that is already initialized (the caller's own init_process_group)
    counts as success.  ``backend`` is the caller's: 'nccl' or 'gloo'.
    """
    global _initialized
    spec = distributed_env(environ)
    if spec is None:
        return False
    if (_initialized or dist.is_initialized()) and not force:
        _initialized = True
        return True
    dist.init_process_group(
        backend, init_method=f"tcp://{spec['coordinator_address']}",
        world_size=spec["num_processes"], rank=spec["process_id"])
    _initialized = True
    return True


def device_grid(devices: Sequence, model_parallel: int = 1,
                procs_of=None) -> np.ndarray:
    """Arrange devices into an (e, m) grid, 'm' innermost within a host.

    'm' ranks exchange O(N^2) bytes per refinement step, so the m-axis
    must never straddle hosts: devices are grouped by owning process
    (here: host) and each group is split into contiguous m-tuples.  A pure
    function (``procs_of`` maps device -> process id; defaults to the
    .process_index attribute); ``energy_mesh`` passes global ranks and
    their host index."""
    if procs_of is None:
        procs_of = lambda d: getattr(d, "process_index", 0)
    devices = list(devices)
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by m={model_parallel}")
    by_proc = {}
    for d in devices:
        by_proc.setdefault(procs_of(d), []).append(d)
    rows = []
    for proc in sorted(by_proc):
        group = by_proc[proc]
        if len(group) % model_parallel:
            raise ValueError(
                f"process {proc} has {len(group)} devices, not divisible "
                f"by m={model_parallel}: the model axis must stay within "
                "one host (it exchanges O(N^2) per refinement step)")
        for i in range(0, len(group), model_parallel):
            rows.append(group[i:i + model_parallel])
    return np.asarray(rows, dtype=object)


@dataclasses.dataclass(frozen=True, eq=False)
class EnergyMesh:
    """One rank's view of the ('e', 'm') mesh.

    ``shape`` is {'e': n_e, 'm': n_m} (as the JAX ``Mesh.shape`` reads),
    ``coords`` the rank's position on each axis, ``grid`` the (n_e, n_m)
    array of global ranks, ``device`` the rank's explicit torch.device,
    ``groups`` the process groups of the rank's 'e' column and 'm' row."""
    shape: dict
    coords: dict
    rank: int
    grid: np.ndarray
    device: torch.device
    backend: str
    groups: dict

    # -- collectives -----------------------------------------------------

    def sum_e(self, x):
        """x summed over the 'e' axis, on every rank of the column (in
        x's own storage when x is contiguous)."""
        y = _wire(x)
        dist.all_reduce(y, group=self.groups[ENERGY_AXIS])
        return _unwire(y, x)

    def gather_e(self, x, dim: int = 0):
        """The 'e' ranks' x concatenated along ``dim`` in 'e' order."""
        return self._gather(x, ENERGY_AXIS, dim)

    def gather_m(self, x, dim: int = -1):
        """The 'm' ranks' x concatenated along ``dim`` in 'm' order."""
        return self._gather(x, MODEL_AXIS, dim)

    def _gather(self, x, axis, dim):
        y = _wire(x)
        parts = [torch.empty_like(y) for _ in range(self.shape[axis])]
        dist.all_gather(parts, y, group=self.groups[axis])
        parts = [_unwire(p, x) for p in parts]
        return torch.cat(parts, dim=dim)

    def broadcast_m(self, x, owner: int):
        """x from the 'm' rank ``owner`` (its 'm' coordinate), on every
        rank of the row; ``x`` is the buffer the others receive into."""
        src = int(self.grid[self.coords[ENERGY_AXIS], owner])
        return self._broadcast(x, src, MODEL_AXIS)

    def broadcast_e(self, x, owner: int = 0):
        """x from the 'e' rank ``owner`` on every rank of the column (the
        spectral basis, which must be the same bits on every rank)."""
        src = int(self.grid[owner, self.coords[MODEL_AXIS]])
        return self._broadcast(x, src, ENERGY_AXIS)

    def _broadcast(self, x, src, axis):
        y = _wire(x)
        dist.broadcast(y, src=src, group=self.groups[axis])
        return _unwire(y, x)

    def max_m(self, x):
        """Elementwise max of a real x over the 'm' axis."""
        y = x.contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.MAX,
                        group=self.groups[MODEL_AXIS])
        return y

    def share(self, obj):
        """World rank 0's picklable ``obj`` on every rank: for a host value
        that one rank reads alone (a checkpoint file), so that every rank
        decides on the same bits."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self):
        dist.barrier()


def _wire(x):
    """A contiguous real view of x for the wire (complex as view_as_real)."""
    x = x.contiguous()
    return torch.view_as_real(x) if x.is_complex() else x


def _unwire(y, like):
    return torch.view_as_complex(y) if like.is_complex() else y


def _hosts(world: int) -> list:
    """Host index of every rank (ranks grouped by host name)."""
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    order = {h: i for i, h in enumerate(dict.fromkeys(names))}
    return [order[h] for h in names]


def energy_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
                *, device, backend: str, environ=None) -> EnergyMesh:
    """Build the ('e', 'm') mesh; the energy axis spans world // m ranks.

    ``device`` is 'cuda' or 'cpu': rank r takes ``cuda:(local_rank %
    device_count)``.  ``backend`` is the caller's choice: 'nccl' needs a
    card per local rank and raises with fewer; 'gloo' runs on the CPU and,
    asked for explicitly, on CUDA tensors.  A multi-process launch
    (``distributed_env``) is bootstrapped here; without one, a world of
    one rank on an in-process store.  ``n_devices``, when given, must be
    the world size (one device per rank)."""
    environ = os.environ if environ is None else environ
    dev = torch.device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} was requested but torch "
                           "sees no CUDA device")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' runs on CUDA devices only")
    started = dist.is_initialized()     # the caller's own process group
    spec = None if started else distributed_env(environ)
    if started:
        rank0 = dist.get_rank()
    else:
        rank0 = spec["process_id"] if spec else 0
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        local = _local_rank(environ, rank0)
        n_local = _local_world(environ)
        if backend == "nccl" and max(local + 1, n_local or 0) > n_cards:
            raise ValueError(
                f"backend='nccl' needs one card per local rank: "
                f"{max(local + 1, n_local or 0)} local ranks, {n_cards} "
                "card(s); use backend='gloo' to share a card")
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if not started and not initialize_distributed(environ, backend=backend):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not backend={backend!r}")
    world = dist.get_world_size()
    rank = dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the world has {world} "
                         "ranks (one device per rank)")
    hosts = _hosts(world)
    grid = device_grid(range(world), model_parallel,
                       procs_of=lambda r: hosts[r]).astype(np.int64)
    e_idx, m_idx = (int(v[0]) for v in np.nonzero(grid == rank))
    groups = {}
    # every rank creates every group, in the same order
    for j in range(grid.shape[1]):
        g = dist.new_group([int(r) for r in grid[:, j]])
        if j == m_idx:
            groups[ENERGY_AXIS] = g
    for i in range(grid.shape[0]):
        g = dist.new_group([int(r) for r in grid[i, :]])
        if i == e_idx:
            groups[MODEL_AXIS] = g
    return EnergyMesh(shape={ENERGY_AXIS: grid.shape[0],
                             MODEL_AXIS: grid.shape[1]},
                      coords={ENERGY_AXIS: e_idx, MODEL_AXIS: m_idx},
                      rank=rank, grid=grid, device=dev, backend=backend,
                      groups=groups)


# ---------------------------------------------------------------------------
# Energy-grid layouts over the 'e' axis (host index arithmetic)
# ---------------------------------------------------------------------------

def _n_e(mesh) -> int:
    return 1 if mesh is None else mesh.shape["e"]


def grid_layout(n: int, mesh, chunk: int):
    """(positions, padding mask) of the grid points this rank serves, in
    the order it serves them -- the JAX package's _layout: the grid padded
    to a multiple of n_e * chunk with the first node (at zero weight),
    chunk c of 'e' rank d being grid chunk c * n_e + d, so every rank runs
    the same number of chunks and a rank with no real point still takes
    part in every collective.  Without a mesh, or with one 'e' rank, the
    grid as it is (the serial layout: no padding)."""
    n_e = _n_e(mesh)
    if n_e == 1:
        return np.arange(n), np.zeros(n, dtype=bool)
    total = n + (-n) % (n_e * chunk)
    idx = np.arange(total).reshape(-1, n_e, chunk)[:, mesh.coords["e"], :]
    idx = idx.ravel()
    pad = idx >= n
    return np.where(pad, 0, idx), pad


def grid_unlayout(vals, n: int, mesh, chunk: int):
    """Per-energy values gathered over 'e' (rank-major, grid_layout's order
    on each rank) back in grid order."""
    n_e = _n_e(mesh)
    if n_e == 1:
        return vals[:n]
    total = n + (-n) % (n_e * chunk)
    served = np.arange(total).reshape(-1, n_e, chunk).transpose(1, 0, 2)
    inv = np.argsort(served.ravel())[:n]
    return vals[torch.as_tensor(inv, device=vals.device)]


def grid_segment(n: int, mesh, chunk: int):
    """[lo, hi): the contiguous segment of an n-point grid that this 'e'
    rank serves on the warm engines (the JAX _layout_lane_major's split:
    chunk * ceil(n / (n_e * chunk)) points per rank, the last ranks
    shorter or empty), and that per-rank length."""
    n_e = _n_e(mesh)
    if n_e == 1:
        return 0, n, n
    per = chunk * -(-n // (n_e * chunk))
    d = mesh.coords["e"]
    return min(d * per, n), min((d + 1) * per, n), per


def warm_segment(n: int, mesh, chunk: int):
    """grid_segment as the warm engines split the grid: the split capped
    at ceil(n / n_e) points, so that every 'e' rank holds a share of a
    grid shorter than n_e * chunk.  There the JAX split (chunk points at
    a time) leaves the last ranks empty -- at the automatic chunk of 128,
    a 50-point bias window on 4 ranks lands on rank 0 alone.  Equal to
    grid_segment from n >= n_e * chunk on."""
    return grid_segment(n, mesh, max(1, min(chunk, -(-n // _n_e(mesh)))))
