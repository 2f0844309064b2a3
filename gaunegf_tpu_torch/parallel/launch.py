"""Run one function on n ranks of this host, one process per rank.

``spawn_ranks`` starts n processes (the 'spawn' start method), each of
which joins a torch.distributed world of n ranks through a rendezvous
file, runs ``target(*args)`` and sends its result back.  The dry run
(entry.dryrun_multichip), the CPU tests and the card's multi-device check
use it; a launch across hosts goes through torchrun or SLURM instead
(parallel/mesh.py).  A rank that raises fails the whole run: the parent
stops every process it started and raises with the rank's traceback.
"""

from __future__ import annotations

import os
import queue
import time
import traceback

__all__ = ["spawn_ranks"]

# the host thread pools a rank's libraries size from the environment when
# they load (OpenMP, MKL, OpenBLAS): n ranks on one host share its cores
_THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def _rank_main(rank, world, init_method, backend, threads, target, args, q):
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
        q.put((rank, True, target(*args)))
    except BaseException:                           # noqa: BLE001
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(n: int, target, args=(), *, backend: str, init_dir: str,
                threads: int = 1, timeout: float = 900.0) -> list:
    """[target(*args) on rank r for r in range(n)], each rank a process of
    its own in a world of n ranks over ``backend``, the rendezvous a file
    in ``init_dir`` (which must be empty of an earlier run's).  ``target``
    must be importable by name (a module-level function); it makes its
    mesh with ``energy_mesh``, which finds the world already joined.
    ``threads`` sets each rank's torch threads and its OpenMP / MKL /
    OpenBLAS pools (0 leaves their defaults)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = "file://" + os.path.join(os.path.abspath(init_dir), "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, init, backend, threads, target, args, q))
             for r in range(n)]
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    if threads:
        os.environ.update({k: str(threads) for k in _THREAD_VARS})
    try:
        for p in procs:                 # a child takes the environment now
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < n:
            try:
                rank, ok, payload = q.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank exited with {dead[0]} "
                                       "before reporting") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the ranks did not finish within "
                                       f"{timeout:.0f} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [results[r] for r in range(n)]
