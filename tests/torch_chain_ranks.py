"""What each rank of the gloo worlds of tests/test_torch_continuation.py
and tests/test_torch_zlinalg.py runs (no JAX here: the ranks are
processes of their own).  Each function runs on every rank of a world of
two on the CPU and returns NumPy results: the run under the mesh and, on
the same rank, the same run without it."""

import numpy as np
import torch

from gaunegf_tpu_torch import density as dens
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
from gaunegf_tpu_torch.ops import zlinalg as zl
from gaunegf_tpu_torch.parallel.mesh import energy_mesh
from gaunegf_tpu_torch.utils.logging import recorder

# tests/test_density.py's system and grids for the continuation densities
DENSITY_N = 32
DENSITY_KW = dict(Eminf=-40.0, Emin=-4.0, mu=0.3, N1=64, N2=24)


def density_system(device="cpu"):
    N = DENSITY_N
    H = -1.0 * (np.eye(N, k=1) + np.eye(N, k=-1))
    S = np.eye(N)
    g = ConstantSelfEnergy(H, S, [np.arange(4), np.arange(N - 4, N)],
                           sig1=-0.1j, device=device)
    return H, S, g


def density_checks():
    """density_eq_n with continuation='contour' (strict, solver='lu',
    chunk 4) under ('e', 'm') = (2, 1) and without the mesh, with the
    chain's step counts of the sharded run."""
    mesh = energy_mesh(model_parallel=1, device="cpu", backend="gloo")
    H, S, g = density_system()
    cfg = ExecutionConfig(precision="strict", solver="lu", energy_chunk=4,
                          continuation="contour")
    with recorder.recording():
        sharded = dens.density_eq_n(H, S, g, exec_cfg=cfg, device="cpu",
                                    mesh=mesh, **DENSITY_KW)
        steps = {k: recorder.count(f"chain.{k}") for k in ("newton", "lu")}
    serial = dens.density_eq_n(H, S, g, exec_cfg=cfg, device="cpu",
                               **DENSITY_KW)
    return {"coords": dict(mesh.coords), "sharded": sharded,
            "serial": serial, "steps": steps}


def dist_system(N=72, k=5, seed=4):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((2, N, N)) + 1j * rng.standard_normal((2, N, N))
    A = A + N * (0.3 + 0.1j) * np.eye(N)
    B = rng.standard_normal((2, N, k)) + 1j * rng.standard_normal((2, N, k))
    return A.astype(np.complex64), B.astype(np.complex64)


def dist_checks(panels=("split", "virtual", "psplit")):
    """zsolve_dist on each panel under ('e', 'm') = (1, 2), bs 16 (N = 72
    pads to 96 over the two ranks), against zsolve on the same panel
    without the mesh."""
    mesh = energy_mesh(model_parallel=2, device="cpu", backend="gloo")
    A, B = (torch.as_tensor(x) for x in dist_system())
    out = {"coords": dict(mesh.coords)}
    for p in panels:
        out[p] = {
            "dist": zl.zsolve_dist(A, B, mesh, bs=16, panel_impl=p).numpy(),
            "serial": zl.zsolve(A, B, bs=16, panel_impl=p).numpy()}
    return out
