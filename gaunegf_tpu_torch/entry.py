"""Entry points of the port: one forward step on a device, and the
multi-device dry run.

The port's counterpart of ``__graft_entry__.py``.  ``entry(device)``
returns the forward step -- the weighted sum of G(E) over one energy
chunk for a 64-orbital tight-binding junction, the core of every density
and transport call -- with its arguments on the device.
``dryrun_multichip(n_devices, device=..., backend=...)`` spawns n ranks
(one process each, parallel/launch.py) and runs the five legs of the JAX
package's dry run on the same systems, each held against a serial run in
the calling process:

1. one biased NEGFE SCF step sharded over 'e';
2. an ('e', 'm') column-sharded gr_sum (zinv_refined_cols);
3. the same with the distributed LU (zsolve_dist);
4. the high tier, column-sharded (complex128 zinv_refined_cols);
5. the spectral route sharded over 'e', with a point 1e-6 from a bare
   eigenvalue so that the deflated segment runs too.

Each leg prints one progress line; a leg that misses its bound raises.
From a shell: ``python -m gaunegf_tpu_torch.entry --n 4 --device cpu
--backend gloo``.
"""

from __future__ import annotations

import dataclasses
import sys
import tempfile

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]

# sharded against serial, relative to the serial result's largest entry:
# the complex128 paths (the high tier, the spectral route) to rounding, as
# the JAX dry run asserts in x64; the mixed tier at its own bound (PERF.md
# section 2, the LU gr_sum: 2e-5), since the column blocks round their
# complex64 products differently
_BOUND_C128 = 1e-10
_BOUND_MIXED = 2e-5


def _tb_system(n=64, n_contact=4):
    H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1)) \
        + np.diag(0.2 * np.cos(np.arange(n)))
    S = np.eye(n)
    inds = [np.arange(n_contact), np.arange(n - n_contact, n)]
    return H, S, inds


def entry(device):
    """(forward, args): forward(params, H, S, E, w) = sum_k w_k G(E_k) of
    the 64-orbital chain with constant contacts over one chunk of 8
    energies, on the fast tier's blocked LU (the strip kernel's panels on
    a card), complex64 tensors on ``device``."""
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
    from gaunegf_tpu_torch.ops.greens import _gr_point, resolve_device

    dev = resolve_device(device)
    H, S, inds = _tb_system(64)
    g = ConstantSelfEnergy(H, S, inds, sig1=-0.1j, device=dev)
    exec_cfg = ExecutionConfig(precision="fast", energy_chunk=8, lu_block=32)
    sig_fn, params = g.total_apply()

    def forward(params, H, S, E, w):
        G = _gr_point(E, H, S, sig_fn(params, E), exec_cfg)
        return (w[:, None, None] * G).sum(dim=0)

    def put(x):
        return torch.as_tensor(np.asarray(x, dtype=np.complex64), device=dev)

    args = ({k: put(v) for k, v in params.items()}, put(H), put(S),
            put(np.linspace(-2, 2, 8)), put(np.ones(8)))
    return forward, args


# ---------------------------------------------------------------------------
# The dry run's legs: each runs on every rank (sharded) and in the parent
# (serial, mesh=None) through the same function
# ---------------------------------------------------------------------------

def _scf_step(device, mesh):
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.models.fock import TightBindingFock
    from gaunegf_tpu_torch.scfe import NEGFE

    n = 16
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    backend = TightBindingFock(H0, n_electrons=n, U=0.2,
                               n0=0.5 * np.ones(n))
    negfe = NEGFE(backend, name="dryrun", verbose=False,
                  exec_cfg=ExecutionConfig(energy_chunk=4, solver="lu"),
                  device=device, mesh=mesh)
    negfe.setSigma([1, 2], [n - 1, n], sig=-0.1j, T=0)
    negfe.setIntegralLimits(N1=32, N2=16)
    negfe.setVoltage(0.2, fermi=0.0)     # finite bias: the G< window too
    negfe.FockToP()                      # the fused biased dispatch
    negfe.PMix(0.05)
    negfe.PToFock()
    return negfe.P


def _mp_system(device):
    from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy

    H, S, inds = _tb_system(32)
    g = ConstantSelfEnergy(H, S, inds, sig1=-0.1j, device=device)
    E = np.linspace(-1, 1, 8) + 0.05j
    return H, S, g, E, np.ones(8)


def _leg_configs():
    from gaunegf_tpu_torch.config import ExecutionConfig

    return {
        "mp": ExecutionConfig(energy_chunk=4, solver="lu"),
        "dist": ExecutionConfig(energy_chunk=4, distribute_lu=True,
                                lu_block=8, solver="lu"),
        "high": ExecutionConfig(precision="high", energy_chunk=4),
        "spectral": ExecutionConfig(precision="mixed", energy_chunk=4,
                                    solver="spectral"),
    }


def _spectral_grid(H, E):
    lam = np.linalg.eigvalsh(H)
    E_sp = E.copy()
    E_sp[3] = lam[len(lam) // 2] + 1e-6
    return E_sp


def _sharded_legs(device, backend):
    """Every leg on this rank under its mesh; the rank's results."""
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    from gaunegf_tpu_torch.parallel.mesh import energy_mesh

    mesh_e = energy_mesh(device=device, backend=backend)
    out = {"scf": _scf_step(None, mesh_e)}
    mesh_em = energy_mesh(model_parallel=2, device=device, backend=backend)
    H, S, g, E, w = _mp_system(mesh_em.device)
    cfgs = _leg_configs()
    shards = {}
    for name in ("mp", "dist", "high"):
        eng = EnergyEngine(H, S, g, cfgs[name], mesh_em)
        shards[name] = eng._model_shards(dw_ok=True)
        out[name] = eng.gr_sum(E, w)
    eng = EnergyEngine(H, S, g, cfgs["spectral"], mesh_e)
    out["spectral_mode"] = eng._spectral_runner()._mode(_spectral_grid(H, E))
    out["spectral"] = eng.gr_sum(_spectral_grid(H, E), w)
    out["shards"] = shards
    out["mesh"] = (dict(mesh_e.shape), dict(mesh_em.shape))
    return out


def _progress(msg):
    print(f"# dryrun: {msg}", flush=True, file=sys.stderr)


def _held(name, sharded, serial, bound):
    """max |sharded - serial| over the serial result's largest entry;
    raises past ``bound``."""
    d = float(np.max(np.abs(sharded - serial)) / np.max(np.abs(serial)))
    if not np.isfinite(d) or d > bound:
        raise AssertionError(f"{name}: sharded diverges from serial: "
                             f"{d:.3e} > {bound:g}")
    return d


def dryrun_multichip(n_devices: int, *, device, backend: str) -> dict:
    """Run the five legs on n_devices ranks and hold each against a serial
    run here; returns {leg: relative difference}.  The 'm' legs need an
    even n_devices.  Raises on any failure (a rank's error, ranks that
    disagree, a leg past its bound)."""
    from gaunegf_tpu_torch.ops.greens import EnergyEngine, resolve_device
    from gaunegf_tpu_torch.parallel.launch import spawn_ranks

    if n_devices < 2 or n_devices % 2:
        raise ValueError("dryrun_multichip needs an even number of ranks "
                         f">= 2 (the 'm' legs take m=2), got {n_devices}")
    dev = resolve_device(device)
    _progress(f"device={dev} backend={backend} ranks={n_devices}: "
              "spawning the sharded legs")
    with tempfile.TemporaryDirectory() as init_dir:
        ranks = spawn_ranks(n_devices, _sharded_legs, (dev.type, backend),
                            backend=backend, init_dir=init_dir)
    r0 = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        for key in ("scf", "mp", "dist", "high", "spectral"):
            if not np.array_equal(res[key], r0[key]):
                raise AssertionError(f"rank {r} disagrees with rank 0 on "
                                     f"leg {key!r}")
    if any(m != 2 for m in r0["shards"].values()):
        raise AssertionError(f"the 'm' legs did not shard: {r0['shards']}")
    if r0["spectral_mode"] != "defl":
        raise AssertionError("the spectral leg's grid missed the deflated "
                             "segment")
    d = {}
    d["scf"] = _held("leg 1 (SCF step, 'e')", r0["scf"],
                     _scf_step(dev, None), _BOUND_MIXED)
    _progress(f"leg 1/5 OK: SCF step on mesh {r0['mesh'][0]}, "
              f"d={d['scf']:.2e}")
    H, S, g, E, w = _mp_system(dev)
    cfgs = _leg_configs()
    ref = EnergyEngine(H, S, g, cfgs["mp"], device=dev).gr_sum(E, w)
    d["mp"] = _held("leg 2 (zinv_refined_cols)", r0["mp"], ref,
                    _BOUND_MIXED)
    _progress(f"leg 2/5 OK: ('e','m') column-sharded gr_sum on mesh "
              f"{r0['mesh'][1]}, d={d['mp']:.2e}")
    d["dist"] = _held("leg 3 (zsolve_dist)", r0["dist"], ref, _BOUND_MIXED)
    _progress(f"leg 3/5 OK: distributed LU, d={d['dist']:.2e}")
    ref_hi = EnergyEngine(H, S, g, cfgs["high"], device=dev).gr_sum(E, w)
    d["high"] = _held("leg 4 (high tier)", r0["high"], ref_hi, _BOUND_C128)
    _progress(f"leg 4/5 OK: high tier column-sharded, d={d['high']:.2e}")
    E_sp = _spectral_grid(H, E)
    sp = EnergyEngine(H, S, g, cfgs["spectral"], device=dev).gr_sum(E_sp, w)
    d["spectral"] = _held("leg 5 (spectral route)", r0["spectral"], sp,
                          _BOUND_C128)
    # the LU reference on a grid with a near-pole point: no warning wanted
    cfg_ref = dataclasses.replace(cfgs["mp"], near_pole_warn=False)
    ref_sp = EnergyEngine(H, S, g, cfg_ref, device=dev).gr_sum(E_sp, w)
    d["spectral_vs_lu"] = _held("leg 5 (spectral vs LU)", sp, ref_sp, 1e-5)
    _progress(f"leg 5/5 OK: spectral route on mesh {r0['mesh'][0]}, "
              f"d={d['spectral']:.2e} (vs LU {d['spectral_vs_lu']:.2e})")
    print(f"dryrun_multichip OK on {n_devices} ranks ({dev}, {backend}): "
          + " ".join(f"{k}={v:.2e}" for k, v in d.items()), flush=True)
    return d


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4)
    # no defaults: the caller picks the card or the CPU, and the backend
    ap.add_argument("--device", required=True, choices=("cuda", "cpu"))
    ap.add_argument("--backend", required=True, choices=("nccl", "gloo"))
    a = ap.parse_args(argv)
    dryrun_multichip(a.n, device=a.device, backend=a.backend)


if __name__ == "__main__":
    main()
