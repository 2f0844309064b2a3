"""T(E) of whole sweeps of a T(E) cell of negfbench, for comparing two
checkouts on the same seeds.

    python3 tools/si_sweeps.py run --root . --seeds 1 2 3 --sweeps 7 \
        --out bench_out/sweeps_this.npz
    python3 tools/si_sweeps.py compare A.npz B.npz [--near 0.304 0.848]

``run`` builds the cell's junction from each seed exactly as
``negfbench/run.py`` does (inputs, program, the warm sweep) with the
package under --root, then runs --sweeps sweeps with the seed's offsets
and saves every energy and T(E); it prints the counters COUNTERS a
sweep.  With --host K it then runs K more sweeps of the first seed under
torch.profiler and prints where a sweep's time goes: its wall time, the
device's busy time, the recorder's spans (total and self milliseconds,
calls) and the host operations with the most self CPU time, each a
sweep (the profiler's own cost inflates the host side by a few percent;
a blocking copy's self time includes its wait for the card).
``compare`` reads two such files, checks that the energies agree,
and prints the largest gap over max(1, max T) of all points and, with
--near, the largest gap outside and inside 1 meV of each given energy
(eV above the lead's conduction-band minimum, the configuration's input
``cbm``).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import sys
from pathlib import Path

COUNTERS = ("chain.lanes", "sancho.cluster_lanes", "launch.sancho_rubio")


def host_breakdown(job, sweeps, device):
    """Where K more sweeps of this job spend their time, a sweep."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gaunegf_tpu_torch.utils.logging import recorder
    with recorder.recording():
        recorder.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            job._run(float("inf"), sweeps, False)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        spans = {name: [round(1e3 * v[0] / sweeps, 3),
                        round(1e3 * v[1] / sweeps, 3), v[2] / sweeps]
                 for name, v in recorder.totals().spans.items()}
    from torch.autograd import DeviceType
    ops = prof.key_averages()
    dev = [e for e in ops if e.device_type == DeviceType.CUDA]
    host = sorted((e for e in ops if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    out = {"sweeps": sweeps, "wall_ms": 1e3 * wall / sweeps,
           "device_busy_ms": sum(dev_us(e) for e in dev) / 1e3 / sweeps,
           "host_self_ms": sum(e.self_cpu_time_total for e in host)
           / 1e3 / sweeps,
           "spans_ms_self_ms_calls": spans,
           "host_ops_self_ms_calls": [
               [e.key, round(e.self_cpu_time_total / 1e3 / sweeps, 3),
                e.count / sweeps] for e in host[:20]],
           "device_ops_ms": [
               [e.key, round(dev_us(e) / 1e3 / sweeps, 3)]
               for e in sorted(dev, key=dev_us, reverse=True)[:5]]}
    print("host breakdown a sweep: " + json.dumps(out), flush=True)
    return out


def run(args):
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.utils.logging import recorder
    from negfbench import harness, jobs
    from types import SimpleNamespace
    p = harness.plan(harness.load_benchmark(Path(root)), args.workload,
                     root=Path(root))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = {}
    for seed in args.seeds:
        inp = p.module.inputs(p.spec, seed)
        negfe = p.module.program(p.spec, inp, device=device,
                                 name=os.path.join(tempfile.gettempdir(),
                                                   f"si_sweeps_{seed}"),
                                 exec_cfg=ExecutionConfig())
        system = SimpleNamespace(negfe=negfe, device=device,
                                 band_center=p.module.band_center(p.spec,
                                                                  inp))
        job = jobs.make(p.mix, system, seed)
        job.warm()
        with recorder.recording():
            recorder.reset()
            job._run(float("inf"), args.sweeps, True)
            counts = {c: recorder.count(c) / args.sweeps for c in COUNTERS}
        out[f"E_{seed}"] = np.stack([e for e, _ in job.sweeps])
        out[f"T_{seed}"] = np.stack([t for _, t in job.sweeps])
        if "cbm" in inp:
            out[f"cbm_{seed}"] = np.asarray(inp["cbm"])
        print(f"seed {seed}: {len(job.sweeps)} sweeps, a sweep: "
              f"{json.dumps(counts)}", flush=True)
        if args.host and seed == args.seeds[0]:
            host_breakdown(job, args.host, device)
        del negfe, job, system
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, **out)


def compare(args):
    import numpy as np
    a, b = np.load(args.a), np.load(args.b)
    seeds = sorted({k.split("_", 1)[1] for k in a.files if k.startswith("T_")})
    res = {"sweeps": 0, "points": 0, "worst": 0.0, "outside": 0.0,
           "near": {}}
    for s in seeds:
        Ea, Ta, Eb, Tb = a[f"E_{s}"], a[f"T_{s}"], b[f"E_{s}"], b[f"T_{s}"]
        k = min(len(Ta), len(Tb))
        assert np.array_equal(Ea[:k], Eb[:k]), f"seed {s}: other energies"
        gap = np.abs(Ta[:k] - Tb[:k]) / np.maximum(
            1.0, np.abs(Tb[:k]).max(axis=-1, keepdims=True))
        gap = gap.reshape(k, -1) if gap.ndim > 2 else gap
        res["sweeps"] += k
        res["points"] += gap.size
        res["worst"] = max(res["worst"], float(gap.max()))
        inside = np.zeros_like(gap, dtype=bool)
        cbm = a[f"cbm_{s}"] if f"cbm_{s}" in a.files else None
        if args.near and cbm is not None:
            for e in args.near:
                near = np.abs(Ea[:k] - (cbm + e)) <= args.width
                near = near.reshape(gap.shape) if near.size == gap.size \
                    else np.broadcast_to(near[..., None], gap.shape)
                inside |= near
                if near.any():
                    key = f"{e:g}"
                    res["near"][key] = max(res["near"].get(key, 0.0),
                                           float(gap[near].max()))
        if (~inside).any():
            res["outside"] = max(res["outside"], float(gap[~inside].max()))
    print(json.dumps(res))


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--root", default=".")
    r.add_argument("--workload", default="si_nanowire.transport")
    r.add_argument("--seeds", type=int, nargs="+", required=True)
    r.add_argument("--sweeps", type=int, default=7)
    r.add_argument("--out", required=True)
    r.add_argument("--host", type=int, default=0,
                   help="sweeps of the first seed to break down by profiler")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--near", type=float, nargs="*", default=[])
    c.add_argument("--width", type=float, default=1e-3)
    args = ap.parse_args()
    run(args) if args.cmd == "run" else compare(args)


if __name__ == "__main__":
    main()
