"""One run of one cell: set-up, the timed window, the traced stretch, the
judge, and the result's line.

Everything that belongs to a configuration, a traffic mix, a cell's
limits or a per-layer metric is found by its name in ``BENCHMARK.json``:

* ``configs/<config>.json`` (its ``file``) and ``configs/<config>.py``
  beside it (``inputs``, ``program``, ``band_center``, ``reference``);
* ``traffic/<traffic>.json``, read by ``jobs.py``;
* ``limits/<workload>.json``: each compared number's limit;
* ``metrics/<metric>.py``: the spans a per-layer metric needs and its
  reader.
"""

from __future__ import annotations

import ctypes
import gc
import hashlib
import importlib.util
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gaunegf_tpu")


def prepare_host(threads, cache):
    """The process's host settings, made before NumPy and torch load: few
    threads; glibc's allocator keeping the memory it frees, so that the
    program's large host arrays (64 MB at N = 2000) are reused instead of
    being returned to the kernel and faulted in again every cycle, kernel
    time that varies from process to process (M_MMAP_MAX 0,
    M_TRIM_THRESHOLD its largest, M_TOP_PAD 64 MiB); every cache of a
    build or a kernel inside the checkout, at fixed paths.  Returns
    'kept' where the allocator took the settings, else 'default'."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(threads)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    try:
        libc = ctypes.CDLL("libc.so.6")
        kept = all(libc.mallopt(k, v) == 1 for k, v in
                   ((-4, 0), (-1, 2 ** 31 - 1), (-2, 64 << 20)))
    except (OSError, AttributeError):
        kept = False
    return "kept" if kept else "default"


def load_module(path):
    """A file of the benchmark, imported by its path (names may hold
    dots)."""
    path = Path(path).resolve()
    name = "negfbench_file_" + hashlib.blake2b(
        str(path).encode(), digest_size=8).hexdigest()
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _for_cell(entries, workload):
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def plan(bench, workload, root=ROOT):
    """Everything one cell needs, resolved from its name in ``bench``
    (the BENCHMARK.json of the checkout at ``root``)."""
    here = Path(root) / "negfbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg_file = Path(root) / config["file"]
    with open(cfg_file) as f:
        spec = json.load(f)
    with open(here / "traffic" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    limits_file = here / "limits" / f"{workload}.json"
    limits = None
    if limits_file.exists():
        with open(limits_file) as f:
            limits = json.load(f)
    return SimpleNamespace(
        dir=here, workload=workload, cell=cell, chips=int(cell["chips"]),
        spec=spec,
        module=load_module(cfg_file.with_suffix(".py")), mix=mix,
        limits=limits, end_to_end=_for_cell(bench["end_to_end"], workload),
        per_layer=_for_cell(bench["per_layer"], workload))


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold, each
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def host_line(device, allocator):
    """The host's CPU count and threads and the card's power limit."""
    import torch
    card = "no card"
    if device.type == "cuda":
        try:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader", f"--id={device.index or 0}"],
                capture_output=True, text=True, timeout=60,
                check=True).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            card = f"{torch.cuda.get_device_name(device)} (nvidia-smi: {e})"
    return (f"negfbench: host cpus={os.cpu_count()} "
            f"torch_threads={torch.get_num_threads()} "
            f"omp={os.environ.get('OMP_NUM_THREADS')} "
            f"allocator={allocator} "
            f"card={card}")


def _end_to_end(plan_, mix, setup_s, units, points, window_s):
    out = {}
    formulas = {"seconds_per_unit": lambda: window_s / units,
                "points_per_second": lambda: points / window_s}
    for m in plan_.end_to_end:
        if m["name"] == "setup_s":
            v = setup_s
        else:
            v = formulas[mix["reports"][m["name"]]]()
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def _usage(a, b, window_s):
    """The process's CPU seconds over the window, in user and in kernel
    mode, as shares of the window (page faults of the host arrays show in
    the kernel's share)."""
    return {"user_share": f"{(b.ru_utime - a.ru_utime) / window_s:.3f}",
            "sys_share": f"{(b.ru_stime - a.ru_stime) / window_s:.3f}"}


def run_cell(plan_, seed, seconds, trace, device, control=None,
             spec_overrides=None, mix_overrides=None, t_start=None):
    """One run; returns (result line without 'checks', readings, verdict,
    the units' end times).  control: {number: 'reference_low' |
    'program_fast'} runs the control in the program's place (a
    calibration, never a benchmark run)."""
    import torch
    from gaunegf_tpu_torch.config import ExecutionConfig
    from negfbench import checks, jobs, tracing
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    spec = {**plan_.spec, **(spec_overrides or {})}
    mix = {**plan_.mix, **(mix_overrides or {})}
    mod = plan_.module
    fast = "program_fast" in (control or {}).values()
    exec_cfg = ExecutionConfig(precision="fast") if fast \
        else ExecutionConfig()
    phases = {"start": time.perf_counter() - t_start}
    mark = time.perf_counter()

    def phase(key):
        nonlocal mark
        now = time.perf_counter()
        phases[key] = now - mark
        mark = now
    inp = mod.inputs(spec, seed)
    phase("inputs")
    name = os.path.join(tempfile.gettempdir(), f"negfbench_{plan_.workload}")
    negfe = mod.program(spec, inp, device=device, name=name,
                        exec_cfg=exec_cfg)
    phase("program")
    system = SimpleNamespace(negfe=negfe, device=device,
                             band_center=mod.band_center(spec, inp))
    job = jobs.make(mix, system, seed)
    phase("mix")
    spans = tracing.Spans(device) if trace else None
    readers = []
    if trace:
        for m in plan_.per_layer:
            reader = load_module(plan_.dir / "metrics" / f"{m['name']}.py")
            for s in reader.SPANS:
                spans.install(**s)
            readers.append((m, reader))
    job.warm()
    jobs.sync(device)
    phase("warm")
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    usage0 = resource.getrusage(resource.RUSAGE_SELF)
    failed, units, window_s, profile, usage = 0, 0, 0.0, None, None
    try:
        if spans:
            spans.timing = True
        units, window_s = job.window(seconds)
        usage = _usage(usage0, resource.getrusage(resource.RUSAGE_SELF),
                       window_s)
        if spans:
            spans.timing = False
            _, profile = tracing.profile(
                lambda: job.extra(int(mix["profile_units"])), spans)
    except Exception:                   # a unit that failed: reported
        failed = 1
        traceback.print_exc()
        units = job.units
        window_s = time.perf_counter() - t0
    finally:
        if spans:
            spans.timing = False
    memory = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    run = SimpleNamespace(job=job, units=units, window_s=window_s,
                          spans=spans, profile=profile)
    print("negfbench: setup_s by phase " + " ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    if usage:
        print("negfbench: window host " + " ".join(
            f"{k} {v}" for k, v in usage.items()), file=sys.stderr)
    if trace:
        metrics = {}
        for m, reader in readers:
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        spans.remove()
    else:
        points = units * (job.points_per_unit or 0)
        metrics = _end_to_end(plan_, mix, setup_s, max(units, 1), points,
                              window_s)
    ends = getattr(job, "unit_ends", None)
    line = {"correct": False, "attempted": units + failed, "failed": failed,
            "metrics": metrics,
            "device": {"platform": "gpu" if device.type == "cuda"
                       else device.type,
                       "kind": torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu",
                       "count": 1, "memory_peak_bytes": int(memory)}}
    if profile is not None:
        line["device"]["busy_s"] = profile.busy_s
        line["device"]["window_s"] = profile.window_s
        line["breakdown"] = profile.breakdown()
    # the program's state goes before the reference runs on the card
    system.negfe = None
    del negfe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = checks.judge(mod, spec, inp, job, seed, device, control) \
        if units else {}
    verdict = checks.verdict(readings, plan_.limits or {})
    line["correct"] = bool(failed == 0 and units > 0 and plan_.limits
                           and all(ok for *_, ok in verdict))
    return line, readings, verdict, ends


def unit_line(ends):
    """Quartiles of the units' durations in the window, for the record."""
    if not ends or len(ends) < 3:
        return None
    d = [b - a for a, b in zip(ends, ends[1:])]
    if len(d) < 2:
        return None
    q = statistics.quantiles(d, n=4)
    return (f"negfbench: {len(ends)} units, seconds per unit q1 {q[0]:.6f} "
            f"median {q[1]:.6f} q3 {q[2]:.6f} max {max(d):.6f}")


def render(line, readings, verdict, ends):
    """(standard output lines, standard error lines) of a run: the units'
    spread, then the result's line last; on standard error the counts,
    then each compared number beside its limit last.  The line gains
    ``checks``, the numbers and limits, as its last key."""
    out, err = [], []
    u = unit_line(ends)
    if u:
        out.append(u)
    limited = {name for name, *_ in verdict}
    err.append("negfbench: counted " + json.dumps(
        {k: v for k, v in readings.items() if k not in limited}))
    if not verdict:
        err.append("negfbench: no limits for this cell")
    for name, v, limit, ok in verdict:
        err.append(f"check {name} {v!r} limit {limit!r} "
                   f"{'ok' if ok else 'FAILED'}")
    line = dict(line)
    line["checks"] = {name: {"value": v, "limit": limit}
                      for name, v, limit, _ in verdict}
    out.append(json.dumps(line))
    return out, err


def main(argv, t_start, allocator="default"):
    import argparse
    ap = argparse.ArgumentParser(prog="negfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    p = plan(load_benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < p.chips:
        print(f"negfbench: the cell needs {p.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(host_line(device, allocator), file=sys.stderr, flush=True)
    line, readings, verdict, ends = run_cell(
        p, args.seed, args.seconds, bool(args.trace), device,
        t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"negfbench: the run loaded {found}; no result",
              file=sys.stderr)
        return 3
    out, err = render(line, readings, verdict, ends)
    for text in err:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    for text in out:
        print(text, flush=True)
    return 0
