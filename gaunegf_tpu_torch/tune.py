"""Sweep the blocked LU's panel width and energy chunk on the card.

    python -m gaunegf_tpu_torch.tune [--out FILE] [--profile]

Times ``EnergyEngine.gr_sum`` (mixed tier, strip-scanned panel) on the
bench junction -- a disordered chain with 8+8 constant contacts, S = I,
real-axis grid on [-2, 2] -- at N=1000 (512 points) and N=2000 (128
points) for each panel width and chunk, and measures the peak device
bytes per energy lane.  These numbers set ``config.LU_BLOCK_SIZE``'s
automatic width and ``ops/greens._LANE_BYTES_PER_N2``.  Needs a CUDA
device; prints one JSON line per configuration and writes them to --out.
--profile instead prints torch.profiler's device-time table of one N=1000
gr_sum at the default width and chunk 64.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
from gaunegf_tpu_torch.ops.greens import EnergyEngine

SWEEP = {1000: (512, (64, 128, 256), (32, 64, 128, 256)),
         2000: (128, (128, 256), (32, 64))}


def bench_system(N, seed=0):
    """The bench junction (bench.py:305-321): disordered chain, S = I,
    ConstantSelfEnergy on 8+8 contact orbitals at -0.1j."""
    rng = np.random.default_rng(seed)
    H = -1.0 * (np.eye(N, k=1) + np.eye(N, k=-1)) \
        + np.diag(0.2 * rng.standard_normal(N))
    S = np.eye(N)
    g = ConstantSelfEnergy(H, S, [np.arange(8), np.arange(N - 8, N)],
                           sig1=-0.1j)
    return H, S, g


def measure(N, n_E, bs, chunk, device):
    H, S, g = bench_system(N)
    E = np.linspace(-2.0, 2.0, n_E)
    w = np.ones(n_E)
    eng = EnergyEngine(H, S, g, ExecutionConfig(
        precision="mixed", solver="lu", lu_panel="pstrip", lu_block=bs,
        energy_chunk=chunk), device=device)
    eng.gr_sum(E[:chunk], w[:chunk])                  # warm-up
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    eng.gr_sum(E[:chunk], w[:chunk])
    torch.cuda.synchronize(device)
    lane = (torch.cuda.max_memory_allocated(device) - base) / chunk
    t0 = time.perf_counter()
    eng.gr_sum(E, w)
    torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    return {"N": N, "points": n_E, "bs": bs, "chunk": chunk,
            "pts_per_s": n_E / dt, "lane_bytes": lane,
            "lane_bytes_per_n2": lane / N ** 2}


def profile(device):
    H, S, g = bench_system(1000)
    E = np.linspace(-2.0, 2.0, 512)
    w = np.ones(512)
    eng = EnergyEngine(H, S, g, ExecutionConfig(
        precision="mixed", solver="lu", lu_panel="pstrip", energy_chunk=64),
        device=device)
    eng.gr_sum(E[:64], w[:64])                        # warm-up
    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eng.gr_sum(E, w)
        torch.cuda.synchronize(device)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                    max_name_column_width=60))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    if args.profile:
        print(card)
        profile(device)
        return
    rows = []
    for N, (n_E, widths, chunks) in SWEEP.items():
        for bs in widths:
            for chunk in chunks:
                row = {"card": card, **measure(N, n_E, bs, chunk, device)}
                print(json.dumps(row), flush=True)
                rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows) + "\n")


if __name__ == "__main__":
    main()
