"""Phase 7 of chip_smoke.py from two checkouts on one card, in turns.

    python3 tools/ab_spectral.py BASELINE_DIR [--rounds N] [--out FILE]

The spectral route's phases are bound by the host (the card idles 60% of
a call), so on a shared host they spread by tens of percent between runs
of one tree.  This runs ``chip_smoke.phase_spectral`` of the baseline
checkout (B) and of this one (A) in the order B A A B, N rounds, each run
in a fresh process from its own root, and prints per run the rates of
7a, 7b, 7c (pts/s) and 7d's seconds per SCF cycle, then each tree's
median, minimum and maximum.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUN = """
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from gaunegf_tpu_torch.ops.kernels import panel_fused, panel_lu, strip_elim
torch.backends.cuda.matmul.allow_tf32 = False
r = cs.phase_spectral((strip_elim, panel_fused, panel_lu),
                      torch.device("cuda", 0), 0.0)
cs.check_spectral(r)
print(json.dumps({"7a_pts_per_s": r["a"]["pts_per_s"],
                  "7b_pts_per_s": r["b"]["pts_per_s"],
                  "7c_T_pts_per_s": r["c"]["T_pts_per_s"],
                  "7d_s_per_cycle": r["d"]["s_per_cycle"]}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("baseline", type=Path, help="root of the baseline checkout")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    roots = {"baseline": args.baseline.resolve(), "change": ROOT}
    runs = {"baseline": [], "change": []}
    for _ in range(args.rounds):
        for label in ("baseline", "change", "change", "baseline"):
            proc = subprocess.run([sys.executable, "-c", RUN],
                                  cwd=roots[label], capture_output=True,
                                  text=True, timeout=600)
            if proc.returncode != 0:
                print(proc.stderr[-2000:])
                return 1
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[label].append(row)
            print(label, json.dumps(row), flush=True)
    summary = {"card": card, "runs": runs, "summary": {
        label: {k: {"median": statistics.median(r[k] for r in rows),
                    "min": min(r[k] for r in rows),
                    "max": max(r[k] for r in rows)} for k in rows[0]}
        for label, rows in runs.items()}}
    print(json.dumps(summary["summary"]))
    if args.out:
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
