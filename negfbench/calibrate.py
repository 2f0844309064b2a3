"""Readings for a cell's limits: the program's numbers on many seeds and
the control's on a few, in one process (not a benchmark run).

    python negfbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 5] [--control '{"density": ...}']

Each run's window is short (its cycles or sweeps are judged as a
benchmark run's are).  The control is the configuration's own
(``control`` in its file) unless one is given.  One JSON line a run, on
standard output and appended to ``--out``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    from negfbench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "4")))
    p = harness.plan(harness.load_benchmark(), args.workload)
    control = json.loads(args.control) if args.control \
        else p.spec["control"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    for kind, ss, ctl in (("program", seeds, None),
                          ("control", cseeds, control)):
        for seed in ss:
            t = time.perf_counter()
            line, readings, verdict, _ = harness.run_cell(
                p, seed, args.seconds, False, torch.device("cuda", 0),
                control=ctl)
            row = {"workload": args.workload, "kind": kind, "seed": seed,
                   "control": ctl, "readings": readings,
                   "units": line["attempted"],
                   "metrics": line["metrics"],
                   "seconds": time.perf_counter() - t}
            print(json.dumps(row), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
