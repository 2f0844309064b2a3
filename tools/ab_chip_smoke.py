"""Compare two checkouts of the repository on one card, in turns.

    python3 tools/ab_chip_smoke.py BASELINE_DIR --out DIR [--tune]
                                   [--smoke-args="--only-bethe"]

Runs ``chip_smoke.py`` of the baseline checkout (B) and of this one (A)
in the order B A A B, each from its own root, so both meet the same card
under the same conditions (--smoke-args hands both the same arguments,
e.g. --only-bethe for phase 9 alone); with --tune it then runs this checkout's panel
sweep (``python3 -m gaunegf_tpu_torch.tune --panel pstrip fused pallas
pallas fused pstrip``).  Each run's output goes to DIR/<n>_<label>.log;
the summary (the card, then per run the phase-3 kernel lines, the phase
4 and 6 rates, phase 6a's T(E) error, the SCF seconds per cycle of phases
5 and 7d, phase 7's rates and, where a checkout has it, phase 8's seconds
and probes and phase 9's seconds per cycle, rates, sweeps per energy,
providers' share and fixed-point launches) is printed and written to
DIR/summary.json.  Needs a CUDA device; exits non-zero if any run fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUN_TIMEOUT_S = 1100


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def summarize(log: str) -> dict:
    """The phase-3 kernel lines, the rates and seconds per cycle of
    phases 4-8 and phase 6a's error of one run."""
    out = {"kernels": [ln for ln in log.splitlines()
                       if ln.startswith("phase 3 kernel")
                       or "kernel device ms" in ln]}
    for ln in log.splitlines():
        if ln.startswith("phase 4 gr_sum: "):
            gr = json.loads(ln.split(": ", 1)[1])
            out["phase4_pts_per_s"] = gr["pts_per_s"]
            out["phase4_launches"] = gr["launches"]
        elif ln.startswith("phase 6 transport: "):
            tr = json.loads(ln.split(": ", 1)[1])
            out["phase6a"] = {k: tr["a"][k] for k in
                              ("pts_per_s", "max_abs_err_T", "launches")}
            out["phase6b"] = {k: tr["b"][k] for k in
                              ("T_pts_per_s", "dos_pts_per_s", "launches")}
            out["phase6d"] = tr.get("d")
        elif ln.startswith("phase 5 scf: "):
            out["phase5_s_per_cycle"] = json.loads(
                ln.split(": ", 1)[1])["s_per_cycle"]
        elif ln.startswith("phase 7 spectral: "):
            sp = json.loads(ln.split(": ", 1)[1])
            out["phase7"] = {"a_pts_per_s": sp["a"]["pts_per_s"],
                             "b_pts_per_s": sp["b"]["pts_per_s"],
                             "c_T_pts_per_s": sp["c"]["T_pts_per_s"],
                             "d_s_per_cycle": sp["d"]["s_per_cycle"]}
        elif ln.startswith("phase 8 fermi: "):
            f = json.loads(ln.split(": ", 1)[1])
            out["phase8"] = {
                "a_s_per_cycle": f["a"]["s_per_cycle"],
                "a_probes": [c["probes"] for c in f["a"]["per_cycle"]],
                "a_eighs": [c["eighs"] for c in f["a"]["per_cycle"]],
                "a_other_seconds": {o["method"]: o["seconds"]
                                    for o in f["a"]["others"]},
                "b_seconds": f["b"]["seconds"],
                "b_rel_err_contour_window":
                    f["b"]["rel_err_contour_window"],
                "c_integral_check_seconds":
                    f["c"]["integral_check_seconds"],
                "c_lead_seconds": f["c"]["lead_seconds"],
                "d_u_s_per_cycle": f["d_u"]["s_per_cycle"],
                "d_u_T_pts_per_s": f["d_u"]["T_pts_per_s"],
                "d_g_default_s_per_cycle":
                    f["d_g_default"]["s_per_cycle"],
                "d_g_lu_s_per_cycle": f["d_g_lu"]["s_per_cycle"],
                "d_g_lu_strip_launches": f["d_g_lu"]["scf_launches"][0]}
        elif ln.startswith("phase 9 bethe: "):
            out["phase9"] = summarize_bethe(json.loads(ln.split(": ", 1)[1]))
        elif ln.startswith("phase 14 timed "):
            key, row = ln[len("phase 14 timed "):].split(": ", 1)
            out.setdefault("phase14", {})[key] = json.loads(row)
    return out


def summarize_bethe(b: dict) -> dict:
    """Phase 9's timings: seconds per cycle and the instrumented FockToP
    (seconds, providers' share, sweeps per energy) of 9a / 9b, the high
    tier's FockToP, 9c's T(E) and DOS rates and 9d's rates, with the
    fixed-point launches where the checkout counts them."""
    out = {}
    for lat in ("a", "b"):
        r = b[lat]
        for key in ("eq", "bias"):
            out[f"{lat}_{key}_s_per_cycle"] = r[key]["s_per_cycle"]
            out[f"{lat}_{key}_launches"] = r[key]["launches"]
        ins = r["instrumented"]
        out[f"{lat}_focktop"] = {k: ins[k] for k in (
            "seconds", "provider_seconds", "provider_share", "sweeps_mean",
            "sweeps_max", "fixed_point_lanes")}
    out["b_high_seconds"] = b["b"]["high"]["seconds"]
    out["seconds"] = b.get("seconds")
    for lat, c in b["c"].items():
        for name, r in c.items():
            if isinstance(r, dict) and "T_pts_per_s" in r:
                out[f"c_{lat}_{name}"] = {k: r[k] for k in (
                    "T_pts_per_s", "dos_pts_per_s", "launches") if k in r}
    for name, d in b["d"].items():
        if isinstance(d, dict):
            out[f"d_{name}"] = {k: d[k] for k in (
                "gr_pts_per_s", "T_pts_per_s", "T_lu_pts_per_s", "launches")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("baseline", type=Path, help="root of the baseline checkout")
    ap.add_argument("--out", type=Path, required=True,
                    help="directory for the logs and summary.json")
    ap.add_argument("--tune", action="store_true",
                    help="then run this checkout's panel sweep")
    ap.add_argument("--smoke-args", default="",
                    help="arguments for both checkouts' chip_smoke.py "
                         "(e.g. --only-bethe)")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    runs = [("baseline", args.baseline.resolve()), ("change", ROOT),
            ("change", ROOT), ("baseline", args.baseline.resolve())]
    summary = {"card": card(), "runs": []}
    print(summary["card"], flush=True)
    failed = False
    for n, (label, root) in enumerate(runs):
        proc = subprocess.run([sys.executable, "chip_smoke.py",
                               *args.smoke_args.split()], cwd=root,
                              capture_output=True, text=True,
                              timeout=RUN_TIMEOUT_S)
        log = proc.stdout + proc.stderr
        (args.out / f"{n}_{label}.log").write_text(log)
        entry = {"run": n, "label": label, "rc": proc.returncode,
                 **summarize(proc.stdout)}
        summary["runs"].append(entry)
        print(json.dumps(entry), flush=True)
        failed |= proc.returncode != 0
    if args.tune:
        proc = subprocess.run(
            [sys.executable, "-m", "gaunegf_tpu_torch.tune", "--panel",
             "pstrip", "fused", "pallas", "pallas", "fused", "pstrip",
             "--out", str(args.out / "tune_panels.jsonl")],
            cwd=ROOT, capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
        (args.out / "tune.log").write_text(proc.stdout + proc.stderr)
        summary["tune_rc"] = proc.returncode
        print(f"tune rc {proc.returncode}", flush=True)
        failed |= proc.returncode != 0
    (args.out / "summary.json").write_text(json.dumps(summary, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
