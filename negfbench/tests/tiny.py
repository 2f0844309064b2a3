"""Tiny sizes of every cell, for runs on the CPU in the tests."""

import copy

import torch

from negfbench import harness

CONFIG = {"chain2000": {"n": 24, "n_electrons": 24,
                        "contacts": [[1, 2], [23, 24]]},
          "au_bethe1000": {"n_chain": 10}}
GRID_CAP = 16
# At N = 64 the contacts' fixed point, stopped at a change of 1e-5, weighs
# more in T(E) than at N = 1000 (1.6e-6 to 1.9e-6 over max(1, T) on the
# CPU, where 'mixed' and 'fast' read alike): the tiny runs hold T(E) at
# 1e-5.
LIMITS = {"au_bethe1000.transport": {"transmission": 1e-5}}


def mix(p):
    """The cell's mix with its grids cut to at most GRID_CAP points and
    20-point sweeps."""
    m = copy.deepcopy(p.mix)
    for call in m["setup"]:
        if call[0] == "setIntegralLimits":
            call[1] = {k: min(v, GRID_CAP) for k, v in call[1].items()}
    if m["job"] == "transmission":
        m["points"] = 20
        m["checked_points"] = 12
    m["profile_units"] = 1
    return m


def run(workload, seed=2 ** 31 + 11, seconds=0.5, trace=False, control=None,
        device="cpu"):
    """(line, readings, verdict, ends) of a tiny run of the cell."""
    torch.set_num_threads(1)
    p = harness.plan(harness.load_benchmark(), workload)
    p.limits = LIMITS.get(workload, p.limits)
    return harness.run_cell(p, seed, seconds, trace, device, control=control,
                            spec_overrides=CONFIG[p.cell["config"]],
                            mix_overrides=mix(p))


def workloads(job=None):
    """The cells, or those whose mix runs ``job``."""
    b = harness.load_benchmark()
    return [w["name"] for w in b["workloads"]
            if job is None or harness.plan(b, w["name"]).mix["job"] == job]
