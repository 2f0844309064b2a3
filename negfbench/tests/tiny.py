"""Tiny sizes of every cell, for runs on the CPU in the tests.

A configuration's tiny sizes sit beside its file in ``BENCHMARK.json``,
under the same name with the suffix ``.tiny.json``
(``configs/<config>.tiny.json``)::

    {"spec": {<the configuration's keys, overridden>},
     "limits": {"<cell>": {"<number>": <its limit at the tiny size>}},
     "why": "..."}

``limits`` and ``why`` may be left out; a cell without tiny limits is
held to its own ``limits/<cell>.json``.  So a configuration and its cells
join these tests by new files alone.
"""

import copy
import json
from pathlib import Path

import numpy as np
import torch

from negfbench import harness

GRID_CAP = 16


def sizes(bench, config, root=harness.ROOT):
    """The tiny file of the configuration named ``config`` in ``bench``
    (the BENCHMARK.json of the checkout at ``root``)."""
    entry = {c["name"]: c for c in bench["configs"]}[config]
    path = (Path(root) / entry["file"]).with_suffix(".tiny.json")
    if not path.is_file():
        raise FileNotFoundError(
            f"configuration {config!r} has no tiny sizes: {path} is missing")
    with open(path) as f:
        return json.load(f)


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
        device="cpu", root=harness.ROOT):
    """(line, readings, verdict, ends) of a tiny run of the cell of the
    checkout at ``root``."""
    torch.set_num_threads(1)
    bench = harness.load_benchmark(root)
    p = harness.plan(bench, workload, root)
    small = sizes(bench, p.cell["config"], root)
    p.limits = small.get("limits", {}).get(workload, p.limits)
    return harness.run_cell(p, seed, seconds, trace, device, control=control,
                            spec_overrides=small["spec"],
                            mix_overrides=mix(p))


def workloads(job=None, root=harness.ROOT):
    """The cells of the checkout at ``root``, or those whose mix runs
    ``job``."""
    b = harness.load_benchmark(root)
    return [w["name"] for w in b["workloads"]
            if job is None
            or harness.plan(b, w["name"], root).mix["job"] == job]


def recorder_metrics(root=harness.ROOT):
    """{cell: its per-layer metrics whose file imports metrics/_units.py,
    the reader of the program's recorder}, from the BENCHMARK.json of the
    checkout at ``root``.  The files are read as text: importing one turns
    the recorder on."""
    b = harness.load_benchmark(root)
    out = {}
    for w in b["workloads"]:
        p = harness.plan(b, w["name"], root)
        names = tuple(m["name"] for m in p.per_layer
                      if "negfbench.metrics import _units" in
                      (p.dir / "metrics" / f"{m['name']}.py").read_text())
        if names:
            out[w["name"]] = names
    return out


def _break_scf(monkeypatch, which):
    from gaunegf_tpu_torch.ops import greens
    from gaunegf_tpu_torch.scf import NEGF
    from gaunegf_tpu_torch.scfe import NEGFE
    if which == "density_unchanged":
        monkeypatch.setattr(NEGFE, "FockToP", lambda self: (None, None))
    elif which == "mixing_unchanged":
        orig = NEGF.PMix

        def pmix(self, damping, pulay=False):
            P = self.P
            out = orig(self, damping, pulay)
            self.P = P
            self._P_stored = P.copy()
            return out
        monkeypatch.setattr(NEGF, "PMix", pmix)
    elif which == "fock_unchanged":
        monkeypatch.setattr(NEGFE, "PToFock", lambda self: 0.0)
    elif which == "half_the_points":
        orig = greens.EnergyEngine.density_neq_sum

        def half(self, E_eq, w_eq, E_neq, w_neq, contact=None):
            return orig(self, E_eq[::2], 2 * np.asarray(w_eq)[::2],
                        E_neq[::2], 2 * np.asarray(w_neq)[::2], contact)
        monkeypatch.setattr(greens.EnergyEngine, "density_neq_sum", half)
    elif which == "density_altered":
        orig = NEGFE.FockToP

        def altered(self):
            out = orig(self)
            self.P = self.P * (1 + 1e-3)
            return out
        monkeypatch.setattr(NEGFE, "FockToP", altered)


def _break_sweep(monkeypatch, which):
    from gaunegf_tpu_torch.ops import greens
    orig = greens.EnergyEngine.transmission
    if which == "sweep_unchanged":
        first = {}

        def stale(self, E):
            if "T" not in first:
                first["T"] = orig(self, E)
            return first["T"]
        monkeypatch.setattr(greens.EnergyEngine, "transmission", stale)
    elif which == "half_the_points":
        def half(self, E):
            T = np.repeat(orig(self, np.asarray(E)[::2]), 2)[:len(E)]
            return T
        monkeypatch.setattr(greens.EnergyEngine, "transmission", half)
    elif which == "answer_altered":
        monkeypatch.setattr(greens.EnergyEngine, "transmission",
                            lambda self, E: orig(self, E) * (1 + 1e-3)
                            + 1e-3)


FAULTS = {"scf": ("density_unchanged", "mixing_unchanged", "fock_unchanged",
                  "half_the_points", "density_altered"),
          "transmission": ("sweep_unchanged", "half_the_points",
                           "answer_altered")}


def break_path(monkeypatch, job, which):
    """Break the timed path of a ``job`` cell underneath, the fault
    ``which`` of ``FAULTS[job]``."""
    {"scf": _break_scf, "transmission": _break_sweep}[job](monkeypatch, which)
