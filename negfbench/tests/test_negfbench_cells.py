"""Every cell at a tiny size on the CPU: the run comes out correct against
the plain reference, its line has the contract's keys, the control in the
program's place comes out not correct, and so does a run with the timed
path broken underneath in each way the cell can be."""

import json

import numpy as np
import pytest

from negfbench import harness
from negfbench.tests import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _config(workload):
    b = harness.load_benchmark()
    cfg = {w["name"]: w for w in b["workloads"]}[workload]["config"]
    p = harness.plan(b, workload)
    return cfg, p


@pytest.mark.parametrize("workload", tiny.workloads())
def test_cell_is_correct_at_a_tiny_size(workload):
    line, readings, verdict, ends = tiny.run(workload)
    assert line["correct"], verdict
    assert line["failed"] == 0 and line["attempted"] >= 1
    out, err = harness.render(line, readings, verdict, ends)
    last = json.loads(out[-1])
    assert set(last) == KEYS and list(last)[-1] == "checks"
    assert err[-1].startswith("check ")
    _, p = _config(workload)
    assert set(last["metrics"]) == {m["name"] for m in p.end_to_end}


@pytest.mark.parametrize("workload", tiny.workloads())
def test_traced_line_has_the_cells_layers(workload):
    line, readings, verdict, ends = tiny.run(workload, trace=True)
    last = json.loads(harness.render(line, readings, verdict, ends)[0][-1])
    assert set(last) == KEYS | {"breakdown"}
    assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    _, p = _config(workload)
    # on the CPU no device operation runs: the device and roofline
    # readers have nothing to read
    host = {m["name"] for m in p.per_layer if m["source"] == "program_span"}
    assert host <= set(last["metrics"]), set(last["metrics"])


@pytest.mark.parametrize("workload", tiny.workloads("scf"))
def test_control_comes_out_not_correct(workload):
    """The SCF cells' control (the reference in complex64 and float32 in
    the program's place) at a tiny size; the T(E) cell's control, the
    program's 'fast' tier, reads like 'mixed' at N = 64 and is a card
    test at the cell's own size (test_negfbench_card.py)."""
    _, p = _config(workload)
    line, readings, verdict, _ = tiny.run(workload, seed=7,
                                          control=p.spec["control"])
    assert not line["correct"], readings


def _scf_faults(monkeypatch, which):
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


def _transport_faults(monkeypatch, which):
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


SCF_FAULTS = ("density_unchanged", "mixing_unchanged", "fock_unchanged",
              "half_the_points", "density_altered")
SWEEP_FAULTS = ("sweep_unchanged", "half_the_points", "answer_altered")
FAULTS = [(w, f) for w in tiny.workloads("scf") for f in SCF_FAULTS] \
    + [(w, f) for w in tiny.workloads("transmission") for f in SWEEP_FAULTS]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_broken_path_comes_out_not_correct(monkeypatch, workload, fault):
    p = harness.plan(harness.load_benchmark(), workload)
    if p.mix["job"] == "scf":
        _scf_faults(monkeypatch, fault)
    else:
        _transport_faults(monkeypatch, fault)
    line, readings, verdict, _ = tiny.run(workload, seed=3)
    assert not line["correct"], (fault, readings)


def test_main_refuses_without_a_card(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", tiny.workloads()[0], "--seed",
                       str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                      0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
