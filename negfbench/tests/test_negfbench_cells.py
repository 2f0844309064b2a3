"""Every cell at a tiny size on the CPU: the run comes out correct against
the plain reference, its line has the contract's keys, the control in the
program's place comes out not correct, and so does a run with the timed
path broken underneath in each way the cell can be."""

import json

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


FAULTS = [(w, f) for job, faults in tiny.FAULTS.items()
          for w in tiny.workloads(job) for f in faults]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_broken_path_comes_out_not_correct(monkeypatch, workload, fault):
    p = harness.plan(harness.load_benchmark(), workload)
    tiny.break_path(monkeypatch, p.mix["job"], fault)
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
