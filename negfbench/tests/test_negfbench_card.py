"""Every cell at a tiny size on the card: correct against the reference,
and traced, every per-layer metric of the cell read from its spans and
the profiler's device trace.  Skips without a CUDA device (decided in the
fixture); run on the card with
``python -m pytest negfbench/tests -m cuda``."""

import pytest

from negfbench import harness
from negfbench.tests import tiny


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", tiny.workloads())
def test_cell_on_the_card(card, workload):
    line, readings, verdict, _ = tiny.run(workload, device=card)
    assert line["correct"], verdict
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", tiny.workloads())
def test_traced_cell_reads_every_layer_on_the_card(card, workload):
    line, _, _, _ = tiny.run(workload, trace=True, device=card)
    p = harness.plan(harness.load_benchmark(), workload)
    assert {m["name"] for m in p.per_layer} == set(line["metrics"])
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for m in p.per_layer:
        if m["unit"] == "%":
            assert 0 <= line["metrics"][m["name"]]["value"] <= 100


@pytest.mark.cuda
@pytest.mark.parametrize("workload", tiny.workloads())
def test_control_at_the_cells_own_size_on_the_card(card, workload):
    """The control of each cell (its configuration's ``control``) at the
    cell's own size, a short window: not correct."""
    p = harness.plan(harness.load_benchmark(), workload)
    line, readings, _, _ = harness.run_cell(
        p, 2 ** 31 + 77, 2.0, False, card, control=p.spec["control"])
    assert not line["correct"], readings
