"""The per-layer metrics read from the program's own recorder
(metrics/_units.py): at each cell's tiny size every one reads, a
program without the recorder gives no reading and no error, and on the
card the blocking transfers a unit counts do not depend on the seed.
Each cell's list is its per-layer metrics in BENCHMARK.json whose file
imports metrics/_units.py."""

import pytest

from negfbench.tests import tiny

READS = tiny.recorder_metrics()
WAITS = {w: n for w, names in READS.items() for n in names
         if n.startswith("host_waits")}


def _metrics(workload, seed=2 ** 31 + 11, device="cpu"):
    line, _, _, _ = tiny.run(workload, seed=seed, trace=True, device=device)
    return {k: v["value"] for k, v in line["metrics"].items()}


@pytest.mark.parametrize("workload", sorted(READS))
def test_recorder_metrics_read_at_a_tiny_size(workload):
    got = _metrics(workload)
    for name in READS[workload]:
        assert got[name] >= 0, name
        if name.startswith("host_waits"):
            assert got[name] > 0 and got[name] == int(got[name])


@pytest.mark.parametrize("workload", sorted(READS))
def test_without_the_recorder_no_reading(monkeypatch, workload):
    """A program that lacks the recorder (an older checkout) leaves the
    metrics out of the line and raises nothing."""
    from negfbench.metrics import _units
    monkeypatch.setattr(_units, "recorder", None)
    got = _metrics(workload)
    assert not set(READS[workload]) & set(got)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(WAITS))
def test_host_waits_do_not_depend_on_the_seed_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = torch.device("cuda", 0)
    name = WAITS[workload]
    reads = [_metrics(workload, seed, card)[name]
             for seed in (2 ** 31 + 21, 2 ** 32 + 5)]
    assert reads[0] == reads[1] > 0
