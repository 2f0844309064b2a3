"""BENCHMARK.json against the files of the harness, the contract's shape,
the imports the benchmark may not make, the roofline yardstick against
the repository's chip_smoke.py, and a configuration and its cells added
to a copy of the checkout by new files alone."""

import ast
import importlib.util
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from negfbench import harness, roofline
from negfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "negfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return harness.load_benchmark()


def test_every_entry_resolves_to_its_files():
    b = _bench()
    for c in b["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and f.with_suffix(".py").is_file(), c["name"]
        assert json.loads(f.read_text())["name"] == c["name"]
    for w in b["workloads"]:
        p = harness.plan(b, w["name"])
        assert p.limits, f"{w['name']} has no limits file"
        assert p.mix["job"] in ("scf", "transmission")
        for m in p.end_to_end:
            assert m["name"] == "setup_s" or m["name"] in p.mix["reports"]
    for m in b["per_layer"]:
        mod = harness.load_module(BENCH / "metrics" / f"{m['name']}.py")
        assert callable(mod.read) and isinstance(mod.SPANS, list)


def test_contract_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_each_cell_reports_what_its_layers_move():
    b = _bench()
    for w in b["workloads"]:
        p = harness.plan(b, w["name"])
        e2e = {m["name"] for m in p.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and p.per_layer
        for m in p.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_forbidden_imports():
    for f in BENCH.rglob("*.py"):
        tops = set(_imports(f))
        assert not tops & {"jax", "jaxlib", "flax", "gaunegf_tpu", "bench",
                           "benchmarks"}, f
        if "reference" in f.relative_to(BENCH).parts:
            assert "gaunegf_tpu_torch" not in tops, f


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types
    assert "gaunegf_tpu_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gaunegf_tpu.scf",
                        types.ModuleType("gaunegf_tpu.scf"))
    assert harness.forbidden_modules() == ["gaunegf_tpu"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_copy",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(64, 32, 1024), (8, 32, 256), (3, 7, 40)])
def test_strip_bound_matches_chip_smoke(shape):
    cs = _chip_smoke()
    b, rows, m = shape
    avail = torch.rand(b, m, generator=torch.Generator().manual_seed(b)) > 0.3
    assert roofline.strip_bound(avail.sum(1).tolist(), rows, m) \
        == cs.strip_bound(avail, rows, m)


@pytest.mark.parametrize("shape", [(64, 1024, 256, 8), (4, 100, 32, 16)])
def test_panel_bound_matches_chip_smoke(shape):
    assert roofline.panel_bound(*shape) == _chip_smoke().panel_bound(*shape)


@pytest.mark.parametrize("mode", [("jacobi", True, True),
                                  ("jacobi", False, False),
                                  (None, True, True)])
def test_fixed_point_ops_matches_chip_smoke(mode):
    counts = torch.as_tensor(np.random.default_rng(0).integers(
        1, 40, size=(50, 2)), dtype=torch.int32)
    assert roofline.fixed_point_ops(counts.tolist(), *mode) \
        == _chip_smoke().fixed_point_ops(counts, *mode)


@pytest.mark.parametrize("mode", ["sancho", "dyson"])
@pytest.mark.parametrize("n", [1, 9, 40])
def test_decimate_ops_matches_chip_smoke(mode, n):
    counts = torch.as_tensor(np.random.default_rng(n).integers(
        1, 60, size=300), dtype=torch.int32)
    assert roofline.decimate_ops(counts.tolist(), n, mode) \
        == _chip_smoke().decimate_ops(counts, n, mode)


def test_recorder_lists_of_the_first_cells():
    """The recorder tests take their lists from BENCHMARK.json, so a metric
    that the derivation missed would drop out of them unseen: each of the
    first two cells keeps its recorder metrics in its list."""
    got = tiny.recorder_metrics()
    assert set(got["au_bethe1000.scf_bias"]) >= {
        "scf_mix_ms", "scf_fock_ms", "density_prep_ms", "host_waits.scf"}
    assert set(got["au_bethe1000.transport"]) >= {
        "sweep_prep_ms", "host_waits.transport"}


NEW = "chain_added"


def _add_a_configuration(root):
    """Give the checkout at ``root`` a configuration that BENCHMARK.json
    does not name (chain2000's files under a new name), an SCF cell and a
    T(E) cell of it, and a per-layer metric: new files, new entries, and
    the cells appended to the ``workloads`` of the metrics they report."""
    here = root / "negfbench"
    cfg = here / "configs"
    spec = json.loads((cfg / "chain2000.json").read_text())
    spec["name"] = NEW
    (cfg / f"{NEW}.json").write_text(json.dumps(spec))
    shutil.copy(cfg / "chain2000.py", cfg / f"{NEW}.py")
    mix = json.loads((here / "traffic" /
                      "transmission_sband_200pts.json").read_text())
    mix["why"] = "T(E) sweeps over the chain's band"
    (here / "traffic" / "transmission_chain.json").write_text(
        json.dumps(mix))
    scf, sweep = f"{NEW}.scf_bias", f"{NEW}.transport"
    # At n = 24 a few energies by the band's edge (E near 2.08 eV) sit on
    # resonances narrow enough that 'mixed' T(E) reads up to 1.5e-5 of
    # max(1, T) there (1 point in ~10^4; the median point 3e-8); the
    # faults read 1e-3 or more.
    tiny_sizes = json.loads((cfg / "chain2000.tiny.json").read_text())
    tiny_sizes["limits"] = {sweep: {"transmission": 1e-4}}
    (cfg / f"{NEW}.tiny.json").write_text(json.dumps(tiny_sizes))
    # The SCF cell at n = 24 on the tiny grids: sound runs read density
    # 1.0e-15 to 3.2e-15, fock and mixing 0 (12 seeds); the faults 1e-3
    # or more.
    (here / "limits" / f"{scf}.json").write_text(
        json.dumps({"density": 1e-9, "fock": 1e-12, "mixing": 1e-12}))
    (here / "limits" / f"{sweep}.json").write_text(
        json.dumps({"transmission": 3e-6}))
    (here / "metrics" / "cycles_seen.py").write_text(
        "SPANS = []\n\n\ndef read(run):\n"
        "    return float(run.units) if run.job.unit == 'cycle' else None\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": NEW, "source": "test",
                         "file": f"negfbench/configs/{NEW}.json",
                         "reduced": [], "why": "test"})
    b["workloads"] += [
        {"name": scf, "config": NEW, "traffic": "scf_bias_0.4V_1048pts",
         "chips": 1, "why": "test"},
        {"name": sweep, "config": NEW, "traffic": "transmission_chain",
         "chips": 1, "why": "test"}]
    grow = {"scf_cycle_s": scf, "transport_pts_s": sweep,
            "scf_host_ms": scf, "scf_mix_ms": scf, "scf_fock_ms": scf,
            "host_waits.scf": scf, "sweep_prep_ms": sweep,
            "host_waits.transport": sweep}
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in grow:
            m["workloads"].append(grow[m["name"]])
    b["per_layer"].append({"name": "cycles_seen", "unit": "cycles",
                           "better": "higher", "source": "program_span",
                           "layer": "SCF driver", "moves": "scf_cycle_s",
                           "workloads": [scf]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return scf, sweep


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in [root / "BENCHMARK.json",
                      *sorted((root / "negfbench").rglob("*"))]
            if p.is_file() and "__pycache__" not in p.parts}


def _only_added(old, new):
    """Every entry of ``old`` (a BENCHMARK.json) is in ``new`` in its
    place, alike but for a ``workloads`` list that grew at its end."""
    assert set(new) == set(old)
    for key, value in old.items():
        if key not in ("configs", "workloads", "end_to_end", "per_layer"):
            assert new[key] == value, key
            continue
        assert len(new[key]) >= len(value), key
        for a, b in zip(value, new[key]):
            kept = {k: v[:len(a[k])] if k == "workloads" and k in a else v
                    for k, v in b.items()}
            assert kept == a, (key, a)


def test_adding_a_cell_config_and_metric_takes_only_new_files(
        tmp_path, monkeypatch):
    """A copy of the checkout gains a configuration and two cells of it,
    by new files and new entries alone.  Through the tiny runs, each new
    cell is correct, its traced line holds its program-span metrics, and a
    broken path of its kind comes out not correct; no file of the
    checkout changed but BENCHMARK.json, which only gained entries."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "negfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    scf, sweep = _add_a_configuration(root)
    assert set(tiny.workloads(root=root)) - set(tiny.workloads()) \
        == {scf, sweep}
    assert set(tiny.recorder_metrics(root)) \
        - set(tiny.recorder_metrics()) == {scf, sweep}
    b = harness.load_benchmark(root)
    for cell, fault in ((scf, "density_altered"), (sweep, "answer_altered")):
        p = harness.plan(b, cell, root)
        line, _, verdict, _ = tiny.run(cell, root=root)
        assert line["correct"], (cell, verdict)
        line, _, verdict, _ = tiny.run(cell, trace=True, root=root)
        assert line["correct"], (cell, verdict)
        spans = {m["name"] for m in p.per_layer
                 if m["source"] == "program_span"}
        assert spans and spans <= set(line["metrics"]), (cell, line)
        with monkeypatch.context() as m:
            tiny.break_path(m, p.mix["job"], fault)
            line, readings, _, _ = tiny.run(cell, seed=3, root=root)
        assert not line["correct"], (cell, fault, readings)
    before, after = _files(ROOT), _files(root)
    assert set(before) <= set(after)
    changed = {p for p in before if before[p] != after[p]}
    assert changed == {Path("BENCHMARK.json")}, changed
    _only_added(json.loads(before[Path("BENCHMARK.json")]),
                json.loads(after[Path("BENCHMARK.json")]))
