"""BENCHMARK.json against the files of the harness, the contract's shape,
the imports the benchmark may not make, and the roofline yardstick
against the repository's chip_smoke.py."""

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


def test_adding_a_cell_config_and_metric_takes_only_new_files(tmp_path):
    """A copy of the checkout gains a configuration, a traffic mix, a
    limits file and a per-layer metric as new files and new entries; its
    new cell then runs, traced, with the new metric in its line."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "negfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    cfg = root / "negfbench" / "configs"
    spec = json.loads((cfg / "chain2000.json").read_text())
    spec.update(name="chain24", n=24, n_electrons=24,
                contacts=[[1, 2], [23, 24]])
    (cfg / "chain24.json").write_text(json.dumps(spec))
    shutil.copy(cfg / "chain2000.py", cfg / "chain24.py")
    mix = json.loads((root / "negfbench" / "traffic" /
                      "scf_bias_0.4V_1048pts.json").read_text())
    mix["setup"][1][1] = {"N1": 8, "N2": 4, "Nnegf": 16}
    (root / "negfbench" / "traffic" / "scf_bias_tiny.json").write_text(
        json.dumps(mix))
    (root / "negfbench" / "limits" / "chain24.scf_tiny.json").write_text(
        json.dumps({"density": 1e-9, "fock": 1e-12, "mixing": 1e-12}))
    (root / "negfbench" / "metrics" / "cycles_seen.py").write_text(
        "SPANS = []\n\ndef read(run):\n    return float(run.units)\n")
    b["configs"].append({"name": "chain24", "source": "test",
                         "file": "negfbench/configs/chain24.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "chain24.scf_tiny", "config": "chain24",
                           "traffic": "scf_bias_tiny", "chips": 1,
                           "why": "test"})
    b["end_to_end"][0]["workloads"].append("chain24.scf_tiny")
    b["per_layer"].append({"name": "cycles_seen", "unit": "cycles",
                           "better": "higher", "source": "host_clock",
                           "layer": "SCF driver", "moves": "scf_cycle_s",
                           "workloads": ["chain24.scf_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    torch.set_num_threads(1)
    p = harness.plan(harness.load_benchmark(root), "chain24.scf_tiny", root)
    line, _, verdict, _ = harness.run_cell(p, 5, 0.3, True, "cpu")
    assert line["metrics"]["cycles_seen"]["value"] >= 1
    assert verdict and all(ok for *_, ok in verdict)
