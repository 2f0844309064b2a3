"""The recorder behind perf_span and perf_count (gaunegf_tpu_torch/
utils/logging.py) on the CPU: off it reads no clock; on it nests spans,
takes self time, groups spans and counters into units; one biased SCF
cycle with Bethe contacts on the warm LU, and one T(E) sweep there, give
the span trees the module documents and count their blocking transfers;
a profiler the program did not open sees none of its spans, and
profile_trace's Chrome trace holds them."""

import json
import logging
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gaunegf_tpu_torch import transport as tr
from gaunegf_tpu_torch import tune
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.scfe import NEGFE
from gaunegf_tpu_torch.utils import logging as tlog
from gaunegf_tpu_torch.utils.logging import perf_count, perf_span
from torch_recording import recording  # noqa: F401  (a fixture)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

# the trees of utils/logging's docstring: {parent: children}
SCF_TREE = {
    None: ["scf.cycle"],
    "scf.cycle": ["scf.FockToP", "scf.PMix", "scf.PToFock"],
    "scf.FockToP": ["density.grids", "engine.setup", "engine.pole_guard",
                    "gr_sum", "engine.chunk", "engine.finish"],
    "gr_sum": ["engine.setup", "engine.chunk", "engine.finish"],
    "engine.chunk": ["engine.sigma"],
    "scf.PToFock": ["fock.build"],
}
SWEEP_TREE = {
    None: ["transport.sweep"],
    "transport.sweep": ["transport.setup", "engine.setup", "engine.chunk",
                        "engine.finish"],
    "transport.setup": ["engine.setup"],
    "engine.chunk": ["engine.sigma"],
}
SPAN_NAMES = ({n for t in (SCF_TREE, SWEEP_TREE) for c in t.values()
               for n in c}
              | {"fermi.probe", "gr_sum_spectral", "gr_sum_chain",
                 "gless_sum_spectral", "density_neq", "density_eq_split",
                 "transmission_spectral"})


def _edges(tree):
    return {(p, c) for p, cs in tree.items() for c in cs}


@pytest.fixture(scope="module")
def junction():
    """A biased SCF on two 3-atom Au(111) Bethe contacts and a 2-site
    chain (56 orbitals; orthogonal, so the warm LU), fixed grids; and the
    energies of a 10-point T(E) sweep in the chain's band."""
    backend, geom, contacts, eps = tune.bethe_junction("Au", n_chain=2)
    negf = NEGFE(backend, device="cpu", verbose=False,
                 exec_cfg=ExecutionConfig(energy_chunk=8))
    negf.setContactBethe(contacts, lat_file="Au", eta=1e-5, T=0.0,
                         geometry=geom, fermi=0.0)
    negf.setIntegralLimits(N1=8, N2=4)
    negf.setVoltage(0.1, fermi=0.0)
    return negf, np.linspace(eps - 1.0, eps + 1.0, 10)


def _cycle(negf):
    negf.SCF(conv=1e-12, damping=0.05, max_cycles=0, checkpoint=False)


def _sweep(negf, E):
    return tr.calculate_transmission(
        negf.F_eV, negf.S, tr.SigmaSource(negf.g), E, device="cpu",
        exec_cfg=ExecutionConfig(energy_chunk=8))


def test_off_reads_no_clock(monkeypatch, caplog):
    def no_clock():
        raise AssertionError("a clock was read")
    for name in ("perf_counter", "perf_counter_ns"):
        monkeypatch.setattr(time, name, no_clock)
    caplog.set_level(logging.INFO, logger="gaunegf_tpu_torch")
    assert not tlog.recorder.enabled
    with perf_span("scf.cycle"):
        with perf_span("gr_sum", nE=4):
            perf_count("wait.h2d", nbytes=8)
    assert perf_span("a") is perf_span("b", nE=1)      # one shared no-op
    assert not tlog.recorder.units()
    assert tlog.recorder.count("wait.h2d") == 0


def test_nesting_self_time_units_and_counters(monkeypatch, recording):
    ticks = iter([0, 10, 20, 50, 70, 80, 85, 100,       # the first cycle
                  200, 210, 230, 300])                   # the second
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))
    perf_count("wait.d2h")                               # in no unit
    with perf_span("scf.cycle"):                         # 0 .. 100
        perf_count("wait.h2d", nbytes=8)
        with perf_span("a"):                             # 10 .. 70
            with perf_span("b"):                         # 20 .. 50
                perf_count("wait.d2h", 2, 16)
        with perf_span("a"):                             # 80 .. 85
            pass
    with perf_span("scf.cycle"):                         # 200 .. 300
        with perf_span("transport.sweep"):               # 210 .. 230
            perf_count("launch.fixed_point")
    one, inner, two = recording.units()
    assert (one.root, inner.root, two.root) \
        == ("scf.cycle", "transport.sweep", "scf.cycle")
    assert one.id < two.id < inner.id                    # ids by opening
    assert one.seconds == pytest.approx(100e-9)
    assert one.span_seconds("a") == pytest.approx(65e-9)
    assert one.self_seconds("a") == pytest.approx(35e-9)
    assert one.calls("a") == 2
    assert one.self_seconds("b") == pytest.approx(30e-9)
    assert one.self_seconds("scf.cycle") == pytest.approx(35e-9)
    assert one.edges == {(None, "scf.cycle"), ("scf.cycle", "a"),
                         ("a", "b")}
    assert (one.count("wait.h2d"), one.nbytes("wait.h2d")) == (1, 8)
    assert (one.count("wait.d2h"), one.nbytes("wait.d2h")) == (2, 16)
    # a unit root inside a unit opens its own unit; its time is a child's
    assert inner.edges == {(None, "transport.sweep")}
    assert inner.count("launch.fixed_point") == 1
    assert two.count("launch.fixed_point") == 0
    assert two.self_seconds("scf.cycle") == pytest.approx(80e-9)
    assert recording.count("wait.d2h") == 3              # units or not
    assert recording.totals().calls("scf.cycle") == 2
    recording.reset()
    assert not recording.units() and recording.count("wait.d2h") == 0


@pytest.mark.parametrize("outer", [False, True])
def test_recording_restores_state_and_contents(outer):
    """recording() is on and empty inside; after it the recorder is on
    or off as before and holds what it held."""
    rec = tlog.recorder
    assert not rec.enabled
    if outer:
        rec.enable()
    try:
        perf_count("wait.h2d")
        with rec.recording():
            assert rec.enabled and rec.count("wait.h2d") == 0
            with perf_span("scf.cycle"):
                perf_count("wait.h2d", 2)
            assert rec.count("wait.h2d") == 2 and len(rec.units()) == 1
        assert rec.enabled is outer
        assert rec.count("wait.h2d") == int(outer)
        assert not rec.units()
    finally:
        rec.disable()
        rec.reset()


def test_threads_keep_their_own_stacks(recording):
    def other():
        perf_count("wait.h2d")
        with perf_span("engine.chunk"):
            pass
    with perf_span("scf.cycle"):
        t = threading.Thread(target=other)
        t.start()
        t.join()
    (u,) = recording.units()
    assert u.count("wait.h2d") == 0 and u.calls("engine.chunk") == 0
    assert recording.count("wait.h2d") == 1
    assert recording.totals().calls("engine.chunk") == 1


def test_threads_lose_no_count(recording):
    """More threads than cores, each opening units and counting, with a
    short switch interval: the totals hold every count and call."""
    n_threads, n = 3 * (os.cpu_count() or 1), 200

    def work():
        for _ in range(n):
            with perf_span("scf.cycle"):
                perf_count("wait.h2d", nbytes=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n
    assert recording.count("wait.h2d") == total
    assert recording.totals().nbytes("wait.h2d") == 2 * total
    assert recording.totals().calls("scf.cycle") == total
    units = recording.units()
    assert len(units) == min(total, tlog.KEEP_UNITS)
    assert len({u.id for u in units}) == len(units)
    assert all(u.count("wait.h2d") == 1 for u in units)


def test_write_logs_one_line_per_unit(recording, caplog):
    recording.enable(write=True)
    caplog.set_level(logging.INFO, logger="gaunegf_tpu_torch")
    with perf_span("transport.sweep"):
        with perf_span("engine.chunk"):
            perf_count("wait.d2h", nbytes=8)
    (rec,) = [r for r in caplog.records if r.getMessage().startswith("unit")]
    msg = rec.getMessage()
    assert rec.name == "gaunegf_tpu_torch.perf" and " transport.sweep " in msg
    assert "engine.chunk" in msg and "wait.d2h 1 (8 B)" in msg


def test_log_performance_turns_the_recorder_on(tmp_path):
    """LOG_PERFORMANCE set before the first logger: the recorder records
    and the perf log holds a line per unit."""
    code = ("import gaunegf_tpu_torch.config as c; c.LOG_PERFORMANCE = True\n"
            "from gaunegf_tpu_torch.utils.logging import perf_span, "
            "recorder\n"
            "with perf_span('scf.cycle'):\n"
            "    pass\n"
            "assert recorder.enabled and len(recorder.units()) == 1\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin"})
    assert proc.returncode == 0, proc.stderr
    (log,) = tmp_path.glob("gaunegf_perf_*.log")
    assert "unit 1 scf.cycle" in log.read_text()


def test_scf_cycle_gives_the_documented_tree(junction, recording):
    negf, _ = junction
    _cycle(negf)
    (u,) = recording.units()
    assert u.root == "scf.cycle" and u.edges == _edges(SCF_TREE)
    assert u.count("wait.h2d") > 0 and u.count("wait.d2h") > 0
    assert u.nbytes("wait.h2d") > 0
    assert u.calls("engine.pole_guard") == 2      # gr_sum's and G<'s grids
    assert u.count("guard.eigvals") == 1          # the first grid's
    assert u.count("guard.reuse") == 1            # the second grid's
    assert u.self_seconds("scf.cycle") <= u.seconds


def test_sweep_gives_the_documented_tree(junction, recording):
    negf, E = junction
    T = _sweep(negf, E)
    (u,) = recording.units()
    assert u.root == "transport.sweep" and u.edges == _edges(SWEEP_TREE)
    assert u.count("wait.h2d") > 0 and u.count("wait.d2h") > 0
    assert u.calls("engine.chunk") == 2 and np.isfinite(T).all()


def test_other_profilers_see_no_program_span(junction, recording):
    negf, _ = junction
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _cycle(negf)
    names = {e.name for e in prof.events()}
    assert not names & SPAN_NAMES
    assert len(recording.units()) == 1            # the spans were on


def test_profile_trace_holds_the_program_spans(junction, tmp_path):
    negf, _ = junction
    assert not tlog.recorder.enabled
    with tlog.profile_trace(str(tmp_path)):
        _cycle(negf)
    (path,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert {"scf.cycle", "engine.chunk", "engine.pole_guard"} <= names
    with perf_span("scf.cycle"):                  # ranges end with it
        pass
    assert not tlog.recorder.units()
