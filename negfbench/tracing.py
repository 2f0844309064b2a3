"""Spans and the device trace of a ``--trace 1`` run.

Spans wrap named calls into the program (``"module:Class.attr"`` or
``"module:attr"``) from the benchmark's side, installed only in a traced
run.  In the traced window each call is timed between two device
synchronisations; in the profiled stretch after it a call is only marked
as a profiler range (no synchronisation), so that the device's idle gaps
can be named by the call the host was inside.  A span with a ``record``
function keeps (phase, what it returns) of each counted call, phase
'window' or 'stretch', for a reader.
Spans of one ``group`` nest: only the outermost call of a group counts.

The device trace is read in memory from ``torch.profiler``: no file is
written.
"""

from __future__ import annotations

import importlib
import time
from collections import defaultdict
from contextlib import nullcontext

import torch


def _resolve(target):
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    *outer, attr = path.split(".")
    for name in outer:
        owner = getattr(owner, name)
    return owner, attr


class Spans:
    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.records = defaultdict(list)
        self.timing = False         # the traced window
        self.marking = False        # the profiled stretch
        self._depth = defaultdict(int)
        self._installed = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def install(self, name, target, group=None, record=None,
                returns_callable=False):
        """Wrap target (once per name).  record(args, kwargs, out) -> a
        value kept for each counted call.  returns_callable: the target
        returns (fn, ...) and the span is on the calls of fn."""
        if name in self._installed:
            return
        owner, attr = _resolve(target)
        orig = getattr(owner, attr)
        group = group or name
        spans = self

        def timed(fn):
            def call(*a, **k):
                if not (spans.timing or spans.marking) \
                        or spans._depth[group]:
                    return fn(*a, **k)
                spans._depth[group] += 1
                mark = torch.profiler.record_function(name) \
                    if spans.marking else nullcontext()
                try:
                    with mark:
                        if spans.timing:
                            spans._sync()
                        t0 = time.perf_counter()
                        out = fn(*a, **k)
                        if spans.timing:
                            spans._sync()
                        dt = time.perf_counter() - t0
                finally:
                    spans._depth[group] -= 1
                if spans.timing:
                    spans.seconds[name] += dt
                    spans.calls[name] += 1
                if record is not None:
                    spans.records[name].append(
                        ("stretch" if spans.marking else "window",
                         record(a, k, out)))
                return out
            return call

        if returns_callable:
            def wrapped(*a, **k):
                out = orig(*a, **k)
                return (timed(out[0]),) + tuple(out[1:])
        else:
            wrapped = timed(orig)
        setattr(owner, attr, wrapped)
        self._installed[name] = (owner, attr, orig)

    def remove(self):
        for owner, attr, orig in self._installed.values():
            setattr(owner, attr, orig)
        self._installed.clear()


class Profile:
    """The device events of a profiled stretch: busy seconds (the union of
    kernel, copy and set intervals), the stretch's length, seconds per
    device operation, and idle gaps named by the innermost span the host
    was inside."""

    def __init__(self, prof, stretch_name, span_names):
        from torch.autograd import DeviceType
        dev, host, stretch = [], [], None
        for e in prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                # the spans' ranges are mirrored on the device's timeline:
                # they are not device operations
                if e.name != stretch_name and e.name not in span_names:
                    dev.append((a, b, e.name))
            elif e.name == stretch_name:
                stretch = (a, b)
            elif e.name in span_names:
                host.append((a, b, e.name))
        if stretch is None:
            raise RuntimeError("the profiled stretch left no range")
        lo, hi = stretch
        self.window_s = (hi - lo) / 1e6
        dev = sorted((max(a, lo), min(b, hi), n) for a, b, n in dev
                     if b > lo and a < hi)
        self.ops = defaultdict(float)
        for a, b, n in dev:
            self.ops[n] += (b - a) / 1e6
        busy, gaps, cur = 0.0, [], lo
        for a, b, _ in dev:
            if a > cur:
                gaps.append((cur, a))
            if b > cur:
                busy += b - max(a, cur)
                cur = b
        if hi > cur:
            gaps.append((cur, hi))
        self.busy_s = busy / 1e6
        self.idle = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            inside = [(e - s, n) for s, e, n in host if s <= mid <= e]
            label = min(inside)[1] if inside else "host outside spans"
            self.idle[label] += (b - a) / 1e6

    def kernel_seconds(self, fragment):
        return sum(s for n, s in self.ops.items() if fragment in n)

    def breakdown(self, top=10):
        rank = lambda d: [[n, s] for n, s in
                          sorted(d.items(), key=lambda x: -x[1])[:top]]
        return {"device_ops": rank(self.ops), "idle_gaps": rank(self.idle)}


def profile(fn, spans, stretch_name="negfbench.stretch"):
    """Run fn() under torch.profiler with the spans marking; returns
    (fn's result, Profile)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU]
    if spans.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    spans.marking = True
    try:
        with tprofile(activities=acts) as prof:
            with torch.profiler.record_function(stretch_name):
                out = fn()
                spans._sync()
    finally:
        spans.marking = False
    return out, Profile(prof, stretch_name, set(spans._installed))
