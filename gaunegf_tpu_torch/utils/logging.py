"""Structured logging, the performance recorder and profiler hooks.

Port of ``gaunegf_tpu/utils/logging.py``, which replaces the reference's
ad-hoc per-host/per-PID file logger (integrate.py:22-49):

* ``get_logger``   -- loggers under the ``gaunegf_tpu_torch`` namespace,
  configured once from config (LOG_LEVEL / LOG_PERFORMANCE); when
  performance logging is enabled, a per-host per-PID file
  ``gaunegf_perf_<host>_<pid>.log`` is attached (same discoverability as
  the reference's integrate_performance files), and the recorder is on
  and writes one line per unit to it (below).
* ``perf_span``    -- context manager around a named region; a span
  given fields (the engine's dispatches: their point counts) logs
  '<label> took <dt>s <fields>' with the logger at DEBUG, beside the
  engine's dispatch log, which names the device and, under a mesh, the
  mesh shape, the rank and its coordinates.  It never synchronizes the
  device: a span around asynchronous work measures the host's side of
  it, and a span that ends in a blocking read (every sum ends in a copy
  to the host) includes the device time before it.
* ``perf_count``   -- adds n (and nbytes) to a named counter.
* ``recorder``     -- the one recorder behind both (below).
* ``profile_trace``-- context manager around ``torch.profiler`` that
  writes a Chrome trace of the enclosed region into ``logdir`` (host
  activity, and the CUDA activity when torch sees a GPU); inside it every
  span is also a ``torch.profiler.record_function`` range, so the trace
  shows the program's spans over the kernels on the profiler's clock.

**Off** (the default: the recorder off, no ``profile_trace`` open, the
logger above DEBUG or no fields) ``perf_span`` reads the module's flag
(and for a span with fields the logger's cached level) and returns a
shared no-op context, and
``perf_count`` reads the flag and returns: neither reads a clock.  No
other profiler sees a range of the program's.

**On** (``recorder.enable()``, ``LOG_PERFORMANCE``, or for a region
``with recorder.recording():``, which restores the recorder's state and
contents on exit) each thread keeps
a stack of its open spans; a span records its host start and end
(``time.perf_counter_ns``), its parent and its unit.  A unit is the work
a caller waits on, opened by one of the spans in ``UNIT_ROOTS``: an SCF
cycle (``scf.cycle``) or a T(E) or DOS sweep (``transport.sweep``);
every span and counter inside it belongs to it, and a counter outside
every span of its thread to no unit.  The recorder keeps, per finished
unit (the last ``KEEP_UNITS``), per span name the seconds, the self
seconds (duration less the time its child spans cover) and the calls,
the (parent, child) pairs of names it saw, and per counter the count and
the bytes; ``recorder.totals()`` sums everything since the last reset,
inside units or not.  With ``LOG_PERFORMANCE`` each finished unit is one
INFO line of the perf log: the unit's id, root and ms, each span's ms
and calls, each counter.

Spans:

  scf.cycle          one iteration of ``NEGF.SCF``'s loop (unit root)
  scf.FockToP, scf.PMix, scf.PToFock  the three stages of the cycle
  fock.build         the backend's Fock rebuild inside PToFock
  density.grids      the quadrature grids of a density route
  engine.setup       EnergyEngine's construction (H and S on the
                     device, the spectral route's state), the provider's
                     params and the warm state copied to the device
  engine.pole_guard  the near-pole guard (the pencil's eigenvalues, once
                     per engine, and the grid's distances to them)
  engine.chunk       one chunk of an engine's sum or per-energy map
  engine.sigma       the provider's self-energy closure inside a chunk
  engine.finish      the copy of a sum or a map to the host
  chain.sigma        a 1D-chain contact's self-energy block: the surface
                     decimation (kernel B on the card) and t g t+
  chain.embed        the chain contacts' blocks scattered into (b, N, N)
  transport.sweep    one T(E) or DOS sweep (unit root)
  transport.setup    the sweep's layout, engine and batch plan
  fermi.probe        one density probe of a Fermi search
  gr_sum, gr_sum_spectral, gr_sum_chain, gless_sum_spectral,
  density_neq, density_eq_split, transmission_spectral
                     the engine's dispatches, under the JAX package's
                     labels

A biased SCF cycle with fixed grids on the warm LU (Bethe or 3D-lattice
contacts) and a T(E) sweep there have these trees (children indented
under their parent, each name once):

  scf.cycle                          transport.sweep
    scf.FockToP                        transport.setup
      density.grids                      engine.setup
      engine.setup                     engine.setup
      engine.pole_guard                engine.chunk
      gr_sum                             engine.sigma
        engine.setup                   engine.finish
        engine.chunk
          engine.sigma
        engine.finish
      engine.chunk        (the G< sum's chunks)
        engine.sigma
      engine.finish
    scf.PMix
    scf.PToFock
      fock.build

Counters:

  wait.h2d, wait.d2h  a blocking copy to the device from host memory, or
                      a blocking read to the host (``.cpu()``,
                      ``.item()``, ``bool(tensor)``), with its bytes:
                      each one drains the device's queue first
  launch.<kernel>     a launch of a hand-written kernel (strip_elim,
                      panel_fused, panel_lu, fixed_point, sancho_rubio)
  chain.newton, chain.lu  Newton-Schulz steps of the continuation chain
                      that passed its gate, and steps that ran the LU
  chain.lanes         the energies (lanes) a 1D-chain contact hands the
                      surface decimation, per call: b per contact
  guard.eigvals, guard.reuse  grids of the near-pole guard that computed
                      the pencil's eigenvalues, and grids served from the
                      engine's earlier ones
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import socket
import tempfile
import threading
import time

__all__ = ["get_logger", "perf_span", "perf_count", "profile_trace",
           "recorder", "Unit", "UNIT_ROOTS", "KEEP_UNITS"]

ROOT = "gaunegf_tpu_torch"
_CONFIGURED = False

UNIT_ROOTS = frozenset({"scf.cycle", "transport.sweep"})
KEEP_UNITS = 4096

# read first by perf_span and perf_count: True while the recorder records
# or a profile_trace is open
_ON = False
_RECORD = False
_WRITE = False
_RANGES = 0
_LOG = None
_OFF = contextlib.nullcontext()
_TLS = threading.local()
_LOCK = threading.Lock()


def _configure_root():
    global _CONFIGURED
    if _CONFIGURED:
        return
    from gaunegf_tpu_torch.config import LOG_LEVEL, LOG_PERFORMANCE

    root = logging.getLogger(ROOT)
    if root.level == logging.NOTSET:       # keep a level set before this
        root.setLevel(getattr(logging, str(LOG_LEVEL).upper(),
                              logging.INFO))
    if LOG_PERFORMANCE and not root.handlers:
        host = socket.gethostname()
        pid = os.getpid()
        path = os.path.join(os.getcwd(), f"gaunegf_perf_{host}_{pid}.log")
        try:
            handler = logging.FileHandler(path, mode="a")
        except OSError:
            path = os.path.join(tempfile.gettempdir(),
                                f"gaunegf_perf_{host}_{pid}.log")
            handler = logging.FileHandler(path, mode="a")
        handler.setFormatter(logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
        root.addHandler(handler)
    _CONFIGURED = True
    if LOG_PERFORMANCE:
        recorder.enable(write=True)


def get_logger(name: str = ROOT) -> logging.Logger:
    _configure_root()
    if name != ROOT and not name.startswith(ROOT + "."):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)


def _perf_logger():
    global _LOG
    if _LOG is None:
        _LOG = get_logger("perf")
    return _LOG


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

class Unit:
    """The aggregates of one unit (or, for ``recorder.totals()``, of
    everything since the last reset): per span name [seconds, self
    seconds, calls], per counter [count, bytes], and the (parent, child)
    pairs of span names (parent None at the unit's top)."""

    __slots__ = ("id", "root", "start_ns", "end_ns", "spans", "counters",
                 "edges")

    def __init__(self, uid, root, start_ns):
        self.id = uid
        self.root = root
        self.start_ns = start_ns
        self.end_ns = None
        self.spans = {}
        self.counters = {}
        self.edges = set()

    @property
    def seconds(self) -> float:
        """The unit's own duration (0 while open)."""
        return 0.0 if self.end_ns is None \
            else (self.end_ns - self.start_ns) / 1e9

    def span_seconds(self, name) -> float:
        return self.spans.get(name, (0.0,))[0]

    def self_seconds(self, name) -> float:
        return self.spans.get(name, (0.0, 0.0))[1]

    def calls(self, name) -> int:
        return self.spans.get(name, (0.0, 0.0, 0))[2]

    def count(self, name) -> int:
        return self.counters.get(name, (0,))[0]

    def nbytes(self, name) -> int:
        return self.counters.get(name, (0, 0))[1]

    def _add_span(self, name, parent, dt_ns, self_ns):
        agg = self.spans.get(name)
        if agg is None:
            agg = self.spans[name] = [0.0, 0.0, 0]
        agg[0] += dt_ns / 1e9
        agg[1] += self_ns / 1e9
        agg[2] += 1
        self.edges.add((parent, name))

    def _add_count(self, name, n, nbytes):
        agg = self.counters.get(name)
        if agg is None:
            agg = self.counters[name] = [0, 0]
        agg[0] += n
        agg[1] += nbytes

    def line(self) -> str:
        """The perf log's line of the unit."""
        spans = ", ".join(
            f"{n} {s * 1e3:.3f} ms" + (f" x{c}" if c > 1 else "")
            for n, (s, _, c) in self.spans.items() if n != self.root)
        counts = ", ".join(f"{n} {c}" + (f" ({b} B)" if b else "")
                           for n, (c, b) in self.counters.items())
        return (f"unit {self.id} {self.root} {self.seconds * 1e3:.3f} ms"
                f" | {spans} | {counts}")


class _Frame:
    __slots__ = ("name", "unit", "opens", "child_ns")

    def __init__(self, name, unit, opens):
        self.name = name
        self.unit = unit
        self.opens = opens
        self.child_ns = 0


def _stack():
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


class _Recorder:
    """The read API of the recorder: ``enable``, ``disable``, ``reset``,
    ``recording`` (on and empty for a region), ``units`` (the finished
    units, oldest first), ``totals`` and ``count``."""

    def __init__(self):
        self._units = collections.deque(maxlen=KEEP_UNITS)
        self._totals = Unit(0, None, 0)
        self._next_id = 1

    @property
    def enabled(self) -> bool:
        return _RECORD

    def enable(self, write: bool = False):
        """Record from now on; ``write`` also logs each finished unit's
        line to the perf log at INFO."""
        global _RECORD, _WRITE
        _RECORD, _WRITE = True, bool(write)
        _set_on()

    def disable(self):
        global _RECORD, _WRITE
        _RECORD = _WRITE = False
        _set_on()

    def reset(self):
        """Forget the finished units and the totals (open spans finish
        into their units as usual)."""
        with _LOCK:
            self._units.clear()
            self._totals = Unit(0, None, 0)

    @contextlib.contextmanager
    def recording(self):
        """The recorder on and empty for the enclosed region, read inside
        it; on exit it is as it was before: on or off, writing or not,
        and holding what it held."""
        global _RECORD, _WRITE
        with _LOCK:
            saved = (_RECORD, _WRITE, self._units, self._totals)
            self._units = collections.deque(maxlen=KEEP_UNITS)
            self._totals = Unit(0, None, 0)
        _RECORD = True
        _set_on()
        try:
            yield self
        finally:
            with _LOCK:
                _RECORD, _WRITE, self._units, self._totals = saved
            _set_on()

    def units(self, root=None) -> list:
        """The finished units, oldest first; only those opened by ``root``
        where it is given."""
        with _LOCK:
            return [u for u in self._units if root is None or u.root == root]

    def totals(self) -> Unit:
        return self._totals

    def count(self, name) -> int:
        """A counter's count since the last reset, in units or not."""
        return self._totals.count(name)

    def _open_unit(self, root, start_ns):
        with _LOCK:
            uid = self._next_id
            self._next_id += 1
        return Unit(uid, root, start_ns)


recorder = _Recorder()


def _set_on():
    global _ON
    _ON = _RECORD or _RANGES > 0


class _Span:
    __slots__ = ("label", "log", "fields", "t0", "frame", "range")

    def __init__(self, label, log, fields):
        self.label = label
        self.log = log
        self.fields = fields
        self.frame = None
        self.range = None

    def __enter__(self):
        if _RANGES:
            import torch
            self.range = torch.profiler.record_function(self.label)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        if _RECORD:
            stack = _stack()
            parent = stack[-1].unit if stack else None
            if self.label in UNIT_ROOTS:
                frame = _Frame(self.label,
                               recorder._open_unit(self.label, self.t0),
                               True)
            else:
                frame = _Frame(self.label, parent, False)
            stack.append(frame)
            self.frame = frame
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        dt = t1 - self.t0
        frame = self.frame
        if frame is not None:
            stack = _stack()
            if stack and stack[-1] is frame:
                stack.pop()
            elif frame in stack:                # an inner span left open
                del stack[stack.index(frame):]
            up = stack[-1] if stack else None
            if up is not None:
                up.child_ns += dt
            unit = frame.unit
            parent = up.name if up is not None and up.unit is unit \
                and not frame.opens else None
            with _LOCK:
                recorder._totals._add_span(self.label, parent, dt,
                                           dt - frame.child_ns)
                if unit is not None:
                    unit._add_span(self.label, parent, dt,
                                   dt - frame.child_ns)
                    if frame.opens:
                        unit.end_ns = t1
                        recorder._units.append(unit)
            if frame.opens and _WRITE:
                _perf_logger().info(unit.line())
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.fields and self.log.isEnabledFor(logging.DEBUG):
            extra = " ".join(f"{k}={v}" for k, v in self.fields.items())
            self.log.debug(f"{self.label} took {dt / 1e9:.3f}s {extra}"
                           .rstrip())
        return False


def perf_span(label: str, logger: logging.Logger | None = None, **fields):
    """A named region (see the module docstring): recorded when the
    recorder is on, a profiler range inside profile_trace, and, given
    fields, logged as '<label> took <dt>s <fields>' at DEBUG."""
    log = logger or _LOG or _perf_logger()
    if not _ON and not (fields and log.isEnabledFor(logging.DEBUG)):
        return _OFF
    return _Span(label, log, fields)


def perf_count(name: str, n: int = 1, nbytes: int = 0):
    """Add n (and nbytes) to counter ``name``, in the unit of the
    innermost open span of this thread (and the totals); nothing when
    the recorder is off."""
    if not _RECORD:
        return
    stack = getattr(_TLS, "stack", None)
    unit = stack[-1].unit if stack else None
    with _LOCK:
        recorder._totals._add_count(name, n, nbytes)
        if unit is not None:
            unit._add_count(name, n, nbytes)


# ---------------------------------------------------------------------------
# Profiler trace
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed region, every span
    a range in it, and write it as a Chrome trace
    (``trace_<host>_<pid>_<n>.json``) into logdir; yields the profiler,
    whose ``key_averages()`` stay readable afterwards."""
    global _RANGES
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    _RANGES += 1
    _set_on()
    try:
        yield prof
    finally:
        _RANGES -= 1
        _set_on()
        prof.__exit__(None, None, None)
        stem = f"trace_{socket.gethostname()}_{os.getpid()}"
        n = sum(1 for f in os.listdir(logdir) if f.startswith(stem))
        prof.export_chrome_trace(os.path.join(logdir, f"{stem}_{n}.json"))
