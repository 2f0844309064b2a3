"""The program's own recorder (gaunegf_tpu_torch.utils.logging), read by
the per-layer metrics whose source is ``program_span``.

Importing such a metric file turns the recorder on; the harness imports
metric files only in a ``--trace 1`` run, so an untraced run keeps it
off.  A reading is the median over the run's units (SCF cycles, or T(E)
sweeps) from the window's start: the window's ~100 cycles or ~170 sweeps
outweigh the 3 profiled after it (the warm unit, before the window, and
the units of any earlier run in the same process are left out).  The
spans read here hold no benchmark wrapper (negfbench/tracing.py), so
none of the benchmark's synchronisations lies inside them.  A program without
the recorder gives no reading."""

import statistics

try:
    from gaunegf_tpu_torch.utils.logging import recorder
except ImportError:                 # a program without the recorder
    recorder = None

ROOTS = {"cycle": "scf.cycle", "sweep": "transport.sweep"}


def turn_on():
    if recorder is not None:
        recorder.enable()


def median(run, unit, value):
    """The median of value(u) over the run's units of kind ``unit``
    ('cycle' or 'sweep') that began at or after the window's start, or
    None."""
    if recorder is None or run.job.unit != unit:
        return None
    ends = getattr(run.job, "unit_ends", None)
    if not ends:
        return None
    t0 = ends[-1] - run.window_s
    vals = [value(u) for u in recorder.units(ROOTS[unit])
            if u.start_ns / 1e9 >= t0]
    return float(statistics.median(vals)) if vals else None


def self_ms(u, names):
    """The unit's self milliseconds in the spans ``names``."""
    return 1e3 * sum(u.self_seconds(n) for n in names)


def waits(u):
    """The unit's blocking copies to the device and reads to the host."""
    return u.count("wait.h2d") + u.count("wait.d2h")
