"""host_waits.transport: the blocking copies to the device and reads to
the host a T(E) sweep, the program's counters wait.h2d + wait.d2h (each
drains the device's queue); the median over the traced run's sweeps from
the window's start (metrics/_units.py)."""

from negfbench.metrics import _units

SPANS = []
_units.turn_on()


def read(run):
    return _units.median(run, "sweep", _units.waits)
