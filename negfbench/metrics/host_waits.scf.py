"""host_waits.scf: the blocking copies to the device and reads to the
host a cycle, the program's counters wait.h2d + wait.d2h (each drains
the device's queue); the median over the traced run's cycles from the
window's start (metrics/_units.py)."""

from negfbench.metrics import _units

SPANS = []
_units.turn_on()


def read(run):
    return _units.median(run, "cycle", _units.waits)
