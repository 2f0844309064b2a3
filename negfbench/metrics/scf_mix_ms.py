"""scf_mix_ms: milliseconds a cycle in PMix, the program's span scf.PMix
(the damped or Pulay mixing and its host arrays); the median over the
traced run's cycles from the window's start (metrics/_units.py)."""

from negfbench.metrics import _units

SPANS = []
_units.turn_on()


def read(run):
    return _units.median(run, "cycle",
                         lambda u: 1e3 * u.span_seconds("scf.PMix"))
