"""scf_fock_ms: milliseconds a cycle in PToFock, the program's span
scf.PToFock (the backend's Fock rebuild, span fock.build, and the
contacts' Fock refresh); the median over the traced run's cycles from the
window's start (metrics/_units.py)."""

from negfbench.metrics import _units

SPANS = []
_units.turn_on()


def read(run):
    return _units.median(run, "cycle",
                         lambda u: 1e3 * u.span_seconds("scf.PToFock"))
