"""density_prep_ms: milliseconds a cycle of FockToP's set-up around the
energy sums, the self time of the program's spans density.grids (the
quadrature grids), engine.setup (the engine, H and S, the provider's
params and the warm state on the device) and engine.pole_guard (the
near-pole guard's digest and eigh); the median over the traced run's
cycles from the window's start (metrics/_units.py)."""

from negfbench.metrics import _units

SPANS = []
_units.turn_on()

NAMES = ("density.grids", "engine.setup", "engine.pole_guard")


def read(run):
    return _units.median(run, "cycle", lambda u: _units.self_ms(u, NAMES))
