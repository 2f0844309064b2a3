"""sweep_prep_ms: milliseconds a T(E) sweep of set-up, the self time of
the program's spans transport.setup (the layout and the batch plan),
engine.setup (the engine, H and S, the provider's params and the warm
state on the device) and engine.pole_guard; the median over the traced
run's sweeps from the window's start (metrics/_units.py)."""

from negfbench.metrics import _units

SPANS = []
_units.turn_on()

NAMES = ("transport.setup", "engine.setup", "engine.pole_guard")


def read(run):
    return _units.median(run, "sweep", lambda u: _units.self_ms(u, NAMES))
