"""chain_lanes: the energies (lanes) the 1D-chain contacts hand the
surface decimation a T(E) sweep, the program's counter chain.lanes; the
median over the traced run's sweeps from the window's start
(metrics/_units.py).  A program without the counter gives no reading."""

from negfbench.metrics import _units

SPANS = []
_units.turn_on()


def read(run):
    lanes = _units.median(run, "sweep", lambda u: u.count("chain.lanes"))
    return lanes or None
