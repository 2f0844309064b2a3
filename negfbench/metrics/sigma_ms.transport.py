"""sigma_ms.transport: milliseconds a T(E) sweep inside the contacts'
self-energy closures in the traced window."""

from negfbench.metrics import _sigma

SPANS = _sigma.SPANS


def read(run):
    if run.job.unit != "sweep" or not run.units or not _sigma.calls(run):
        return None
    return _sigma.seconds(run) / run.units * 1e3
