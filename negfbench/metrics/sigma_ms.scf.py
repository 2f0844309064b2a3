"""sigma_ms.scf: milliseconds a cycle inside the contacts' self-energy
closures in the traced window."""

from negfbench.metrics import _sigma

SPANS = _sigma.SPANS


def read(run):
    if run.job.unit != "cycle" or not run.units or not _sigma.calls(run):
        return None
    return _sigma.seconds(run) / run.units * 1e3
