"""sigma_ms.chain: milliseconds a T(E) sweep inside the 1D-chain
contacts' self-energy closures in the traced window."""

from negfbench.metrics import _sigma_chain

SPANS = _sigma_chain.SPANS


def read(run):
    if run.job.unit != "sweep" or not run.units \
            or not _sigma_chain.calls(run):
        return None
    return _sigma_chain.seconds(run) / run.units * 1e3
