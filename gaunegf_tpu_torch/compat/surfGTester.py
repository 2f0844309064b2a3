"""gauNEGF.surfGTester parity: energy-independent Sigma provider
(surfGTester.py:62-152), used for testing and production constant-Sigma
runs at finite T."""

from gaunegf_tpu_torch.compat._device import get_device
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy


class surfGTest(ConstantSelfEnergy):
    """surfGTester.surfGTest (same signature: Fock, Overlap, indsList,
    sig1=None, sig2=None; defaults to -0.05j contact diagonals), with
    ``sigma`` / ``sigmaTot`` evaluated on the facade's device."""

    def __init__(self, Fock, Overlap, indsList, sig1=None, sig2=None,
                 device=None):
        super().__init__(Fock, Overlap, indsList, sig1, sig2,
                         device=get_device(device))
