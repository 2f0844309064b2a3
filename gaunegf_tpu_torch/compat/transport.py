"""gauNEGF.transport parity.

This package's transport module already exposes the reference's legacy
API under its original names (current/currentSpin/currentE/currentF/
cohTrans/cohTransSpin/DOS/cohTransE/cohTransSpinE/DOSE,
transport.py:723-1107) and the checkpointing calculators
(calculate_transmission/calculate_dos/calculate_current,
transport.py:376-720); here each takes ``device=None`` and runs on the
facade's device.  SigmaCalculator (transport.py:40-146) is the
SigmaSource auto-detector, its one-energy helpers on the facade's device.
"""

from gaunegf_tpu_torch import transport as _tr
from gaunegf_tpu_torch.compat._device import get_device, on_device
from gaunegf_tpu_torch.transport import SigmaSource


class SigmaCalculator(SigmaSource):
    """transport.SigmaCalculator: SigmaSource whose get_sigma_total /
    get_sigma / get_gamma take ``device=None`` for the facade's device."""

    def get_sigma_total(self, E, spin=None, matrix_size=None, device=None):
        return super().get_sigma_total(E, spin, matrix_size,
                                       device=get_device(device))

    def get_sigma(self, E, contact_index, spin=None, matrix_size=None,
                  device=None):
        return super().get_sigma(E, contact_index, spin, matrix_size,
                                 device=get_device(device))

    def get_gamma(self, E, contact_index, spin=None, matrix_size=None,
                  device=None):
        return super().get_gamma(E, contact_index, spin, matrix_size,
                                 device=get_device(device))


calculate_transmission = on_device(_tr.calculate_transmission)
calculate_dos = on_device(_tr.calculate_dos)
calculate_current = on_device(_tr.calculate_current)
transmission_single_energy = on_device(_tr.transmission_single_energy)
dos_single_energy = on_device(_tr.dos_single_energy)
current = on_device(_tr.current)
currentSpin = on_device(_tr.currentSpin)
currentE = on_device(_tr.currentE)
currentF = on_device(_tr.currentF)
cohTrans = on_device(_tr.cohTrans)
cohTransSpin = on_device(_tr.cohTransSpin)
DOS = on_device(_tr.DOS)
cohTransE = on_device(_tr.cohTransE)
cohTransSpinE = on_device(_tr.cohTransSpinE)
DOSE = on_device(_tr.DOSE)
