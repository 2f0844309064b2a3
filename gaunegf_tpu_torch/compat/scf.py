"""gauNEGF.scf parity: the Gaussian-coupled NEGF class.

The reference NEGF constructor (scf.py:134-208) owns a Gaussian run
keyed by the .gjf basename; this package's NEGF takes any Fock provider
and a device.  This wrapper reconstructs the reference entry point on top
of GaussianFock (models/fock.py), which requires the proprietary gauopen
package, on the facade's device.  The method surface (setVoltage/
setSigma/setContacts/FockToP/PMix/PToFock/SCF/saveMAT/runDFT/writeChk)
already carries the reference names.
"""

from gaunegf_tpu_torch.compat._device import get_device
from gaunegf_tpu_torch.config import PULAY_MIXING_SIZE
from gaunegf_tpu_torch.models.fock import GaussianFock
from gaunegf_tpu_torch.scf import NEGF as _NEGF


def _gaussian_backend(fn, basis, func, spin, route, section, fullSCF):
    """Shared reference-signature -> GaussianFock translation (used by
    compat.scf.NEGF and compat.scfE.NEGFE)."""
    return GaussianFock(fn, basis=basis, func=func, spin=spin, route=route,
                        section=section, full_scf=fullSCF)


class NEGF(_NEGF):
    """scf.NEGF with the reference's constructor signature."""

    def __init__(self, fn, basis="chkbasis", func="hf", spin="r",
                 fullSCF=True, route=None, section=None,
                 nPulay=PULAY_MIXING_SIZE, device=None, **kw):
        device = get_device(device)
        backend = _gaussian_backend(fn, basis, func, spin, route, section,
                                    fullSCF)
        super().__init__(backend, spin=spin, name=fn, n_pulay=nPulay,
                         device=device, **kw)


# Module constants under the reference's names (scf.py:64-65)
from gaunegf_tpu_torch.units import HAR_TO_EV as har_to_eV  # noqa: E402,F401
from gaunegf_tpu_torch.units import V_TO_AU as V_to_au      # noqa: E402,F401
