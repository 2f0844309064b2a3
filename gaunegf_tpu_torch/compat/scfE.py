"""gauNEGF.scfE parity: the energy-dependent SCF class.

NEGFE (scfE.py:63-479) inherits the reference NEGF constructor; the
method surface (setContactBethe/setContact1D/setSigma/setVoltage/
setIntegralLimits/integralCheck/FockToP/PToFock) carries the reference
names on this package's class already.  Runs on the facade's device.
"""

from gaunegf_tpu_torch.compat._device import get_device
from gaunegf_tpu_torch.compat.scf import _gaussian_backend
from gaunegf_tpu_torch.config import PULAY_MIXING_SIZE
from gaunegf_tpu_torch.scfe import NEGFE as _NEGFE


class NEGFE(_NEGFE):
    """scfE.NEGFE with the reference's constructor signature."""

    def __init__(self, fn, basis="chkbasis", func="hf", spin="r",
                 fullSCF=True, route=None, section=None,
                 nPulay=PULAY_MIXING_SIZE, device=None, **kw):
        device = get_device(device)
        backend = _gaussian_backend(fn, basis, func, spin, route, section,
                                    fullSCF)
        super().__init__(backend, spin=spin, name=fn, n_pulay=nPulay,
                         device=device, **kw)


# Module constants under the reference's names (scfE.py:44-47); the
# reference also star-imports the matTools matrix headers.
from gaunegf_tpu_torch.units import EOVERH as eoverh        # noqa: E402,F401
from gaunegf_tpu_torch.units import HAR_TO_EV as har_to_eV  # noqa: E402,F401
from gaunegf_tpu_torch.units import KB as kB                # noqa: E402,F401
from gaunegf_tpu_torch.units import V_TO_AU as V_to_au      # noqa: E402,F401
from gaunegf_tpu_torch.compat.matTools import (             # noqa: E402,F401
    AlphaDen, AlphaEnergies, AlphaFock, AlphaMOs, AlphaSCFDen, BetaDen,
    BetaEnergies, BetaFock, BetaMOs, BetaSCFDen)
