"""gauNEGF.surfG1D parity: semi-infinite 1D-chain surface self-energy.

The provider (models/chain1d.py) implements the same three construction
patterns as surfG1D.surfG (surfG1D.py:83-165) and the classic duck-typed
interface (sigma/sigmaTot/setF, surfG1D.py:344-399), evaluated here on
the facade's device.  Default iteration is Sancho-Rubio decimation; pass
method='dyson' for the reference-faithful relaxed Dyson fixed point
(surfG1D.py:223-295).
"""

from gaunegf_tpu_torch.compat._device import get_device
from gaunegf_tpu_torch.config import ETA, SURFACE_GREEN_CONVERGENCE
from gaunegf_tpu_torch.models.chain1d import Chain1DSelfEnergy


class surfG(Chain1DSelfEnergy):
    """surfG1D.surfG with the reference's keyword names."""

    def __init__(self, Fock, Overlap, indsList, taus=None, staus=None,
                 alphas=None, aOverlaps=None, betas=None, bOverlaps=None,
                 eta=ETA, device=None, **kw):
        super().__init__(Fock, Overlap, indsList, taus=taus, staus=staus,
                         alphas=alphas, a_overlaps=aOverlaps, betas=betas,
                         b_overlaps=bOverlaps, eta=eta,
                         device=get_device(device), **kw)

    def g(self, E, i, conv=SURFACE_GREEN_CONVERGENCE, relFactor=None):
        """Surface Green's function of contact i (surfG1D.py:223-295).

        relFactor (the reference Dyson iteration's relaxation) is accepted
        for signature parity; the fixed point itself is solved by the
        provider's configured method (Sancho default / 'dyson').
        """
        return self.surface_g(E, i, conv=conv)

    def setContacts(self, alphas=None, aOverlaps=None, betas=None,
                    bOverlaps=None):
        """Re-set contact parameters (surfG1D.py:167-222)."""
        return self.set_contacts(alphas, aOverlaps, betas, bOverlaps)
