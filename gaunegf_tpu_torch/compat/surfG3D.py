"""gauNEGF.surfG3D parity: explicit 3D-lattice contact plane.

The reference's surfG3 is an unfinished NumPy twin of surfGBethe
("work in progress -- need to implement k-space integration",
surfG3D.py:21-23).  The provider (models/lattice3d.py) completes it: real
2D Brillouin-zone integration over an nk x nk Monkhorst-Pack surface grid
with optional C3v symmetry reduction.  Gamma-only (the reference's
implemented mode) is the default here for parity.  Both classes run on
the facade's device.
"""

import numpy as np

from gaunegf_tpu_torch.compat._device import get_device
from gaunegf_tpu_torch.compat.surfGBethe import _SKMethodsMixin, surfGBAt
from gaunegf_tpu_torch.config import ENERGY_MIN, ETA, TEMPERATURE
from gaunegf_tpu_torch.models import slater_koster as _sk
from gaunegf_tpu_torch.models.bethe import DIM, BetheAtomGF, BetheGeometry
from gaunegf_tpu_torch.models.lattice3d import Lattice3DSelfEnergy
from gaunegf_tpu_torch.units import HAR_TO_EV, KB

# Module constants under the reference's names (surfG3D.py:11-14)
kB = KB
dim = _sk.DIM
har_to_eV = HAR_TO_EV
Eminf = ENERGY_MIN


class surfG3(_SKMethodsMixin, Lattice3DSelfEnergy):
    """surfG3D.surfG3 with the reference's signature (F, S, contacts, bar,
    latFile, spin, eta, T); pass gamma_point_only=False plus nk for the
    full k-space mode the reference left open."""

    def __init__(self, F, S, contacts, bar, latFile="Au", spin="r",
                 eta=ETA, T=TEMPERATURE, device=None, **kw):
        geometry = BetheGeometry.from_backend(getattr(bar, "bar", bar))
        super().__init__(F, S, contacts, geometry, lat_file=latFile,
                         spin=spin, eta=eta, T=T, device=get_device(device),
                         **kw)


class surfGAt(surfGBAt):
    """surfG3D.surfGAt parity (surfG3D.py:721-1077): the atomic-level
    fixed point with DOS and calcFermi, using the reference's EXPLICIT
    all-neighbour lattice closure -- the bulk Dyson equation sums all 12
    directions with ONE shared inverse per sweep (surfG3D.py:877-903),
    unlike surfGBethe's opposite-direction exclusion -- plus the
    sigmaKprev warm start: the previous bulk solution seeds the fixed
    point whenever |E - Eprev| < 1 eV (surfG3D.py:877-879).  ``sigma``
    runs the bulk and surface stages as one call from that seed, which
    also returns the converged bulk state for the next energy.  The
    k-resolved surface physics the reference left open lives in
    Lattice3DSelfEnergy (models/lattice3d.py)."""

    def __init__(self, H, Slist, Vlist, eta, T=TEMPERATURE, device=None):
        super().__init__(H, Slist, Vlist, eta, T=T, device=device,
                         closure="lattice")
        self.sigmaKprev = None
        self.Eprev = Eminf

    def _warm_sig0(self, E):
        if (self.sigmaKprev is not None and self.Eprev != Eminf
                and abs(self.Eprev - E) < 1):
            return self.sigmaKprev
        return None

    def sigmaK(self, E, conv=None, mix=0.5):
        """Bulk self-energies with the reference's previous-energy reuse
        (surfG3D.py:843-903)."""
        kw = {} if conv is None else {"conv": conv}
        sig = self.sigma_k(E, mix=mix, sig0=self._warm_sig0(E), **kw)
        self.sigmaKprev = np.asarray(sig)
        self.Eprev = E
        return sig

    def sigma(self, E, inds=None, conv=None, mix=0.5):
        """Surface self-energies; the bulk stage rides the sigmaKprev
        warm start exactly like the reference's sigmaK-then-surface
        structure (surfG3D.py:905-977)."""
        sig0 = self._warm_sig0(E)
        if sig0 is None:                       # the fixed point's cold init
            sig0 = -1j * np.eye(DIM)
        kw = {} if conv is None else {"conv": conv}
        sig, self.sigmaKprev = BetheAtomGF.sigma(self, E, mix=mix,
                                                 sig0=sig0, **kw)
        self.Eprev = E
        if inds is None:
            return sig
        return [sig[i] for i in np.atleast_1d(inds)]
