"""gauNEGF.surfGBethe parity: FCC[111] Bethe-lattice electrode.

surfGB (surfGBethe.py:106-221) takes a gauopen ``bar`` and autodetects
the contact geometry from its atomic coordinates; the provider keeps that
entry point via BetheGeometry.from_backend and runs the batched (12, 9, 9)
Jacobi fixed point on the facade's device (models/bethe.py).
"""

import numpy as np

from gaunegf_tpu_torch.compat._device import get_device
from gaunegf_tpu_torch.config import ENERGY_MIN, ETA, TEMPERATURE
from gaunegf_tpu_torch.models import slater_koster as _sk
from gaunegf_tpu_torch.models.bethe import (
    BetheAtomGF, BetheGeometry, BetheSelfEnergy)
from gaunegf_tpu_torch.units import HAR_TO_EV, KB, BOHR_TO_ANG

# Module constants under the reference's names (surfGBethe.py:40-44)
kB = KB
dim = _sk.DIM                 # 9: 1s + 3p + 5d
har_to_eV = HAR_TO_EV
Eminf = ENERGY_MIN
bohr_to_ang = BOHR_TO_ANG


class _SKMethodsMixin:
    """Reference-named Slater-Koster helpers (surfGBethe.py:223-829),
    delegating to the closed-form host implementations in
    models/slater_koster.py."""

    def genNeighbors(self, plane_normal, first_neighbor):
        """12 FCC nearest-neighbor direction cosines split by layer
        (surfGBethe.py:223-299)."""
        return _sk.fcc111_neighbor_directions(plane_normal, first_neighbor)

    def readBetheParams(self, filename):
        """Parse a .bethe file into Edict/Sdict/Vdict + H0
        (surfGBethe.py:301-355)."""
        p = _sk.parse_bethe_file(filename)
        self.ne = p.ne
        self.Edict = dict(p.onsite)
        self.Sdict = dict(p.overlap)
        self.Vdict = dict(p.hopping)
        self.H0 = p.h0()
        return p

    def constructMat(self, Mdict, dirCosines):
        """9x9 two-center interaction matrix for a bond direction
        (surfGBethe.py:357-477)."""
        return _sk.bond_matrix(Mdict, np.asarray(dirCosines, dtype=float))

    # -- self-test surface (surfGBethe.py:649-829) ----------------------
    def _sk_hopping(self):
        p = getattr(self, "params_sk", None)
        if p is not None:
            return p
        return _sk.parse_bethe_file("Au")

    def testDOrbitalFunctions(self):
        _sk.validate_slater_koster(self._sk_hopping(), atol=1e-8)
        return True

    testDOrbitalSymmetry = testDOrbitalFunctions
    testPDInteraction = testDOrbitalFunctions
    testDDInteraction = testDOrbitalFunctions
    testHoppingPhysics = testDOrbitalFunctions

    def runAllTests(self):
        """All SK angular-identity self-tests (surfGBethe.py:812-829);
        raises AssertionError on failure."""
        self.testDOrbitalFunctions()
        return True


class surfGB(_SKMethodsMixin, BetheSelfEnergy):
    """surfGBethe.surfGB with the reference's signature (F, S, contacts,
    bar, latFile, spin, eta, T), on the facade's device."""

    def __init__(self, F, S, contacts, bar, latFile="Au", spin="r",
                 eta=ETA, T=TEMPERATURE, device=None, **kw):
        geometry = BetheGeometry.from_backend(getattr(bar, "bar", bar))
        super().__init__(F, S, contacts, geometry, lat_file=latFile,
                         spin=spin, eta=eta, T=T, device=get_device(device),
                         **kw)


class surfGBAt(BetheAtomGF):
    """surfGBethe.surfGBAt parity: single-atom Bethe GF fixed point
    (surfGBethe.py:832-1186), its one-energy methods on the facade's
    device."""

    def __init__(self, H, Slist, Vlist, eta, T=TEMPERATURE, device=None,
                 closure="bethe"):
        super().__init__(H, Slist, Vlist, eta=eta, T=T, closure=closure,
                         device=get_device(device))

    def sigmaK(self, E, conv=None, mix=0.5):
        """Per-direction self-energies (surfGBethe.py:958-1031)."""
        kw = {} if conv is None else {"conv": conv}
        return self.sigma_k(E, **kw)

    def updateH(self, fermi=None):
        """Shift the onsite H to put the band at `fermi`
        (surfGBethe.py:914-957)."""
        return self.update_h(fermi)

    def calcFermi(self, ne, fGuess=5, tol=None, device=None):
        """Fermi level from electron count (surfGBethe.py:1159-1186)."""
        kw = {"f_guess": fGuess}
        if tol is not None:
            kw["tol"] = tol
        dev = self.device if device is None else get_device(device)
        return self.calc_fermi(ne, device=dev, **kw)
