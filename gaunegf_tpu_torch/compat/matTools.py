"""gauNEGF.matTools parity: Gaussian matrix bridge + constant-Sigma construction.

Reference surface: formSigma (matTools.py:39-74), getDen (77-118),
getFock (121-168), getEnergies (171-213), storeDen (216-269).
"""

import numpy as np

from gaunegf_tpu_torch.io.gaussian import (
    get_density, get_energies, get_fock, store_density)
from gaunegf_tpu_torch.models.selfenergy import form_sigma
from gaunegf_tpu_torch.units import HAR_TO_EV as har_to_eV  # noqa: F401

# Gaussian matrix headers (matTools.py:26-33, scfE.py:32-41)
AlphaDen = "ALPHA DENSITY MATRIX"
BetaDen = "BETA DENSITY MATRIX"
AlphaSCFDen = "ALPHA SCF DENSITY MATRIX"
BetaSCFDen = "BETA SCF DENSITY MATRIX"
AlphaFock = "ALPHA FOCK MATRIX"
BetaFock = "BETA FOCK MATRIX"
AlphaMOs = "ALPHA MO COEFFICIENTS"
BetaMOs = "BETA MO COEFFICIENTS"
AlphaEnergies = "ALPHA ORBITAL ENERGIES"
BetaEnergies = "BETA ORBITAL ENERGIES"


def formSigma(inds, V, nsto, S=0):
    """matTools.formSigma(inds, V, nsto, S=0): scalar/vector/matrix Sigma
    embedding with the -1j*1e-9*S background broadening."""
    S_ = None if np.isscalar(S) and S == 0 else S
    return form_sigma(inds, V, nsto, S_)


def getDen(bar, spin):
    return get_density(bar, spin)


def getFock(bar, spin):
    return get_fock(bar, spin)


def getEnergies(bar, spin):
    return get_energies(bar, spin)


def storeDen(bar, P, spin):
    return store_density(bar, P, spin)
