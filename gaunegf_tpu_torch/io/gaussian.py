"""Gaussian (gauopen) matrix marshalling.

Capability parity with gauNEGF/matTools.py:77-269: density/Fock extraction
with spin blocking, orbital->atom index maps (+/- encodes alpha/beta), orbital
energies, and density write-back ("ALPHA/BETA SCF DENSITY MATRIX", halved
for restricted, complex-typed for generalized).  All functions take a live
QCBinAr object; gauopen itself is only needed by the caller.

Pure NumPy, host-side; a copy of ``gaunegf_tpu/io/gaussian.py`` (that
package's ``__init__`` imports JAX, so this package keeps its own).
"""

from __future__ import annotations

import numpy as np

from gaunegf_tpu_torch.units import HAR_TO_EV

ALPHA_SCF_DEN = "ALPHA SCF DENSITY MATRIX"
BETA_SCF_DEN = "BETA SCF DENSITY MATRIX"
ALPHA_FOCK = "ALPHA FOCK MATRIX"
BETA_FOCK = "BETA FOCK MATRIX"
ALPHA_ENERGIES = "ALPHA ORBITAL ENERGIES"
BETA_ENERGIES = "BETA ORBITAL ENERGIES"


def _blockdiag(A, B):
    Z = np.zeros_like(A)
    return np.block([[A, Z], [Z, B]])


def get_density(bar, spin: str) -> np.ndarray:
    if spin in ("r", "g"):
        return np.array(bar.matlist[ALPHA_SCF_DEN].expand())
    if spin in ("ro", "u"):
        PA = np.array(bar.matlist[ALPHA_SCF_DEN].expand())
        PB = np.array(bar.matlist[BETA_SCF_DEN].expand())
        return _blockdiag(PA, PB)
    raise ValueError(f"Spin treatment '{spin}' not recognized!")


def get_fock(bar, spin: str):
    """Returns (F, locs); locs sign encodes alpha(+)/beta(-) orbitals."""
    if spin == "r":
        locs = np.asarray(bar.ibfatm)
        F = np.array(bar.matlist[ALPHA_FOCK].expand())
    elif spin in ("ro", "u"):
        locs = np.concatenate((bar.ibfatm, np.asarray(bar.ibfatm) * -1))
        FA = np.array(bar.matlist[ALPHA_FOCK].expand())
        FB = np.array(bar.matlist[BETA_FOCK].expand())
        F = _blockdiag(FA, FB)
    elif spin == "g":
        locs = np.array([v for pair in zip(bar.ibfatm,
                                           np.asarray(bar.ibfatm) * -1)
                         for v in pair])
        F = np.array(bar.matlist[ALPHA_FOCK].expand())
    else:
        raise ValueError(f"Spin treatment '{spin}' not recognized!")
    return F, np.asarray(locs)


def get_energies(bar, spin: str) -> np.ndarray:
    """Per-electron orbital energies in eV, ascending
    (matTools.py:171-213)."""
    if spin == "r":
        A = np.sort(bar.matlist[ALPHA_ENERGIES].expand())
        levels = [x for pair in zip(A, A) for x in pair]
    elif spin in ("ro", "u"):
        A = np.sort(bar.matlist[ALPHA_ENERGIES].expand())
        B = np.sort(bar.matlist[BETA_ENERGIES].expand())
        levels = [x for pair in zip(A, B) for x in pair]
    elif spin == "g":
        levels = np.sort(bar.matlist[ALPHA_ENERGIES].expand())
    else:
        raise ValueError(f"Spin treatment '{spin}' not recognized!")
    return np.sort(levels) * HAR_TO_EV


def store_density(bar, P, spin: str) -> None:
    from gauopen import QCOpMat as qco

    nsto = len(bar.ibfatm)
    if spin == "r":
        P = np.real(np.array(P))
        obj = qco.OpMat(ALPHA_SCF_DEN, P / 2, dimens=(nsto, nsto))
        obj.compress()
        bar.addobj(obj)
    elif spin in ("ro", "u"):
        P = np.real(np.array(P))
        Pa = P[:nsto, :nsto]
        Pb = P[nsto:, nsto:]
        oa = qco.OpMat(ALPHA_SCF_DEN, Pa, dimens=(nsto, nsto))
        ob = qco.OpMat(BETA_SCF_DEN, Pb, dimens=(nsto, nsto))
        oa.compress()
        ob.compress()
        bar.addobj(oa)
        bar.addobj(ob)
    elif spin == "g":
        P = np.complex128(np.array(P))
        obj = qco.OpMat(ALPHA_SCF_DEN, P, dimens=(nsto * 2, nsto * 2),
                        typed="c")
        obj.compress()
        bar.addobj(obj)
    else:
        raise ValueError(f"Spin treatment '{spin}' not recognized!")
