"""gauNEGF.density parity: every public routine of the reference's
density.py under its original name and keyword spelling, delegating to the
engines of this package (density.py / quadrature.py / fermi.py).  Each
routine that integrates Green's functions runs on the facade's device, or
on the one given as ``device=``.

Reference lines cited per function; behaviour parity is covered by the
golden tests (tests/test_density.py, tests/test_fermi.py) and by the
comparisons with the JAX package (tests/test_torch_compat.py).
"""

from gaunegf_tpu_torch import density as _d
from gaunegf_tpu_torch import fermi as _f
from gaunegf_tpu_torch import quadrature as _q
from gaunegf_tpu_torch.compat._device import get_device
from gaunegf_tpu_torch.config import (
    ADAPTIVE_INTEGRATION_TOL, ENERGY_MIN, FERMI_CALCULATION_TOL,
    FERMI_SEARCH_CYCLES, MAX_CYCLES, MAX_GRID_POINTS, TEMPERATURE)

__all__ = [
    "fermi", "getANTPoints", "integratePoints", "integratePointsAdaptiveANT",
    "density", "bisectFermi", "densityRealN", "densityReal", "densityGridN",
    "densityGridTrap", "densityGrid", "densityComplexN", "densityComplex",
    "calcEmin", "integralFit", "integralFitNEGF", "getFermiContact",
    "getFermi1DContact", "calcFermi", "calcFermiBisect", "calcFermiSecant",
    "calcFermiMuller", "calcFermiPolyFit"]


def fermi(E, mu, T):
    """Fermi-Dirac occupation (density.py:64-86)."""
    return _q.fermi_dirac(E, mu, T)


def getANTPoints(N):
    """ANT modified Gauss-Chebyshev nodes/weights (density.py:88-119)."""
    return _q.ant_points(N)


def integratePoints(computePointFunc, numPoints, parallel=False,
                    numWorkers=None, chunkSize=None, debug=False):
    """Serial / process-pool point integration (density.py:121-210)."""
    return _d.integrate_points(computePointFunc, numPoints,
                               parallel=parallel, num_workers=numWorkers,
                               chunk_size=chunkSize, debug=debug)


def integratePointsAdaptiveANT(computePoint, tol=ADAPTIVE_INTEGRATION_TOL,
                               maxN=MAX_GRID_POINTS, debug=False):
    """Nested-adaptive ANT integration with node reuse
    (density.py:211-273); computePoint(x, w) -> weighted partial sum."""
    return _q.AdaptiveANT(tol=tol, max_n=maxN, verbose=True,
                          debug=debug).integrate(computePoint)


def density(V, Vc, D, Gam, Emin, mu):
    """Analytic zero-T density, PRB 65 165401 Eq. 27
    (density.py:276-329)."""
    return _d.density_analytic(V, Vc, D, Gam, Emin, mu)


def bisectFermi(V, Vc, D, Gam, Nexp, conv=FERMI_CALCULATION_TOL,
                Eminf=ENERGY_MIN):
    """Fermi bisection on the analytic density (density.py:331-382)."""
    return _d.bisect_fermi(V, Vc, D, Gam, Nexp, conv=conv, Eminf=Eminf)


def densityRealN(F, S, g, Emin, mu, N=100, T=TEMPERATURE, showText=True,
                 device=None):
    """Real-axis Gauss-Legendre density (density.py:385-436)."""
    return _d.density_real_n(F, S, g, Emin, mu, N=N, T=T, verbose=showText,
                             device=get_device(device))


def densityReal(F, S, g, Emin, mu, tol=ADAPTIVE_INTEGRATION_TOL,
                T=TEMPERATURE, maxN=MAX_CYCLES, debug=False, device=None):
    """Adaptive real-axis density (density.py:438-484)."""
    return _d.density_real(F, S, g, Emin, mu, tol=tol, T=T, max_n=maxN,
                           verbose=debug, device=get_device(device))


def densityGridN(F, S, g, mu1, mu2, ind=None, N=100, T=TEMPERATURE,
                 showText=True, device=None):
    """Bias-window G< density on an N-point grid (density.py:487-544)."""
    return _d.density_grid_n(F, S, g, mu1, mu2, ind=ind, N=N, T=T,
                             verbose=showText, device=get_device(device))


def densityGridTrap(F, S, g, mu1, mu2, ind=None, N=100, T=TEMPERATURE,
                    device=None):
    """Trapezoid-rule bias-window density (density.py:547-603)."""
    return _d.density_grid_trap(F, S, g, mu1, mu2, ind=ind, N=N, T=T,
                                device=get_device(device))


def densityGrid(F, S, g, mu1, mu2, ind=None, tol=ADAPTIVE_INTEGRATION_TOL,
                T=TEMPERATURE, debug=False, device=None):
    """Adaptive-ANT bias-window density (density.py:605-658)."""
    return _d.density_grid(F, S, g, mu1, mu2, ind=ind, tol=tol, T=T,
                           verbose=debug, device=get_device(device))


def densityComplexN(F, S, g, Emin, mu, N=100, T=TEMPERATURE, showText=True,
                    method="ant", device=None):
    """Semicircle-contour density, N points (density.py:660-748)."""
    return _d.density_complex_n(F, S, g, Emin, mu, N=N, T=T, method=method,
                                verbose=showText, device=get_device(device))


def densityComplex(F, S, g, Emin, mu, tol=ADAPTIVE_INTEGRATION_TOL,
                   T=TEMPERATURE, debug=False, device=None):
    """Adaptive contour density (density.py:750-816)."""
    return _d.density_complex(F, S, g, Emin, mu, tol=tol, T=T, verbose=debug,
                              device=get_device(device))


def calcEmin(F, S, g, tol=FERMI_CALCULATION_TOL, maxN=MAX_CYCLES,
             device=None):
    """DOS-walk lower integration bound (density.py:821-834)."""
    return _d.calc_emin(F, S, g, tol=tol, max_n=maxN,
                        device=get_device(device))


def integralFit(F, S, g, mu, Eminf=ENERGY_MIN, tol=FERMI_CALCULATION_TOL,
                T=TEMPERATURE, maxN=MAX_CYCLES, device=None):
    """N1/N2 grid-size fit (density.py:836-914)."""
    return _d.integral_fit(F, S, g, mu, Eminf=Eminf, tol=tol, T=T, max_n=maxN,
                           device=get_device(device))


def integralFitNEGF(F, S, g, fermi, qV, Eminf=ENERGY_MIN,
                    tol=FERMI_CALCULATION_TOL, T=TEMPERATURE,
                    maxGrid=MAX_GRID_POINTS, device=None):
    """Bias-window grid-size fit (density.py:916-964)."""
    return _d.integral_fit_negf(F, S, g, fermi, qV, Eminf=Eminf, tol=tol,
                                T=T, max_grid=maxGrid,
                                device=get_device(device))


def getFermiContact(g, ne, tol=FERMI_CALCULATION_TOL, Eminf=ENERGY_MIN,
                    maxcycles=MAX_CYCLES, T=TEMPERATURE, nOrbs=0,
                    device=None):
    """Contact Fermi level from electron count (density.py:967-1003)."""
    return _f.get_fermi_contact(g, ne, tol=tol, Eminf=Eminf,
                                max_cycles=maxcycles, T=T, n_orbs=nOrbs,
                                device=get_device(device))


def getFermi1DContact(gSys, ne, ind=0, tol=FERMI_CALCULATION_TOL,
                      Eminf=ENERGY_MIN, T=TEMPERATURE, maxcycles=MAX_CYCLES,
                      device=None):
    """1D-contact Fermi level, 2-cell periodic block trick
    (density.py:1005-1053)."""
    return _f.get_fermi_1d_contact(gSys, ne, ind=ind, tol=tol, Eminf=Eminf,
                                   T=T, max_cycles=maxcycles,
                                   device=get_device(device))


def calcFermi(g, ne, Emin, Emax, fermiGuess=0, N1=100, N2=50,
              Eminf=ENERGY_MIN, T=TEMPERATURE, tol=FERMI_CALCULATION_TOL,
              maxcycles=MAX_CYCLES, nOrbs=0, device=None):
    """Bounded Fermi bisection (density.py:1056-1143)."""
    return _f.calc_fermi(g, ne, Emin, Emax, fermi_guess=fermiGuess, N1=N1,
                         N2=N2, Eminf=Eminf, T=T, tol=tol,
                         max_cycles=maxcycles, n_orbs=nOrbs,
                         device=get_device(device))


def calcFermiBisect(g, ne, Emin, Ef, N, tol=ADAPTIVE_INTEGRATION_TOL,
                    conv=FERMI_CALCULATION_TOL, maxcycles=FERMI_SEARCH_CYCLES,
                    T=TEMPERATURE, uBound=None, lBound=None, device=None):
    """DOS-informed expanding bisection (density.py:1145-1201)."""
    return _f.calc_fermi_bisect(g, ne, Emin, Ef, N, tol=tol, conv=conv,
                                max_cycles=maxcycles, T=T, u_bound=uBound,
                                l_bound=lBound, device=get_device(device))


def calcFermiSecant(g, ne, Emin, Ef, N, tol=ADAPTIVE_INTEGRATION_TOL,
                    conv=FERMI_CALCULATION_TOL, maxcycles=FERMI_SEARCH_CYCLES,
                    T=TEMPERATURE, device=None):
    """Secant Fermi search (density.py:1203-1238)."""
    return _f.calc_fermi_secant(g, ne, Emin, Ef, N, tol=tol, conv=conv,
                                max_cycles=maxcycles, T=T,
                                device=get_device(device))


def calcFermiMuller(g, ne, Emin, Ef, N, tol=ADAPTIVE_INTEGRATION_TOL,
                    conv=FERMI_CALCULATION_TOL, maxcycles=FERMI_SEARCH_CYCLES,
                    T=TEMPERATURE, device=None):
    """Muller quadratic-root Fermi search (density.py:1240-1331)."""
    return _f.calc_fermi_muller(g, ne, Emin, Ef, N, tol=tol, conv=conv,
                                max_cycles=maxcycles, T=T,
                                device=get_device(device))


def calcFermiPolyFit(g, ne, Emin, Ef, N, tol=ADAPTIVE_INTEGRATION_TOL,
                     conv=FERMI_CALCULATION_TOL,
                     maxcycles=FERMI_SEARCH_CYCLES, T=TEMPERATURE, order=3,
                     device=None):
    """Robust-polynomial Fermi search (density.py:1333-1515)."""
    return _f.calc_fermi_poly_fit(g, ne, Emin, Ef, N, tol=tol, conv=conv,
                                  max_cycles=maxcycles, T=T, order=order,
                                  device=get_device(device))


# Module constants under the reference's names (density.py:57-61)
FERMI_DEBUG = False
from gaunegf_tpu_torch.units import HAR_TO_EV as har_to_eV  # noqa: E402,F401
from gaunegf_tpu_torch.units import KB as kB                # noqa: E402,F401
