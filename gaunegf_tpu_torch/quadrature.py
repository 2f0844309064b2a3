"""Quadrature rules and energy-contour builders.

All node/weight generation happens on the host in float64 (it is O(N) work,
done once per grid); only the weighted Green's-function sums run on device.

Parity notes (values must match the reference bit-for-bit in f64):
* ANT modified Gauss-Chebyshev rule: gauNEGF/density.py:88-119 -- this rule
  is load-bearing for matching ANT.Gaussian behaviour, including the magic
  constant 0.21220659078919378103 and the always-even point count.
* Nested N -> 3N refinement with node reuse: gauNEGF/density.py:211-273.
* Complex semicircle contour + finite-T broadening segment:
  gauNEGF/density.py:660-748.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
from scipy.special import roots_legendre

from gaunegf_tpu_torch.config import (
    ADAPTIVE_INTEGRATION_TOL, MAX_GRID_POINTS, N_KT, TEMPERATURE)
from gaunegf_tpu_torch.units import KB

__all__ = [
    "fermi_dirac", "gauss_legendre", "ant_points", "adaptive_ant_levels",
    "AdaptiveANT", "real_axis_grid", "bias_window_grid",
    "semicircle_contour", "broadening_segment", "contour_grid",
]


def fermi_dirac(E, mu, T):
    """Fermi-Dirac occupation; T in Kelvin, step function at T=0.

    Accepts complex E (contour nodes): T=0 compares real parts, matching the
    lexicographic complex comparison the reference relies on
    (density.py:64-86 with complex Elist at density.py:722).
    """
    E = np.asarray(E)
    kT = KB * T
    if kT == 0:
        if np.iscomplexobj(E):
            # lexicographic (real, then imag) complex comparison, matching
            # the NumPy semantics the reference's step function relies on
            return ((E.real < mu) | ((E.real == mu) & (E.imag <= 0))) * 1
        return (E <= mu) * 1
    return 1.0 / (np.exp((E - mu) / kT) + 1.0)


def gauss_legendre(N: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights on [-1, 1]."""
    x, w = roots_legendre(int(N))
    return np.real(x), np.real(w)


# ANT.Gaussian's IntCompPlane magic constant (see density.py:112); it equals
# 2/(3*pi) and turns the Chebyshev map into the nested-rule node transform.
_ANT_C = 0.21220659078919378103


def ant_points(N: int) -> Tuple[np.ndarray, np.ndarray]:
    """Modified Gauss-Chebyshev rule on [-1, 1] (ANT.Gaussian IntCompPlane).

    Produces an even number of points (pairs +/-x).  Nested: the node set of
    3N contains the node set of N, enabling reuse in adaptive refinement.
    """
    k = np.arange(1, N + 1, 2)
    theta = k * np.pi / (2 * N)
    s, c = np.sin(theta), np.cos(theta)
    x = 1.0 + _ANT_C * s * c * (3.0 + 2.0 * s * s) - k / N
    w = s ** 4 * 16.0 / (3.0 * N)
    return np.concatenate([x, -x]), np.concatenate([w, w])


def adaptive_ant_levels(max_n: int = MAX_GRID_POINTS):
    """Yield the nested ANT refinement levels N = 2, 6, 18, ... <= max_n."""
    N = 2
    while N <= max_n:
        yield N
        N *= 3


class AdaptiveANT:
    """Nested-adaptive ANT integration driver (density.py:211-273 behaviour).

    Each level triples the node count; previously-evaluated nodes are reused
    by rescaling the old partial integral with the exact nested weight ratio
    (~1/3) and evaluating only the new nodes.  ``compute(x, w)`` must return
    the weighted partial integral over the given nodes; it is called with
    host float64 arrays of varying (static per level) length.
    """

    def __init__(self, tol: float = ADAPTIVE_INTEGRATION_TOL,
                 max_n: int = MAX_GRID_POINTS, verbose: bool = True,
                 debug: bool = False):
        self.tol = tol
        self.max_n = max_n
        self.verbose = verbose
        self.debug = debug        # per-level direct-calculation cross-check
        self.n_final = 0
        self.converged = False
        self.error = np.inf

    def integrate(self, compute: Callable[[np.ndarray, np.ndarray], np.ndarray]):
        prev_x = None
        prev_wsum = None
        P = None
        for N in adaptive_ant_levels(self.max_n):
            x, w = ant_points(N)
            if prev_x is None:
                P = compute(x, w)
            else:
                old = np.isin(np.round(x, 14), np.round(prev_x, 14))
                assert int(old.sum()) == prev_x.size, "nested node mismatch"
                ratio = float(np.sum(w[old]) / prev_wsum)
                P_new = P * ratio + compute(x[~old], w[~old])
                self.error = float(np.max(np.abs(P_new - P)))
                if self.debug:
                    # reference debug parity (density.py:256-262): evaluate
                    # the full level directly and compare with the
                    # node-reuse result
                    P_direct = compute(x, w)
                    max_dp = float(np.max(np.abs(P_direct - P)))
                    max_diff = float(np.max(np.abs(P_direct - P_new)))
                    print(f"Direct Calculation: N={len(x)}, "
                          f"maxDP={max_dp:.3e}, maxDiff={max_diff:.3e}")
                P = P_new
                if self.error < self.tol:
                    self.converged = True
                    self.n_final = len(x)
                    if self.verbose:
                        print(f"Adaptive integration converged to "
                              f"{self.error:.3e} in {len(x)} points.")
                    return P
            prev_x, prev_wsum = x, float(np.sum(w))
            self.n_final = len(x)
        if self.verbose:
            print(f"Adaptive integration reached full grid "
                  f"({self.n_final} points), final error {self.error:.3e}")
        return P


# ---------------------------------------------------------------------------
# Energy grids for the density integrals
# ---------------------------------------------------------------------------

def real_axis_grid(Emin: float, mu: float, N: int, T: float = TEMPERATURE,
                   n_kt: int = N_KT):
    """Gauss-Legendre grid on [Emin, mu + n_kt*kB*T], Fermi-weighted.

    Matches densityRealN's grid construction (density.py:385-436): returns
    (energies, weights) with weights = jacobian * w * f(E).
    """
    Emax = mu + n_kt * KB * T
    mid = (Emax - Emin) / 2
    x, w = gauss_legendre(N)
    E = mid * (x + 1) + Emin
    weights = mid * w * fermi_dirac(E, mu, T)
    return E, weights


def bias_window_grid(mu1: float, mu2: float, N: int, T: float = TEMPERATURE,
                     n_kt: int = N_KT):
    """Grid for the non-equilibrium G< window (density.py:487-544).

    Returns (energies, weights) including the Fermi-window factor
    (f(E, muHi) - f(E, muLo)) and bias-sign convention.
    """
    kT = KB * T
    lo, hi = min(mu1, mu2), max(mu1, mu2)
    sgn = np.sign(mu2 - mu1)
    Emin, Emax = lo - n_kt * kT, hi + n_kt * kT
    mid = (Emax - Emin) / 2
    x, w = gauss_legendre(N)
    E = mid * (x + 1) + Emin
    dfermi = fermi_dirac(E, hi, T) - fermi_dirac(E, lo, T)
    return E, mid * w * dfermi * sgn


def semicircle_contour(Emin: float, mu: float, x: np.ndarray, w: np.ndarray,
                       T: float = TEMPERATURE, n_kt: int = N_KT):
    """Map [-1,1] nodes onto the semicircular contour from Emin to
    mu - n_kt*kB*T, with full complex weights (density.py:699-722).

    Returns (z_nodes, weights); the density contribution is
    Im(sum_k weights_k * G(z_k)) / pi.
    """
    broadening = n_kt * KB * T
    Emax = mu - broadening
    center = (Emin + Emax) / 2
    r = (Emax - Emin) / 2
    theta = np.pi / 2 * (np.asarray(x) + 1)
    z = center + r * np.exp(1j * theta)
    dz = 1j * r * np.exp(1j * theta)
    weights = (np.pi / 2) * np.asarray(w) * fermi_dirac(z, mu, T) * dz
    return z, weights


def broadening_segment(mu: float, N: int, T: float, n_kt: int = N_KT,
                       method: str = "legendre"):
    """Real-axis Fermi-broadening segment around mu (density.py:729-742)."""
    broadening = n_kt * KB * T
    if method == "trap":
        x = np.linspace(-1, 1, N)
        w = 2 * np.ones(N) / N
    else:
        x, w = gauss_legendre(N)
    E = broadening * x + mu
    weights = broadening * w * fermi_dirac(E, mu, T)
    return E, weights


def contour_grid(Emin: float, mu: float, N: int, T: float = TEMPERATURE,
                 method: str = "ant", n_kt: int = N_KT):
    """Full equilibrium contour: semicircle (+ broadening segment if T>0).

    method selects the base rule on [-1,1]: 'ant' (default, ANT-compatible),
    'legendre', 'chebyshev' or midpoint -- mirroring densityComplexN's
    options (density.py:706-716).
    Returns (nodes, weights) concatenated; nodes complex.
    """
    if method == "legendre":
        x, w = gauss_legendre(N)
    elif method == "chebyshev":
        k = np.arange(1, N + 1)
        x = np.cos(k * np.pi / (N + 1))
        w = (np.pi / (N + 1)) * (np.sin(k * np.pi / (N + 1)) ** 2) / np.sqrt(1 - x ** 2)
    elif method == "ant":
        x, w = ant_points(N)
    else:
        x = np.linspace(-1, 1, N)
        w = 2 * np.ones(N) / N
    z, zw = semicircle_contour(Emin, mu, x, w, T, n_kt)
    if T > 0:
        nb = max(1, int(N // 8))
        fmethod = "legendre" if method in ("legendre", "chebyshev", "ant") else "trap"
        Eb, wb = broadening_segment(mu, nb, T, n_kt, fmethod)
        # The real-axis segment contributes -Im(G)/pi to the density while the
        # contour piece contributes +Im(G)/pi (orientation), so its weights
        # enter with a minus sign.  NOTE: the reference adds this segment with
        # a + sign (density.py:729-742), which gives *negative* occupation for
        # spectral weight inside the broadening window -- verified wrong
        # against brute-force integration; fixed here (documented deviation).
        z = np.concatenate([z, Eb.astype(complex)])
        zw = np.concatenate([zw, -wb.astype(complex)])
    return z, zw
