"""The density integrals' energy grids at T = 0, worked out again.

A frozen copy of the grids that the NEGF density of a biased junction is
defined on (the real-axis lower segment, the ANT semicircular contour and
the bias window), for zero temperature only.  Source of the rules:
gauNEGF density.py (densityRealN, densityComplexN, densityGridN).
"""

from __future__ import annotations

import numpy as np
from scipy.special import roots_legendre

# ANT.Gaussian's IntCompPlane constant (2 / (3 pi))
ANT_C = 0.21220659078919378103


def gauss_legendre(n):
    x, w = roots_legendre(int(n))
    return np.real(x), np.real(w)


def ant_points(n):
    """Modified Gauss-Chebyshev rule on [-1, 1] (pairs +-x)."""
    k = np.arange(1, n + 1, 2)
    theta = k * np.pi / (2 * n)
    s, c = np.sin(theta), np.cos(theta)
    x = 1.0 + ANT_C * s * c * (3.0 + 2.0 * s * s) - k / n
    w = s ** 4 * 16.0 / (3.0 * n)
    return np.concatenate([x, -x]), np.concatenate([w, w])


def step(E, mu):
    """Occupation at T = 0; a complex node compares its real part first."""
    E = np.asarray(E)
    if np.iscomplexobj(E):
        return ((E.real < mu) | ((E.real == mu) & (E.imag <= 0))) * 1.0
    return (E <= mu) * 1.0


def real_axis(lo, hi, n):
    """Gauss-Legendre on [lo, hi], occupied below hi."""
    mid = (hi - lo) / 2
    x, w = gauss_legendre(n)
    E = mid * (x + 1) + lo
    return E, mid * w * step(E, hi)


def contour(lo, mu, n):
    """The ANT semicircle from lo to mu: nodes and complex weights."""
    x, w = ant_points(n)
    center, r = (lo + mu) / 2, (mu - lo) / 2
    theta = np.pi / 2 * (x + 1)
    z = center + r * np.exp(1j * theta)
    dz = 1j * r * np.exp(1j * theta)
    return z, (np.pi / 2) * w * step(z, mu) * dz


def bias_window(mu1, mu2, n):
    """Gauss-Legendre over the window between the two potentials, with
    the window's sign (mu2 - mu1)."""
    lo, hi = min(mu1, mu2), max(mu1, mu2)
    mid = (hi - lo) / 2
    x, w = gauss_legendre(n)
    E = mid * (x + 1) + lo
    return E, mid * w * (step(E, hi) - step(E, lo)) * np.sign(mu2 - mu1)


def density_grids(Eminf, Emin, mu1, mu2, N1, N2, Nnegf):
    """[(E, w, kind)] of a fixed-grid density at T = 0: the equilibrium
    part Im(sum w G) over the lower segment and the contour to mu1, and,
    under bias, sum w G Gamma_2 G+ over the window."""
    E_r, w_r = real_axis(Eminf, Emin, N2)
    z_c, w_c = contour(Emin, mu1, N1)
    E_eq = np.concatenate([E_r.astype(complex), z_c])
    w_eq = np.concatenate([-w_r.astype(complex), w_c]) / np.pi
    grids = [(E_eq, w_eq, "eq")]
    if mu1 != mu2:
        E_n, w_n = bias_window(mu1, mu2, Nnegf)
        grids.append((E_n.astype(complex), w_n.astype(complex) / (2 * np.pi),
                      "window"))
    return grids
