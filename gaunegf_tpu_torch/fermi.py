"""Fermi-level search strategies.

Port of ``gaunegf_tpu/fermi.py`` (the search family of
gauNEGF/density.py:1056-1515):
full-bracket bisection (calc_fermi), DOS-informed expanding bisection
(calc_fermi_bisect), secant, Muller, and robust PCHIP+Huber polynomial
regression (calc_fermi_poly_fit), plus the contact-level searches
get_fermi_contact / get_fermi_1d_contact.

The searches share two small building blocks instead of mirroring the
reference's per-method bookkeeping:

* ``_DensityProbe`` -- shift the provider's Fermi level, integrate the
  density, and report the electron-count error (every strategy's inner
  step; reference repeats this 5x);
* ``_Bracket`` -- the running (l_bound, u_bound) pair around the root
  that NEGFE's fallback bisection consumes (scfE.py:363-395).

Muller's quadratic step is expressed as an exact 3-point ``np.polyfit``
plus the stabilized-denominator root (identical math to the reference's
manual divided-difference determinants, density.py:1263-1280).  Parity is
pinned by behaviour -- property tests over random monotone n(E) profiles
(tests/test_torch_fermi.py) -- not by line-matching.

All searches are host-driven sequential loops in NumPy/SciPy (each probe
is a full contour integral, inherently sequential -- SURVEY.md section 7.4
item 4); every probe is one density_complex_n call, a new EnergyEngine on
``device`` (keyword-only and required), sharded over ``mesh`` where one
is given; every step of a search is taken on replicated values, so every
rank probes the same energies.  With an unchanged Fock matrix the
spectral route's basis cache and the provider's structure cache keep a
whole search at one eigendecomposition and one structure detection.

Documented deviation: the reference's calc_fermi_bisect DOS step-size
heuristic calls its DOS kernel with F and S swapped (density.py:1176); we
use the correct argument order (affects only the bracketing step sizes,
never the converged Fermi level).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
from scipy.interpolate import PchipInterpolator
from scipy.optimize import least_squares

from gaunegf_tpu_torch.config import (
    ADAPTIVE_INTEGRATION_TOL, ENERGY_MIN, FERMI_CALCULATION_TOL,
    FERMI_SEARCH_CYCLES, MAX_CYCLES, TEMPERATURE, ExecutionConfig)
from gaunegf_tpu_torch.density import (
    density_complex, density_complex_n, density_real, density_real_n,
    dos_at_energy, integral_fit, sigma_total)
from gaunegf_tpu_torch.models.chain1d import Chain1DSelfEnergy
from gaunegf_tpu_torch.utils.logging import perf_span

__all__ = [
    "calc_fermi", "calc_fermi_bisect", "calc_fermi_secant",
    "calc_fermi_muller", "calc_fermi_poly_fit",
    "get_fermi_contact", "get_fermi_1d_contact",
]

_DEFAULT_EXEC = ExecutionConfig()
FERMI_DEBUG = False


def _p_mu(g, Emin, N, tol, T, exec_cfg, device, mesh=None, method="ant"):
    if N is None:
        return lambda E: density_complex(g.F, g.S, g, Emin, E, tol, T,
                                         exec_cfg=exec_cfg, device=device,
                                         mesh=mesh,
                                         verbose=False)
    return lambda E: density_complex_n(g.F, g.S, g, Emin, E, int(N), T=T,
                                       method=method, exec_cfg=exec_cfg,
                                       device=device, mesh=mesh)


def _check_ne(g, ne):
    if not ne < len(g.F):
        raise ValueError(
            "Number of electrons cannot exceed number of basis functions!")


def _ne_of(P, S, n_orbs=0):
    # trace((P @ S)[block]) without the GEMM: O(N^2) or O(N * n_orbs)
    P = np.asarray(P)
    S = np.asarray(S)
    if n_orbs:
        return float(np.einsum("ij,ji->", P[-n_orbs:, :],
                               S[:, -n_orbs:]).real)
    return float(np.einsum("ij,ji->", P, S).real)


class _Bracket:
    """Running bounds around the root of n(E) - ne.

    ``hi`` is the tightest energy seen with too many electrons, ``lo``
    the tightest with too few; either may stay None if that side was
    never probed.  This is the (u_bound, l_bound) state every search
    hands back to NEGFE for its bisection fallback."""

    def __init__(self, lo=None, hi=None):
        self.lo = lo
        self.hi = hi

    def update(self, E, n_err):
        if n_err > 0:
            self.hi = E if self.hi is None else min(self.hi, E)
        elif n_err < 0:
            self.lo = E if self.lo is None else max(self.lo, E)

    @property
    def closed(self):
        return self.lo is not None and self.hi is not None


class _DensityProbe:
    """probe(E) -> (n_err, P): move the provider's Fermi level to E,
    integrate the density and report the electron-count error.

    Each call is one full contour integration -- the unit of cost every
    search strategy below is counting -- and one span fermi.probe
    (utils/logging)."""

    def __init__(self, g, p_mu, ne, n_orbs=0, bracket=None, memo=False):
        self.g = g
        self.p_mu = p_mu
        self.ne = ne
        self.n_orbs = n_orbs
        self.bracket = bracket
        self.calls = 0
        self._memo = {} if memo else None

    def __call__(self, E):
        if self._memo is not None and E in self._memo:
            return self._memo[E]
        with perf_span("fermi.probe"):
            self.g.setF(self.g.F, E, E)
            P = self.p_mu(E)
            n_err = _ne_of(P, self.g.S, self.n_orbs) - self.ne
        if self.bracket is not None:
            self.bracket.update(E, n_err)
        self.calls += 1
        if FERMI_DEBUG:
            print(f"DEBUG: Ef={E:.4f}, dN={n_err:.2E}")
        if self._memo is not None:
            self._memo[E] = (n_err, P)
        return n_err, P


def calc_fermi(g, ne, Emin, Emax, fermi_guess=0.0, N1=100, N2=50,
               Eminf=ENERGY_MIN, T=TEMPERATURE, tol=FERMI_CALCULATION_TOL,
               max_cycles=MAX_CYCLES, n_orbs=0, exec_cfg=_DEFAULT_EXEC, *,
               device, mesh=None, verbose=True):
    """Bracketed bisection over [Emin, Emax] with full-contour probes
    (calcFermi, density.py:1056-1143)."""
    if verbose:
        dos_inf = dos_at_energy(Eminf, g.F, g.S,
                                sigma_total(g, Eminf, device))
        print(f"Eminf DOS = {dos_inf}")

    def p_low():
        if N2 is None:
            return density_real(g.F, g.S, g, Eminf, Emin, tol, T=0,
                                exec_cfg=exec_cfg, device=device, mesh=mesh,
                                verbose=False)
        return density_real_n(g.F, g.S, g, Eminf, Emin, int(N2), T=T,
                              exec_cfg=exec_cfg, device=device, mesh=mesh)

    ne_low = _ne_of(p_low(), g.S, n_orbs)
    if verbose:
        print(f"Electrons below lowest onsite energy: {ne_low}")
    if ne_low >= ne:
        raise RuntimeError(
            "Calculated Fermi energy is below lowest orbital energy!")
    # the reference's bracketed search probes with the Legendre contour
    # (density.py:1110-1112), unlike the ANT-rule defaults elsewhere
    p_mu = _p_mu(g, Emin, N1, tol, T, exec_cfg, device, mesh,
                 method="legendre")
    bracket = _Bracket(lo=Emin, hi=Emax)
    probe = _DensityProbe(
        g, lambda E: np.real(p_low() + p_mu(E)), ne, n_orbs, bracket)

    fermi = fermi_guess
    n_err = -np.inf
    counter = 0
    if verbose:
        print("Calculating Fermi energy using bisection:")
    while (abs(n_err) > tol and bracket.hi - bracket.lo > tol / 10
           and counter < max_cycles):
        n_err, _ = probe(fermi)
        if abs(n_err) > tol:
            fermi = (bracket.hi + bracket.lo) / 2
        if verbose:
            print("DN:", -n_err, "Fermi:", fermi,
                  "Bounds:", bracket.lo, bracket.hi)
        counter += 1
    if abs(n_err) > tol and counter >= max_cycles:
        # n_err stays -inf when max_cycles=0 left the loop before any probe
        n_str = f"{ne + n_err:.2f}" if np.isfinite(n_err) else "unprobed"
        print(f"Warning: Fermi energy still not within tolerance! "
              f"Ef = {fermi:.2f} eV, N = {n_str})")
    if verbose:
        print(f"Finished after {counter} iterations, Ef = {fermi:.2f}")
    return fermi, Emin, N1, N2


def calc_fermi_bisect(g, ne, Emin, Ef, N, tol=ADAPTIVE_INTEGRATION_TOL,
                      conv=FERMI_CALCULATION_TOL,
                      max_cycles=FERMI_SEARCH_CYCLES, T=TEMPERATURE,
                      u_bound=None, l_bound=None, exec_cfg=_DEFAULT_EXEC, *,
                      device, mesh=None):
    """Expanding-bracket bisection with DOS-informed step sizes
    (calcFermiBisect, density.py:1145-1201).

    Phase 1 walks outward from Ef (step grown by 2*|dN|/DOS, the local
    first-order estimate of the distance to the root) until both bounds
    exist; phase 2 bisects the bracket."""
    _check_ne(g, ne)
    p_mu = _p_mu(g, Emin, N, tol, T, exec_cfg, device, mesh)
    bracket = _Bracket(lo=l_bound, hi=u_bound)
    # memoized: the bracket-alignment re-probe of Ef reuses the stored
    # integral instead of paying a second contour integration
    probe = _DensityProbe(g, p_mu, ne, bracket=bracket, memo=True)

    E = float(Ef)
    dE = tol
    counter = 0
    n_err, P = probe(E)
    while not bracket.closed and counter < max_cycles:
        Ef = E                                  # last probed bound
        E += -dE if n_err > 0 else dE
        dos = dos_at_energy(E, g.F, g.S, sigma_total(g, E, device))
        dE = max(2 * abs(n_err) / max(dos, 1e-12), dE)
        counter += 1
        n_err, P = probe(E)
    if E != Ef:
        # Align the electron count with Ef before bisecting.  The reference
        # enters its bisection with n_err taken at the last bracketing
        # probe E but attributes it to Ef (density.py:1182-1196), which can
        # collapse the bracket to u_bound == l_bound; documented robustness
        # fix.
        n_err, P = probe(Ef)
    while abs(n_err) > conv and counter < max_cycles \
            and bracket.hi != bracket.lo:
        Ef = (bracket.hi + bracket.lo) / 2
        dE = bracket.hi - bracket.lo
        counter += 1
        n_err, P = probe(Ef)
    if counter == max_cycles:
        print(f"Warning: Max cycles reached, convergence = {abs(n_err):.2E}")
    elif bracket.hi == bracket.lo:
        print(f"Warning: Bisection failed, convergence = {abs(n_err):.2E}")
    return Ef, dE, P


def calc_fermi_secant(g, ne, Emin, Ef, N, tol=ADAPTIVE_INTEGRATION_TOL,
                      conv=FERMI_CALCULATION_TOL,
                      max_cycles=FERMI_SEARCH_CYCLES, T=TEMPERATURE,
                      exec_cfg=_DEFAULT_EXEC, *, device, mesh=None):
    """Secant iteration (calcFermiSecant, density.py:1203-1238)."""
    _check_ne(g, ne)
    probe = _DensityProbe(g, _p_mu(g, Emin, N, tol, T, exec_cfg, device,
                                   mesh), ne)
    n_err, P = probe(Ef)
    dE = conv
    counter = 0
    while abs(n_err) > conv and counter < max_cycles:
        Ef += dE
        n_next, P = probe(Ef)
        counter += 1
        if abs(n_next - n_err) < 1e-10:
            # flat region: retry from this point with a 10x smaller step,
            # keeping the stale far-side count (density.py:1221-1226)
            print("Warning: change in ne low, reducing step size")
            dE *= 0.1
            continue
        dE = -dE * n_next / (n_next - n_err)   # secant step from the new pt
        n_err = n_next
    Ef += dE
    if counter == max_cycles:
        print(f"Warning: Max cycles reached, convergence = {abs(n_err):.2E}")
    return Ef, dE, P, abs(n_err)


def _muller_step(pts):
    """Next root estimate from the quadratic through three (E, n) points.

    Exact 3-point polyfit in coordinates centred on the newest point,
    then the stabilized-denominator root -2c/(b + sign(b)*sqrt(disc))
    closest to it; a negative discriminant falls back to the Newton-like
    -2c/b step (same convention as density.py:1274-1280)."""
    (EA, nA), (EB, nB), (EC, nC) = pts            # EC is the newest point
    a, b, c = np.polyfit([EA - EC, EB - EC, 0.0], [nA, nB, nC], 2)
    disc = np.sqrt(b * b - 4 * a * c) if b * b > 4 * a * c else 0.0
    if b < 0:
        disc = -disc
    return EC - 2 * c / (b + disc)


def calc_fermi_muller(g, ne, Emin, Ef, N, tol=ADAPTIVE_INTEGRATION_TOL,
                      conv=FERMI_CALCULATION_TOL,
                      max_cycles=FERMI_SEARCH_CYCLES, T=TEMPERATURE,
                      exec_cfg=_DEFAULT_EXEC, *, device, mesh=None):
    """Muller's quadratic root iteration (calcFermiMuller,
    density.py:1240-1331).  Returns (Ef, dE, P, err, u_bound, l_bound).

    After each step only the two history points closest to the new
    estimate are retained (the reference's pairwise swap cascade reduces
    to exactly this selection)."""
    _check_ne(g, ne)
    bracket = _Bracket()
    probe = _DensityProbe(g, _p_mu(g, Emin, N, tol, T, exec_cfg, device,
                                   mesh), ne,
                          bracket=bracket)

    pts = []
    for E in (float(Ef), float(Ef) - conv, float(Ef) + conv):
        n_err, P = probe(E)
        if abs(n_err) < conv:
            return E, 0.0, P, abs(n_err), bracket.hi, bracket.lo
        pts.append((E, n_err))
    # seed order matches the reference's (E0, E1, E2=Ef) labelling
    pts = [pts[2], pts[1], pts[0]]

    counter = 3
    dE = conv
    n_err = pts[-1][1]
    while counter < max_cycles:
        E_next = _muller_step(pts)
        dE = E_next - pts[-1][0]
        # keep the two closest points (farther of the pair first)
        pts = sorted(pts, key=lambda p: abs(p[0] - E_next))[:2][::-1]
        n_err, P = probe(E_next)
        pts.append((E_next, n_err))
        if abs(n_err) < conv:
            break
        counter += 1
    Ef = pts[-1][0]
    if counter == max_cycles:
        print(f"Warning: Max cycles reached, convergence = {abs(n_err):.2E}")
    return Ef, dE, P, abs(n_err), bracket.hi, bracket.lo


def _robust_poly_root(E_pts, n_pts, order):
    """Huber-regularized polynomial root nearest the latest probe.

    PCHIP through the sorted history smooths non-monotone noise; a
    Huber-loss least-squares polynomial fit of the raw points against the
    smoothed values rejects outlier probes; the nearest real part of the
    fit's roots is the candidate (calcFermiPolyFit, density.py:1380-1424).
    """
    poly_order = min(len(n_pts) - 1, order)
    Es, ns = zip(*sorted(zip(E_pts, n_pts)))
    n_smooth = PchipInterpolator(Es, ns)(E_pts)
    p0 = np.polyfit(E_pts, n_pts, poly_order)
    result = least_squares(
        lambda coeffs: np.polyval(coeffs, E_pts) - n_smooth,
        p0, loss="huber", f_scale=ADAPTIVE_INTEGRATION_TOL)
    roots = np.roots(result.x)
    return roots[np.argmin(np.abs(roots - E_pts[-1]))].real


def calc_fermi_poly_fit(g, ne, Emin, Ef, N, tol=ADAPTIVE_INTEGRATION_TOL,
                        conv=FERMI_CALCULATION_TOL,
                        max_cycles=FERMI_SEARCH_CYCLES, T=TEMPERATURE,
                        order=3, exec_cfg=_DEFAULT_EXEC, *, device,
                        mesh=None):
    """Accumulating-history robust polynomial regression root finder
    (calcFermiPolyFit, density.py:1333-1515): PCHIP-smoothed points, Huber-
    loss polynomial fit, nearest real root, monotonicity enforcement."""
    _check_ne(g, ne)
    bracket = _Bracket()
    probe = _DensityProbe(g, _p_mu(g, Emin, N, tol, T, exec_cfg, device,
                                   mesh), ne,
                          bracket=bracket)
    E = float(Ef)
    n_err, P = probe(E)
    if abs(n_err) < conv:
        return E, 0.0, P, abs(n_err), bracket.hi, bracket.lo
    E_pts, n_pts = [E], [n_err]

    # establish a second point with measurable dN (monotonicity seed)
    step = conv * 10
    counter = 1
    while counter < max_cycles:
        E = Ef + step
        n_err, P = probe(E)
        if abs(n_err) < conv:
            return E, step, P, abs(n_err), bracket.hi, bracket.lo
        if n_err > n_pts[0]:
            break
        step *= 10
        counter += 1
    E_pts.append(E)
    n_pts.append(n_err)
    dE = step

    while counter < max_cycles:
        E_next = _robust_poly_root(E_pts, n_pts, order)
        # monotonicity guard: n(E) grows with E, so the root must lie on
        # the deficit side of the latest probe; otherwise discard that
        # probe and step away from it instead
        if n_pts[-1] > 0 and E_next > E_pts[-1]:
            E_next = E_pts[-1] - abs(dE) * 10
            E_pts.pop()
            n_pts.pop()
            counter -= 1
        elif n_pts[-1] < 0 and E_next < E_pts[-1]:
            E_next = E_pts[-1] + abs(dE) * 10
            E_pts.pop()
            n_pts.pop()
            counter -= 1
        n_err, P = probe(E_next)
        dE = E_next - E_pts[-1]
        E_pts.append(E_next)
        n_pts.append(n_err)
        E = E_next
        if abs(n_err) < conv:
            break
        counter += 1
    if counter >= max_cycles:
        print(f"Warning: Max cycles reached, convergence = {abs(n_err):.2E}")
    return E, dE, P, abs(n_err), bracket.hi, bracket.lo


# ---------------------------------------------------------------------------
# Contact-level Fermi searches
# ---------------------------------------------------------------------------

def get_fermi_contact(g, ne, tol=FERMI_CALCULATION_TOL, Eminf=ENERGY_MIN,
                      max_cycles=MAX_CYCLES, T=TEMPERATURE, n_orbs=0,
                      exec_cfg=_DEFAULT_EXEC, *, device, mesh=None,
                      verbose=True):
    """Fermi energy of an isolated contact system (getFermiContact,
    density.py:967-1003): seed from the generalized eigenvalue gap, tune
    the grids with integral_fit, then bracketed bisection."""
    S = np.asarray(g.S)
    F = np.asarray(g.F)
    orbs = np.sort(np.real(scipy.linalg.eigvals(np.linalg.solve(S, F))))
    fermi = (orbs[int(ne) - 1] + orbs[int(ne)]) / 2
    Emin, N1, N2 = integral_fit(F, S, g, fermi, Eminf, tol, T,
                                max_n=max_cycles, exec_cfg=exec_cfg,
                                device=device, mesh=mesh, verbose=verbose)
    Emax = float(np.max(orbs))
    return calc_fermi(g, ne, Emin, Emax, fermi, N1, N2, Eminf, T, tol,
                      max_cycles, n_orbs, exec_cfg, device=device, mesh=mesh,
                      verbose=verbose)[0]


def get_fermi_1d_contact(g_sys, ne, ind=0, tol=FERMI_CALCULATION_TOL,
                         Eminf=ENERGY_MIN, T=TEMPERATURE,
                         max_cycles=MAX_CYCLES, exec_cfg=_DEFAULT_EXEC, *,
                         device, mesh=None, verbose=True):
    """Fermi energy of a 1D chain contact via the 2-cell periodic block
    trick (getFermi1DContact, density.py:1005-1053)."""
    F = np.asarray(g_sys.a_list[ind])
    S = np.asarray(g_sys.aS_list[ind])
    tau = np.asarray(g_sys.b_list[ind])
    stau = np.asarray(g_sys.bS_list[ind])
    inds = np.arange(len(F))
    g = Chain1DSelfEnergy(F, S, [inds], taus=[tau], staus=[stau], eta=1e-6,
                          device=device)

    F2 = np.block([[F, tau], [tau.conj().T, F]])
    S2 = np.block([[S, stau], [stau.T, S]])
    g2 = Chain1DSelfEnergy(F2, S2, [inds], taus=[tau], staus=[stau],
                           eta=1e-6, device=device)
    orbs = np.sort(np.real(
        scipy.linalg.eigvals(np.linalg.solve(S2, F2))))
    fermi = (orbs[2 * int(ne) - 1] + orbs[2 * int(ne)]) / 2
    Emin, N1, N2 = integral_fit(F2, S2, g2, fermi, Eminf, tol, T,
                                max_n=max_cycles, exec_cfg=exec_cfg,
                                device=device, mesh=mesh, verbose=verbose)
    Emax = float(np.max(orbs))
    return calc_fermi(g, ne, Emin, Emax, fermi, N1, N2, Eminf, T, tol,
                      max_cycles, 0, exec_cfg, device=device, mesh=mesh,
                      verbose=verbose)
