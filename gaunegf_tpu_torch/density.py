"""Density-matrix integration engines.

Port of ``gaunegf_tpu/density.py`` (the reference's L3 layer): the analytic
energy-independent density, the real-axis / complex-contour / bias-window
routes with fixed-N and adaptive variants, the Emin search and the grid
auto-tuning.  The weighted sums of G(E) over the grid run through
ops/greens.py on the device named by ``device`` (keyword-only and
required), sharded over an ('e', 'm') mesh where ``mesh`` is given, as in
the JAX package; the analytic route and the searches' bookkeeping are
host NumPy, the same on every rank.

Conventions (identical to the reference):
* real-axis equilibrium part:   P = -Im( sum_k w_k G(E_k) ) / pi
  (densityRealN, density.py:385-436)
* complex contour part:         P = +Im( sum_k w_k G(z_k) ) / pi
  (densityComplexN, density.py:660-748; the finite-T broadening segment
  enters with a corrected sign -- see quadrature.contour_grid)
* non-equilibrium G< window:    P = sum_k w_k [G Gamma G+](E_k) / (2 pi)
  (densityGridN, density.py:487-544)
"""

from __future__ import annotations

import os
from multiprocessing.pool import ThreadPool
from typing import Optional

import numpy as np

from gaunegf_tpu_torch.config import (
    ADAPTIVE_INTEGRATION_TOL, ENERGY_MIN, FERMI_CALCULATION_TOL, MAX_CYCLES,
    MAX_GRID_POINTS, N_KT, TEMPERATURE, ExecutionConfig)
from gaunegf_tpu_torch import quadrature as quad
from gaunegf_tpu_torch.models.selfenergy import _host_eval
from gaunegf_tpu_torch.ops.greens import EnergyEngine
from gaunegf_tpu_torch.units import KB

__all__ = [
    "density_analytic", "bisect_fermi", "dos_at_energy", "sigma_total",
    "density_real_n", "density_real", "density_eq_n", "density_neq_n",
    "density_complex_n", "density_complex",
    "density_grid_n", "density_grid", "density_grid_trap",
    "calc_emin", "integral_fit", "integral_fit_negf", "integrate_points",
]

_DEFAULT_EXEC = ExecutionConfig()


def integrate_points(compute_point_func, num_points, parallel=False,
                     num_workers=None, chunk_size=None, debug=False):
    """Sum compute_point_func(i) over i (integratePoints parity,
    density.py:121-210).  Host only.

    Batched device execution goes through the ops.greens engines; this is
    for users of host-side point functions.  It keeps the reference's
    parallel gating (explicit ``parallel=True`` AND >=100 points AND >=32
    cores, honoring SLURM_CPUS_ON_NODE) and chunked index ranges summed per
    worker, on a thread pool as in the JAX package: point functions spend
    their time in BLAS calls that release the interpreter lock, and a
    thread needs no pickling.
    """
    num_points = int(num_points)
    num_cores = int(os.environ.get("SLURM_CPUS_ON_NODE",
                                   os.cpu_count() or 1))
    if debug:
        print(f"Number of points to integrate: {num_points}")
        print(f"Number of CPU cores: {num_cores}")

    if not (parallel and num_points >= 100 and num_cores >= 32):
        result = np.zeros_like(compute_point_func(0))
        for i in range(num_points):
            result = result + compute_point_func(i)
        return result

    if num_workers is None:
        num_workers = max(1, num_cores // 16)
    if chunk_size is None:
        chunk_size = max(1, min(num_points // (num_workers * 4), 100))
    if debug:
        print(f"Workers: {num_workers}, Chunk size: {chunk_size}")

    chunks = [range(i, min(i + chunk_size, num_points))
              for i in range(0, num_points, chunk_size)]

    def chunk_sum(points):
        return sum(compute_point_func(i) for i in points)

    try:
        pool = ThreadPool(num_workers)
    except (OSError, RuntimeError) as e:     # no thread could be started
        if debug:
            print(f"Thread pool failed ({e!r}); falling back to serial")
        return sum(chunk_sum(chunk) for chunk in chunks)
    with pool:
        return sum(pool.map(chunk_sum, chunks))


def _engine(F, S, g, exec_cfg, device, mesh=None):
    return EnergyEngine(F, S, g, exec_cfg, mesh, device=device)


# ---------------------------------------------------------------------------
# Energy-independent analytic route (PRB 65, 165401 Eq. 27), host NumPy
# ---------------------------------------------------------------------------

def density_analytic(V, Vc, D, Gam, Emin, mu):
    """Closed-form density matrix for constant self-energies.

    Parity with density.density (density.py:276-329): in the eigenbasis of
    Fbar (eigenvectors V, inverse-adjoint Vc, eigenvalues D), with
    broadening matrix Gam, the occupied-window integral of the spectral
    function has the closed form

        P_ij = [ (l_i - l_j*) - (m_i - m_j*) ] / (2 pi (D_i - D_j*)) * Gb_ij

    where l = log(1 - mu/D), m = log(1 - Emin/D), Gb = Vc+ Gam Vc; then
    P -> V P V+.
    """
    D = np.asarray(D).ravel()
    V = np.asarray(V)
    Vc = np.asarray(Vc)
    Gam = np.asarray(Gam)
    log_mu = np.emath.log(1 - mu / D)
    log_e0 = np.emath.log(1 - Emin / D)
    num = (log_mu[:, None] - np.conj(log_mu)[None, :]) \
        - (log_e0[:, None] - np.conj(log_e0)[None, :])
    den = 2 * np.pi * (D[:, None] - np.conj(D)[None, :])
    pref = num / den
    Gb = Vc.conj().T @ Gam @ Vc
    return V @ (pref * Gb) @ V.conj().T


def bisect_fermi(V, Vc, D, Gam, Nexp, conv=FERMI_CALCULATION_TOL,
                 Eminf=ENERGY_MIN, max_iter=1000, verbose=True):
    """Fermi level from the analytic density by bisection
    (density.py:331-382 semantics: bounds = eigenvalue range)."""
    D = np.asarray(D).ravel()
    lo, hi = float(np.min(D.real)), float(np.max(D.real))
    dN = Nexp
    it = 0
    fermi = 0.5 * (lo + hi)
    while abs(dN) > conv and it < max_iter:
        fermi = 0.5 * (lo + hi)
        P = density_analytic(V, Vc, D, Gam, Eminf, fermi)
        dN = float(np.trace(P).real) - Nexp
        if dN > 0:
            hi = fermi
        else:
            lo = fermi
        it += 1
    if verbose:
        if it >= max_iter:
            print("Warning: Bisection search timed out after "
                  f"{max_iter} iterations!")
        print(f"Bisection fermi search converged to {dN:.2E} in {it} iterations.")
    return fermi


def dos_at_energy(E, F, S, sigma_total):
    """DOS(E) = -Im tr G / pi for a precomputed total self-energy.

    Single-energy probe of the host-driven searches (calc_emin, the
    bisection's step sizes); runs on the host in NumPy."""
    A = E * np.asarray(S) - np.asarray(F) - np.asarray(sigma_total)
    G = np.linalg.inv(A)
    return float(-np.imag(np.trace(G)) / np.pi)


def density_real_n(F, S, g, Emin, mu, N=100, T=TEMPERATURE,
                   exec_cfg=_DEFAULT_EXEC, *, device, mesh=None,
                   verbose=False):
    """Equilibrium density from N-point Gauss-Legendre on [Emin, mu+nkT]."""
    E, w = quad.real_axis_grid(Emin, mu, N, T)
    if verbose:
        print(f"Integrating {N} points along real axis...")
    im = _engine(F, S, g, exec_cfg, device, mesh).gr_sum(E, w, epilog="im")
    return (-1 + 0j) * im / np.pi


def density_real(F, S, g, Emin, mu, tol=ADAPTIVE_INTEGRATION_TOL,
                 T=TEMPERATURE, max_n=MAX_CYCLES, exec_cfg=_DEFAULT_EXEC, *,
                 device, mesh=None, verbose=True):
    """Adaptive (grid-doubling) version of density_real_n
    (density.py:438-484 behaviour)."""
    P = np.zeros_like(np.asarray(F), dtype=complex)
    N = 1
    err = np.inf
    while N < max_n:
        P_prev = P
        P = density_real_n(F, S, g, Emin, mu, N, T, exec_cfg, device=device,
                           mesh=mesh)
        err = float(np.max(np.abs(P - P_prev)))
        if err < tol:
            if verbose:
                print(f"Adaptive integration converged to {err:.3e} in {N} points.")
            return P
        N *= 2
    if verbose:
        print(f"Warning: adaptive integration not converged after {max_n} "
              f"points: maxDP={err:.2E}")
    return P


def density_eq_n(F, S, g, Eminf, Emin, mu, N1=100, N2=50, T=TEMPERATURE,
                 T_real=0.0, method="ant", exec_cfg=_DEFAULT_EXEC, *, device,
                 mesh=None,
                 verbose=False):
    """Full equilibrium density in ONE engine dispatch: the real-axis lower
    segment [Eminf, Emin] (N2 Gauss-Legendre points) and the semicircular
    contour [Emin, mu] (N1 points) are both Im(sum w G)/pi with opposite
    sign conventions, so their grids concatenate into a single weighted
    G(E) sum."""
    E_r, w_r = quad.real_axis_grid(Eminf, Emin, N2, T_real)
    z_c, w_c = quad.contour_grid(Emin, mu, N1, T, method)
    if verbose:
        print(f"Fused integration: {N2} real-axis + {len(z_c)} contour "
              "points...")
    im = _engine(F, S, g, exec_cfg, device, mesh).density_eq_split(
        np.asarray(E_r, complex), -np.asarray(w_r, complex),
        np.asarray(z_c, complex), np.asarray(w_c, complex))
    return (1 + 0j) * im / np.pi


def density_neq_n(F, S, g, Eminf, Emin, mu1, mu2, N1=100, N2=50, Nnegf=100,
                  T=TEMPERATURE, T_real=0.0, method="ant", ind=-1,
                  exec_cfg=_DEFAULT_EXEC, *, device, mesh=None,
                   verbose=False):
    """Full BIASED density in ONE engine dispatch: real-axis lower segment
    + equilibrium contour (both Im(sum w G)/pi, as in density_eq_n) + the
    non-equilibrium G< window (sum w G Gamma G+ / 2pi), one host copy per
    SCF cycle (reference: three separate integrals, scfE.py:301-462).  The
    physics scales fold into the quadrature weights so the engine remains
    a plain weighted sum."""
    E_r, w_r = quad.real_axis_grid(Eminf, Emin, N2, T_real)
    z_c, w_c = quad.contour_grid(Emin, mu1, N1, T, method)  # eq filled to mu1
                                                            # (scfE.py:439)
    E_eq = np.concatenate([np.asarray(E_r, complex),
                           np.asarray(z_c, complex)])
    w_eq = np.concatenate([-np.asarray(w_r, complex),
                           np.asarray(w_c, complex)]) / np.pi
    E_n, w_n = quad.bias_window_grid(mu1, mu2, Nnegf, T)
    if verbose:
        print(f"Fused biased integration: {N2} real-axis + {len(z_c)} "
              f"contour + {Nnegf} window points...")
    return _engine(F, S, g, exec_cfg, device, mesh).density_neq_sum(
        E_eq, w_eq, E_n, np.asarray(w_n) / (2 * np.pi), contact=ind)


def density_complex_n(F, S, g, Emin, mu, N=100, T=TEMPERATURE, method="ant",
                      exec_cfg=_DEFAULT_EXEC, *, device, mesh=None,
                   verbose=False):
    """Equilibrium density from the N-point semicircular contour."""
    z, w = quad.contour_grid(Emin, mu, N, T, method)
    if verbose:
        print(f"Complex integration over {len(z)} points...")
    im = _engine(F, S, g, exec_cfg, device, mesh).gr_sum(z, w, epilog="im")
    return (1 + 0j) * im / np.pi


def density_complex(F, S, g, Emin, mu, tol=ADAPTIVE_INTEGRATION_TOL,
                    T=TEMPERATURE, exec_cfg=_DEFAULT_EXEC, *, device,
                    mesh=None,
                    verbose=True):
    """Adaptive nested-ANT contour integration (density.py:750-816): one
    engine, called once per refinement level with that level's new nodes."""
    eng = _engine(F, S, g, exec_cfg, device, mesh)

    def compute(x, w):
        z, zw = quad.semicircle_contour(Emin, mu, x, w, T)
        return eng.gr_sum(z, zw)

    drv = quad.AdaptiveANT(tol=tol, verbose=verbose)
    line = drv.integrate(compute)
    if T > 0:
        def compute_broad(x, w):
            broad = N_KT * KB * T
            E = broad * np.asarray(x) + mu
            # minus sign: real-axis segment enters the +Im/pi convention
            weights = -broad * np.asarray(w) * quad.fermi_dirac(E, mu, T)
            return eng.gr_sum(E, weights)

        drv2 = quad.AdaptiveANT(tol=tol, verbose=verbose)
        line = line + drv2.integrate(compute_broad)
    return (1 + 0j) * np.imag(line) / np.pi


# ---------------------------------------------------------------------------
# Non-equilibrium (bias window) routes
# ---------------------------------------------------------------------------

def density_grid_n(F, S, g, mu1, mu2, ind: Optional[int] = None, N=100,
                   T=TEMPERATURE, exec_cfg=_DEFAULT_EXEC, *, device,
                    mesh=None,
                   verbose=False):
    """Non-equilibrium G< window on an N-point Gauss-Legendre grid."""
    E, w = quad.bias_window_grid(mu1, mu2, N, T)
    if verbose:
        print(f"Real integration over {N} points...")
    s = _engine(F, S, g, exec_cfg, device, mesh).gless_sum(E, w, contact=ind)
    return s / (2 * np.pi)


def _bias_window(mu1, mu2, T):
    """(lo, hi, sign, Emin, Emax) of the G< window between mu1 and mu2,
    spread by N_KT*kT at each end."""
    kT = KB * T
    lo, hi = min(mu1, mu2), max(mu1, mu2)
    return lo, hi, np.sign(mu2 - mu1), lo - N_KT * kT, hi + N_KT * kT


def density_grid(F, S, g, mu1, mu2, ind: Optional[int] = None,
                 tol=ADAPTIVE_INTEGRATION_TOL, T=TEMPERATURE,
                 exec_cfg=_DEFAULT_EXEC, *, device, mesh=None,
                   verbose=False):
    """Adaptive nested-ANT version of density_grid_n (density.py:605-658)."""
    lo, hi, sgn, Emin, Emax = _bias_window(mu1, mu2, T)
    mid = (Emax - Emin) / 2
    eng = _engine(F, S, g, exec_cfg, device, mesh)

    def compute(x, w):
        E = mid * (np.asarray(x) + 1) + Emin
        df = quad.fermi_dirac(E, hi, T) - quad.fermi_dirac(E, lo, T)
        return eng.gless_sum(E, mid * np.asarray(w) * df * sgn, contact=ind)

    drv = quad.AdaptiveANT(tol=tol, verbose=verbose)
    return drv.integrate(compute) / (2 * np.pi)


def density_grid_trap(F, S, g, mu1, mu2, ind: Optional[int] = None, N=100,
                      T=TEMPERATURE, exec_cfg=_DEFAULT_EXEC, *, device,
                      mesh=None):
    """Midpoint/trapezoid variant (densityGridTrap, density.py:547-603)."""
    lo, hi, sgn, Emin, Emax = _bias_window(mu1, mu2, T)
    grid = np.linspace(Emin, Emax, N)
    E = 0.5 * (grid[1:] + grid[:-1])
    dE = np.diff(grid)
    df = quad.fermi_dirac(E, hi, T) - quad.fermi_dirac(E, lo, T)
    w = df * dE * sgn
    s = _engine(F, S, g, exec_cfg, device, mesh).gless_sum(E, w, contact=ind)
    return s / (2 * np.pi)


# ---------------------------------------------------------------------------
# Integration-limit auto-tuning
# ---------------------------------------------------------------------------

def sigma_total(g, E, device):
    """g's total self-energy at the one energy E, computed on ``device``,
    as complex128 NumPy (the reference's g.sigmaTot(E))."""
    fn, params = g.total_apply()
    return _host_eval(fn, params, E, device)


def calc_emin(F, S, g, tol=FERMI_CALCULATION_TOL, max_n=MAX_CYCLES, *,
              device, verbose=True):
    """Walk Emin down from min eigenvalue - 5 until DOS < tol
    (density.py:821-834); the self-energies on ``device``."""
    F = np.asarray(F)
    S = np.asarray(S)
    D = np.linalg.eigvalsh(np.linalg.solve(S, F))
    Emin = float(np.min(D.real)) - 5
    it = 0
    dos = dos_at_energy(Emin, F, S, sigma_total(g, Emin, device))
    while dos > tol and it < max_n:
        Emin -= 1
        dos = dos_at_energy(Emin, F, S, sigma_total(g, Emin, device))
        it += 1
    if verbose:
        if it == max_n:
            print(f"Warning: Emin still not within tolerance "
                  f"(final value = {dos}) after {max_n} energy samples")
        print(f"Calculated Emin: {Emin} eV, DOS = {dos:.2E}")
    return Emin


def _diag_change(rho_new, rho):
    return float(np.max(np.abs(np.diag(rho_new - rho))))


def integral_fit(F, S, g, mu, Eminf=ENERGY_MIN, tol=FERMI_CALCULATION_TOL,
                 T=TEMPERATURE, max_n=MAX_CYCLES, exec_cfg=_DEFAULT_EXEC, *,
                 device, mesh=None, verbose=True):
    """Auto-tune (Emin, N_contour, N_real) by doubling until dP < tol
    (integralFit, density.py:836-914)."""
    Emin = calc_emin(F, S, g, tol, max_n, device=device, verbose=verbose)

    Ncomplex = 4
    dP = np.inf
    rho = np.zeros(np.shape(F))
    while dP > tol and Ncomplex < max_n:
        Ncomplex *= 2
        rho_ = np.real(density_complex_n(F, S, g, Emin, mu, Ncomplex, T=T,
                                         exec_cfg=exec_cfg, device=device,
                                         mesh=mesh))
        dP = _diag_change(rho_, rho)
        if verbose:
            print(f"MaxDP = {dP:.2E}, N = {np.sum(np.diag(rho_).real):2f}")
        rho = rho_
    if dP < tol:
        Ncomplex //= 2
    elif verbose:
        print(f"Warning: Ncomplex still not within tolerance (final = {dP})")
    if verbose:
        print(f"Final Ncomplex: {Ncomplex}")

    Nreal = 8
    dP = np.inf
    rho = np.zeros(np.shape(F))
    while dP > tol and Nreal < max_n:
        Nreal *= 2
        rho_ = np.real(density_real_n(F, S, g, Eminf, Emin, Nreal, T=0,
                                      exec_cfg=exec_cfg, device=device,
                                         mesh=mesh))
        dP = _diag_change(rho_, rho)
        if verbose:
            print(f"MaxDP = {dP:.2E}")
        rho = rho_
    if dP < tol:
        Nreal //= 2
    elif verbose:
        print(f"Warning: Nreal still not within tolerance (final = {dP})")
    if verbose:
        print(f"Final Nreal: {Nreal}")
    return Emin, Ncomplex, Nreal


def integral_fit_negf(F, S, g, fermi, qV, Eminf=ENERGY_MIN,
                      tol=FERMI_CALCULATION_TOL, T=TEMPERATURE,
                      max_grid=MAX_GRID_POINTS, exec_cfg=_DEFAULT_EXEC, *,
                      device, mesh=None, verbose=True):
    """Auto-tune the non-equilibrium grid size (integralFitNEGF,
    density.py:916-964)."""
    N = 8
    dP = np.inf
    rho = np.zeros(np.shape(F))
    while dP > tol and N < max_grid:
        N *= 2
        rho_ = np.real(density_grid_n(F, S, g, fermi, fermi + qV / 2, ind=0,
                                      N=N, T=T, exec_cfg=exec_cfg,
                                      device=device, mesh=mesh))
        rho_ = rho_ + np.real(density_grid_n(F, S, g, fermi, fermi - qV / 2,
                                             ind=-1, N=N, T=T,
                                             exec_cfg=exec_cfg,
                                             device=device, mesh=mesh))
        dP = _diag_change(rho_, rho)
        if verbose:
            print(f"MaxDP = {dP:.2E}")
        rho = rho_
    if dP < tol:
        N //= 2
    elif verbose:
        print(f"Warning: N still not within tolerance (final = {dP})")
    if verbose:
        print(f"Final Nnegf: {N}")
    return N
