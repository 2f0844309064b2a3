"""Density-matrix integration engines (the routes of the biased SCF).

Port of the fixed-grid routes of ``gaunegf_tpu/density.py``.  The weighted
sums of G(E) over the grid run through ops/greens.py on the device named
by ``device``.

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

import numpy as np

from gaunegf_tpu_torch.config import (
    FERMI_CALCULATION_TOL, MAX_CYCLES, TEMPERATURE, ExecutionConfig)
from gaunegf_tpu_torch import quadrature as quad
from gaunegf_tpu_torch.ops.greens import EnergyEngine

__all__ = ["dos_at_energy", "density_real_n", "density_eq_n",
           "density_neq_n", "calc_emin"]

_DEFAULT_EXEC = ExecutionConfig()


def _engine(F, S, g, exec_cfg, device):
    return EnergyEngine(F, S, g, exec_cfg, device=device)


def dos_at_energy(E, F, S, sigma_total):
    """DOS(E) = -Im tr G / pi for a precomputed total self-energy.

    Single-energy probe of the host-driven searches (calc_emin); runs on
    the host in NumPy."""
    A = E * np.asarray(S) - np.asarray(F) - np.asarray(sigma_total)
    G = np.linalg.inv(A)
    return float(-np.imag(np.trace(G)) / np.pi)


def density_real_n(F, S, g, Emin, mu, N=100, T=TEMPERATURE,
                   exec_cfg=_DEFAULT_EXEC, *, device, verbose=False):
    """Equilibrium density from N-point Gauss-Legendre on [Emin, mu+nkT]."""
    E, w = quad.real_axis_grid(Emin, mu, N, T)
    if verbose:
        print(f"Integrating {N} points along real axis...")
    im = _engine(F, S, g, exec_cfg, device).gr_sum(E, w, epilog="im")
    return (-1 + 0j) * im / np.pi


def density_eq_n(F, S, g, Eminf, Emin, mu, N1=100, N2=50, T=TEMPERATURE,
                 T_real=0.0, method="ant", exec_cfg=_DEFAULT_EXEC, *, device,
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
    im = _engine(F, S, g, exec_cfg, device).density_eq_split(
        np.asarray(E_r, complex), -np.asarray(w_r, complex),
        np.asarray(z_c, complex), np.asarray(w_c, complex))
    return (1 + 0j) * im / np.pi


def density_neq_n(F, S, g, Eminf, Emin, mu1, mu2, N1=100, N2=50, Nnegf=100,
                  T=TEMPERATURE, T_real=0.0, method="ant", ind=-1,
                  exec_cfg=_DEFAULT_EXEC, *, device, verbose=False):
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
    return _engine(F, S, g, exec_cfg, device).density_neq_sum(
        E_eq, w_eq, E_n, np.asarray(w_n) / (2 * np.pi), contact=ind)


def calc_emin(F, S, g, tol=FERMI_CALCULATION_TOL, max_n=MAX_CYCLES,
              verbose=True):
    """Walk Emin down from min eigenvalue - 5 until DOS < tol
    (density.py:821-834)."""
    F = np.asarray(F)
    S = np.asarray(S)
    D = np.linalg.eigvalsh(np.linalg.solve(S, F))
    Emin = float(np.min(D.real)) - 5
    it = 0
    dos = dos_at_energy(Emin, F, S, g.sigmaTot(Emin))
    while dos > tol and it < max_n:
        Emin -= 1
        dos = dos_at_energy(Emin, F, S, g.sigmaTot(Emin))
        it += 1
    if verbose:
        if it == max_n:
            print(f"Warning: Emin still not within tolerance "
                  f"(final value = {dos}) after {max_n} energy samples")
        print(f"Calculated Emin: {Emin} eV, DOS = {dos:.2E}")
    return Emin
