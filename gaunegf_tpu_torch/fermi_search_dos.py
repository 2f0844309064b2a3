"""DOS-Taylor-expansion Fermi-step predictor.

[DEPRECATED -- capability parity with gauNEGF/fermiSearch.py, which the
reference itself marks deprecated (fermiSearch.py:4-6) but still imports
from density.py.  Prefer the strategies in gaunegf_tpu_torch.fermi.]

Predicts the Fermi-level shift needed to reach a target electron count from
a local Taylor model of the DOS: derivatives by Vandermonde finite
differences, polynomial root solve with step limiting, sign correction and
oscillation damping.
"""

from __future__ import annotations

from math import factorial

import numpy as np

__all__ = ["DOSFermiSearch", "matrix_finite_difference"]


def matrix_finite_difference(dos_func, E, h, num_points):
    """Derivatives [DOS, DOS', DOS'', ...] at E via a Vandermonde system
    over num_points samples on [E-h, E+h] (fermiSearch.py:86-116)."""
    points = np.linspace(-h, h, num_points)
    A = np.zeros((num_points, num_points))
    for i in range(num_points):
        for j in range(num_points):
            A[i, j] = points[i] ** j / factorial(j)
    b = np.array([dos_func(E + p) for p in points])
    return np.linalg.solve(A, b)


class DOSFermiSearch:
    """Taylor-of-DOS Fermi-step predictor (fermiSearch.py:24-196 parity)."""

    def __init__(self, initial_Ef, n_target, deltaE=0.01, num_points=5,
                 debug=False):
        self.Ef = initial_Ef
        self.n_target = n_target
        self.deltaE = deltaE
        self.num_points = num_points
        self.deltaEf = initial_Ef
        self.debug = debug

    def get_accuracy(self):
        return abs(self.deltaEf) if self.deltaEf is not None else float("inf")

    getAccuracy = get_accuracy

    def step(self, dos_func, n_curr, step_lim=10):
        """One predictor step: solve sum_n DOS^(n) dE^(n+1)/(n+1)! = dN for
        dE, with step-limit/oscillation/sign handling
        (fermiSearch.py:118-196)."""
        delta_N = self.n_target - n_curr
        h = min(self.deltaE, np.abs(self.deltaEf / 10))
        derivs = matrix_finite_difference(dos_func, self.Ef, h,
                                          self.num_points)
        if self.debug:
            print("DOS derivatives:", derivs)

        coeffs = [0.0] * (self.num_points + 1)
        coeffs[0] = -delta_N
        for n in range(self.num_points):
            coeffs[n + 1] = derivs[n] / factorial(n + 1)
        roots = np.roots(coeffs[::-1])
        real_roots = roots[np.abs(roots.imag) < 1e-9].real
        if len(real_roots) > 0:
            root = real_roots[np.argmin(np.abs(real_roots))]
        else:
            # fall back to a Newton step on the leading DOS term
            root = delta_N / derivs[0]

        if np.abs(root) > step_lim:
            print(f"Warning: deltaEf cutoff reached! Incrementing by "
                  f"{step_lim} eV")
            if self.deltaEf == -np.sign(root) * step_lim:
                self.deltaEf = np.sign(root) * step_lim * 0.5
            else:
                self.deltaEf = np.sign(root) * step_lim
        else:
            self.deltaEf = root
        if np.sign(np.real(delta_N)) != np.sign(np.real(self.deltaEf)):
            print("Warning: deltaEf sign error corrected")
            self.deltaEf *= -1
        self.Ef = self.Ef + self.deltaEf
        return self.Ef
