"""gauNEGF.fermiSearch parity: DOS-Taylor Fermi step predictor
(fermiSearch.py:51-196; the reference marks it deprecated but density.py
still imports it)."""

from gaunegf_tpu_torch.fermi_search_dos import (
    DOSFermiSearch as _DOSFermiSearch, matrix_finite_difference)


def matrixFiniteDifference(dosFunc, E, h, numPoints):
    """Vandermonde finite-difference row (fermiSearch.py:86-116)."""
    return matrix_finite_difference(dosFunc, E, h, numPoints)


class DOSFermiSearch(_DOSFermiSearch):
    """fermiSearch.DOSFermiSearch with the reference's keyword names."""

    def __init__(self, initialEf, nTarget, deltaE=0.01, numPoints=5,
                 debug=False):
        super().__init__(initialEf, nTarget, deltaE=deltaE,
                         num_points=numPoints, debug=debug)

    def getAccuracy(self):
        return self.get_accuracy()

    def matrixFiniteDifference(self, dosFunc, E, h, numPoints):
        return matrix_finite_difference(dosFunc, E, h, numPoints)

    def step(self, dosFunc, nCurr, stepLim=10):
        return super().step(dosFunc, nCurr, step_lim=stepLim)
