"""gauNEGF.utils parity (utils.py:12-62): the linear-algebra helpers.

A NumPy argument is computed on the facade's device (or ``device=``) and
comes back as NumPy; a tensor is computed where it lies and comes back as
a tensor.  See ops/zlinalg.py for what each one runs.
"""

import numpy as np
import torch

from gaunegf_tpu_torch.compat._device import get_device
from gaunegf_tpu_torch.ops import zlinalg as _zl

__all__ = ["inv", "eig", "eigh", "fractional_matrix_power"]


def _apply(fn, A, device, *args):
    if isinstance(A, torch.Tensor):
        return fn(A, *args)
    out = fn(torch.as_tensor(np.asarray(A), device=get_device(device)),
             *args)
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return tuple(x.cpu().numpy() for x in out)


def inv(A, device=None):
    """Matrix inverse (utils.py:52-54)."""
    return _apply(_zl.inv, A, device)


def eig(A, device=None):
    """General eigendecomposition, complex (w, v)."""
    return _apply(_zl.eig, A, device)


def eigh(A, device=None):
    """Hermitian eigendecomposition (utils.py:60-62): (w, v)."""
    return _apply(_zl.eigh, A, device)


def fractional_matrix_power(S, power, device=None):
    """S^power by Hermitian eigendecomposition (utils.py:12-48)."""
    return _apply(_zl.fractional_matrix_power, S, device, power)
