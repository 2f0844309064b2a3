"""Spin-layout transforms for 'r' / 'u' / 'ro' / 'g' calculations.

Port of ``gaunegf_tpu/spin.py``.  The reference scatters kron-expansion
rules across scf.py:473-503 and transport.py:92-141; here they are explicit
array transforms:

* 'r'  -- restricted: one N x N block, spin degeneracy by a factor 2.
* 'u'/'ro' -- collinear: block-diagonal [[up, 0], [0, down]] (2N x 2N).
* 'g'  -- non-collinear spinor: per-orbital 2x2 blocks, interleaved
  [a0, b0, a1, b1, ...]; related to the block layout by a fixed permutation.

The host transforms are NumPy; the wrapped sigma functions run on torch
tensors (a batch of energies gives (b, N, N), an energy-independent
provider (N, N)).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "expand_matrix", "expand_vector", "spinor_block_perm",
    "wrap_expand_fn", "wrap_permute_fn",
]


def expand_matrix(sig, spin: str):
    """Expand an N x N matrix to 2N x 2N for the given spin layout."""
    sig = np.asarray(sig)
    if spin in ("u", "ro"):
        return np.kron(np.eye(2), sig)
    if spin == "g":
        return np.kron(sig, np.eye(2))
    return sig


def expand_vector(v, spin: str):
    """Expand a per-orbital vector for the given spin layout
    (scf.py:478-484 rules)."""
    v = np.asarray(v)
    if spin in ("u", "ro"):
        return np.kron([1, 1], v)
    if spin == "g":
        return np.kron(v, [1, 1])
    return v


def spinor_block_perm(n_orb: int) -> np.ndarray:
    """Permutation mapping spinor-interleaved indices to block layout:
    [a0, b0, a1, b1, ...] -> [a0, a1, ..., b0, b1, ...]."""
    return np.concatenate([np.arange(0, 2 * n_orb, 2),
                           np.arange(1, 2 * n_orb, 2)])


@lru_cache(maxsize=None)
def wrap_expand_fn(fn, spin: str):
    """Wrap a sigma-apply fn so its output is spin-expanded.  Cached, so a
    wrapped function keeps one identity."""
    if spin not in ("u", "ro", "g"):
        return fn

    def wrapped(params, E):
        sig = fn(params, E)
        eye = torch.eye(2, dtype=sig.dtype, device=sig.device)
        # torch.kron broadcasts the (2, 2) factor over a leading batch
        return torch.kron(sig, eye) if spin == "g" else torch.kron(eye, sig)

    return wrapped


@lru_cache(maxsize=None)
def wrap_permute_fn(fn, n_orb: int):
    """Wrap a sigma-apply fn with the spinor -> block permutation."""
    perm = spinor_block_perm(n_orb)

    def wrapped(params, E):
        sig = fn(params, E)
        p = torch.as_tensor(perm, device=sig.device)
        return sig[..., p[:, None], p[None, :]]

    return wrapped
