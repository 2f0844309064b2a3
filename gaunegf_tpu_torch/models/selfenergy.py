"""Self-energy provider protocol and the constant-Sigma provider.

Providers are *pure-function + params* pairs, as in the JAX package:

* ``params()``                 -> dict of NumPy arrays
* ``sigma_total(params, E)``   (staticmethod) -> Sigma_total
* ``sigma_contact(params, E, i)`` (staticmethod, i an int) -> Sigma_i
* ``total_apply()``            -> (fn, params), fn(params, E) = Sigma_total
* ``contact_apply(i)``         -> (fn, params), fn(params, E) = Sigma_i

The engines copy params to the device as torch tensors and call fn with a
1-D tensor of energies E; fn returns Sigma broadcastable to
(len(E), N, N) (an energy-independent provider returns (N, N)).  The
reference's duck-typed interface (``sigma(E, i)`` / ``sigmaTot(E)`` /
``setF``) is provided on top as host-side wrappers returning NumPy.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from gaunegf_tpu_torch.config import SURFACE_GREEN_CONVERGENCE

__all__ = ["SelfEnergyProvider", "ConstantSelfEnergy", "form_sigma",
           "tree_map"]


def tree_map(fn, tree):
    """fn applied to every leaf of nested dicts, tuples and lists (the
    providers' params)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def form_sigma(inds, V, nsto: int, S=None):
    """Embed a contact self-energy into an (nsto, nsto) matrix.

    Semantics match matTools.formSigma (matTools.py:39-74): the background is
    a small anti-Hermitian broadening ``-1j * 1e-9 * S`` (identity if S not
    given); V may be a scalar (placed on the diagonal at ``inds``), a vector
    (diagonal values) or a full (len(inds), len(inds)) matrix.
    """
    inds = np.asarray(inds, dtype=int)
    if S is None or (isinstance(S, int) and S == 0):
        S = np.eye(nsto)
    sigma = np.array(-1j * 1e-9 * np.asarray(S), dtype=complex)
    V = np.asarray(V)
    if V.ndim == 0:
        sigma[inds, inds] = complex(V)
    elif V.ndim == 1:
        sigma[inds, inds] = V
    else:
        sigma[np.ix_(inds, inds)] = V
    return sigma


@runtime_checkable
class SelfEnergyProvider(Protocol):
    """Typed version of the duck-typed contract in SURVEY.md section 2.3."""

    F: np.ndarray
    S: np.ndarray

    def params(self): ...

    @staticmethod
    def sigma_total(params, E): ...

    @staticmethod
    def sigma_contact(params, E, i: int): ...

    def total_apply(self): ...

    def contact_apply(self, i: int): ...

    def num_contacts(self) -> int: ...

    def set_fock(self, F, mu1=None, mu2=None) -> None: ...


def _host_eval(fn, params, E, device):
    """fn at one energy on ``device`` (required: None raises), complex128,
    as NumPy."""
    from gaunegf_tpu_torch.ops.greens import resolve_device
    device = resolve_device(device)
    p = tree_map(lambda v: torch.as_tensor(np.asarray(v, dtype=np.complex128),
                                           device=device), params)
    E_t = torch.tensor([complex(E)], dtype=torch.complex128, device=device)
    out = fn(p, E_t)
    return (out[0] if out.dim() == 3 else out).cpu().numpy()


class _CompatMixin:
    """Reference-compatible method names on top of the pure API.  The
    one-energy methods evaluate on the provider's ``device``, which its
    constructor takes; they raise for a provider made without one."""

    def sigma(self, E, i, conv=SURFACE_GREEN_CONVERGENCE):
        fn, params = self.contact_apply(i)
        return _host_eval(fn, params, E, self.device)

    def sigmaTot(self, E, conv=SURFACE_GREEN_CONVERGENCE):
        fn, params = self.total_apply()
        return _host_eval(fn, params, E, self.device)

    def setF(self, F, mu1=None, mu2=None):
        self.set_fock(F, mu1, mu2)


class ConstantSelfEnergy(_CompatMixin):
    """Energy-independent contact self-energies.

    Capability parity with surfGTester.surfGTest (surfGTester.py:62-152):
    used both for testing and for production constant-Sigma runs.  Defaults
    to ``-0.05j`` diagonals on the contact orbitals when no values given.
    ``device`` is where ``sigma`` / ``sigmaTot`` evaluate; the engines
    take theirs from the caller.
    """

    def __init__(self, Fock, Overlap, inds_list, sig1=None, sig2=None, *,
                 device=None):
        self.device = device
        self.F = np.asarray(Fock)
        self.S = np.asarray(Overlap)
        self.N = self.F.shape[0]
        self.inds_list = [np.asarray(i, dtype=int) for i in inds_list]
        sigs = []
        if sig1 is not None:
            sigs.append(form_sigma(self.inds_list[0], sig1, self.N, self.S))
            sigs.append(form_sigma(self.inds_list[1],
                                   sig1 if sig2 is None else sig2,
                                   self.N, self.S))
        else:
            for inds in self.inds_list[:2]:
                s = np.zeros((self.N, self.N), dtype=complex)
                s[np.ix_(inds, inds)] = np.diag([-0.05j] * len(inds))
                sigs.append(s)
        self._sigs = np.stack(sigs)

    def params(self):
        return {"sigs": self._sigs}

    @staticmethod
    def sigma_total(params, E):
        return params["sigs"].sum(dim=0)

    @staticmethod
    def sigma_contact(params, E, i: int):
        return params["sigs"][i]

    def num_contacts(self) -> int:
        return int(self._sigs.shape[0])

    def total_apply(self):
        return ConstantSelfEnergy.sigma_total, self.params()

    def contact_apply(self, i: int):
        i = i % self.num_contacts()
        return _const_contact(i), self.params()

    def contact_inds(self, i=None):
        """Static contact support for the low-rank fast path."""
        if i is None:
            return tuple(sorted({int(j) for inds in self.inds_list[:2]
                                 for j in inds}))
        return tuple(int(j) for j in self.inds_list[i % len(self.inds_list)])

    def total_block_apply(self, c):
        """fn(params, E) -> Sigma_total[c, c] without building the (N, N)
        total (the spectral route's per-point block)."""
        return _const_total_block(tuple(int(j) for j in c))

    def set_fock(self, F, mu1=None, mu2=None):
        self.F = np.asarray(F)


@lru_cache(maxsize=None)
def _const_contact(i: int):
    def fn(params, E):
        return ConstantSelfEnergy.sigma_contact(params, E, i)
    return fn


@lru_cache(maxsize=None)
def _const_total_block(c: tuple):
    def fn(params, E):
        sigs = params["sigs"]
        ci = torch.as_tensor(c, device=sigs.device)
        return sigs[:, ci[:, None], ci[None, :]].sum(dim=0)
    return fn
