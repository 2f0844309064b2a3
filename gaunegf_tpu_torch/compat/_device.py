"""The facade's device.

The reference's signatures carry no device (``NEGF(fn, ...)``,
``cohTrans(Elist, F, S, sig1, sig2)``, ``surfGB(F, S, contacts, bar)``);
this package's engines require one.  So the facade holds one: ``'cuda'``
unless ``compat.install(device=...)`` or ``compat.set_device(...)`` says
otherwise, and every facade class and function takes a ``device=``
keyword that overrides it.  It resolves through ``resolve_device``:
``'cuda'`` without a visible GPU raises, and nothing falls back to the
CPU.  A facade object resolves its device when it is made and keeps it
as ``device``, where a provider also evaluates its one-energy
reference methods (``sigma``, ``sigmaTot``, ``g``; see
models/selfenergy.py::_CompatMixin).
"""

from __future__ import annotations

import functools

import torch

from gaunegf_tpu_torch.ops.greens import resolve_device

DEFAULT_DEVICE = "cuda"
_state = {"device": DEFAULT_DEVICE}


def set_device(device) -> torch.device:
    """Make ``device`` the facade's device; returns it resolved (raises
    RuntimeError for 'cuda' without a visible GPU)."""
    dev = resolve_device(device)
    _state["device"] = dev
    return dev


def get_device(device=None) -> torch.device:
    """``device`` resolved, or the facade's device when it is None."""
    return resolve_device(_state["device"] if device is None else device)


def on_device(fn):
    """Wrap a function of this package whose ``device`` keyword is required
    so that it takes ``device=None`` and gets the facade's device."""
    @functools.wraps(fn)
    def wrapped(*args, device=None, **kw):
        return fn(*args, device=get_device(device), **kw)
    return wrapped

