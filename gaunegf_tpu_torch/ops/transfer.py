"""Blocking host <-> device copies, counted by the recorder.

A copy to the device from pageable host memory, or a read of a device
tensor on the host, waits until the device's queue has drained, so the
host stalls there and the device idles after it.  These helpers make the
copy or read and count it (``utils/logging``: ``wait.h2d``, ``wait.d2h``,
with the bytes), on any device, so that tests on the CPU hold the counts
of the paths that run on a card.
"""

from __future__ import annotations

import numpy as np
import torch

from gaunegf_tpu_torch.utils.logging import perf_count

__all__ = ["to_device", "to_host", "host_bool"]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def to_device(x, device, dtype=None) -> torch.Tensor:
    """torch.as_tensor(x, device=device), then in ``dtype`` where given:
    one counted copy of host data (a NumPy array, a list, a scalar)."""
    t = torch.as_tensor(x)
    perf_count("wait.h2d", nbytes=_nbytes(t))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def to_host(t: torch.Tensor) -> np.ndarray:
    """t as NumPy: one counted read (t.cpu().numpy())."""
    perf_count("wait.d2h", nbytes=_nbytes(t))
    return t.cpu().numpy()


def host_bool(t: torch.Tensor) -> bool:
    """bool(t) of a one-element tensor: one counted read."""
    perf_count("wait.d2h", nbytes=t.element_size())
    return bool(t)
