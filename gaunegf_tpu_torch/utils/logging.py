"""Structured logging, performance spans and profiler hooks.

Port of ``gaunegf_tpu/utils/logging.py``, which replaces the reference's
ad-hoc per-host/per-PID file logger (integrate.py:22-49):

* ``get_logger``   -- loggers under the ``gaunegf_tpu_torch`` namespace,
  configured once from config (LOG_LEVEL / LOG_PERFORMANCE); when
  performance logging is enabled, a per-host per-PID file
  ``gaunegf_perf_<host>_<pid>.log`` is attached (same discoverability as
  the reference's integrate_performance files).
* ``perf_span``    -- context manager timing a labelled region on the
  host clock and logging it at DEBUG; the energy engine wraps each sum's
  dispatch in one, and its dispatch log names the device and, under a
  mesh, the mesh shape, the rank and its coordinates.  It never synchronizes the device: a span around
  asynchronous work measures the host's side of it (the engine's sums
  end in a copy to the host, so theirs include the device time).
  Below DEBUG it costs one ``time.perf_counter`` pair.
* ``profile_trace``-- context manager around ``torch.profiler`` that
  writes a Chrome trace of the enclosed region into ``logdir`` (host
  activity, and the CUDA activity when torch sees a GPU).
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import tempfile
import time

__all__ = ["get_logger", "perf_span", "profile_trace"]

ROOT = "gaunegf_tpu_torch"
_CONFIGURED = False


def _configure_root():
    global _CONFIGURED
    if _CONFIGURED:
        return
    from gaunegf_tpu_torch.config import LOG_LEVEL, LOG_PERFORMANCE

    root = logging.getLogger(ROOT)
    if root.level == logging.NOTSET:       # keep a level set before this
        root.setLevel(getattr(logging, str(LOG_LEVEL).upper(),
                              logging.INFO))
    if LOG_PERFORMANCE and not root.handlers:
        host = socket.gethostname()
        pid = os.getpid()
        path = os.path.join(os.getcwd(), f"gaunegf_perf_{host}_{pid}.log")
        try:
            handler = logging.FileHandler(path, mode="a")
        except OSError:
            path = os.path.join(tempfile.gettempdir(),
                                f"gaunegf_perf_{host}_{pid}.log")
            handler = logging.FileHandler(path, mode="a")
        handler.setFormatter(logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
        root.addHandler(handler)
    _CONFIGURED = True


def get_logger(name: str = ROOT) -> logging.Logger:
    _configure_root()
    if name != ROOT and not name.startswith(ROOT + "."):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)


@contextlib.contextmanager
def perf_span(label: str, logger: logging.Logger | None = None, **fields):
    """Time a region and log '<label> took <dt>s <fields>' at DEBUG."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        log = logger or get_logger("perf")
        if log.isEnabledFor(logging.DEBUG):
            extra = " ".join(f"{k}={v}" for k, v in fields.items())
            log.debug(f"{label} took {dt:.3f}s {extra}".rstrip())


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed region and write it
    as a Chrome trace (``trace_<host>_<pid>_<n>.json``) into logdir; yields
    the profiler, whose ``key_averages()`` stay readable afterwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        stem = f"trace_{socket.gethostname()}_{os.getpid()}"
        n = sum(1 for f in os.listdir(logdir) if f.startswith(stem))
        prof.export_chrome_trace(os.path.join(logdir, f"{stem}_{n}.json"))
