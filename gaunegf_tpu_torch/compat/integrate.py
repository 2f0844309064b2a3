"""gauNEGF.integrate parity: weighted Green's-function sums over energy.

GrInt (integrate.py:146-173) and GrLessInt (integrate.py:177-208) map to
the energy engine of ops/greens.py (chunked batched solves on the
facade's device, complex128 accumulation).
"""

from gaunegf_tpu_torch.compat._device import get_device
from gaunegf_tpu_torch.ops.greens import weighted_gless_sum, weighted_gr_sum


def GrInt(F, S, g, Elist, weights, device=None):
    """sum_k w_k G(E_k) -- integrate.GrInt parity."""
    return weighted_gr_sum(F, S, g, Elist, weights,
                           device=get_device(device))


def GrLessInt(F, S, g, Elist, weights, ind=None, device=None):
    """sum_k w_k [G Gamma_ind G^+](E_k) -- integrate.GrLessInt parity
    (ind=None uses the total Sigma's Gamma)."""
    return weighted_gless_sum(F, S, g, Elist, weights, contact=ind,
                              device=get_device(device))


# Module-level knobs and logger under the reference's names
# (integrate.py:23-60).  The memory heuristics are advisory here: engine
# dispatch is governed by ExecutionConfig.energy_chunk instead of the
# reference's vmap-vs-scan memory estimate.
import logging as _logging
import os as _os
import socket as _socket

from gaunegf_tpu_torch.config import LOG_LEVEL as _LOG_LEVEL

hostname = _socket.gethostname()
pid = _os.getpid()
log_level = getattr(_logging, str(_LOG_LEVEL).upper(), _logging.DEBUG)
parallel_logger = _logging.getLogger("gauNEGF.integrate")
parallel_logger.setLevel(log_level)

MAX_VMAP_MEMORY_GB = 5.0
FORCE_SYNCHRONOUS = True
MEMORY_PER_MATRIX_FACTOR = 16
BYTES_TO_GB = 1e9
