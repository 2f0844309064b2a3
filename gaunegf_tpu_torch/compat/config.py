"""gauNEGF.config parity: the constant names already match the reference
(config.py:7-34), so this is a direct re-export."""

from gaunegf_tpu_torch.config import (  # noqa: F401
    ADAPTIVE_INTEGRATION_TOL, ENERGY_MIN, ENERGY_STEP, ETA,
    FERMI_CALCULATION_TOL, FERMI_SEARCH_CYCLES, LOG_LEVEL, LOG_PERFORMANCE,
    MAX_CYCLES, MAX_GRID_POINTS, N_KT, PULAY_MIXING_SIZE, SCF_CONVERGENCE_TOL,
    SCF_DAMPING, SCF_MAX_CYCLES, SURFACE_GREEN_CONVERGENCE,
    SURFACE_RELAXATION_FACTOR, TEMPERATURE)
