"""Configuration for gaunegf_tpu_torch.

The same module-level defaults and the same four frozen dataclasses as
``gaunegf_tpu.config``, with identical field names and defaults, so a
configuration written for the JAX package means the same here.  Knobs
whose meaning is specific to the TPU implementation are accepted and
inert in this package; each says so below.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Module-level defaults (names match gauNEGF/config.py:7-33 exactly)
# ---------------------------------------------------------------------------

# Physical parameters
TEMPERATURE = 0.0               # Kelvin - ambient temperature
ETA = 1e-6                      # eV - broadening parameter
ENERGY_STEP = 0.001             # eV - default energy step size

# Contact tolerances
FERMI_CALCULATION_TOL = 1e-3        # Fermi energy calculation tolerance
FERMI_SEARCH_CYCLES = 10            # Cycles to run search before returning
SURFACE_GREEN_CONVERGENCE = 1e-5    # Surface Green's function convergence
SURFACE_RELAXATION_FACTOR = 0.1     # Mixing factor for surface-GF iteration

# Integration parameters
ADAPTIVE_INTEGRATION_TOL = 1e-4     # Adaptive integration tolerance
N_KT = 10                           # Number of kT for integration limits
ENERGY_MIN = -1e6                   # eV - lower bound for energy integration
MAX_CYCLES = 1000                   # Maximum iteration cycles
MAX_GRID_POINTS = 1000              # Maximum number of grid points

# SCF parameters
SCF_DAMPING = 0.02              # SCF damping parameter
SCF_CONVERGENCE_TOL = 1e-3      # SCF convergence tolerance
SCF_MAX_CYCLES = 100            # Maximum SCF cycles
PULAY_MIXING_SIZE = 4           # Number of iterations for Pulay mixing

# Logging
LOG_LEVEL = "INFO"
LOG_PERFORMANCE = False

# Surface-GF iteration budgets (reference: surfG1D.py:265, surfGBethe.py:998)
SURFACE_MAX_ITER_1D = 2000
SURFACE_MAX_ITER_BETHE = 1000
SURFACE_BETHE_MIX = 0.5

# Device execution parameters (no reference equivalent)
DEFAULT_ENERGY_CHUNK = 0        # energies solved together per batched LU;
                                # 0 = auto (ops/greens._auto_chunk_cfg):
                                # the largest power of two whose measured
                                # live bytes per energy fit the memory
                                # budget, clamped to [1, 128]
LU_BLOCK_SIZE = 0               # panel width of the blocked complex LU;
                                # 0 = auto (ops/zlinalg._pick_block): 256
                                # from N=1000 up, else 128 (PERF.md's H100
                                # sweep: 256 ahead by 3.5% at N=1000 and
                                # 9% at N=2000)


# ---------------------------------------------------------------------------
# Frozen dataclass configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SurfaceConfig:
    """Surface self-energy iteration settings (reference surfG1D.py:223-295)."""
    conv: float = SURFACE_GREEN_CONVERGENCE
    relaxation: float = SURFACE_RELAXATION_FACTOR
    max_iter: int = SURFACE_MAX_ITER_1D
    eta: float = ETA
    method: str = "sancho"      # 'sancho' (fast decimation) or 'dyson' (reference-faithful)


@dataclass(frozen=True)
class IntegrationConfig:
    """Quadrature / density integration settings (reference density.py)."""
    tol: float = ADAPTIVE_INTEGRATION_TOL
    n_kt: int = N_KT
    e_min_inf: float = ENERGY_MIN
    max_cycles: int = MAX_CYCLES
    max_grid_points: int = MAX_GRID_POINTS
    temperature: float = TEMPERATURE


@dataclass(frozen=True)
class SCFConfig:
    """SCF driver settings (reference scf.py:691-813)."""
    conv: float = SCF_CONVERGENCE_TOL
    damping: float = SCF_DAMPING
    max_cycles: int = SCF_MAX_CYCLES
    pulay_size: int = PULAY_MIXING_SIZE
    checkpoint: bool = True
    pulay: bool = True


@dataclass(frozen=True)
class ExecutionConfig:
    """Execution policy: precision, chunking and solver choice."""
    # 'fast'   : complex64 blocked LU, no refinement (~1e-5)
    # 'mixed'  : complex64 blocked LU + Newton refinement whose residual
    #            I - A X is computed in complex128 against the complex128
    #            operator (~6e-8 away from poles: the complex64 storage of
    #            G; the JAX package's contract is ~2e-6)
    # 'strict' : complex128 throughout, solved by torch.linalg.solve
    # 'high', 'exact' : not yet ported (ROADMAP section 1, item 2)
    precision: str = "mixed"
    refine_steps: int = 1   # Newton steps of the mixed tier
    energy_chunk: int = DEFAULT_ENERGY_CHUNK
    lu_block: int = LU_BLOCK_SIZE   # 0 = auto by matrix size
    # panel factorization of the blocked LU.  'auto', 'scan' and 'pstrip'
    # all name the strip-scanned panel (ops/zlinalg._factor_panel_scan),
    # whose 32-column strips are eliminated by the hand-written kernel
    # ops/kernels/strip_elim.py.  Every other name of the JAX package
    # ('split', 'psplit', 'virtual', 'fused', 'fused3', 'pallas', 'xla')
    # raises NotImplementedError until its ROADMAP item lands.
    lu_panel: str = "auto"
    # inert here: selects the TPU matrix-unit pass count of the trailing
    # updates in the JAX package; torch.matmul runs them in full precision
    lu_trail: str = "hi"
    # energy-grid solver family.  'lu' = per-point blocked LU; 'auto'
    # resolves to 'lu' until the spectral route is ported (LU is one of
    # the outcomes of the JAX package's own 'auto'); 'spectral' raises
    # NotImplementedError.
    solver: str = "auto"
    # near-pole guard threshold (ops/greens.EnergyEngine._near_pole_guard);
    # the remaining spectral_* knobs belong to the spectral route and are
    # inert until it is ported
    spectral_dist_f32: float = 1e-4
    spectral_dist_lu: float = 1e-5
    spectral_dw: str = "lite"          # inert: TPU double-word emulation
    spectral_deflate: int = 8
    spectral_basis: str = "auto"       # inert: TPU device-basis choice
    spectral_basis_device_min_n: int = 3072   # inert (TPU size gate)
    spectral_warm_basis: bool = False  # inert (TPU device-basis warm start)
    # warn when a fast/mixed LU dispatch has real-axis points within
    # spectral_dist_f32 of an eigenvalue of the (H, S) pencil that is
    # already cached; see EnergyEngine._near_pole_guard
    near_pole_warn: bool = True
    # accepted for configuration compatibility; this package runs on one
    # device, so nothing is distributed
    distribute_lu: bool = False
    # G< and transmission solve only the contact columns of G (LU cost
    # unchanged, triangular solves shrink N -> nc).  Neglects the
    # -1j*1e-9*S broadening background's Gamma (~1e-9 relative).
    use_lowrank: bool = True
    # warm-start provider fixed points along the grid; no provider of
    # this package exposes a warm interface yet
    warm_start: bool = True
    # Newton-Schulz continuation of the JAX package (greens.py:1006-1250)
    # is accepted as a knob; this package runs the batched LU for every
    # value until a measurement on the card shows continuation pays
    continuation: object = "contour"
    chain_steps: int = 0               # inert (continuation steps)


def replace(cfg, **kwargs):
    """Functional update helper for the frozen configs."""
    return dataclasses.replace(cfg, **kwargs)
