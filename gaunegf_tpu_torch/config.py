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
# bound of an iterated self-energy (Bethe, k-space) on the high, exact and
# strict tiers, whose contracts a fixed point stopped at 1e-5 would break
TIGHT_CONV = 1e-11
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
    # 'high'   : complex128 throughout, solved by the blocked LU (panel
    #            'pallas', the swap-pivoted panel kernel); the JAX package
    #            emulates it with double-word float32 (~7e-8 contract)
    # 'exact'  : 'high' plus one complex128 Newton step
    # 'strict' : complex128 throughout, solved by torch.linalg.solve
    precision: str = "mixed"
    refine_steps: int = 1   # Newton steps of the mixed tier
    energy_chunk: int = DEFAULT_ENERGY_CHUNK
    lu_block: int = LU_BLOCK_SIZE   # 0 = auto by matrix size
    # panel factorization of the blocked LU, each a hand-written kernel
    # (ops/zlinalg._pick_panel).  complex64 (fast, mixed): 'auto', 'scan'
    # and 'pstrip' name the strip-scanned panel (strips on
    # ops/kernels/strip_elim.py), 'fused' and its alias 'fused3' the fused
    # panel (ops/kernels/panel_fused.py), 'pallas' the swap-pivoted panel
    # (ops/kernels/panel_lu.py).  complex128 (high, exact): 'auto' and
    # 'pallas' name the swap-pivoted panel; other names raise ValueError.
    # The JAX package's XLA panels run as plain PyTorch: 'xla' (row
    # swaps), 'virtual' (virtual pivoting), 'split' (recursive halves) on
    # both dtypes, and 'psplit' ('split' with the strip kernel at its
    # leaves) on complex64.
    lu_panel: str = "auto"
    # inert here: selects the TPU matrix-unit pass count of the trailing
    # updates in the JAX package; torch.matmul runs them in full precision
    lu_trail: str = "hi"
    # energy-grid solver family (ops/greens.EnergyEngine._spectral_runner).
    # 'auto' and 'spectral' run the spectral route (ops/spectral.py: one
    # float64 eigh of the (H, S) pencil per Fock, a rank-k Woodbury
    # correction per energy, complex128 throughout) on the fast and mixed
    # tiers wherever Sigma is a constant background plus a contact block,
    # and the LU route elsewhere; 'lu' = per-point blocked LU always.
    solver: str = "auto"
    # spectral route: points nearer than spectral_dist_f32 to a bare
    # eigenvalue (3x that for G<) run the pole-deflated chain of the
    # spectral_deflate nearest modes; with spectral_deflate=0, points
    # nearer than spectral_dist_lu go to the exact-tier LU.  The near-pole
    # guard of the LU route warns within spectral_dist_f32.
    spectral_dist_f32: float = 1e-4
    spectral_dist_lu: float = 1e-5
    spectral_dw: str = "lite"          # inert: TPU double-word emulation
    spectral_deflate: int = 8
    # inert: the JAX package's choice between a host and a TPU device basis
    # and the device basis's size gate and warm start; here the basis is
    # always one float64 eigh on the engine's device
    spectral_basis: str = "auto"
    spectral_basis_device_min_n: int = 3072
    spectral_warm_basis: bool = False
    # warn when a fast/mixed LU dispatch has real-axis points within
    # spectral_dist_f32 of an eigenvalue of the (H, S) pencil; see
    # EnergyEngine._near_pole_guard
    near_pole_warn: bool = True
    # distribute the LU factorization itself over the mesh's 'm' axis
    # (zlinalg.zsolve_dist: panel-cyclic columns, one broadcast per
    # panel).  Off by default: the replicated LU has no broadcast on its
    # critical path; for N >~ 8k junctions (any N: the solver pads to the
    # panel-cyclic layout).  Without a mesh of more than one 'm' rank it
    # changes nothing.
    distribute_lu: bool = False
    # G< and transmission solve only the contact columns of G (LU cost
    # unchanged, triangular solves shrink N -> nc).  Neglects the
    # -1j*1e-9*S broadening background's Gamma (~1e-9 relative).
    use_lowrank: bool = True
    # warm-start provider fixed points along the grid: the Bethe and
    # 3D-lattice providers expose a warm interface (contacts_warm_apply)
    # and the LU route's sums and T(E) use it below the high tiers,
    # unless the provider sets warm_profitable = False (1D chains);
    # "force" engages them for such a provider too; False gives the cold
    # path
    warm_start: object = True
    # Newton-Schulz continuation (ops/greens.EnergyEngine._chain_sum):
    # along each lane's contiguous, sorted grid segment the neighbouring
    # energy's G seeds a few Newton iterations (batched matmuls) in place
    # of a fresh LU, with a chunk-wide residual gate that sends the first
    # step, resonances, coarse grids and NaNs to the tier's LU.  Below the
    # high tiers: False (off); True (gr_sum on every grid, and the biased
    # density as gr_sum + gless_sum); "contour" (default): only the
    # equilibrium contour of density_eq_split rides the chain, the
    # real-axis segment keeps the batched LU.  The spectral route, the
    # warm engines and a column-sharded mesh take precedence as in the
    # JAX package.  An automatic energy_chunk gives the chain at most 32
    # lanes.
    continuation: object = "contour"
    # plain Newton iterations per continuation step (0 = auto: 2 for
    # 'mixed', whose complex128 polish squares the error once more, 3 for
    # 'fast'; 'strict' takes at least 3)
    chain_steps: int = 0


def replace(cfg, **kwargs):
    """Functional update helper for the frozen configs."""
    return dataclasses.replace(cfg, **kwargs)
