"""gaunegf_tpu_torch: the PyTorch/CUDA port of gaunegf_tpu.

A second package beside the JAX reference ``gaunegf_tpu``, with the same
module paths, names, physics and accuracy contracts.  The port grows one
slice at a time (ROADMAP.md).  It carries the NEGF / NEGFE SCF cycle with
every density route and Fermi search, and the transport that follows it,
for the four spin layouts, with constant, 1D-chain, Bethe-lattice and
3D-lattice electrodes, on the spectral route and on the blocked LU,
whose panel factorizations run on CUDA kernels written for Hopper
(ops/kernels/, csrc/), and the Gaussian bridge (io/gaussian,
models/fock.GaussianFock) under the reference-named facade (compat/).

Imports torch, numpy and scipy, never JAX.  Every engine and SCF class takes
an explicit ``device``; the facade holds one ('cuda' unless asked).  The
engines and drivers shard over an ('e', 'm') mesh of torch.distributed
ranks (``energy_mesh``, parallel/mesh.py) where one is given.
"""

__version__ = "0.1.0"

from gaunegf_tpu_torch.config import (                            # noqa: F401
    ExecutionConfig, IntegrationConfig, SCFConfig, SurfaceConfig)
from gaunegf_tpu_torch.parallel.mesh import energy_mesh  # noqa: F401


# the JAX package's lazily importable submodules: gaunegf_tpu_torch.transport
# etc. without an import statement of their own
_SUBMODULES = ("transport", "density", "fermi", "quadrature", "scf", "scfe",
               "spin", "units", "models", "ops", "parallel", "io",
               "fermi_search_dos")


def __getattr__(name):
    """Lazy submodule access: gaunegf_tpu_torch.transport etc."""
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f"gaunegf_tpu_torch.{name}")
    raise AttributeError(
        f"module 'gaunegf_tpu_torch' has no attribute {name!r}")
