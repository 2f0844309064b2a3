"""gaunegf_tpu_torch: the PyTorch/CUDA port of gaunegf_tpu.

A second package beside the JAX reference ``gaunegf_tpu``, with the same
module paths, names, physics and accuracy contracts.  The port grows one
slice at a time (ROADMAP.md); this slice carries the biased NEGFE density
build on the LU route, whose panel-strip eliminations run on a CUDA kernel
written for Hopper (ops/kernels/strip_elim.py, csrc/strip_elim.cu).

Imports torch, numpy and scipy, never JAX.  Every engine and driver takes
an explicit ``device``.
"""

__version__ = "0.1.0"

from gaunegf_tpu_torch.config import (                            # noqa: F401
    ExecutionConfig, IntegrationConfig, SCFConfig, SurfaceConfig)
