"""Multi-device execution over torch.distributed (mesh.py, launch.py)."""

from gaunegf_tpu_torch.parallel.mesh import (  # noqa: F401
    EnergyMesh, energy_mesh, local_device_count)
