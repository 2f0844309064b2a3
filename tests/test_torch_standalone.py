"""gaunegf_tpu_torch stands alone: it imports without JAX and names none."""

import pathlib
import re
import subprocess
import sys

import pytest

PORT = pathlib.Path(__file__).resolve().parents[1] / "gaunegf_tpu_torch"
SLICE_MODULES = [
    "gaunegf_tpu_torch", "gaunegf_tpu_torch.config", "gaunegf_tpu_torch.units",
    "gaunegf_tpu_torch.quadrature", "gaunegf_tpu_torch.ops.kernels._build",
    "gaunegf_tpu_torch.ops.kernels.strip_elim",
    "gaunegf_tpu_torch.ops.kernels.panel_fused",
    "gaunegf_tpu_torch.ops.kernels.panel_lu",
    "gaunegf_tpu_torch.models.chain1d", "gaunegf_tpu_torch.transport",
    "gaunegf_tpu_torch.ops.zlinalg", "gaunegf_tpu_torch.models.selfenergy",
    "gaunegf_tpu_torch.models.fock", "gaunegf_tpu_torch.ops.spectral",
    "gaunegf_tpu_torch.ops.greens",
    "gaunegf_tpu_torch.density", "gaunegf_tpu_torch.io.checkpoint",
    "gaunegf_tpu_torch.scf", "gaunegf_tpu_torch.scfe",
    "gaunegf_tpu_torch.interop", "gaunegf_tpu_torch.tune",
]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_imports_with_jax_absent(module):
    """sys.modules['jax'] = None makes any `import jax` raise."""
    code = ("import sys; sys.modules['jax'] = None; "
            f"import importlib; importlib.import_module({module!r}); "
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m, v in sys.modules.items() if v is not None)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=str(PORT.parent))
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_in_source():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    offenders = [str(p) for p in PORT.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
