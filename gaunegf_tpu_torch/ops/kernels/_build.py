"""Build and load the package's CUDA kernels.

Each kernel is CUDA C++ under ``gaunegf_tpu_torch/csrc/`` with a plain C
interface.  At first use it is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``gaunegf_tpu_torch/_build/``
and loaded with ``ctypes``.  The library's file name carries a digest of
its sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  Nothing is built or imported when this module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> its CUDA sources under csrc/
LIBRARIES = {
    "strip_elim": ("strip_elim.cu",),
    "panel_fused": ("panel_fused.cu",),
    "panel_lu": ("panel_lu.cu",),
    "fixed_point": ("fixed_point.cu",),
    "sancho_rubio": ("sancho_rubio.cu",),
}

BUILD_LOGS: dict[str, str] = {}     # library name -> nvcc's output
_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str | None:
    """nvcc from CUDA_HOME / CUDA_PATH, then PATH, then DEFAULT_NVCC."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return DEFAULT_NVCC if os.path.isfile(DEFAULT_NVCC) else None


def _target(name: str) -> tuple[Path, list[Path]]:
    paths = [CSRC_DIR / s for s in LIBRARIES[name]]
    h = hashlib.blake2b(" ".join(NVCC_FLAGS).encode(), digest_size=8)
    for p in paths:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()}.so", paths


def build_libraries(names=tuple(LIBRARIES)) -> dict[str, ctypes.CDLL]:
    """Compile every named library not built yet -- one nvcc process per
    library, all started together -- then load them.  Raises
    RuntimeError when nvcc is missing or any build fails."""
    procs = {}
    for name in names:
        if name in _LIBS:
            continue
        target, paths = _target(name)
        if target.exists():
            continue
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                f"building the CUDA kernel {name!r} needs nvcc (the CUDA "
                "toolkit); none was found under CUDA_HOME, CUDA_PATH, PATH "
                "or /usr/local/cuda")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        procs[name] = (target, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (target, tmp, proc) in procs.items():
        BUILD_LOGS[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name!r} (exit "
                          f"{proc.returncode}):\n{BUILD_LOGS[name]}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_target(name)[0]))
    return {name: _LIBS[name] for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``LIBRARIES[name]`` into lib<name>_<digest>.so (once) and
    load it.  Raises RuntimeError when nvcc is missing or fails."""
    return build_libraries((name,))[name]
