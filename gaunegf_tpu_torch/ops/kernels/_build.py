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


def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Compile ``csrc/<sources>`` into lib<name>_<digest>.so (once) and
    load it.  Raises RuntimeError when nvcc is missing or fails."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    paths = [CSRC_DIR / s for s in sources]
    h = hashlib.blake2b(" ".join(NVCC_FLAGS).encode(), digest_size=8)
    for p in paths:
        h.update(p.read_bytes())
    target = BUILD_DIR / f"lib{name}_{h.hexdigest()}.so"
    if not target.exists():
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                f"building the CUDA kernel {name!r} needs nvcc (the CUDA "
                "toolkit); none was found under CUDA_HOME, CUDA_PATH, PATH "
                "or /usr/local/cuda")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)],
            capture_output=True, text=True)
        BUILD_LOGS[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name!r} "
                               f"(exit {proc.returncode}):\n{BUILD_LOGS[name]}")
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    _LIBS[name] = lib
    return lib
