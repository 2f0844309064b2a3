"""SCF checkpoint / result export.

Reproduces the reference's four persistence layers (SURVEY.md section 5):
1. density checkpoints  <name>_P.mat, promoted to <name>_Final.mat on
   convergence (scf.py:744-799)
2. transmission/DOS/current resumable npz sweeps  (transport; not yet
   ported to this package)
3. final results export saveMAT                    (scf.py:823-843)
4. backend-native checkpoints (e.g. Gaussian .chk) -- delegated to the
   FockProvider.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.io


def save_density(path: str, P, conv: float) -> None:
    scipy.io.savemat(path, {"den": np.asarray(P), "conv": conv})


def load_density(path: str):
    d = scipy.io.loadmat(path)
    return np.asarray(d["den"]), float(np.ravel(d.get("conv", [np.inf]))[0])


def promote_final(checkpoint_path: str, final_path: str) -> None:
    if os.path.exists(checkpoint_path):
        os.replace(checkpoint_path, final_path)


def save_results(path: str, *, F, sig1, sig2, S, fermi, qV, spin, P, conv):
    """saveMAT-compatible export (scf.py:823-843 key set)."""
    scipy.io.savemat(path, {
        "F": np.asarray(F), "sig1": np.asarray(sig1),
        "sig2": np.asarray(sig2), "S": np.asarray(S),
        "fermi": fermi, "qV": qV, "spin": spin,
        "den": np.asarray(P), "conv": conv,
    })


def load_results(path: str) -> dict:
    return scipy.io.loadmat(path)
