"""Fock/overlap providers: the backend-agnostic replacement for Gaussian.

Pure NumPy, copied from ``gaunegf_tpu/models/fock.py`` (that package's
``__init__`` imports JAX, so this package keeps its own copy):

* TightBindingFock  -- synthetic mean-field TB model (testable SCF without
  any quantum-chemistry code; the reference's test strategy, SURVEY.md section 4)
* MatrixFock        -- fixed matrices from arrays / .mat / .npz files

The Gaussian adapter (GaussianFock) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Protocol, Tuple, runtime_checkable

import numpy as np

__all__ = ["FockProvider", "TightBindingFock", "MatrixFock"]


@runtime_checkable
class FockProvider(Protocol):
    """What an SCF driver needs from an electronic-structure backend."""

    n_electrons: float
    locs: np.ndarray          # orbital -> atom map (+/- encodes alpha/beta)
    f_to_eV: float            # unit conversion for returned Fock matrices

    def overlap(self) -> np.ndarray: ...

    def initial_density(self) -> np.ndarray: ...

    def initial_fock(self) -> np.ndarray: ...

    def fock(self, P: np.ndarray) -> Tuple[np.ndarray, float]:
        """Build F[P]; returns (F, total_energy)."""
        ...

    def store_density(self, P: np.ndarray) -> None: ...

    def atom_coords(self) -> Optional[np.ndarray]: ...

    def set_field(self, field) -> None: ...


class TightBindingFock:
    """Mean-field tight-binding backend.

    Restricted ('r'): F[P] = H0 + U * diag(occ - n0) -- an on-site
    Hubbard-like mean field so the SCF loop has genuine self-consistency.
    Unrestricted ('u'/'ro'): the 2N block-diagonal layout of the reference
    (matTools.getFock blocks), with the proper cross-spin Hubbard field
    F_up = H0 + U diag(n_dn - n0) (and vice versa) plus an optional
    exchange seed splitting to break spin symmetry.
    Generalized ('g'): spinor-interleaved 2N layout ([a0, b0, a1, b1, ...],
    matTools.py:163 convention) with an optional transverse exchange field
    (spin-x seed) so non-collinear densities develop.
    With U = 0 the Fock matrix is density-independent (one-shot NEGF).
    Energies in eV (f_to_eV = 1).
    """

    f_to_eV = 1.0

    def __init__(self, H0, S=None, n_electrons=None, U=0.0, n0=None,
                 coords=None, locs=None, spin="r", exchange=0.0,
                 multiplicity=1):
        self.H0 = np.asarray(H0, dtype=float)
        n = self.H0.shape[0]
        self.n_orb = n
        self.S1 = np.eye(n) if S is None else np.asarray(S, dtype=float)
        # scalar or per-orbital Hubbard U
        self.U = np.asarray(U, dtype=float)
        self.exchange = float(exchange)
        self.n0 = np.zeros(n) if n0 is None else np.asarray(n0, dtype=float)
        self.n_electrons = float(n // 2 if n_electrons is None else n_electrons)
        self.spin = spin
        self.multiplicity = multiplicity
        self._coords = None if coords is None else np.asarray(coords)
        base_locs = np.arange(n) + 1 if locs is None else np.asarray(locs)
        if spin in ("u", "ro"):
            self.locs = np.concatenate([base_locs, -base_locs])
        elif spin == "g":
            self.locs = np.array(
                [v for pair in zip(base_locs, -base_locs) for v in pair])
        else:
            self.locs = base_locs
        self.field = np.zeros(3)

    @property
    def S(self):
        if self.spin in ("u", "ro"):
            Z = np.zeros_like(self.S1)
            return np.block([[self.S1, Z], [Z, self.S1]])
        if self.spin == "g":
            return np.kron(self.S1, np.eye(2))
        return self.S1

    def overlap(self):
        return self.S

    def initial_fock(self):
        if self.spin in ("u", "ro"):
            Z = np.zeros_like(self.H0)
            dx = self.exchange / 2 * np.eye(self.n_orb)
            return np.block([[self.H0 - dx, Z], [Z, self.H0 + dx]])
        if self.spin == "g":
            # spinor layout: per-orbital 2x2 blocks; transverse exchange
            # seed -B_x * sigma_x mixes the spin channels (non-collinear)
            sx = np.array([[0.0, 1.0], [1.0, 0.0]])
            return (np.kron(self.H0, np.eye(2))
                    - self.exchange / 2 * np.kron(np.eye(self.n_orb), sx))
        return self.H0.copy()

    def initial_density(self):
        """Aufbau fill of the lowest generalized eigenvectors."""
        import scipy.linalg
        F0 = self.initial_fock()
        w, v = scipy.linalg.eigh(np.real(F0), self.S)
        occ = int(round(self.n_electrons / (2 if self.spin == "r" else 1)))
        vo = v[:, :occ]
        return vo @ vo.conj().T

    def fock(self, P):
        n = self.n_orb
        # diag(A @ B) and trace(A @ B) via einsum: O(N^2), not a full GEMM
        # (the backend Fock rebuild is on the SCF cycle's critical path --
        # at N=2000 the naive np.diag(P @ S) pair cost ~2 s/cycle on this
        # host, e59)
        _diag_mm = lambda A, B: np.einsum("ij,ji->i", A, B)
        _tr_mm = lambda A, B: complex(np.einsum("ij,ji->", A, B))
        if self.spin == "g":
            P = np.asarray(P)
            occ = np.real(_diag_mm(P, self.S))     # per spin-orbital
            occ_orb = occ[0::2] + occ[1::2]        # per orbital (both spins)
            F = self.initial_fock().astype(complex) + np.kron(
                np.diag(self.U * (occ_orb - 2 * self.n0)), np.eye(2))
            E = float(np.real(_tr_mm(P, self.initial_fock() + F)) / 2)
            return F, E
        if self.spin in ("u", "ro"):
            P = np.asarray(P)
            occ_up = np.real(_diag_mm(P[:n, :n], self.S1))
            occ_dn = np.real(_diag_mm(P[n:, n:], self.S1))
            dx = self.exchange / 2 * np.eye(n)
            Fu = self.H0 - dx + np.diag(self.U * (occ_dn - self.n0))
            Fd = self.H0 + dx + np.diag(self.U * (occ_up - self.n0))
            Z = np.zeros_like(Fu)
            F = np.block([[Fu, Z], [Z, Fd]])
            E = float(np.real(_tr_mm(P, self.initial_fock() + F)) / 2)
            return F, E
        P = np.asarray(P)
        occ = np.real(_diag_mm(P, self.S1))
        F = self.H0 + np.diag(self.U * (occ - self.n0))
        # mean-field total energy: Tr[P (H0 + F)] / 2 (double-count corrected)
        E = float(np.real(np.einsum("ij,ji->", P, self.H0 + F)))
        E = E / 2
        spin_factor = 2.0 if self.spin == "r" else 1.0
        return F, spin_factor * E

    def store_density(self, P):
        self._P = np.asarray(P)

    def stored_density(self):
        return getattr(self, "_P", None)

    def atom_coords(self):
        return self._coords

    def set_field(self, field):
        self.field = np.asarray(field)


class MatrixFock:
    """Fixed-matrix backend (no self-consistency): F and S from arrays or a
    .mat/.npz file -- covers the reference's saveMAT round trip
    (transport.currentF, transport.py:847-875)."""

    f_to_eV = 1.0

    def __init__(self, F=None, S=None, P=None, n_electrons=None,
                 filename=None, locs=None):
        if filename is not None:
            if filename.endswith(".npz"):
                d = np.load(filename)
            else:
                import scipy.io
                d = scipy.io.loadmat(filename)
            F = np.asarray(d["F"])
            S = np.asarray(d["S"])
            P = np.asarray(d["den"]) if "den" in d else None
        self.F0 = np.asarray(F, dtype=complex)
        self.S = np.eye(len(self.F0)) if S is None else np.asarray(S)
        self._P0 = P
        n = self.F0.shape[0]
        self.n_electrons = float(n // 2 if n_electrons is None else n_electrons)
        self.locs = (np.arange(n) + 1 if locs is None else np.asarray(locs))

    def overlap(self):
        return self.S

    def initial_fock(self):
        return self.F0.copy()

    def initial_density(self):
        if self._P0 is not None:
            return np.asarray(self._P0)
        import scipy.linalg
        w, v = scipy.linalg.eigh(np.real(self.F0), self.S)
        occ = int(round(self.n_electrons / 2))
        vo = v[:, :occ]
        return vo @ vo.conj().T

    def fock(self, P):
        E = float(np.real(np.einsum("ij,ji->", np.asarray(P), self.F0)))
        return self.F0.copy(), E

    def store_density(self, P):
        self._P = np.asarray(P)

    def atom_coords(self):
        return None

    def set_field(self, field):
        pass
