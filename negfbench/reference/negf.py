"""Dense complex128 NEGF: densities, T(E), Emin, the mean-field Fock matrix
and the SCF's density mixing, each worked out again from the benchmark's
inputs.

Every function takes its precision as ``dtype`` (complex128, or complex64
and float32 for the control that stands in for the program in the next
precision down).  Green's functions come from ``torch.linalg.solve`` on
the dense (b, N, N) operator E S - F - Sigma(E), in chunks of energies.
"""

from __future__ import annotations

import numpy as np
import torch

def _chunk(N):
    """Energies a chunk: three (b, N, N) complex128 operands stay near
    4 GB."""
    return max(1, min(64, (4 << 30) // (16 * N * N * 3)))


def density(F, S, sigmas, grids, device, dtype=torch.complex128,
            window_support=None):
    """The density matrix on ``grids`` ([(E, w, kind)], kind 'eq' or
    'window'; see quadrature.density_grids).  sigmas(E) -> [(b, N, N)]
    per contact, complex128 on ``device``.  'eq' adds Im(sum w G); 'window'
    adds sum w G Gamma G+ with Gamma the last contact's, restricted to
    ``window_support`` (orbital indices) where given."""
    N = np.shape(F)[0]
    Fd = torch.as_tensor(np.asarray(F), device=device).to(dtype)
    Sd = torch.as_tensor(np.asarray(S), device=device).to(dtype)
    eye = torch.eye(N, dtype=dtype, device=device)
    P = torch.zeros((N, N), dtype=dtype, device=device)
    step = _chunk(N)
    for E, w, kind in grids:
        for i in range(0, len(E), step):
            E128 = torch.as_tensor(np.asarray(E[i:i + step], complex),
                                   device=device)
            Eb = E128.to(dtype)
            wb = torch.as_tensor(np.asarray(w[i:i + step]),
                                 device=device).to(dtype)
            sig = [s.to(dtype) for s in sigmas(E128)]
            A = Eb[:, None, None] * Sd - Fd - sum(sig)
            if kind == "eq":
                G = torch.linalg.solve(A, eye.expand(A.shape).contiguous())
                P += (wb[:, None, None] * G).sum(0).imag.to(dtype)
                continue
            gam = 1j * (sig[-1] - sig[-1].conj().transpose(1, 2))
            rhs = eye
            if window_support is not None:
                c = torch.as_tensor(np.asarray(window_support), device=device)
                gam = gam[:, c[:, None], c[None, :]]
                rhs = eye[:, c]
            G = torch.linalg.solve(A, rhs.expand(len(Eb), *rhs.shape)
                                   .contiguous())
            P += (wb[:, None, None]
                  * (G @ gam @ G.conj().transpose(1, 2))).sum(0)
    return P.cpu().numpy()


def transmission(F, S, sigmas, E, device, dtype=torch.complex128):
    """T(E) = Tr[Gamma_1 G Gamma_2 G+] at the real energies E."""
    N = np.shape(F)[0]
    Fd = torch.as_tensor(np.asarray(F), device=device).to(dtype)
    Sd = torch.as_tensor(np.asarray(S), device=device).to(dtype)
    eye = torch.eye(N, dtype=dtype, device=device)
    out = []
    step = _chunk(N)
    E = np.asarray(E, dtype=complex)
    for i in range(0, len(E), step):
        Eb = torch.as_tensor(E[i:i + step], device=device)
        sig = [s.to(dtype) for s in sigmas(Eb)]
        Eb = Eb.to(dtype)
        A = Eb[:, None, None] * Sd - Fd - sum(sig)
        G = torch.linalg.solve(A, eye.expand(A.shape).contiguous())
        g1 = 1j * (sig[0] - sig[0].conj().transpose(1, 2))
        g2 = 1j * (sig[-1] - sig[-1].conj().transpose(1, 2))
        T = torch.einsum("bij,bji->b", g1 @ G, g2 @ G.conj().transpose(1, 2))
        out.append(T.real.cpu().numpy())
    return np.concatenate(out)


def emin(F, S, sigma_total_at, tol=1e-3, max_n=1000):
    """The lower end of the contour: the least eigenvalue of the pencil
    less 5 eV, walked down 1 eV at a time until the DOS there is below
    ``tol``.  sigma_total_at(E) -> the (N, N) total self-energy."""
    F, S = np.asarray(F), np.asarray(S)
    E = float(np.min(np.linalg.eigvalsh(np.linalg.solve(S, F)).real)) - 5

    def dos(e):
        G = np.linalg.inv(e * S - F - sigma_total_at(e))
        return float(-np.imag(np.trace(G)) / np.pi)
    n = 0
    while dos(E) > tol and n < max_n:
        E -= 1
        n += 1
    return E


def mean_field_fock(H0, U, n0, S, P, dtype=np.float64):
    """F[P] = H0 + U diag(Re diag(P S) - n0): the restricted on-site
    mean field of a tight-binding junction."""
    real = np.float32 if dtype == np.float32 else np.float64
    P = np.asarray(P).astype(np.complex64 if real is np.float32
                             else np.complex128)
    occ = np.real(np.einsum("ij,ji->i", P, np.asarray(S).astype(real)))
    return np.asarray(H0).astype(real) + np.diag(
        (np.asarray(U) * (occ - np.asarray(n0))).astype(real))


def aufbau_density(H0, S, n_electrons, dtype=np.float64):
    """The lowest round(n_electrons / 2) states of the pencil, filled."""
    import scipy.linalg
    w, v = scipy.linalg.eigh(np.asarray(H0).astype(dtype),
                             np.asarray(S).astype(dtype))
    occ = int(round(n_electrons / 2))
    return v[:, :occ] @ v[:, :occ].T


def mix_step(P_back, P_new, p_list, dp_list, p_mat, p_b, damping, pulay,
             dtype=np.complex128):
    """The SCF's mixed density, one step from the mixer's state: the
    damped step P_back + damping (P_new - P_back) joins the window of
    candidates and P_new - P_back the window of residuals; the DIIS Gram
    matrix gains the new residual's unconjugated products; on a Pulay
    cycle the candidates combine by the DIIS weights unless the system is
    singular or the weights are not finite or sum over 1e3 in magnitude,
    and otherwise the damped step is taken."""
    c = lambda x: np.asarray(x).astype(dtype)
    P_back, P_new = c(P_back), c(P_new)
    p_list = [P_back + damping * (P_new - P_back)] + [c(p)
                                                      for p in p_list[:-1]]
    dp = P_new - P_back
    dp_list = [dp] + [c(v) for v in dp_list[:-1]]
    w = len(dp_list)
    p_mat = c(p_mat).copy()
    p_mat[1:w, 1:w] = p_mat[:w - 1, :w - 1].copy()
    row = np.array([np.sum(dp * v) for v in dp_list])
    p_mat[0, :w] = row
    p_mat[1:w, 0] = row[1:]
    if pulay:
        try:
            coeff = np.linalg.solve(p_mat, c(p_b))[:-1]
        except np.linalg.LinAlgError:
            coeff = None
        if coeff is not None and np.all(np.isfinite(coeff)) \
                and np.sum(np.abs(coeff)) < 1e3:
            return sum(p_list[i] * coeff[i] for i in range(len(coeff)))
    return p_list[0]
