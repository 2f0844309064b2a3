"""Batched complex dense linear algebra: the blocked LU of the fast and
mixed tiers.

Port of the part of ``gaunegf_tpu/ops/zlinalg.py`` that the density
build runs.  Every G(E) of the complex64 tiers is solved by a hand-built
right-looking blocked LU with partial pivoting:

* panel factorization by strips (``_factor_panel_scan``): each 32-column
  strip of the transposed panel is eliminated by the strip kernel
  (ops/kernels/strip_elim.py -- CUDA on the card, its plain PyTorch
  version on the CPU), and the deferred update of the panel's later
  columns runs as index gathers and small batched products;
* pivoting applied to the rest of the matrix as one gather per panel;
* the L11 and U11 triangular solves by ``torch.linalg.solve_triangular``,
  trailing updates by ``torch.matmul``, with forward substitution fused
  into the sweep through an augmented ``[A | B]`` working matrix.

All functions take a batch dimension written out: A is (B, N, N).
``method=None`` means the blocked LU for complex64 on any device;
``torch.linalg.solve`` ('lapack') is an explicit opt-in, and the default
only for complex128.  Precision tiers:

* 'fast'   : complex64 blocked LU.
* 'mixed'  : complex64 blocked LU + Newton refinement of the inverse whose
             residual I - A X is computed in native complex128 against the
             complex128 operator (the JAX package forms a complex64 A and
             emulates the residual product with split f32 products).
"""

from __future__ import annotations

import torch

from gaunegf_tpu_torch.ops.kernels.strip_elim import eliminate_strip

__all__ = ["zsolve", "zinv", "zinv_refined", "zlu_factor", "zlu_solve",
           "fractional_matrix_power"]

PANEL_SPLIT_BASE = 32       # strip width of the strip-scanned panel

# panel names of the JAX package that this package does not implement,
# with the ROADMAP item that ports each
_UNPORTED_PANELS = {
    "fused": "ROADMAP section 2a, item 2 (panel_fused.factor_panel_fused)",
    "fused3": "ROADMAP section 2a, item 2 (panel_fused.factor_panel_fused)",
    "pallas": "ROADMAP section 2a, item 3 (panel_lu.factor_panel_pallas)",
    "split": "ROADMAP section 1, item 2 (remaining XLA panel variants)",
    "psplit": "ROADMAP section 1, item 2 (remaining XLA panel variants)",
    "virtual": "ROADMAP section 1, item 2 (remaining XLA panel variants)",
    "xla": "ROADMAP section 1, item 2 (remaining XLA panel variants)",
}


# ---------------------------------------------------------------------------
# Panel factorization
# ---------------------------------------------------------------------------

def _factor_panel_scan(panel, base: int = PANEL_SPLIT_BASE):
    """Strip-scanned panel factorization of a batch of (m, bs) panels.

    Virtual pivoting on the transposed (bs, m) layout: each ``base``-row
    strip is eliminated by the strip kernel, then the panel's later rows
    receive the strip's deferred update.  With the strip's pivot lanes
    piv and multipliers Lm (zero at used lanes), G = strip[:, piv] gives
    the unit upper L11^T, and for the later rows U_raw = pt[:, piv]:
    W = U_raw (L11^T)^-1, pt -= W Lm, and the pivot lanes take W -- the
    JAX package's one-hot contractions, here as exact index gathers.
    Panels of at most one strip are one strip.

    Returns (packed (B, m, bs) in pivoted row order, perm (B, m) int64):
    pivot rows first in elimination order, then the untouched rows in
    ascending order, exactly the partial-pivot sequence."""
    nb, m, bs = panel.shape
    pt = panel.transpose(1, 2).contiguous()          # (B, bs, m)
    avail = torch.ones((nb, m), dtype=torch.bool, device=panel.device)
    pivrows = torch.empty((nb, bs), dtype=torch.int64, device=panel.device)
    width = base if bs % base == 0 and bs // base >= 2 else bs
    for s0 in range(0, bs, width):
        s1 = s0 + width
        sb, piv32, avail = eliminate_strip(pt[:, s0:s1], avail)
        pt[:, s0:s1] = sb
        piv = piv32.to(torch.int64)
        pivrows[:, s0:s1] = piv
        if s1 == bs:
            break
        later = pt[:, s1:]                              # (B, bs - s1, m)
        G = sb.gather(2, piv[:, None, :].expand(nb, width, width))
        U_raw = later.gather(2, piv[:, None, :].expand(nb, bs - s1, width))
        # W L11^T = U_raw with L11^T = triu(G, 1) + I (unit upper)
        W = torch.linalg.solve_triangular(G, U_raw, upper=True, left=False,
                                          unitriangular=True)
        Lm = torch.where(avail[:, None, :], sb, torch.zeros_like(sb))
        later = later - torch.matmul(W, Lm)
        later.scatter_(2, piv[:, None, :].expand(nb, bs - s1, width), W)
        pt[:, s1:] = later
    # available lanes in ascending order follow the pivots
    rest = torch.argsort((~avail).to(torch.int8), dim=1,
                         stable=True)[:, :m - bs]
    perm = torch.cat([pivrows, rest], dim=1)
    packed = pt.gather(2, perm[:, None, :].expand(nb, bs, m)).transpose(1, 2)
    return packed, perm


def _pick_panel(N: int, panel_impl: str | None) -> str:
    """Resolve a panel name: 'auto', 'scan' and 'pstrip' all name the
    strip-scanned panel, whose strips run on the strip kernel (the JAX
    package's 'scan' and 'pstrip' differ only in who runs the strip loop);
    the other JAX names raise NotImplementedError."""
    if panel_impl in (None, "auto", "scan", "pstrip"):
        return "pstrip"
    if panel_impl in _UNPORTED_PANELS:
        raise NotImplementedError(
            f"lu_panel={panel_impl!r} is not ported yet: "
            f"{_UNPORTED_PANELS[panel_impl]}")
    raise ValueError(f"unknown lu_panel {panel_impl!r}")


def _dispatch_panel(panel, panel_impl: str):
    """Panel factorization by resolved panel name (one place to add one)."""
    if panel_impl == "pstrip":
        return _factor_panel_scan(panel)
    raise ValueError(f"unresolved panel name {panel_impl!r}")


# ---------------------------------------------------------------------------
# Blocked solve: right-looking LU fused with forward substitution
# ---------------------------------------------------------------------------

def _pick_block(N: int, bs: int | None) -> int:
    """Largest power of two <= min(requested, ~N), floor 8.

    bs None/0 = auto: config.LU_BLOCK_SIZE if set, else 256 from N=1000 up
    and 128 below (PERF.md's sweep on the H100; below N=1000 a 256 panel
    pads too much).  Small matrices get small panels so the sequential
    loops do not run on padding."""
    if bs is None:
        from gaunegf_tpu_torch.config import LU_BLOCK_SIZE
        bs = LU_BLOCK_SIZE
    if not bs:
        bs = 256 if N >= 1000 else 128
    cap = min(bs, max(N, 8))
    b = 8
    while b * 2 <= cap:
        b *= 2
    return b


def _pad_to(A, Np):
    """Pad (B, N, N) A -> block-diag(A, I); the padding factors trivially."""
    N = A.shape[-1]
    if Np == N:
        return A
    out = torch.zeros(A.shape[:-2] + (Np, Np), dtype=A.dtype, device=A.device)
    out[..., :N, :N] = A
    idx = torch.arange(N, Np, device=A.device)
    out[..., idx, idx] = 1.0
    return out


def _gather_rows(X, perm):
    """X[b, perm[b], :] for a batch: the panel's pivots as one gather."""
    return X.gather(1, perm[:, :, None].expand(-1, -1, X.shape[-1]))


def _zsolve_single(A, B, bs: int, panel_impl: str):
    """Solve A X = B for a batch of (N, N) complex matrices, (N, k) RHS.

    The working matrix [A | B] shrinks panel by panel.  Per panel: the
    pivoted panel factorization, one permutation gather, the unit-lower
    L11 solve giving the U12 rows (with the forward-substituted RHS), and
    the trailing update.  Backward substitution solves the saved U11
    blocks."""
    N = A.shape[-1]
    k = B.shape[-1]
    n_pad = (-N) % bs
    Np = N + n_pad
    A = _pad_to(A, Np)
    nb = Np // bs
    if n_pad:
        B = torch.cat([B, B.new_zeros(B.shape[0], n_pad, k)], dim=1)
    work = torch.cat([A, B], dim=2)                  # (b, Np, Np + k)

    heads, u_rows = [], []
    for kb in range(nb):
        panel, perm = _dispatch_panel(work[:, :, :bs], panel_impl)
        rest = _gather_rows(work[:, :, bs:], perm)
        head = panel[:, :bs]                         # L11 (unit) and U11
        U12R = torch.linalg.solve_triangular(head, rest[:, :bs], upper=False,
                                             unitriangular=True)
        heads.append(head)
        u_rows.append(U12R)
        if kb < nb - 1:
            work = rest[:, bs:] - torch.matmul(panel[:, bs:], U12R)

    X = None
    for ib in range(nb - 1, -1, -1):
        row = u_rows[ib]                             # (b, bs, rest_ib + k)
        acc = row[:, :, -k:]
        if X is not None:
            acc = acc - torch.matmul(row[:, :, :X.shape[1]], X)
        Xi = torch.linalg.solve_triangular(heads[ib], acc, upper=True)
        X = Xi if X is None else torch.cat([Xi, X], dim=1)
    return X[:, :N]


def _zlu_factor_single(A, bs: int, panel_impl: str):
    """Factor a batch of (N, N) matrices into reusable blocked-LU pieces:
    per panel (perm, the packed L11\\U11 head, L21, U12 rows), so any
    number of later right-hand sides cost O(N^2 k) each."""
    N = A.shape[-1]
    Np = N + (-N) % bs
    A = _pad_to(A, Np)
    nb = Np // bs
    perms, heads, l21s, u_rows = [], [], [], []
    work = A
    for kb in range(nb):
        panel, perm = _dispatch_panel(work[:, :, :bs], panel_impl)
        rest = _gather_rows(work[:, :, bs:], perm)
        head = panel[:, :bs]
        U12 = torch.linalg.solve_triangular(head, rest[:, :bs], upper=False,
                                            unitriangular=True)
        perms.append(perm)
        heads.append(head)
        l21s.append(panel[:, bs:])
        u_rows.append(U12)
        if kb < nb - 1:
            work = rest[:, bs:] - torch.matmul(panel[:, bs:], U12)
    return {"perms": perms, "heads": heads, "l21s": l21s, "u_rows": u_rows}


def _zlu_solve_single(data, B, N: int, bs: int):
    """Solve with saved factors: forward substitution panel by panel, then
    the backward pass over the U11 blocks."""
    k = B.shape[-1]
    nb = len(data["perms"])
    Np = nb * bs
    if Np != N:
        B = torch.cat([B, B.new_zeros(B.shape[0], Np - N, k)], dim=1)
    ys = []
    work = B
    for kb in range(nb):
        rest = _gather_rows(work, data["perms"][kb])
        y = torch.linalg.solve_triangular(data["heads"][kb], rest[:, :bs],
                                          upper=False, unitriangular=True)
        ys.append(y)
        if kb < nb - 1:
            work = rest[:, bs:] - torch.matmul(data["l21s"][kb], y)
    X = None
    for ib in range(nb - 1, -1, -1):
        acc = ys[ib]
        if X is not None:
            acc = acc - torch.matmul(data["u_rows"][ib][:, :, :X.shape[1]], X)
        Xi = torch.linalg.solve_triangular(data["heads"][ib], acc, upper=True)
        X = Xi if X is None else torch.cat([Xi, X], dim=1)
    return X[:, :N]


def _flat(A):
    """(..., N, N) -> (B, N, N) plus the leading shape to restore."""
    return A.reshape((-1,) + A.shape[-2:]), A.shape[:-2]


def _resolve_method(A, method: str | None) -> str:
    if method is None:
        return "blocked" if A.dtype == torch.complex64 else "lapack"
    if method not in ("blocked", "lapack"):
        raise ValueError(f"unknown method {method!r}")
    return method


def zsolve(A, B, *, method: str | None = None, bs: int | None = None,
           panel_impl: str = "auto", trail: str = "hi"):
    """Solve A X = B for batched complex A (..., N, N), B (..., N, k).

    method: None (blocked for complex64, 'lapack' otherwise), 'blocked' or
    'lapack' (torch.linalg.solve).  trail is accepted and inert (it sets
    the TPU matrix-unit pass count in the JAX package)."""
    if _resolve_method(A, method) == "lapack":
        # a materialized B: LAPACK rejects the zero strides of an expand()
        return torch.linalg.solve(A, B.contiguous())
    N = A.shape[-1]
    bs = _pick_block(N, bs)
    panel_impl = _pick_panel(N, panel_impl)
    Af, lead = _flat(A)
    Bf = B.expand(lead + B.shape[-2:]).reshape((-1,) + B.shape[-2:])
    X = _zsolve_single(Af, Bf.to(A.dtype), bs, panel_impl)
    return X.reshape(lead + X.shape[-2:])


def zinv(A, *, method: str | None = None, bs: int | None = None,
         panel_impl: str = "auto", trail: str = "hi"):
    """Batched complex inverse (reference utils.py:52-54 ``inv``)."""
    N = A.shape[-1]
    eye = torch.eye(N, dtype=A.dtype, device=A.device)
    return zsolve(A, eye.expand(A.shape), method=method, bs=bs,
                  panel_impl=panel_impl, trail=trail)


def zlu_factor(A, *, bs: int | None = None, panel_impl: str = "auto",
               trail: str = "hi"):
    """Blocked-LU factorization with reusable factors of a batch
    (B, N, N).  Returns {"data": per-panel tensors, "N", "bs"}."""
    N = A.shape[-1]
    bs = _pick_block(N, bs)
    panel_impl = _pick_panel(N, panel_impl)
    return {"data": _zlu_factor_single(A, bs, panel_impl), "N": N, "bs": bs}


def zlu_solve(factors, B):
    """Solve A X = B (B: (B, N, k)) from zlu_factor output."""
    return _zlu_solve_single(factors["data"], B, factors["N"], factors["bs"])


def zinv_refined(A, *, steps: int = 2, method: str | None = None,
                 bs: int | None = None, panel_impl: str = "auto",
                 trail: str = "hi"):
    """Inverse with Newton refinement: X <- X + X (I - A X).

    The seed is the complex64 inverse of A; the residual I - A X is
    computed in complex128 against A itself, so a complex128 A (the
    operator as assembled in double precision) is inverted to the
    complex64 storage floor, not to the rounding of its complex64 copy.
    Each step roughly squares the seed's error; the correction X R is a
    complex64 product (R is already small).  A batch element whose
    residual reaches 0.5 (kappa ~ 1/eps32) keeps its seed: a Newton step
    would amplify noise there.  Returns complex64."""
    X = zinv(A.to(torch.complex64), method=method, bs=bs,
             panel_impl=panel_impl, trail=trail)
    if not steps:
        return X
    A_hi = A.to(torch.complex128)
    eye = torch.eye(A.shape[-1], dtype=torch.complex128, device=A.device)
    for _ in range(steps):
        R = eye - torch.matmul(A_hi, X.to(torch.complex128))
        ok = R.abs().amax(dim=(-2, -1)) < 0.5
        X = torch.where(ok[..., None, None],
                        X + torch.matmul(X, R.to(X.dtype)), X)
    return X


def fractional_matrix_power(S, power):
    """S^power by Hermitian eigendecomposition; parity with utils.py:12-48.

    Eigenvalues are clamped at 1e-16 exactly as the reference does."""
    eigenvalues, eigenvectors = torch.linalg.eigh(S)
    eigenvalues = torch.clamp(eigenvalues, min=1e-16)
    powered = torch.pow(eigenvalues, power).to(eigenvectors.dtype)
    return (eigenvectors * powered[..., None, :]) @ \
        eigenvectors.conj().transpose(-1, -2)
