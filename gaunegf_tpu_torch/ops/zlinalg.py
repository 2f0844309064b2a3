"""Batched complex dense linear algebra: the blocked LU of every tier
but 'strict'.

Port of the part of ``gaunegf_tpu/ops/zlinalg.py`` that the density
build and transport run.  Every G(E) of the fast, mixed, high and exact
tiers is solved by a hand-built right-looking blocked LU with partial
pivoting:

* panel factorization chosen by ``lu_panel``, on one of three
  hand-written CUDA kernels (their plain PyTorch versions on the CPU):
  - 'pstrip' (the complex64 default): the strip-scanned panel
    (``_factor_panel_scan``), each 32-column strip of the transposed
    panel eliminated by the strip kernel (ops/kernels/strip_elim.py),
    the deferred update of the panel's later columns as index gathers
    and small batched products;
  - 'fused' (and its alias 'fused3'): the whole strip-scanned panel in
    one kernel (ops/kernels/panel_fused.py), complex64 only;
  - 'pallas' (the complex128 default): the swap-pivoted panel LU
    (ops/kernels/panel_lu.py), complex64 or complex128;
  or on the JAX package's XLA panels, which are plain PyTorch here as
  they are plain XLA there:
  - 'xla': row swaps, one column at a time (``_factor_panel_xla``);
  - 'virtual': virtual pivoting on the transposed panel
    (``_factor_panel_virtual``);
  - 'split': recursive halves down to 32-column virtual-pivot strips,
    the block updates as matmuls (``_factor_panel_split``);
  - 'psplit': 'split' with the strip kernel at every leaf, complex64
    only;
* pivoting applied to the rest of the matrix as one gather per panel;
* the L11 and U11 triangular solves by ``torch.linalg.solve_triangular``,
  trailing updates by ``torch.matmul``, with forward substitution fused
  into the sweep through an augmented ``[A | B]`` working matrix.

All functions take a batch dimension written out: A is (B, N, N).
``method=None`` means the blocked LU for complex64 on any device;
``torch.linalg.solve`` ('lapack') is an explicit opt-in, and the default
for complex128, whose blocked LU is asked for with ``method='blocked'``.
Precision tiers:

* 'fast'   : complex64 blocked LU.
* 'mixed'  : complex64 blocked LU + Newton refinement of the inverse whose
             residual I - A X is computed in native complex128 against the
             complex128 operator (the JAX package forms a complex64 A and
             emulates the residual product with split f32 products).
* 'high'   : complex128 blocked LU (the JAX package emulates it with
             double-word float32 arithmetic, ``zinv_dw``);
* 'exact'  : 'high' plus one complex128 Newton step (ops/greens.py).
"""

from __future__ import annotations

import torch

from gaunegf_tpu_torch.ops.kernels.panel_fused import (
    factor_panel_fused, pack_virtual)
from gaunegf_tpu_torch.ops.kernels.panel_lu import factor_panel_lu
from gaunegf_tpu_torch.ops.kernels.strip_elim import eliminate_strip

__all__ = ["zsolve", "zinv", "zinv_refined", "zlu_factor", "zlu_solve",
           "zinv_refined_cols", "zsolve_dist",
           "fractional_matrix_power", "inv", "solve", "eigh", "eig"]

PANEL_SPLIT_BASE = 32       # strip width of the strip-scanned panel and
                            # the leaf width of the split recursion
# the split recursion halves a panel only while each half is a multiple of
# this (the JAX package's triangular-inverse base): the same recursion
# tree, so the same leaf shapes reach the strip kernel
_SPLIT_ALIGN = 32


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
    return pack_virtual(pt, pivrows, avail)


def _factor_panel_xla(panel):
    """The JAX package's ``_factor_panel`` ('xla'): partial pivoting with
    row swaps, one column at a time, on a batch of (m, bs) panels.

    Per column j: the first row of largest |value| at or below j (as
    jnp.argmax), the swap of rows j and p in the panel and in the perm,
    the multipliers col / pivot below j (a zero pivot reads as 1) and the
    rank-1 update of the trailing block.  Returns (the panel with its rows
    swapped in place, perm (B, m) int64: the composed swaps)."""
    nb, m, bs = panel.shape
    dev = panel.device
    P = panel.clone()
    perm = torch.arange(m, device=dev).repeat(nb, 1)
    rows = torch.arange(m, device=dev)
    b = torch.arange(nb, device=dev)
    for j in range(bs):
        mag = torch.where(rows >= j, P[:, :, j].abs(),
                          torch.full((), -torch.inf, device=dev))
        p = torch.argmax(mag, dim=1)                    # first maximum
        row_j, row_p = P[:, j].clone(), P[b, p]
        P[:, j], P[b, p] = row_p, row_j
        perm_j, perm_p = perm[:, j].clone(), perm[b, p]
        perm[:, j], perm[b, p] = perm_p, perm_j
        piv = P[:, j, j]
        safe = torch.where(piv == 0, torch.ones_like(piv), piv)
        l = P[:, j + 1:, j] / safe[:, None]             # (B, m - j - 1)
        P[:, j + 1:, j + 1:] -= l[:, :, None] * P[:, j, None, j + 1:]
        P[:, j + 1:, j] = l
    return P, perm


def _factor_panel_virtual(panel):
    """The JAX package's ``_factor_panel_virtual`` ('virtual'): virtual
    pivoting on the transposed (bs, m) layout of a batch of (m, bs)
    panels.  An availability mask stands in for the row swaps: per
    column j the first available lane of largest |value| is the pivot,
    the other available lanes take the multipliers col / pivot, the later
    rows of the transposed panel their rank-1 update, and the pivot leaves
    the mask.  Packed as the strip-scanned panel (``pack_virtual``): the
    same pivot sequence as partial pivoting."""
    nb, m, bs = panel.shape
    dev = panel.device
    pt = panel.transpose(1, 2).contiguous()             # (B, bs, m)
    lanes = torch.arange(m, device=dev)
    avail = torch.ones((nb, m), dtype=torch.bool, device=dev)
    pivrows = torch.empty((nb, bs), dtype=torch.int64, device=dev)
    for j in range(bs):
        col = pt[:, j]                                  # (B, m)
        mag = torch.where(avail, col.abs(),
                          torch.full((), -torch.inf, device=dev))
        p = torch.argmax(mag, dim=1)
        piv = col.gather(1, p[:, None])
        safe = torch.where(piv == 0, torch.ones_like(piv), piv)
        keep = avail & (lanes[None, :] != p[:, None])
        l = torch.where(keep, col / safe, torch.zeros_like(col))
        if j + 1 < bs:
            u = pt[:, j + 1:].gather(
                2, p[:, None, None].expand(nb, bs - j - 1, 1))
            pt[:, j + 1:] -= u * l[:, None, :]
        pt[:, j] = torch.where(keep, l, col)
        pivrows[:, j] = p
        avail = keep
    return pack_virtual(pt, pivrows, avail)


def _factor_panel_strip(panel):
    """The leaf of 'psplit': a panel of at most 32 columns eliminated by
    the strip kernel in one launch, packed as 'virtual' packs it."""
    sb, piv, avail = eliminate_strip(
        panel.transpose(1, 2),
        torch.ones(panel.shape[:2], dtype=torch.bool, device=panel.device))
    return pack_virtual(sb, piv, avail)


def _factor_panel_split(panel, leaf=_factor_panel_virtual,
                        base: int = PANEL_SPLIT_BASE):
    """The JAX package's ``_factor_panel_split`` ('split'; 'psplit' with
    ``leaf=_factor_panel_strip``): factor the left half of the panel
    recursively, apply its pivots to the right half (one gather), solve
    the U12 block (unit lower triangular solve), update the rest of the
    right half by one matmul and factor it recursively; leaves of at most
    ``base`` columns go to ``leaf``.  Returns (packed in pivoted row
    order, perm (B, m) int64): the partial-pivot sequence."""
    nb, m, bs = panel.shape
    if bs <= base or bs % 2 or (bs // 2) % _SPLIT_ALIGN:
        return leaf(panel)
    h = bs // 2
    left, perm_l = _factor_panel_split(panel[:, :, :h], leaf, base)
    right = _gather_rows(panel[:, :, h:], perm_l)
    U12 = torch.linalg.solve_triangular(left[:, :h], right[:, :h],
                                        upper=False, unitriangular=True)
    low = right[:, h:] - torch.matmul(left[:, h:], U12)
    br, perm_r = _factor_panel_split(low, leaf, base)
    packed = torch.cat(
        [torch.cat([left[:, :h], _gather_rows(left[:, h:], perm_r)], dim=1),
         torch.cat([U12, br], dim=1)], dim=2)
    idx = torch.cat([torch.arange(h, device=panel.device).expand(nb, h),
                     h + perm_r], dim=1)
    return packed, perm_l.gather(1, idx)


# every lu_panel name -> the panel it names for complex64
_PANEL_NAMES = {None: "pstrip", "auto": "pstrip", "scan": "pstrip",
                "pstrip": "pstrip", "fused": "fused", "fused3": "fused",
                "pallas": "pallas", "xla": "xla", "virtual": "virtual",
                "split": "split", "psplit": "psplit"}
# the names a complex128 LU takes (the others run a complex64 kernel)
_PANELS_C128 = ("pallas", "xla", "virtual", "split")


def _pick_panel(N: int, panel_impl: str | None,
                dtype=torch.complex64) -> str:
    """Resolve a panel name for an LU in ``dtype``.

    complex64: 'auto', 'scan' and 'pstrip' name the strip-scanned panel
    (the JAX package's 'scan' and 'pstrip' differ only in who runs the
    strip loop; its 'auto' is 'split' from N=1536 on, this package's
    stays 'pstrip' at every N), 'fused' and 'fused3' the fused panel
    kernel ('fused3' is the TPU matrix unit's bf16-split mode: an alias
    here), 'pallas' the swap-pivoted panel kernel, 'xla', 'virtual',
    'split' and 'psplit' the XLA panels.  complex128: 'auto' and 'pallas'
    name the swap-pivoted panel kernel; 'xla', 'virtual' and 'split' run
    as they do on complex64; the names of a complex64 kernel raise
    ValueError."""
    if panel_impl not in _PANEL_NAMES:
        raise ValueError(f"unknown lu_panel {panel_impl!r}")
    if dtype == torch.complex64:
        return _PANEL_NAMES[panel_impl]
    if dtype != torch.complex128:
        raise ValueError(f"the blocked LU takes complex64 or complex128, "
                         f"got {dtype}")
    if panel_impl in (None, "auto"):
        return "pallas"
    if panel_impl in _PANELS_C128:
        return panel_impl
    raise ValueError(f"lu_panel={panel_impl!r} takes complex64 only; a "
                     "complex128 LU runs on 'pallas' (or 'auto'), 'xla', "
                     "'virtual' or 'split'")


def _dispatch_panel(panel, panel_impl: str):
    """Panel factorization by resolved panel name (one place to add one)."""
    if panel_impl == "pstrip":
        return _factor_panel_scan(panel)
    if panel_impl == "fused":
        return factor_panel_fused(panel)
    if panel_impl == "pallas":
        return factor_panel_lu(panel)
    if panel_impl == "xla":
        return _factor_panel_xla(panel)
    if panel_impl == "virtual":
        return _factor_panel_virtual(panel)
    if panel_impl == "split":
        return _factor_panel_split(panel)
    if panel_impl == "psplit":
        return _factor_panel_split(panel, leaf=_factor_panel_strip)
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
    panel_impl = _pick_panel(N, panel_impl, A.dtype)
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
    panel_impl = _pick_panel(N, panel_impl, A.dtype)
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


# ---------------------------------------------------------------------------
# Column-sharded solves over the mesh's 'm' axis (parallel/mesh.py)
# ---------------------------------------------------------------------------

def _rank_cols(N: int, mesh):
    """(rank's 'm' coordinate, per-rank column width); N % m raises."""
    m = mesh.shape["m"]
    if N % m:
        raise ValueError(f"N={N} not divisible by m-axis size {m}")
    return mesh.coords["m"], N // m


def zinv_refined_cols(A, mesh, *, steps: int = 2, bs: int | None = None,
                      panel_impl: str = "auto", distribute_lu: bool = False,
                      lu_dtype=torch.complex64):
    """The rank's (b, N, N/m) column block of A^-1 for a batch (b, N, N),
    over the mesh's 'm' axis.

    Each 'm' rank solves its N/m identity columns in ``lu_dtype``: on the
    replicated blocked LU, or with ``distribute_lu`` through
    ``zsolve_dist`` (the factorization divides too).  Refinement, as
    ``zinv_refined``: ``steps`` Newton steps X <- X + X (I - A X) with the
    residual in complex128 against A itself; the correction needs the
    whole iterate, so each step gathers X over 'm' once, and one max over
    'm' of the residual decides per batch element whether to keep the
    seed (residual >= 0.5).  Returns ``lu_dtype``; callers reassemble the
    inverse with ``mesh.gather_m``."""
    b, N = A.shape[0], A.shape[-1]
    rank, w = _rank_cols(N, mesh)
    I_cols = torch.zeros((N, w), dtype=lu_dtype, device=A.device)
    I_cols[torch.arange(rank * w, (rank + 1) * w), torch.arange(w)] = 1.0
    I_cols = I_cols.expand(b, N, w)
    A_lu = A.to(lu_dtype)
    if distribute_lu:
        X = zsolve_dist(A_lu, I_cols, mesh, bs=bs, panel_impl=panel_impl)
    else:
        X = zsolve(A_lu, I_cols, method="blocked", bs=bs,
                   panel_impl=panel_impl)
    if not steps:
        return X
    A_hi = A.to(torch.complex128)
    I_hi = I_cols.to(torch.complex128)
    for _ in range(steps):
        R = I_hi - torch.matmul(A_hi, X.to(torch.complex128))
        ok = mesh.max_m(R.abs().amax(dim=(-2, -1))) < 0.5
        Xf = mesh.gather_m(X, dim=-1)
        X = torch.where(ok[:, None, None],
                        X + torch.matmul(Xf, R.to(X.dtype)), X)
    return X


def _dist_panel(N: int, panel_impl: str, dtype) -> str:
    """The panel of zsolve_dist: what the JAX zsolve_dist accepts
    ('virtual', 'split', 'scan', 'pstrip', 'psplit', and 'auto'), plus
    'pallas' (also 'auto') on complex128; 'xla', 'fused' and, on
    complex64, 'pallas' raise."""
    name = _pick_panel(N, panel_impl, dtype)
    if name not in ("pstrip", "virtual", "split", "psplit") and not (
            dtype == torch.complex128 and name == "pallas"):
        raise ValueError(
            "zsolve_dist supports panel_impl 'auto'/'scan'/'pstrip'/"
            "'virtual'/'split'/'psplit' on complex64 and 'auto'/'pallas'/"
            f"'virtual'/'split' on complex128, got {panel_impl!r} on "
            f"{dtype}")
    return name


def zsolve_dist(A, B_cols, mesh, *, bs: int | None = None,
                panel_impl: str = "auto"):
    """Distributed blocked solve over the mesh's 'm' axis: the O(N^3)
    trailing updates divide across the ranks, the panels stay serial.

    A (b, N, N) arrives replicated; B_cols (b, N, k) is the rank's RHS.
    A is padded to block-diag(A, I) up to a multiple of bs*M (M ranks on
    'm'; the padded rows of B are zero) and each rank keeps the
    panel-cyclic column blocks it owns (global panel kb belongs to rank
    kb % M).  Per panel, only its owner factors it and one broadcast over
    'm' sends the packed factors and the pivots to the others (the JAX
    package factors on every rank and selects the owner's with a masked
    psum: the same values); each rank then pivots, solves the U12 rows of
    its own later columns and of its RHS, and updates its trailing
    columns.  After the last panel one gather over 'm' assembles the
    replicated U12 rows, and the back substitution of the rank's RHS runs
    without further collectives.  Returns the rank's (b, N, k) solution."""
    b, N0 = A.shape[0], A.shape[-1]
    k = B_cols.shape[-1]
    bs = _pick_block(N0, bs)
    name = _dist_panel(N0, panel_impl, A.dtype)
    M, r = mesh.shape["m"], mesh.coords["m"]
    N = -(-N0 // (bs * M)) * (bs * M)
    A = _pad_to(A, N)
    B = B_cols.to(A.dtype).expand(b, N0, k)
    if N != N0:
        B = torch.cat([B, B.new_zeros(b, N - N0, k)], dim=1)
    nb = N // bs
    nbl = nb // M
    # local block j <-> global panel r + j*M
    gcols = torch.cat([torch.arange((r + j * M) * bs, (r + j * M + 1) * bs)
                       for j in range(nbl)]).to(A.device)
    work = torch.cat([A[:, :, gcols], B], dim=2)     # (b, N, nbl*bs + k)

    heads, u_rows = [], []
    for kb in range(nb):
        owner = kb % M
        rows = N - kb * bs
        if r == owner:
            panel, perm = _dispatch_panel(work[:, :, :bs], name)
            panel, perm = panel.contiguous(), perm.contiguous()
            work = work[:, :, bs:]
        else:
            panel = torch.empty((b, rows, bs), dtype=A.dtype,
                                device=A.device)
            perm = torch.empty((b, rows), dtype=torch.int64, device=A.device)
        panel = mesh.broadcast_m(panel, owner)
        perm = mesh.broadcast_m(perm, owner)
        rest = _gather_rows(work, perm)
        head = panel[:, :bs]
        U12R = torch.linalg.solve_triangular(head, rest[:, :bs], upper=False,
                                             unitriangular=True)
        heads.append(head)
        u_rows.append(U12R)
        if kb < nb - 1:
            work = rest[:, bs:] - torch.matmul(panel[:, bs:], U12R)

    # the rank's local columns of U beyond the diagonal blocks; its later
    # columns after panel kb are a suffix of its local blocks
    U_loc = torch.zeros((b, N, nbl * bs), dtype=A.dtype, device=A.device)
    for kb, U12R in enumerate(u_rows):
        c = U12R.shape[-1] - k
        if c:
            U_loc[:, kb * bs:(kb + 1) * bs, nbl * bs - c:] = U12R[..., :c]
    Ug = mesh.gather_m(U_loc, dim=-1)                # (b, N, N), rank-major
    # global column (j * M + q) * bs + t sits at rank q's local block j
    order = torch.arange(N).reshape(M, nbl, bs).transpose(0, 1).reshape(-1)
    U = Ug[:, :, order.to(A.device)]
    X = None
    for ib in range(nb - 1, -1, -1):
        acc = u_rows[ib][..., -k:]
        if X is not None:
            acc = acc - torch.matmul(U[:, ib * bs:(ib + 1) * bs,
                                       (ib + 1) * bs:], X)
        Xi = torch.linalg.solve_triangular(heads[ib], acc, upper=True)
        X = Xi if X is None else torch.cat([Xi, X], dim=1)
    return X[:, :N0]


# ---------------------------------------------------------------------------
# Reference-parity helpers (gauNEGF/utils.py); library calls in the JAX
# package too.  Each runs on the device of the tensor it is given.
# ---------------------------------------------------------------------------

def inv(A):
    """Matrix inverse (utils.py:52-54): zinv, so the blocked LU for
    complex64 and torch.linalg.solve otherwise."""
    return zinv(A)


def solve(A, B, **kw):
    return zsolve(A, B, **kw)


def eigh(A):
    """Hermitian eigendecomposition (utils.py:60-62)."""
    return torch.linalg.eigh(A)


def eig(A):
    """General (non-Hermitian) eigendecomposition, complex (w, v).  Used
    once per SCF cycle at most (the analytic density route), never in the
    energy loop."""
    return torch.linalg.eig(A)


def fractional_matrix_power(S, power):
    """S^power by Hermitian eigendecomposition; parity with utils.py:12-48.

    Eigenvalues are clamped at 1e-16 exactly as the reference does."""
    eigenvalues, eigenvectors = torch.linalg.eigh(S)
    eigenvalues = torch.clamp(eigenvalues, min=1e-16)
    powered = torch.pow(eigenvalues, power).to(eigenvectors.dtype)
    return (eigenvectors * powered[..., None, :]) @ \
        eigenvectors.conj().transpose(-1, -2)
