"""The yardstick of the kernels' roofline shares: the card's peaks and the
operations and bytes each kernel launch needs, from its shapes.

Copied from the repository's ``chip_smoke.py`` (``PEAK_OPS``,
``PEAK_BYTES``, ``bound``, ``panel_bound``, ``strip_bound``,
``fixed_point_ops``, ``decimate_ops``; the counts taken as lists, not
tensors), frozen here so that the yardstick stays as it is.
Peaks: NVIDIA H100 SXM data sheet, 67 TFLOP/s (FP32 on the CUDA cores;
FP64 on the tensor cores) and 3.35 TB/s of device memory, at the full
700 W power limit.
"""

from __future__ import annotations

PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
DIM9 = 9


def bound(ops, nbytes):
    """(least milliseconds, what sets it) for ops operations and nbytes
    bytes moved once."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def panel_bound(batch, m, bs, elem):
    """Bound of a batch of (m, bs) panel factorizations: per column j the
    argmax (3 ops a row), the multipliers (6) and the rank-1 update (8 per
    complex update); the panel read and written once, perm written."""
    ops = batch * sum(3 * (m - j) + 6 * (m - j - 1)
                      + 8 * (m - j - 1) * (bs - j - 1) + 5
                      for j in range(bs))
    return bound(ops, batch * (2 * m * bs * elem + 8 * m))


def strip_bound(avail_counts, rows, m):
    """Bound of a batch of (rows, m) strip eliminations, given each
    strip's count of available lanes: per step j, hypot (7 ops) at the
    available lanes, then the multipliers (6) and the update of rows below
    (8 a value) at the others; the strip and avail read and written once,
    piv written."""
    ops = sum(7 * (a - j) + (a - j - 1) * (6 + 8 * (rows - j - 1)) + 10
              for a in avail_counts for j in range(rows))
    batch = len(avail_counts)
    return bound(ops, batch * (2 * rows * m * 8 + 2 * m + 4 * rows))


def fixed_point_ops(counts, bulk, exclusion, surface):
    """FP64 operations of kernel A for per-lane sweep counts [(bulk,
    surface)]: a 9x9 complex inverse or product is 8 * 9^3; a bulk sweep
    with exclusion inverts 12 blocks, without one, and multiplies 24; a
    surface sweep inverts one and multiplies 12; plus ~12 operations an
    entry of each updated slot and 5 an entry of each summed slot."""
    c0 = float(sum(c[0] for c in counts))
    c1 = float(sum(c[1] for c in counts))
    blk = 8 * DIM9 ** 3
    ops = 0.0
    if bulk is not None:
        inv = 12 if exclusion else 1
        ops += c0 * (blk * (inv + 24) + 81 * (12 * 12 + 12 * 5))
    if surface:
        ops += c1 * (blk * 13 + 81 * (6 * 12 + 9 * 5))
    return ops


def decimate_ops(counts, n, mode):
    """FP64 operations of kernel B for these per-lane iteration counts (a
    list, one a lane): an n x n complex inverse or product is 8 n^3; a
    decimation step inverts once and multiplies six times (al g, be g, and
    four products with them), the Dyson map inverts once and multiplies
    twice; one more inverse a lane (the last, or the first)."""
    it = float(sum(counts))
    blk = 8 * n ** 3
    per = blk * 7 + 20 * n * n if mode == "sancho" else blk * 3 + 15 * n * n
    return it * per + len(counts) * blk
