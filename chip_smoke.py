"""Drive the port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--kernels-only | --only-fermi]

Imports gaunegf_tpu_torch (never JAX).  Phases, one result line each; any
failure raises and exits non-zero:

1. device    -- a CUDA device must be visible (exit 1 otherwise);
2. build     -- nvcc builds the three kernels for sm_90a, one process
                each, all started together;
3. kernels   -- each kernel against its plain PyTorch version on the card,
                batch 64: the strip kernel at the strip shapes of the
                N=1000 LU (m = 1024, 896, ..., 128: the panel heights at
                bs=128, which include those of the automatic bs=256), the
                fused panel kernel at the panels of N=1000 at bs=256
                ((m, 256), m = 1024, 768, 512, 256) in complex64, the
                swap-pivoted panel kernel at the same panels in complex64
                and complex128, each plus a tie case and a zero-column
                case, and a larger case at m = 4096 for the three
                cluster kernels (a (64, 32, 4096) strip, (64, 4096, 256)
                panels), which sizes their clusters differently:
                identical pivots, values within the bound below; each
                timed case has its plain version's time, the bound from
                its shapes (and, for the strip, its avail mask) and the
                time of torch.linalg.lu_factor_ex on the same panels (the
                strip as its (B, m, 32) transpose) as a yardstick that the
                port never calls; --kernels-only stops here;
4. gr_sum    -- EnergyEngine.gr_sum at the bench shape (N=1000 junction,
                8+8 constant contacts, 512 real-axis points), mixed tier on
                the blocked LU, against a complex128 torch.linalg.solve sum;
5. scf       -- a biased NEGFE SCF on a 1000-site chain (the README quick
                start at full width): first density against a complex128
                build on the same grids, then 3 more cycles;
6. transport -- on the n=1000 SCF result: (a) the quick start's T(E)
                sweep, 500 points, mixed tier on the fused panel, against
                complex128 torch.linalg.solve; (b) 1D-chain electrodes
                (setContact1D): T(E) and DOS over 200 points at
                precision='high' (the complex128 LU on the swap-pivoted
                panel) against complex128 torch.linalg.solve; (c) the
                Landauer current at qV=0.1; (d) one gr_sum at the bench
                shape per complex64 panel (pstrip, fused, pallas), with
                each kernel's launches;
7. spectral  -- the default solver='auto' on the spectral route (one
                float64 eigh per Fock, a rank-k Woodbury correction per
                point, complex128 throughout); each sub-phase raises if
                the route declines: (a) gr_sum at the bench shape and
                (b) at N=2000 (128 points) against complex128
                torch.linalg.solve sums, with setup seconds, pts/s (median
                of 3 calls), deflated points and peak bytes of one call;
                (c) T(E) over the bench grid and G< over a 50-point bias
                window at N=1000 against complex128 contact-column
                solves; (d) the biased NEGFE SCF of phase 5 on the
                default configuration: first density against the
                complex128 build, then 3 cycles;
8. fermi     -- the quick-start junction of phases 5/7d on the default
                configuration, with what a user gets by default: (a)
                setVoltage(0.1) without a Fermi level (a Muller search in
                every cycle), 3 SCF cycles with probes and eigh per cycle,
                the found level's electron count against a complex128 LU
                density, one cycle per other search method, and a search
                from a displaced start; (b) setIntegralLimits() with its
                defaults (every grid adaptive) against fixed grids; (c)
                integralCheck(cycles=2) and setContact1D(alphas=...) with a
                2-orbital lead cell; (d) spin 'u' at 2N = 2000 (3 SCF
                cycles, a 200-point T(E) with its 4 channels on the fused
                panel, against complex128 solves of each spin block) and
                'g' at 2N = 1000 on the default configuration and with
                solver='lu' (kernel 1 must launch), against complex128
                dense solves in the spinor-interleaved layout.

Each path sets every launch count to 0 just before it and reads the
counts just after (phase 7 runs no hand-written kernel: its counts stay
0).  The second-to-last line is the kernel
table (JSON), the last line {"ok": true, "device": {...}}.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 64                                  # energy chunk of the main path
PANEL_HEIGHTS = tuple(range(1024, 0, -128))  # N=1000 padded to 1024
# Kernel vs plain: both round every operation the same way, so they agree
# bit for bit; the bound allows the last-bit freedom of the device libm
# (sqrt, division) in the plain version's torch ops: 8 ulp of the strip's
# largest value.
KERNEL_REL_BOUND = 8 * 2.0 ** -23
# gr_sum (mixed tier) against complex128.  The mixed tier refines its
# complex64 LU seed against the complex128 operator, so one Newton step
# leaves (cond * u32)^2 plus the complex64 storage of G (~6e-8).  Points
# whose reference |G| stays below 1e4 (cond * u32 <~ 2.4e-3) must agree
# to 2e-5 of their partial sum's largest entry; the whole real-axis grid
# includes points within ~1e-5 of eigenvalues of weakly coupled interior
# states (cond * u32 up to ~0.1), hence 3e-2 for the full sum.
GR_FAR_BOUND = 2e-5
GR_FULL_BOUND = 3e-2
GR_FAR_MAX_G = 1e4
# first SCF density against complex128: the lower real-axis segment and
# the contour are well conditioned; the bias window's low-rank contact
# columns see near-pole points only through the contact coupling.
SCF_P_BOUND = 1e-4
PANEL_HEIGHTS_256 = (1024, 768, 512, 256)   # N=1000 at bs=256
PANEL_BS = 256
# Panel kernels vs plain: like the strip kernel, both round every
# operation alike and (the fused kernel) take every sum over k one term at
# a time in the same order, so they agree bit for bit; the bound allows 8
# ulp of the panel's largest value for the device libm's last bit in the
# plain version's torch ops (sqrt, division), in the panel's real dtype.
PANEL_REL_BOUND = {torch.complex64: 8 * 2.0 ** -23,
                   torch.complex128: 8 * 2.0 ** -52}
# (a) mixed-tier T(E) against complex128, absolute (0 <= T <= 1 here).
# Away from poles one Newton step leaves (cond * u32)^2 plus complex64
# storage, T to ~1e-6; near the band edges the 1000-site chain has levels
# whose contact weight is ~1e-5, and grid points within ~1e-5 of them put
# cond * u32 near 0.1, hence 1e-3 for the whole grid.
T_MIXED_BOUND = 1e-3
# (b) the high tier is a complex128 LU: cond * u64 with cond <= ~1e4 on
# this grid (perfect leads broaden every level), so 1e-9 absolute for T
# and 1e-9 of the largest total DOS.
T_HIGH_BOUND = 1e-9
DOS_HIGH_REL_BOUND = 1e-9
# Phase 7, the spectral route: complex128 throughout, so each result holds
# cond * u64 against a complex128 LU reference.  Each bound is about 10x
# what the H100 measured, or the first bound set where that is lower
# (PERF.md).  (a) gr_sum over the whole bench grid, 1e-9 of the sum's
# largest entry (measured 5.6e-10: a point 4.4e-7 from a weakly coupled
# level, where both sides carry u64 * |H| / dist); (b) N=2000, 1e-10
# (measured 6.8e-12); (c) T(E) absolute 1e-11 and G< 3e-11 relative
# (measured 1.0e-12 and 2.4e-12; both references take Gamma on the
# contact block, as the route does); (d) the first SCF density 1e-6 of
# max |P| (measured 1.3e-7): its reference keeps the broadening
# background's Gamma, which the route's G< drops.
SP_GR_BOUND = {"a": 1e-9, "b": 1e-10}
SP_T_BOUND = 1e-11
SP_GLESS_BOUND = 3e-11
SP_P_BOUND = 1e-6
# Phase 8.  (a) The found Fermi level's electron count, rebuilt by the
# exact-tier LU on the same grids, must be within the search's own conv of
# the target ('predict' takes one step of a constant-sigma model and
# promises no count: printed, not held); a probe's count on the default
# configuration (complex128 spectral route) must agree with that rebuild to
# 1e-5 electrons of 500 (2e-8 relative; phase 7's sums hold ~1e-9 or
# better).  (b) Each adaptive route stops at a change below
# ADAPTIVE_INTEGRATION_TOL (1e-4) and the last change is an estimate, so
# the adaptive contour plus window is held to 10x that of the largest |P|
# against fixed grids several times denser than the adaptive ones end at.
# The lower segment is held on its own: density_real's first two grids (1
# and 2 points over the 1e6 eV from Eminf to Emin) both see ~0, so it stops
# there and leaves out the tail of the contact levels below Emin, as in the
# JAX package: at most 0.1 / (5 pi) per contact orbital (a -0.1j level at
# least 5 eV above Emin).  (d) 'u': the spectral first
# density as 7d (1e-6); T_uu and T_dd on the mixed tier as 6a (1e-3
# absolute), the spin-flip channels of a block-diagonal system 1e-6
# absolute (they are exact zeros unless a pivot crosses blocks).  'g':
# first density 1e-6 on the spectral route and 1e-4 on the mixed LU as
# phase 5; T channels and per-site DOS on the mixed tier at 20 sampled
# points, 1e-3 absolute for T and 1e-3 of the largest per-site DOS.
FERMI_PROBE_BOUND = 1e-5
ADAPTIVE_P_BOUND = 1e-3
LOWER_TAIL_BOUND = 0.1 / (5 * np.pi)
SPIN_FLIP_BOUND = 1e-6
SPIN_DOS_REL_BOUND = 1e-3
# The cluster kernels' larger case, which sizes their clusters and
# sub-panels differently (8 CTAs per strip and per fused panel; narrower
# sub-panels of the swap-pivoted panel).
LARGE_M = 4096
# Bounds: H100 SXM data sheet, 67 TFLOP/s (FP32 CUDA cores; FP64 tensor
# cores) and 3.35 TB/s of device memory.
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12


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


def strip_bound(avail, rows, m):
    """Bound of a batch of (rows, m) strip eliminations with this avail
    mask: per step j, hypot (7 ops) at the available lanes, then the
    multipliers (6) and the update of rows below (8 a value) at the others;
    the strip and avail read and written once, piv written."""
    A = avail.sum(1).tolist()
    ops = sum(7 * (a - j) + (a - j - 1) * (6 + 8 * (rows - j - 1)) + 10
              for a in A for j in range(rows))
    batch = len(A)
    return bound(ops, batch * (2 * rows * m * 8 + 2 * m + 4 * rows))


def device_ms(fn, kernel, reps):
    """Mean device milliseconds per fn() of the CUDA kernels whose name
    contains ``kernel``, from torch.profiler's trace; None when the trace
    holds none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0.0)
                for e in prof.key_averages() if kernel in e.key)
    return total / reps / 1e3 if total > 0 else None


def library_ms(x, reps):
    """torch.linalg.lu_factor_ex on x (a yardstick, never the port's)."""
    return cuda_ms(lambda: torch.linalg.lu_factor_ex(x), reps)


def device_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def strip_cases(device, batch=BATCH, heights=PANEL_HEIGHTS, seed=0,
                large=(LARGE_M,)):
    """(label, strip (B, 32, m) complex64, avail (B, m) bool) cases."""
    rng = np.random.default_rng(seed)

    def random_case(m):
        sb = (rng.standard_normal((batch, 32, m))
              + 1j * rng.standard_normal((batch, 32, m))).astype(np.complex64)
        av = rng.random((batch, m)) < 0.9
        av[:, :32] = True                   # at least 32 available lanes
        return f"m={m}", sb, av

    cases = [random_case(m) for m in heights]
    m = heights[-1]
    # ties: integer values repeat, so equal magnitudes at several lanes
    tie = rng.integers(-2, 3, (batch, 32, m)).astype(np.complex64)
    tie[:, :, ::3] = 3 + 4j                 # |3+4i| == |5|: exact ties
    tie[:, :, 1::3] = 5
    cases.append(("tie", tie, np.ones((batch, m), bool)))
    # zero columns: strip row 5 is all zeros -> zero-pivot guard
    zc = (rng.standard_normal((batch, 32, m))
          + 1j * rng.standard_normal((batch, 32, m))).astype(np.complex64)
    zc[:, 5, :] = 0
    cases.append(("zero-column", zc, np.ones((batch, m), bool)))
    cases += [random_case(m) for m in large]
    return [(lbl, torch.as_tensor(sb, device=device),
             torch.as_tensor(av, device=device)) for lbl, sb, av in cases]


def phase_kernel(se, device, timed=True, **shape):
    """Kernel against plain on every case; returns (max rel err, rows)."""
    worst = 0.0
    rows = []
    for label, sb, av in strip_cases(device, **shape):
        out_k, piv_k, av_k = se.eliminate_strip(sb, av)
        out_p, piv_p, av_p = se.eliminate_strip_plain(sb, av)
        if not torch.equal(piv_k, piv_p) or not torch.equal(av_k, av_p):
            raise AssertionError(f"{label}: kernel pivots/avail differ "
                                 "from the plain version")
        if not (torch.isfinite(out_k).all() and torch.isfinite(out_p).all()):
            raise AssertionError(f"{label}: non-finite strip values")
        scale = float(out_p.abs().max())
        err = float((out_k - out_p).abs().max())
        rel = err / max(scale, 1e-30)
        if rel > KERNEL_REL_BOUND:
            raise AssertionError(f"{label}: kernel differs from plain by "
                                 f"{rel:.3e} > {KERNEL_REL_BOUND:.3e}")
        worst = max(worst, rel)
        ms = plain_ms = lib_ms = kernel_ms = float("nan")
        if timed:
            ms = cuda_ms(lambda: se.eliminate_strip(sb, av), 20)
            kernel_ms = device_ms(lambda: se.eliminate_strip(sb, av),
                                  "strip_elim_kernel", 20)
            plain_ms = cuda_ms(lambda: se.eliminate_strip_plain(sb, av), 3)
            lib_ms = library_ms(sb.transpose(1, 2).contiguous(), 5)
        bound_ms, bound_by = strip_bound(av, sb.shape[1], sb.shape[2])
        rows.append({"case": label, "m": sb.shape[-1], "max_abs_err": err,
                     "rel_err": rel, "ms": ms, "kernel_ms": kernel_ms,
                     "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "launch": (se.config(sb.shape[1], sb.shape[2])
                                if device.type == "cuda" else None)})
    return worst, rows


def panel_cases(device, dtype, batch=BATCH, heights=PANEL_HEIGHTS_256,
                bs=PANEL_BS, seed=1, large=()):
    """(label, panel (B, m, bs)) cases of one dtype, then the heights in
    large."""
    rng = np.random.default_rng(seed)
    ndt = np.complex64 if dtype == torch.complex64 else np.complex128

    def random_case(m):
        return f"({m},{bs})", (rng.standard_normal((batch, m, bs))
                               + 1j * rng.standard_normal((batch, m, bs))
                               ).astype(ndt)

    cases = [random_case(m) for m in heights]
    m = heights[-1]
    # ties: |3+4i| == |5|, equal in hypot and in re^2 + im^2
    tie = rng.integers(-2, 3, (batch, m, bs)).astype(ndt)
    tie[:, ::3] = 3 + 4j
    tie[:, 1::3] = 5
    cases.append(("tie", tie))
    zc = (rng.standard_normal((batch, m, bs))
          + 1j * rng.standard_normal((batch, m, bs))).astype(ndt)
    zc[:, :, 5] = 0                         # column 5 -> zero-pivot guard
    cases.append(("zero-column", zc))
    cases += [random_case(m) for m in large]
    return [(lbl, torch.as_tensor(a, device=device)) for lbl, a in cases]


def phase_panel(kernel, plain, device, dtype, timed=True, config=None,
                name=None, **shape):
    """A panel kernel against its plain version on every case of
    panel_cases(device, dtype, **shape); returns (max rel err, rows).
    config(m, bs, dtype, batch), where given, names the kernel's launch
    shape; name is the CUDA kernel's symbol for its device time."""
    worst = 0.0
    rows = []
    bound = PANEL_REL_BOUND[dtype]
    for label, panel in panel_cases(device, dtype, **shape):
        out_k, perm_k = kernel(panel)
        out_p, perm_p = plain(panel)
        if not torch.equal(perm_k, perm_p):
            raise AssertionError(f"{label} {dtype}: kernel perm differs "
                                 "from the plain version")
        if not (torch.isfinite(out_k).all() and torch.isfinite(out_p).all()):
            raise AssertionError(f"{label} {dtype}: non-finite panel values")
        scale = float(out_p.abs().max())
        err = float((out_k - out_p).abs().max())
        rel = err / max(scale, 1e-30)
        if rel > bound:
            raise AssertionError(f"{label} {dtype}: kernel differs from "
                                 f"plain by {rel:.3e} > {bound:.3e}")
        worst = max(worst, rel)
        ms = plain_ms = lib_ms = kernel_ms = float("nan")
        if timed:
            ms = cuda_ms(lambda: kernel(panel), 10)
            kernel_ms = device_ms(lambda: kernel(panel), name, 5)
            plain_ms = cuda_ms(lambda: plain(panel), 2)
            lib_ms = library_ms(panel, 3)
        nb_, m, bs = panel.shape
        bound_ms, bound_by = panel_bound(nb_, m, bs, panel.element_size())
        rows.append({"case": label, "dtype": str(dtype).split(".")[-1],
                     "max_abs_err": err, "rel_err": rel, "ms": ms,
                     "kernel_ms": kernel_ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "launch": (config(m, bs, dtype, nb_)
                                if config and device.type == "cuda"
                                else None)})
    return worst, rows


def timing(row):
    """The kernel line's measured and bound fields of one phase-3 row."""
    return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "kernel_ms")}


def reset_launches(*mods):
    for mod in mods:
        mod.LAUNCHES = 0


def reference_gr_terms(H, S, g, E, w, device, chunk=64):
    """Per-point w_k G(E_k) sums in complex128 by torch.linalg.solve, and
    max |G(E_k)| per point (a test reference, not the path)."""
    fn, params = g.total_apply()
    sig = fn({k: torch.as_tensor(v, device=device)
              for k, v in params.items()}, None)
    Hd = torch.as_tensor(H, dtype=torch.complex128, device=device)
    Sd = torch.as_tensor(S, dtype=torch.complex128, device=device)
    N = H.shape[0]
    eye = torch.eye(N, dtype=torch.complex128, device=device)
    total = torch.zeros((N, N), dtype=torch.complex128, device=device)
    gmax = []
    for i in range(0, len(E), chunk):
        Eb = torch.as_tensor(np.asarray(E[i:i + chunk], complex),
                             device=device)
        wb = torch.as_tensor(np.asarray(w[i:i + chunk], complex),
                             device=device)
        A = Eb[:, None, None] * Sd - Hd - sig
        G = torch.linalg.solve(A, eye.expand(A.shape).contiguous())
        total += (wb[:, None, None] * G).sum(0)
        gmax.append(G.abs().amax(dim=(1, 2)).cpu().numpy())
    return total.cpu().numpy(), np.concatenate(gmax)


def rel_err(x, ref):
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


def phase_gr_sum(kernels, device, N=1000, n_E=512, chunk=BATCH):
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    from gaunegf_tpu_torch.tune import bench_system
    H, S, g = bench_system(N)
    E = np.linspace(-2.0, 2.0, n_E)
    w = np.ones(n_E)
    cfg = ExecutionConfig(precision="mixed", solver="lu", lu_panel="pstrip",
                          energy_chunk=chunk)
    eng = EnergyEngine(H, S, g, cfg, device=device)
    ref, gmax = reference_gr_terms(H, S, g, E, w, device)
    out = eng.gr_sum(E, w)                   # warm-up and full-grid check
    full = rel_err(out, ref)
    far = gmax <= GR_FAR_MAX_G
    ref_far, _ = reference_gr_terms(H, S, g, E[far], w[far], device)
    far_err = rel_err(eng.gr_sum(E[far], w[far]), ref_far)
    reset_launches(*kernels)
    _sync(device)
    t0 = time.perf_counter()
    out = eng.gr_sum(E, w)
    _sync(device)
    dt = time.perf_counter() - t0
    launches = kernels[0].LAUNCHES
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        eng.gr_sum(E[:chunk], w[:chunk])
        lane_bytes = (torch.cuda.max_memory_allocated(device) - base) / chunk
    else:
        lane_bytes = float("nan")
    return {"N": N, "points": n_E, "rel_err_full": full,
            "rel_err_far": far_err, "far_points": int(far.sum()),
            "pts_per_s": n_E / dt, "seconds": dt, "launches": launches,
            "finite": bool(np.isfinite(out).all()),
            "lane_bytes": lane_bytes, "lane_bytes_per_n2": lane_bytes / N ** 2}


def reference_density_neq(negfe, device, rows=None):
    """The first FockToP density rebuilt in complex128 on the same grids:
    per-point torch.linalg.solve, full G Gamma G+ (a test reference).
    rows: the orbitals of one spin block of a block-diagonal system, solved
    on their own."""
    from gaunegf_tpu_torch import quadrature as quad
    rows = slice(None) if rows is None else rows
    E_r, w_r = quad.real_axis_grid(negfe.Eminf, negfe.Emin, negfe.N2, 0.0)
    z_c, w_c = quad.contour_grid(negfe.Emin, negfe.mu1, negfe.N1, negfe.T)
    E_eq = np.concatenate([np.asarray(E_r, complex), np.asarray(z_c, complex)])
    w_eq = np.concatenate([-np.asarray(w_r, complex),
                           np.asarray(w_c, complex)]) / np.pi
    E_n, w_n = quad.bias_window_grid(negfe.mu1, negfe.mu2, negfe.Nnegf,
                                     negfe.T)
    F = torch.as_tensor(negfe.F_eV[rows, rows], dtype=torch.complex128,
                        device=device)
    S = torch.as_tensor(negfe.S[rows, rows], dtype=torch.complex128,
                        device=device)
    sig1, sig2 = (torch.as_tensor(s[rows, rows], dtype=torch.complex128,
                                  device=device)
                  for s in negfe.g.params()["sigs"])
    gam2 = 1j * (sig2 - sig2.conj().T)
    N = F.shape[0]
    eye = torch.eye(N, dtype=torch.complex128, device=device)
    P = torch.zeros((N, N), dtype=torch.complex128, device=device)
    for E, w, neq in ((E_eq, w_eq, False),
                      (E_n, np.asarray(w_n) / (2 * np.pi), True)):
        for i in range(0, len(E), 32):
            Eb = torch.as_tensor(np.asarray(E[i:i + 32], complex),
                                 device=device)
            wb = torch.as_tensor(np.asarray(w[i:i + 32], complex),
                                 device=device)
            G = torch.linalg.solve(Eb[:, None, None] * S - F - sig1 - sig2,
                                   eye.expand(len(Eb), N, N).contiguous())
            if neq:
                P += (wb[:, None, None]
                      * (G @ gam2 @ G.conj().transpose(1, 2))).sum(0)
            else:
                P += (wb[:, None, None] * G).sum(0).imag
    return P.cpu().numpy()


def phase_scf(kernels, device, n=1000, N1=128, N2=64, chunk=BATCH, cycles=3):
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.models.fock import TightBindingFock
    from gaunegf_tpu_torch.scfe import NEGFE
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    backend = TightBindingFock(H0, n_electrons=n, U=0.5,
                               n0=0.5 * np.ones(n))
    cfg = ExecutionConfig(precision="mixed", solver="lu", lu_panel="pstrip",
                          energy_chunk=chunk)
    with tempfile.TemporaryDirectory() as tmp:
        negfe = NEGFE(backend, name=f"{tmp}/chain", exec_cfg=cfg,
                      device=device, verbose=False)
        negfe.setSigma([1, 2], [n - 1, n], sig=-0.1j)
        negfe.setIntegralLimits(N1=N1, N2=N2)
        negfe.setVoltage(0.1, fermi=0.0)
        negfe.FockToP()                      # the first cycle's density
        P_first = negfe.P.copy()
        p_err = rel_err(P_first, reference_density_neq(negfe, device))
        reset_launches(*kernels)
        _sync(device)
        t0 = time.perf_counter()
        counts, electrons, _ = negfe.SCF(conv=1e-5, damping=0.05,
                                         max_cycles=cycles)
        _sync(device)
        dt = time.perf_counter() - t0
    P = negfe.P
    return negfe, {"n": n, "points_per_cycle": N2 + N1 + negfe.Nnegf,
            "rel_err_first_P": p_err, "cycles": len(counts),
            "s_per_cycle": dt / len(counts), "launches": kernels[0].LAUNCHES,
            "nelec": float(electrons[-1]),
            "finite": bool(np.isfinite(P).all()),
            "hermitian_err": float(np.max(np.abs(P - P.conj().T)))}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sigma(g, device, E):
    """The provider's total and contact sigmas at the energies E (b,),
    complex128 on the device."""
    from gaunegf_tpu_torch.models.selfenergy import tree_map
    to = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.complex128,
                                   device=device)
    out = []
    for fn, params in (g.total_apply(), g.contact_apply(0),
                       g.contact_apply(-1)):
        s = fn(tree_map(to, params), E)
        out.append(s.expand(E.shape[0], *s.shape[-2:]))
    return out


def reference_transport(F, S, g, E, device, chunk=32):
    """T(E) and total DOS in complex128 by torch.linalg.solve on the full
    inverse (a test reference, not the path)."""
    Fd = torch.as_tensor(F, dtype=torch.complex128, device=device)
    Sd = torch.as_tensor(S, dtype=torch.complex128, device=device)
    N = Fd.shape[0]
    eye = torch.eye(N, dtype=torch.complex128, device=device)
    T, dos = [], []
    for i in range(0, len(E), chunk):
        Eb = torch.as_tensor(np.asarray(E[i:i + chunk], complex),
                             device=device)
        sig, s1, s2 = _sigma(g, device, Eb)
        G = torch.linalg.solve(Eb[:, None, None] * Sd - Fd - sig,
                               eye.expand(len(Eb), N, N).contiguous())
        g1 = 1j * (s1 - s1.conj().transpose(1, 2))
        g2 = 1j * (s2 - s2.conj().transpose(1, 2))
        M1 = g1 @ G
        M2 = g2 @ G.conj().transpose(1, 2)
        T.append(torch.einsum("bij,bji->b", M1, M2).real.cpu().numpy())
        dos.append((-G.diagonal(dim1=1, dim2=2).imag.sum(1) / np.pi)
                   .cpu().numpy())
    return np.concatenate(T), np.concatenate(dos)


def _timed(device, fn):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def phase_transport(negfe, kernels, device, chunk=BATCH):
    """Phase 6 on the SCF result; returns the result dict."""
    from gaunegf_tpu_torch import transport as tr
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.ops import greens
    from gaunegf_tpu_torch.tune import bench_system, measure
    se, pf, pl = kernels
    F, S, n = negfe.F, negfe.S, negfe.F.shape[0]
    res = {"n": n}

    # (a) the quick start's sweep, mixed tier on the fused panel
    g_const = negfe.g
    E_a = np.linspace(-3, 3, 500)
    cfg_a = ExecutionConfig(precision="mixed", solver="lu", lu_panel="fused",
                            energy_chunk=chunk)
    tr.calculate_transmission(F, S, tr.SigmaSource(g_const), E_a[:chunk],
                              exec_cfg=cfg_a, device=device)    # warm-up
    reset_launches(se, pf, pl)
    T_a, dt = _timed(device, lambda: tr.calculate_transmission(
        F, S, tr.SigmaSource(g_const), E_a, exec_cfg=cfg_a, device=device))
    launches = {"strip_elim": se.LAUNCHES, "panel_fused": pf.LAUNCHES,
                "panel_lu": pl.LAUNCHES}
    T_ref, _ = reference_transport(F, S, g_const, E_a, device)
    err = np.abs(T_a - T_ref)
    res["a"] = {"points": len(E_a), "pts_per_s": len(E_a) / dt,
                "seconds": dt, "max_abs_err_T": float(err.max()),
                "median_abs_err_T": float(np.median(err)),
                "max_T": float(T_ref.max()), "launches": launches,
                "finite": bool(np.isfinite(T_a).all())}

    # (c) Landauer current at the mixed tier (constant contacts)
    cfg_c = ExecutionConfig(precision="mixed", solver="lu",
                            energy_chunk=chunk)
    I, dt = _timed(device, lambda: tr.calculate_current(
        F, S, tr.SigmaSource(g_const), fermi=0.0, qV=0.1, exec_cfg=cfg_c,
        device=device))
    res["c"] = {"current_A": I, "seconds": dt}

    # (b) 1D-chain electrodes at the high tier
    lead = [np.array([[-1.0]]), np.array([[-1.0]])]
    negfe.setContact1D([[1], [n]], tau_list=lead,
                       stau_list=[np.zeros((1, 1))] * 2, eta=1e-4)
    g_chain = negfe.g
    E_b = np.linspace(-2.5, 2.5, 200)
    cfg_b = ExecutionConfig(precision="high", solver="lu", energy_chunk=chunk)
    tr.calculate_dos(F, S, tr.SigmaSource(g_chain), E_b[:chunk],
                     exec_cfg=cfg_b, device=device)            # warm-up
    reset_launches(se, pf, pl)
    T_b, dt_t = _timed(device, lambda: tr.calculate_transmission(
        F, S, tr.SigmaSource(g_chain), E_b, exec_cfg=cfg_b, device=device))
    (dos_b, _), dt_d = _timed(device, lambda: tr.calculate_dos(
        F, S, tr.SigmaSource(g_chain), E_b, exec_cfg=cfg_b, device=device))
    launches = {"strip_elim": se.LAUNCHES, "panel_fused": pf.LAUNCHES,
                "panel_lu": pl.LAUNCHES}
    T_ref, dos_ref = reference_transport(F, S, g_chain, E_b, device)
    res["b"] = {"points": len(E_b), "T_pts_per_s": len(E_b) / dt_t,
                "dos_pts_per_s": len(E_b) / dt_d,
                "max_abs_err_T": float(np.abs(T_b - T_ref).max()),
                "rel_err_dos": rel_err(dos_b, dos_ref),
                "T_range": [float(T_ref.min()), float(T_ref.max())],
                "launches": launches,
                "finite": bool(np.isfinite(T_b).all()
                               and np.isfinite(dos_b).all())}
    if device.type != "cuda":
        return res
    # bytes per energy lane of the complex128 (high-tier) LU, as phase 4
    H, Sb, gb = bench_system(1000)
    eng = greens.EnergyEngine(H, Sb, gb, ExecutionConfig(
        precision="high", solver="lu", energy_chunk=chunk), device=device)
    Eq = np.linspace(-2.0, 2.0, chunk)
    eng.gr_sum(Eq, np.ones(chunk))
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    eng.gr_sum(Eq, np.ones(chunk))
    lane = (torch.cuda.max_memory_allocated(device) - base) / chunk
    res["b"]["lane_bytes_per_n2_c128"] = lane / 1000 ** 2
    # (d) A/B of the complex64 panels at the bench shape (one call each
    # after a warm-up, in one process)
    res["d"] = {}
    for p in ("pstrip", "fused", "pallas"):
        r = measure(1000, 512, 0, chunk, device, p)
        res["d"][p] = r["pts_per_s"]
        res["d"][f"{p}_launches"] = r["launches"]
    return res


def check_transport(res):
    """Raise unless phase 6 ran its kernels, stayed finite and met its
    bounds."""
    a, b, c = res["a"], res["b"], res["c"]
    if a["launches"]["panel_fused"] <= 0 or not a["finite"] \
            or a["max_abs_err_T"] > T_MIXED_BOUND:
        raise AssertionError(f"transport (a) failed: {a}")
    if b["launches"]["panel_lu"] <= 0 or not b["finite"] \
            or b["max_abs_err_T"] > T_HIGH_BOUND \
            or b["rel_err_dos"] > DOS_HIGH_REL_BOUND:
        raise AssertionError(f"transport (b) failed: {b}")
    if not (np.isfinite(c["current_A"]) and c["current_A"] > 0):
        raise AssertionError(f"transport (c): current {c['current_A']} is "
                             "not finite and positive at qV=0.1")


def _spectral_engine(H, S, g, device, cfg=None):
    """An engine on the default solver='auto' with its spectral runner
    built; raises if the route declines.  Returns the seconds of the
    structure detection (two host probes) and of the runner (the basis
    from an empty cache)."""
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.ops import spectral as sp
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    sp._BASIS_CACHE.clear()
    _, detect = _timed(device, lambda: sp.detect_structure(g, S))
    eng = EnergyEngine(H, S, g, cfg or ExecutionConfig(precision="mixed"),
                       device=device)
    runner, basis = _timed(device, eng._spectral_runner)
    if runner is None:
        raise AssertionError("phase 7: the spectral runner declined "
                             f"(N={H.shape[0]}); no silent LU")
    return eng, runner, {"detect_s": detect, "basis_s": basis}


def _call_stats(eng, runner, E, w, device, reps=3):
    """Median seconds of reps gr_sum calls on the cached basis, peak
    device bytes of one call, the result, and the deflated points."""
    out, _ = _timed(device, lambda: eng.gr_sum(E, w))       # warm-up
    times = [_timed(device, lambda: eng.gr_sum(E, w))[1] for _ in range(reps)]
    peak = float("nan")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        eng.gr_sum(E, w)
        peak = torch.cuda.max_memory_allocated(device) - base
    dt = float(np.median(times))
    near = int((runner._dists(E) < eng.exec_cfg.spectral_dist_f32).sum())
    return out, {"points": len(E), "pts_per_s": len(E) / dt,
                 "seconds": times, "deflated_points": near,
                 "min_pole_dist": float(runner._dists(E).min()),
                 "peak_bytes": peak, "chunk": runner.exec_cfg.energy_chunk}


def reference_contact_cols(H, S, g, E, cols, device, chunk=64):
    """G(E)[:, cols] per point in complex128 by torch.linalg.solve on
    unit right-hand sides (a test reference, not the path)."""
    Hd = torch.as_tensor(H, dtype=torch.complex128, device=device)
    Sd = torch.as_tensor(S, dtype=torch.complex128, device=device)
    N = H.shape[0]
    B = torch.zeros((N, len(cols)), dtype=torch.complex128, device=device)
    B[list(cols), torch.arange(len(cols))] = 1.0
    out = []
    for i in range(0, len(E), chunk):
        Eb = torch.as_tensor(np.asarray(E[i:i + chunk], complex),
                             device=device)
        sig, _, _ = _sigma(g, device, Eb)
        A = Eb[:, None, None] * Sd - Hd - sig
        out.append(torch.linalg.solve(A, B.expand(len(Eb), N, len(cols))))
    return torch.cat(out)


def phase_spectral(kernels, device, lu_s_per_cycle, N=1000, n_E=512,
                   N_big=2000, n_E_big=128, n_win=50, scf_n=1000, N1=128,
                   N2=64, cycles=3):
    """Phase 7; returns the result dict (raises on a declined runner)."""
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.models.fock import TightBindingFock
    from gaunegf_tpu_torch.scfe import NEGFE
    from gaunegf_tpu_torch.tune import bench_system
    res = {}
    # (a), (b): gr_sum at the bench shape and at N=2000
    for key, n, nE in (("a", N, n_E), ("b", N_big, n_E_big)):
        H, S, g = bench_system(n)
        E = np.linspace(-2.0, 2.0, nE)
        w = np.ones(nE)
        reset_launches(*kernels)
        eng, runner, setup = _spectral_engine(H, S, g, device)
        out, stats = _call_stats(eng, runner, E, w, device)
        ref, _ = reference_gr_terms(H, S, g, E, w, device)
        far = runner._dists(E) >= eng.exec_cfg.spectral_dist_f32
        ref_far, _ = reference_gr_terms(H, S, g, E[far], w[far], device)
        res[key] = {"N": n, **setup, **stats,
                    "rel_err": rel_err(out, ref),
                    "rel_err_far": rel_err(eng.gr_sum(E[far], w[far]),
                                           ref_far),
                    "finite": bool(np.isfinite(out).all()),
                    "launches": [m.LAUNCHES for m in kernels]}
    # (c): T(E) over the bench grid, G< (contact 1) over a bias window
    H, S, g = bench_system(N)
    E = np.linspace(-2.0, 2.0, n_E)
    reset_launches(*kernels)
    eng, runner, _ = _spectral_engine(H, S, g, device)
    eng.transmission(E[:8])                                   # warm-up
    T, dt = _timed(device, lambda: eng.transmission(E))
    c1, c2 = g.contact_inds(0), g.contact_inds(-1)
    G12 = reference_contact_cols(H, S, g, E, c2, device)[:, list(c1)]
    s1, s2 = (torch.as_tensor(x, dtype=torch.complex128, device=device)
              for x in g.params()["sigs"])
    blk1 = s1[list(c1)][:, list(c1)]
    blk2 = s2[list(c2)][:, list(c2)]
    gam1 = 1j * (blk1 - blk1.conj().T)
    gam2 = 1j * (blk2 - blk2.conj().T)
    T_ref = torch.einsum("bij,bji->b", gam1 @ G12,
                         gam2 @ G12.conj().transpose(1, 2)).real
    T_ref = T_ref.cpu().numpy()
    Ew = np.linspace(-0.05, 0.05, n_win)
    ww = np.full(n_win, 0.1 / n_win)
    gl, dt_gl = _timed(device, lambda: eng.gless_sum(Ew, ww, 1))
    c = list(runner.c)
    Y = reference_contact_cols(H, S, g, Ew, c, device)
    blk = s2[c][:, c]
    gam = 1j * (blk - blk.conj().T)
    wt = torch.as_tensor(ww, dtype=torch.complex128, device=device)
    gl_ref = ((wt[:, None, None] * (Y @ gam @ Y.conj().transpose(1, 2)))
              .sum(0).cpu().numpy())
    res["c"] = {"N": N, "T_points": len(E), "T_pts_per_s": len(E) / dt,
                "max_abs_err_T": float(np.abs(T - T_ref).max()),
                "T_range": [float(T_ref.min()), float(T_ref.max())],
                "gless_points": n_win, "gless_seconds": dt_gl,
                "rel_err_gless": rel_err(gl, gl_ref),
                "finite": bool(np.isfinite(T).all()
                               and np.isfinite(gl).all()),
                "launches": [m.LAUNCHES for m in kernels]}
    # (d): the biased SCF of phase 5 on the default configuration
    H0 = -1.0 * (np.eye(scf_n, k=1) + np.eye(scf_n, k=-1))
    backend = TightBindingFock(H0, n_electrons=scf_n, U=0.5,
                               n0=0.5 * np.ones(scf_n))
    with tempfile.TemporaryDirectory() as tmp:
        negfe = NEGFE(backend, name=f"{tmp}/chain", exec_cfg=ExecutionConfig(),
                      device=device, verbose=False)
        negfe.setSigma([1, 2], [scf_n - 1, scf_n], sig=-0.1j)
        negfe.setIntegralLimits(N1=N1, N2=N2)
        negfe.setVoltage(0.1, fermi=0.0)
        _, _, setup = _spectral_engine(negfe.F_eV, negfe.S, negfe.g, device,
                                       negfe.exec_cfg)
        negfe.FockToP()                      # the first cycle's density
        p_err = rel_err(negfe.P, reference_density_neq(negfe, device))
        reset_launches(*kernels)
        _sync(device)
        t0 = time.perf_counter()
        counts, electrons, _ = negfe.SCF(conv=1e-5, damping=0.05,
                                         max_cycles=cycles)
        _sync(device)
        dt = time.perf_counter() - t0
    P = negfe.P
    res["d"] = {"n": scf_n, "points_per_cycle": N2 + N1 + negfe.Nnegf,
                **setup, "rel_err_first_P": p_err,
                "cycles": len(counts), "s_per_cycle": dt / len(counts),
                "lu_s_per_cycle": lu_s_per_cycle,
                "nelec": float(electrons[-1]),
                "finite": bool(np.isfinite(P).all()),
                "hermitian_err": float(np.max(np.abs(P - P.conj().T))),
                "launches": [m.LAUNCHES for m in kernels]}
    return res


def check_spectral(res):
    """Raise unless phase 7 stayed finite and met its bounds."""
    for key in ("a", "b"):
        r = res[key]
        if not r["finite"] or r["rel_err"] > SP_GR_BOUND[key]:
            raise AssertionError(f"spectral ({key}) failed: {r}")
    c = res["c"]
    if not c["finite"] or c["max_abs_err_T"] > SP_T_BOUND \
            or c["rel_err_gless"] > SP_GLESS_BOUND:
        raise AssertionError(f"spectral (c) failed: {c}")
    d = res["d"]
    if not d["finite"] or d["hermitian_err"] > 1e-6 or d["cycles"] < 3 \
            or d["rel_err_first_P"] > SP_P_BOUND:
        raise AssertionError(f"spectral (d) failed: {d}")


class _Spy:
    """Counts taken around a stretch of phase 8 by wrapping functions of
    the package for that stretch: Fermi-search probes, pencil
    eigendecompositions, and the grid length of every engine sum."""

    def __init__(self):
        self.probes = 0
        self.last = {}              # probe energy -> electron-count error
        self.eighs = 0
        self.grids = {"gr_sum": [], "gless_sum": []}

    def __enter__(self):
        from gaunegf_tpu_torch import fermi
        from gaunegf_tpu_torch.ops import greens, spectral
        spy = self
        self._saved = [(fermi, "_DensityProbe", fermi._DensityProbe),
                       (spectral, "_eigh_pencil", spectral._eigh_pencil),
                       (greens.EnergyEngine, "gr_sum",
                        greens.EnergyEngine.gr_sum),
                       (greens.EnergyEngine, "gless_sum",
                        greens.EnergyEngine.gless_sum)]

        class Probe(fermi._DensityProbe):
            def __call__(self, E):
                spy.probes += 1
                out = super().__call__(E)
                spy.last[E] = out[0]
                return out

        def eigh(*a, **k):
            spy.eighs += 1
            return self._saved[1][2](*a, **k)

        def sized(name, fn):
            def wrapped(eng, E, *a, **k):
                spy.grids[name].append(int(np.size(E)))
                return fn(eng, E, *a, **k)
            return wrapped

        fermi._DensityProbe = Probe
        spectral._eigh_pencil = eigh
        greens.EnergyEngine.gr_sum = sized("gr_sum", self._saved[2][2])
        greens.EnergyEngine.gless_sum = sized("gless_sum", self._saved[3][2])
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def _junction(device, tmp, n, cfg=None, spin="r", exchange=0.0, N1=128,
              N2=64):
    """The README quick start's junction: an n-site chain with a Hubbard
    mean field, contacts [1, 2] and [n-1, n] at -0.1j, fixed grids."""
    from gaunegf_tpu_torch.models.fock import TightBindingFock
    from gaunegf_tpu_torch.scfe import NEGFE
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    backend = TightBindingFock(H0, n_electrons=n, U=0.5, n0=0.5 * np.ones(n),
                               spin=spin, exchange=exchange)
    negfe = NEGFE(backend, spin=spin, name=f"{tmp}/{spin}{n}", exec_cfg=cfg,
                  device=device, verbose=False)
    negfe.setSigma([1, 2], [n - 1, n], sig=-0.1j)
    negfe.setIntegralLimits(N1=N1, N2=N2)
    return negfe


def _reference_count(negfe, Emin, fermi, device):
    """Electrons below ``fermi`` on negfe's Fock matrix and grids, by the
    exact-tier LU (complex128 blocked LU and a Newton step): the lower
    real-axis segment plus the contour from Emin, as a search counts."""
    from gaunegf_tpu_torch import density as dens
    from gaunegf_tpu_torch.config import ExecutionConfig
    cfg = ExecutionConfig(precision="exact", solver="lu")
    P = dens.density_real_n(negfe.F_eV, negfe.S, negfe.g, negfe.Eminf, Emin,
                            negfe.N2, T=0, exec_cfg=cfg, device=device) \
        + dens.density_complex_n(negfe.F_eV, negfe.S, negfe.g, Emin, fermi,
                                 N=negfe.N1, T=negfe.T, exec_cfg=cfg,
                                 device=device)
    return float(np.einsum("ij,ji->", P, negfe.S).real)


def _search_once(negfe, device):
    """One FockToP under upd_fermi on the current Fock matrix: the found
    level, the search's conv and target, probes, eighs, seconds, the
    search's own count error at the found level (None where it returns a
    level it did not probe, as the secant does), and that level's electron
    count rebuilt by the exact-tier LU."""
    from gaunegf_tpu_torch.config import FERMI_CALCULATION_TOL
    conv = min(negfe.conv_level, FERMI_CALCULATION_TOL)
    target = negfe.backend.n_electrons / (2 if negfe.spin == "r" else 1)
    Emin = negfe.Emin
    with _Spy() as spy:
        _, dt = _timed(device, negfe.FockToP)
    n_ref = _reference_count(negfe, Emin, negfe.fermi, device)
    return {"method": negfe.fermi_method, "fermi": negfe.fermi,
            "probes": spy.probes, "eighs": spy.eighs, "seconds": dt,
            "conv": conv, "target": target, "n_ref": n_ref,
            "n_err_ref": n_ref - target,
            "n_err_search": spy.last.get(negfe.fermi),
            "finite": bool(np.isfinite(negfe.P).all())}


def _fermi_scf(negfe, device, cycles):
    """cycles SCF cycles under upd_fermi; per cycle the Fermi level, the
    probes and the eighs."""
    per = []
    with _Spy() as spy:
        def note(d):
            per.append({"fermi": d.fermi, "probes": spy.probes,
                        "eighs": spy.eighs})
        _sync(device)
        t0 = time.perf_counter()
        counts, electrons, _ = negfe.SCF(conv=1e-5, damping=0.05,
                                         max_cycles=cycles - 1,
                                         callback=note)
        _sync(device)
        dt = time.perf_counter() - t0
    for later, earlier in zip(per[:0:-1], per[-2::-1]):   # totals -> deltas
        later["probes"] -= earlier["probes"]
        later["eighs"] -= earlier["eighs"]
    return {"cycles": len(counts), "s_per_cycle": dt / len(counts),
            "per_cycle": per, "nelec": float(electrons[-1])}


def _dense_spinor_reference(F, S, sig1, sig2, E, device):
    """Per energy, in the spinor-interleaved layout as stored: the four
    spin-block channels of T(E) (even/odd index sets as up/down) and the
    per-site DOS, from complex128 dense inverses."""
    Fd, Sd, s1, s2 = (torch.as_tensor(np.asarray(x), dtype=torch.complex128,
                                      device=device)
                      for x in (F, S, sig1, sig2))
    g1 = 1j * (s1 - s1.conj().T)
    g2 = 1j * (s2 - s2.conj().T)
    T, site = [], []
    up, dn = slice(0, None, 2), slice(1, None, 2)
    for e in E:
        G = torch.linalg.inv(complex(e) * Sd - Fd - s1 - s2)
        Ga = G.conj().T
        T.append([float(torch.trace(g1[r, r] @ G[r, c] @ g2[c, c]
                                    @ Ga[r, c]).real)
                  for r, c in ((up, up), (up, dn), (dn, up), (dn, dn))])
        site.append((-G.diagonal().imag / np.pi).cpu().numpy())
    return np.array(T), np.array(site)


def phase_fermi(kernels, device, n=1000, n_g=500, N1=128, N2=64, cycles=3,
                n_T=200, n_sample=20, fixed=(512, 256, 200)):
    """Phase 8; returns the result dict."""
    from gaunegf_tpu_torch import density as dens
    from gaunegf_tpu_torch import transport as tr
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
    se, pf, pl = kernels
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) setVoltage without a Fermi level: a search in every cycle
        from gaunegf_tpu_torch.ops import spectral
        spectral._BASIS_CACHE.clear()       # count every Fock's eigh
        reset_launches(*kernels)
        negfe = _junction(device, tmp, n, N1=N1, N2=N2)
        negfe.setVoltage(0.1)
        a = {"n": n, "method": negfe.fermi_method,
             **_fermi_scf(negfe, device, cycles),
             "launches": [m.LAUNCHES for m in kernels]}
        a["check"] = _search_once(negfe, device)
        a["others"] = []
        for method in ("secant", "bisect", "poly", "predict"):
            d = _junction(device, tmp, n, N1=N1, N2=N2)
            d.setVoltage(0.1, fermi_method=method)
            a["others"].append(_search_once(d, device))
        # a search that has to move: the same junction started 0.03 eV off
        d = _junction(device, tmp, n, N1=N1, N2=N2)
        d.fermi = 0.03
        d.setVoltage(0.1)
        a["displaced"] = _fermi_scf(d, device, 2)
        Emin = d.Emin
        last = _search_once(d, device)
        n_port = float(np.einsum("ij,ji->", (
            dens.density_real_n(d.F_eV, d.S, d.g, d.Eminf, Emin, N2, T=0,
                                device=device)
            + dens.density_complex_n(d.F_eV, d.S, d.g, Emin, d.fermi, N=N1,
                                     T=d.T, device=device)), d.S).real)
        a["displaced"]["last"] = {**last, "n_port": n_port,
                                  "probe_err": abs(n_port - last["n_ref"])}
        res["a"] = a

        # (b) every grid adaptive, at a fixed Fermi level under bias
        d = _junction(device, tmp, n)
        d.setIntegralLimits()
        d.setVoltage(0.1, fermi=0.0)
        with _Spy() as spy:
            _, dt = _timed(device, d.FockToP)
        P_adaptive = d.P.copy()
        d.setIntegralLimits(N1=fixed[0], N2=fixed[1], Nnegf=fixed[2],
                            Emin=d.Emin)
        _, dt_fixed = _timed(device, d.FockToP)
        low_a = dens.density_real(d.F_eV, d.S, d.g, d.Eminf, d.Emin, d.tol,
                                  T=0, device=device, verbose=False)
        low_f = dens.density_real_n(d.F_eV, d.S, d.g, d.Eminf, d.Emin,
                                    fixed[1], T=0, device=device)
        window = {k: dens.density_grid_n(d.F_eV, d.S, d.g, d.mu1, d.mu2,
                                         ind=-1, N=k, T=d.T, device=device)
                  for k in (fixed[2], 1000)}
        win_a = dens.density_grid(d.F_eV, d.S, d.g, d.mu1, d.mu2, ind=-1,
                                  tol=d.tol, T=d.T, device=device)
        pmax = float(np.abs(d.P).max())
        res["b"] = {
            "n": n, "seconds": dt, "fixed_seconds": dt_fixed,
            "points_gr_sum": spy.grids["gr_sum"],
            "points_gless_sum": spy.grids["gless_sum"],
            "fixed_grids": list(fixed), "max_P": pmax,
            "rel_err_vs_fixed": float(np.abs(P_adaptive - d.P).max()) / pmax,
            "rel_err_contour_window": float(np.abs(
                (P_adaptive - low_a) - (d.P - low_f)).max()) / pmax,
            "lower_tail_left_out": float(np.abs(low_f - low_a).max()),
            "window_adaptive_vs_fixed": float(np.abs(
                win_a - window[fixed[2]]).max()) / pmax,
            "window_fixed_vs_1000": float(np.abs(
                window[fixed[2]] - window[1000]).max()) / pmax,
            "finite": bool(np.isfinite(P_adaptive).all())}

        # (c) integralCheck on (a)'s system; a fully specified chain lead
        _, dt = _timed(device, lambda: negfe.integralCheck(cycles=2))
        res["c"] = {"integral_check_seconds": dt, "N1": negfe.N1,
                    "N2": negfe.N2, "Nnegf": negfe.Nnegf,
                    "Emin": negfe.Emin, "fermi": negfe.fermi,
                    "nelec": float(negfe.updateN()),
                    "finite": bool(np.isfinite(negfe.P).all())}
        alpha = -1.0 * (np.eye(2, k=1) + np.eye(2, k=-1))
        beta = np.zeros((2, 2))
        beta[0, -1] = -1.0
        zero = np.zeros((2, 2))
        d = _junction(device, tmp, n)
        _, dt = _timed(device, lambda: d.setContact1D(
            [[1, 2], [n - 1, n]], tau_list=[beta, beta.T],
            stau_list=[zero, zero], alphas=[alpha, alpha],
            a_overlaps=[np.eye(2)] * 2, betas=[beta, beta],
            b_overlaps=[zero, zero], ne_list=[1.0, 1.0], eta=1e-4))
        leads = list(d.g.fermi_list)
        d.setIntegralLimits(N1=N1, N2=N2)
        d.setVoltage(0.1, fermi=0.0)
        _, dt_p = _timed(device, d.FockToP)
        res["c"].update({"lead_seconds": dt, "lead_fermi": leads,
                         "chain_focktop_seconds": dt_p,
                         "chain_finite": bool(np.isfinite(d.P).all()),
                         "chain_nelec": float(d.updateN())})

        # (d) spin 'u' at 2N = 2n on the default configuration
        reset_launches(*kernels)
        d = _junction(device, tmp, n, spin="u", exchange=0.2, N1=N1, N2=N2)
        d.setVoltage(0.1, fermi=0.0)
        d.FockToP()
        blocks = (slice(0, n), slice(n, 2 * n))
        p_err = max(rel_err(d.P[b, b], reference_density_neq(d, device, b))
                    for b in blocks)
        cross = float(np.abs(d.P[blocks[0], blocks[1]]).max())
        _sync(device)
        t0 = time.perf_counter()
        counts, electrons, _ = d.SCF(conv=1e-5, damping=0.05,
                                     max_cycles=cycles - 1)
        _sync(device)
        dt = time.perf_counter() - t0
        occ = np.real(np.diag(d.P))
        E = np.linspace(-3, 3, n_T)
        cfg_t = ExecutionConfig(precision="mixed", solver="lu",
                                lu_panel="fused")
        src = tr.SigmaSource(d.sigma1, d.sigma2)
        scf_launches = [m.LAUNCHES for m in kernels]
        tr.calculate_transmission(d.F, d.S, src, E[:2], spin="u",
                                  exec_cfg=cfg_t, device=device)   # warm-up
        reset_launches(*kernels)
        (T, Tspin), dt_T = _timed(device, lambda: tr.calculate_transmission(
            d.F, d.S, src, E, spin="u", exec_cfg=cfg_t, device=device))
        T_launches = [m.LAUNCHES for m in kernels]
        ends = [np.arange(2), np.arange(n - 2, n)]
        T_ref = [reference_transport(
            d.F[b, b], d.S[b, b], ConstantSelfEnergy(
                d.F[b, b], d.S[b, b], ends, sig1=-0.1j), E, device)[0]
            for b in blocks]
        res["d_u"] = {
            "N": 2 * n, "rel_err_first_P": p_err, "cross_block_P": cross,
            "cycles": len(counts), "s_per_cycle": dt / len(counts),
            "nelec": float(electrons[-1]),
            "polarization": float(occ[:n].sum() - occ[n:].sum()),
            "scf_launches": scf_launches,
            "T_points": n_T, "T_pts_per_s": n_T / dt_T,
            "T_launches": T_launches,
            "max_abs_err_T_uu": float(np.abs(Tspin[:, 0] - T_ref[0]).max()),
            "max_abs_err_T_dd": float(np.abs(Tspin[:, 3] - T_ref[1]).max()),
            "max_spin_flip_T": float(np.abs(Tspin[:, 1:3]).max()),
            "uu_minus_dd": float(np.abs(Tspin[:, 0] - Tspin[:, 3]).max()),
            "sum_err": float(np.abs(T - Tspin.sum(axis=1)).max()),
            "finite": bool(np.isfinite(d.P).all()
                           and np.isfinite(Tspin).all())}

        # (d) spin 'g' at 2N = 2 n_g: the default configuration, then the LU
        E_s = np.linspace(-2, 2, n_sample)
        for key, cfg in (("d_g_default", ExecutionConfig()),
                         ("d_g_lu", ExecutionConfig(solver="lu"))):
            reset_launches(*kernels)
            d = _junction(device, tmp, n_g, cfg=cfg, spin="g", exchange=0.2,
                          N1=N1, N2=N2)
            d.setVoltage(0.1, fermi=0.0)
            from gaunegf_tpu_torch.ops.greens import EnergyEngine
            route = "spectral" if EnergyEngine(
                d.F_eV, d.S, d.g, d.exec_cfg,
                device=device)._spectral_runner() is not None else "lu"
            d.FockToP()
            p_err = rel_err(d.P, reference_density_neq(d, device))
            _sync(device)
            t0 = time.perf_counter()
            counts, electrons, _ = d.SCF(conv=1e-5, damping=0.05,
                                         max_cycles=cycles - 1)
            _sync(device)
            dt = time.perf_counter() - t0
            scf_launches = [m.LAUNCHES for m in kernels]
            # transport with N x N sigmas, expanded by the source
            s1 = d.sigma1[0::2, 0::2]
            s2 = d.sigma2[0::2, 0::2]
            src = tr.SigmaSource(s1, s2)
            kw = dict(spin="g", exec_cfg=cfg, device=device)
            T, Tspin = tr.calculate_transmission(d.F, d.S, src, E_s, **kw)
            _, site, dspin = tr.calculate_dos(d.F, d.S, src, E_s, **kw)
            T_ref, site_ref = _dense_spinor_reference(
                d.F, d.S, np.kron(s1, np.eye(2)), np.kron(s2, np.eye(2)),
                E_s, device)
            res[key] = {
                "N": 2 * n_g, "route": route, "rel_err_first_P": p_err,
                "cycles": len(counts), "s_per_cycle": dt / len(counts),
                "nelec": float(electrons[-1]),
                "transverse_P": float(np.abs(
                    d.P[0::2, 1::2].diagonal()).max()),
                "scf_launches": scf_launches,
                "launches": [m.LAUNCHES for m in kernels],
                "sample_points": n_sample,
                "max_abs_err_T": float(np.abs(Tspin - T_ref).max()),
                "max_spin_flip_T": float(Tspin[:, 1:3].max()),
                "rel_err_site_dos": rel_err(site, site_ref),
                "dos_spin_err": float(np.abs(
                    dspin - np.stack([site_ref[:, 0::2].sum(1),
                                      site_ref[:, 1::2].sum(1)], 1)).max()
                    / np.abs(site_ref).max()),
                "finite": bool(np.isfinite(d.P).all()
                               and np.isfinite(Tspin).all()
                               and np.isfinite(site).all())}
    return res


def check_fermi(res, cycles=3):
    """Raise unless phase 8 stayed finite and met its bounds."""
    a = res["a"]
    for one in [a["check"]] + a["others"] + [a["displaced"]["last"]]:
        if not one["finite"]:
            raise AssertionError(f"fermi (a) search failed: {one}")
    for one in [a["check"]] + a["others"] + [a["displaced"]["last"]]:
        if one["method"] == "predict":
            continue
        own = one["n_err_search"]
        if one["probes"] < 1 or (own is not None and abs(
                one["n_err_ref"] - own) > FERMI_PROBE_BOUND):
            raise AssertionError(
                f"fermi (a): the search's count at the found level is off "
                f"the complex128 rebuild: {one}")
        # a search that reports convergence must be within conv there
        if (own is None or abs(own) <= one["conv"]) \
                and abs(one["n_err_ref"]) > one["conv"]:
            raise AssertionError(
                f"fermi (a): the found level's complex128 electron count is "
                f"{one['n_err_ref']:.3e} off the target, conv "
                f"{one['conv']:g}: {one}")
    if a["cycles"] < cycles or any(c["eighs"] != 1 for c in a["per_cycle"]):
        raise AssertionError(f"fermi (a): not one eigh per Fock: {a}")
    if a["displaced"]["last"]["probe_err"] > FERMI_PROBE_BOUND \
            or sum(c["probes"] for c in a["displaced"]["per_cycle"]) < 4:
        raise AssertionError(f"fermi (a) displaced start: {a['displaced']}")
    if any(a["launches"]):
        raise AssertionError("fermi (a): the default configuration must "
                             f"stay on the spectral route: {a['launches']}")
    b = res["b"]
    if not b["finite"] or b["rel_err_contour_window"] > ADAPTIVE_P_BOUND \
            or b["lower_tail_left_out"] > LOWER_TAIL_BOUND:
        raise AssertionError(f"fermi (b) failed: {b}")
    c = res["c"]
    if not (c["finite"] and c["chain_finite"] and c["N1"] >= 8
            and c["N2"] >= 8 and c["Nnegf"] >= 8
            and max(abs(mu) for mu in c["lead_fermi"]) < 0.05):
        raise AssertionError(f"fermi (c) failed: {c}")
    u = res["d_u"]
    if not u["finite"] or u["rel_err_first_P"] > SP_P_BOUND \
            or u["cycles"] < cycles \
            or max(u["max_abs_err_T_uu"], u["max_abs_err_T_dd"]) \
            > T_MIXED_BOUND or u["max_spin_flip_T"] > SPIN_FLIP_BOUND \
            or u["uu_minus_dd"] < 1e-3:
        raise AssertionError(f"fermi (d) 'u' failed: {u}")
    for key, p_bound in (("d_g_default", SP_P_BOUND), ("d_g_lu", SCF_P_BOUND)):
        g = res[key]
        if not g["finite"] or g["rel_err_first_P"] > p_bound \
                or g["cycles"] < cycles \
                or g["max_abs_err_T"] > T_MIXED_BOUND \
                or g["rel_err_site_dos"] > SPIN_DOS_REL_BOUND \
                or g["dos_spin_err"] > SPIN_DOS_REL_BOUND \
                or g["max_spin_flip_T"] < 1e-4:
            raise AssertionError(f"fermi (d) {key} failed: {g}")
    if res["d_g_default"]["route"] != "spectral" \
            or any(res["d_g_default"]["scf_launches"]):
        raise AssertionError("fermi (d): 'g' on the default configuration "
                             f"left the spectral route: {res['d_g_default']}")
    # the kernels of the paths that pin the LU must have launched
    if u["T_launches"][1] <= 0:
        raise AssertionError("fermi (d): the 'u' T(E) sweep on the fused "
                             f"panel launched no panel_fused kernel: {u}")
    if res["d_g_lu"]["route"] != "lu" or res["d_g_lu"]["scf_launches"][0] <= 0:
        raise AssertionError("fermi (d): 'g' with solver='lu' must launch "
                             f"the strip kernel: {res['d_g_lu']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (build and kernel checks)")
    ap.add_argument("--only-fermi", action="store_true",
                    help="after the build, run phase 8 alone (prints no "
                         "kernel table and no result line)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("phase 1 device: FAIL, torch sees no CUDA device")
        return 1
    device = torch.device("cuda", 0)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})",
          flush=True)
    print(f"nvidia-smi: {device_line()}", flush=True)

    from gaunegf_tpu_torch.ops.kernels import _build
    from gaunegf_tpu_torch.ops.kernels import panel_fused as pf
    from gaunegf_tpu_torch.ops.kernels import panel_lu as pl
    from gaunegf_tpu_torch.ops.kernels import strip_elim as se
    t0 = time.perf_counter()
    _build.build_libraries()
    for mod in (se, pf, pl):
        mod.build()
    print(f"phase 2 build: 3 libraries built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in _build.BUILD_LOGS.items():
        ptxas = " | ".join(line.strip() for line in log.splitlines()
                           if "registers" in line or "spill" in line)
        print(f"  ptxas {name}: {ptxas}", flush=True)

    if args.only_fermi:
        fermi = phase_fermi((se, pf, pl), device)
        print(f"phase 8 fermi: {json.dumps(fermi)}", flush=True)
        check_fermi(fermi)
        return 0

    worst, rows = phase_kernel(se, device)
    main_row = rows[0]
    print("phase 3 kernel strip_elim: identical pivots/avail on "
          f"{len(rows)} cases, max rel err {worst:.3e} (bound "
          f"{KERNEL_REL_BOUND:.3e}); ms kernel/plain/lu_factor_ex/bound: "
          + ", ".join(f"{r['case']} {r['ms']:.4f}/{r['plain_ms']:.3f}/"
                      f"{r['library_ms']:.4f}/{r['bound_ms']:.4f}"
                      for r in rows), flush=True)
    print("  strip_elim kernel device ms (profiler): " + ", ".join(
        f"{r['case']} {r['kernel_ms']}" for r in rows), flush=True)
    print(f"  strip_elim launch shapes: " + ", ".join(
        f"{r['case']} {r['launch']}" for r in rows), flush=True)
    panel_rows = {}
    for name, mod, kernel, plain, dtypes, extra in (
            ("panel_fused", pf, pf.factor_panel_fused,
             pf.factor_panel_fused_plain, (torch.complex64,),
             {"name": "panel_fused_kernel",
              "config": lambda m, bs, dtype, batch: pf.config(m, bs, batch),
              "large": (LARGE_M,)}),
            ("panel_lu", pl, pl.factor_panel_lu, pl.factor_panel_lu_plain,
             (torch.complex64, torch.complex128),
             {"name": "panel_lu_kernel",
              "config": lambda m, bs, dtype, batch: pl.config(m, dtype, batch),
              "large": (LARGE_M,)})):
        panel_rows[name] = []
        for dtype in dtypes:
            w, r = phase_panel(kernel, plain, device, dtype, **extra)
            panel_rows[name] += r
            print(f"phase 3 kernel {name} {dtype}: identical perms on "
                  f"{len(r)} cases, max rel err {w:.3e} (bound "
                  f"{PANEL_REL_BOUND[dtype]:.3e}); ms kernel/plain/"
                  "lu_factor_ex/bound: "
                  + ", ".join(f"{x['case']} {x['ms']:.4f}/"
                              f"{x['plain_ms']:.3f}/{x['library_ms']:.4f}/"
                              f"{x['bound_ms']:.4f}" for x in r), flush=True)
            print(f"  {name} {dtype} kernel device ms (profiler): " + ", ".join(
                f"{x['case']} {x['kernel_ms']}" for x in r), flush=True)
            if "config" in extra:
                print(f"  {name} {dtype} launch shapes: " + ", ".join(
                    f"{x['case']} {x['launch']}" for x in r), flush=True)
    if args.kernels_only:
        return 0

    gr = phase_gr_sum((se, pf, pl), device)
    print(f"phase 4 gr_sum: {json.dumps(gr)}", flush=True)
    if not gr["finite"] or gr["launches"] <= 0:
        raise AssertionError(f"gr_sum: finite={gr['finite']} "
                             f"launches={gr['launches']}")
    if gr["rel_err_far"] > GR_FAR_BOUND or gr["rel_err_full"] > GR_FULL_BOUND:
        raise AssertionError(
            f"gr_sum off the complex128 reference: far {gr['rel_err_far']:.3e}"
            f" (bound {GR_FAR_BOUND:g}), full {gr['rel_err_full']:.3e} "
            f"(bound {GR_FULL_BOUND:g})")

    negfe, scf = phase_scf((se, pf, pl), device)
    print(f"phase 5 scf: {json.dumps(scf)}", flush=True)
    if not scf["finite"] or scf["hermitian_err"] > 1e-6 \
            or scf["launches"] <= 0 or scf["cycles"] < 3:
        raise AssertionError(f"scf failed: {scf}")
    if scf["rel_err_first_P"] > SCF_P_BOUND:
        raise AssertionError(f"first SCF density off the complex128 "
                             f"reference: {scf['rel_err_first_P']:.3e} > "
                             f"{SCF_P_BOUND:g}")

    trans = phase_transport(negfe, (se, pf, pl), device)
    print(f"phase 6 transport: {json.dumps(trans)}", flush=True)
    check_transport(trans)

    spec = phase_spectral((se, pf, pl), device, scf["s_per_cycle"])
    print(f"phase 7 spectral: {json.dumps(spec)}", flush=True)
    check_spectral(spec)

    fermi = phase_fermi((se, pf, pl), device)
    print(f"phase 8 fermi: {json.dumps(fermi)}", flush=True)
    check_fermi(fermi)

    fused_main = panel_rows["panel_fused"][0]          # (1024, 256)
    lu_main = next(r for r in panel_rows["panel_lu"]
                   if r["dtype"] == "complex128")      # (1024, 256)
    print(json.dumps({"kernels": [{
        "name": "strip_elim", "route": "cuda",
        "source": "gaunegf_tpu_torch/csrc/strip_elim.cu",
        "replaces": "gaunegf_tpu/ops/pallas/strip_elim.py:104",
        "launches": scf["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **timing(main_row)}, {
        "name": "panel_fused", "route": "cuda",
        "source": "gaunegf_tpu_torch/csrc/panel_fused.cu",
        "replaces": "gaunegf_tpu/ops/pallas/panel_fused.py:255",
        "launches": trans["a"]["launches"]["panel_fused"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in panel_rows["panel_fused"]),
        **timing(fused_main)}, {
        "name": "panel_lu", "route": "cuda",
        "source": "gaunegf_tpu_torch/csrc/panel_lu.cu",
        "replaces": "gaunegf_tpu/ops/pallas/panel_lu.py:109",
        "launches": trans["b"]["launches"]["panel_lu"],
        "max_abs_err": max(r["max_abs_err"] for r in panel_rows["panel_lu"]),
        **timing(lu_main)}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
