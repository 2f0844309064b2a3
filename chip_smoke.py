"""Drive the port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--kernels-only | --only-fermi | --only-bethe |
                           --only-compat | --only-multi | --only-chain |
                           --only-iv]

Imports gaunegf_tpu_torch (never JAX).  Phases, one result line each; any
failure raises and exits non-zero:

1. device    -- a CUDA device must be visible (exit 1 otherwise);
2. build     -- nvcc builds the five kernels for sm_90a (the three LU
                panel kernels and the two fixed-point kernels), one
                process each, all started together;
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
3b. held     -- after phase 13: every (batch, shape, dtype) that phases
                4-13 handed a kernel wrapper was recorded (phase 11's
                ranks record their own and hand them back); each kernel is
                held against its plain version on a random case of each
                such shape at phase 3's bound (the clusters are sized from
                the batch, and the default configuration's energy chunk
                is not phase 3's batch); the two fixed-point kernels are
                replayed on the inputs of the first call of each (shape,
                mode) that the paths handed their wrappers, at phase 14's
                rule, and no plain fixed point may have run on a CUDA
                tensor;
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
                dense solves in the spinor-interleaved layout;
9. bethe     -- Bethe-lattice and 3D-lattice electrodes on the default
                configuration unless said.  The junction: two 3-atom
                Au(111) contact triangles (27 orbitals each) and a
                946-site chain between them, N = 1000.  (a) demo.bethe
                (non-orthogonal, static contact support: the spectral
                route) and (b) Au.bethe (orthogonal, dense Xi sig Xi: the
                warm-started LU engines on full inverses, kernel 1): the
                first density at V = 0 and at V = 0.1 against references
                that iterate the plain Jacobi map to 1e-13, redo the
                embedding and invert densely in complex128; each
                provider's sigmas at 3 energies against the same
                references, beside two references with a fault put in
                that must miss the bound; 3 SCF cycles each; fixed-point
                sweeps per energy and the providers' share of one FockToP; (b) once more at precision='high'
                (kernel 3, sigma at conv 1e-11); (c) T(E) and DOS over 200
                points inside the lattice s band, warm and cold, and one
                T(E) sweep on the fused panel (kernel 2); (d)
                Lattice3DSelfEnergy between two 4-atom planes at N = 1000:
                gamma-point, and k-space at nk = 8 with and without the
                symmetry reduction (against textbook Sancho-Rubio per k);
                (e) setContactBethe without a Fermi level (the contact
                search on the 117 x 117 extended lattice) and a provider
                from harrison.bethe_params('Au');
10. compat   -- a reference script through the facade on the card:
                tests/fake_gauopen.py stands in for Gaussian (loaded by
                path, registered as gauopen with ibftyp added), holding
                9b's Au junction in Hartree and Bohr; compat.install(
                device='cuda') and gauNEGF.scfE.NEGFE(fn) +
                setContactBethe(..., fermi=0) + setVoltage(0.1): (a) the
                first density against 9b's path on the same matrices
                (1e-10) and the complex128 reference (1e-4), 3 SCF cycles
                through the OpMat packing and dofock='DENSITY' with the
                stand-in's host Fock rebuild timed apart (kernel 1),
                writeChk and runDFT, one FockToP at precision='high'
                against the reference (kernel 3, 2e-7); (b)
                gauNEGF.transport.cohTransE and DOSE over 9c's 200 energies
                at 9c's bounds, current() on the contacts' Sigma at E = 0
                against a trapezoid of the dense T(E); (c) spin 'u' at
                2N = 2000 through GaussianFock with setSigma: the first
                density per spin block against 8d's complex128 reference
                (1e-6), one cycle;
11. multi    -- multi-device execution over torch.distributed on the
                card: (a) a world of one rank over NCCL on cuda:0 --
                7d's default-config biased cycle, phase 4's LU gr_sum and
                9b's Au warm-LU cycle under energy_mesh(device='cuda',
                backend='nccl') equal bit for bit to the same runs
                without it; (b) four ranks sharing cuda:0 over gloo with
                CUDA tensors, each a process of its own: ('e', 'm') =
                (4, 1) for 7d's cycle (spectral route) and 9b's cycle
                with solver='lu' (warm segments per rank), (2, 2) for
                phase 4's gr_sum through zinv_refined_cols (kernel 1), the
                same with distribute_lu=True (zsolve_dist), the high
                tier's gr_sum (kernel 3) and 6a's T(E) (kernel 2); each
                against the serial run on the card (1e-10 on complex128
                paths, the tier's own bounds on the mixed LU and the warm
                cycle), the ranks equal bit for bit, each kernel of a leg
                launched on every rank.  Seconds are 4 ranks time-sharing
                one card: no scaling number.  The ranks' kernel shapes
                join phase 3b.  (4, 1) also runs 12a's 'contour' cycle
                against serial at 12a's bound (each rank gates its own
                chain steps);
12. chain    -- Newton-Schulz continuation and the XLA panels: (a) phase
                5's chain at V = 0 and a fixed Fermi level on the LU
                route, mixed tier, N1 = 128, N2 = 64, 32 lanes:
                continuation='contour' (the contour on the chain, the
                real segment on the batched LU) against False, 3 cycles
                each in ABBA order twice, s/cycle, Newton steps against LU
                steps, kernel-1 launches, each first density against the
                complex128 build; (b) gr_sum with continuation=True over
                that 128-point contour at N = 1000 (fast, mixed, strict)
                and N = 2000 (mixed), and a lane sweep 8/16/32/128 (mixed,
                N = 1000), each against the same engine with False and a
                complex128 torch.linalg.solve sum; (c) one gr_sum over
                256 points of the bench grid per XLA panel ('xla',
                'virtual', 'split', 'psplit': kernel 1 at every leaf) at
                phase 4's bounds;
13. iv       -- (a) BASELINE's finite-bias I-V sweep on the quick start's
                chain at N = 2000, default configuration (the spectral
                route): integralCheck(cycles=2) at the largest bias sets
                the grids every point keeps; qV = 0, 0.2, 0.4 at
                Fermi level 0, T = 0, each point's SCF to conv 1e-5 from
                the previous point's density, then calculate_current
                (dE = 0.01); every point converged, its first density
                against the complex128 rebuild with the window's Gamma
                taken as the route takes it, I(0) = 0 and I rising,
                each current against a trapezoid of the complex128 T(E);
                seconds and cycles per point, s/cycle split into eigh,
                sums and host; at the last point one FockToP and the
                current on the mixed LU (kernel 1 at N = 2000); (b) 6b's
                1D-chain junction: T(E) and DOS with warm_start="force"
                (the warm engines) against False on the mixed tier and
                against complex128; (c) the five examples, main('cuda')
                against main('cpu'); (d) the ported paths no earlier
                phase runs, each held to a complex128 reference at its
                nearest phase's bound: finite T, a bias window across the
                band edge, spin 'ro', 'u' and 'g' with Bethe contacts,
                upd_fermi with Bethe contacts (the search must
                converge), a k-space SCF cycle (nk=8)
                and gr_sum (nk=16), BetheAtomGF(closure='lattice'),
                density_grid_trap, compat's cohTransSpinE / surfGAt /
                surfG3 / NEGFE 'ro', and the peak device bytes of 9b's
                warm cycle at the automatic chunk; a leg's launches are
                those of its path, its references' left out;
14. fixed points -- kernel A (csrc/fixed_point.cu: the Bethe bulk loop,
                Jacobi and Seidel, with and without exclusion, the
                surface loop after it, and the surface loop alone as
                k-space runs it) and kernel B (csrc/sancho_rubio.cu:
                Sancho-Rubio and the Dyson map at n = 1, 9, 27, 40: its
                scalar, column, CTA and global-scratch variants) against
                their plain versions on the card at conv 1e-5 and 1e-11,
                64 lanes (kernel A also 400 lanes, three a CTA); the
                wrappers' launch rules held to the C entry points'; each
                case's variant, lanes a CTA and shared memory printed;
                then each path case timed (CUDA events, torch.profiler's
                device time, the plain version, the FP64 bound from the
                sweeps this run needed, the share): kernel A's bulk +
                surface at 64 and 96 energies, its k-space surface mode
                and the case of most lane-calls, kernel B's k-space lanes
                and a chain's.  Phases 6b, 9, 10, 13b and 13d must each
                launch the fixed-point kernel they reach.

Each path sets every launch count to 0 just before it and reads the
counts just after (phase 7 runs no hand-written kernel: its counts stay
0).  --only-fermi, --only-bethe, --only-compat, --only-multi,
--only-chain and --only-iv run the build and one phase (3b after 9, 10,
11, 12 and 13; 14 after 9's 3b) and print no kernel table and no result
line.  The second-to-last line is the kernel
table (JSON), the last line {"ok": true, "device": {...}}.
"""

import argparse
import json
import re
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
# Phase 13's first densities on the spectral route against the complex128
# rebuild that takes the window's Gamma as the route does (on the
# contacts' support: reference_density_neq's block) hold rounding only:
# 6.0e-15 to 4.2e-13 of max |P| on the H100 (4.2e-13 density_grid_trap's
# window alone, 3.6e-13 across the band edge), held at about 10x.
SP_BLOCK_P_BOUND = 5e-12
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
# Phase 9, Bethe and 3D-lattice electrodes, against references that
# iterate the plain Jacobi map to 1e-13 and invert densely in complex128.
# A fixed point stopped at the default conv = 1e-5 (relative change of a
# sweep, mix 0.5) leaves Sigma off by ~1e-5 of its size, so the default
# tiers are held at that scale: the first density and the k-space /
# gamma-point gr_sum within 1e-4 of their largest entry, |T - T_ref| within
# 1e-4 of max(1, max T) (as the JAX package's warm-against-cold test), warm
# against cold likewise.  Where the sweep runs the mixed-tier LU (complex64
# seeds refined once) the chain's narrow levels add phase 6a's 1e-3 for T
# and 1e-3 of the largest value for the total DOS.  The high tier (Sigma
# at conv = 1e-11, complex128 LU) is held to 2e-7, the bound of the JAX
# package's high-tier Bethe test.  Retardedness: the least eigenvalue of
# each Gamma >= -1e-6; T >= -1e-8.  The contact Fermi search stops anywhere
# inside |dN| < tol = 1e-3, so two arithmetic paths agree to 10 tol.
# Each provider's sigmas are held directly too, at 3 energies in the
# lattice s band, within 3e-5 of the reference's largest entry (3x what a
# fixed point stopped at a change of 1e-5 leaves).  Controls:
# the references are redone with a fault put in (the fixed points stopped
# at 1e-3; the matched slots not subtracted in the embedding).  Either
# faulty sigma must miss the bound.  Of the first densities and 9d's
# gr_sum only the faulty embedding must: a density hardly moves with
# sigma's convergence (printed as control_rel_err["conv"], not held),
# which is why sigma is held on its own.
BETHE_P_BOUND = 1e-4
BETHE_SIGMA_BOUND = 3e-5
BETHE_T_REL_BOUND = 1e-4
BETHE_DOS_REL_BOUND = 1e-3
BETHE_HIGH_BOUND = 2e-7
BETHE_GAMMA_MIN = -1e-6
BETHE_T_MIN = -1e-8
BETHE_FERMI_BOUND = 1e-2
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


def ptxas_summary(log):
    """Per kernel function of an nvcc -Xptxas -v log: its short name (with
    a template argument), registers, stack frame and spills."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']*)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)(?:ILi(\d+)E)?", m.group(1))
            name = m.group(1) if k is None else k.group(1) + (
                f"<{k.group(2)}>" if k.group(2) else "")
            frame = ""
        elif "stack frame" in line and name:
            frame = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name} {regs.group(1) if regs else '?'} regs, "
                       f"{frame}")
            name = None
    return " | ".join(out)


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
                large=(LARGE_M,), rows=32, edge=True):
    """(label, strip (B, rows, m) complex64, avail (B, m) bool) cases:
    random strips at the heights, then (edge) a tie and a zero-column case
    of 32 rows at the last height, then the heights in large."""
    rng = np.random.default_rng(seed)

    def random_case(m):
        sb = (rng.standard_normal((batch, rows, m)) + 1j
              * rng.standard_normal((batch, rows, m))).astype(np.complex64)
        av = rng.random((batch, m)) < 0.9
        av[:, :rows] = True                 # at least rows available lanes
        return f"m={m}", sb, av

    cases = [random_case(m) for m in heights]
    if not edge:
        return [(lbl, torch.as_tensor(sb, device=device),
                 torch.as_tensor(av, device=device)) for lbl, sb, av in cases]
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
                bs=PANEL_BS, seed=1, large=(), edge=True):
    """(label, panel (B, m, bs)) cases of one dtype: random panels at the
    heights, then (edge) a tie and a zero-column case at the last height,
    then the heights in large."""
    rng = np.random.default_rng(seed)
    ndt = np.complex64 if dtype == torch.complex64 else np.complex128

    def random_case(m):
        return f"({m},{bs})", (rng.standard_normal((batch, m, bs))
                               + 1j * rng.standard_normal((batch, m, bs))
                               ).astype(ndt)

    cases = [random_case(m) for m in heights]
    if not edge:
        return [(lbl, torch.as_tensor(a, device=device)) for lbl, a in cases]
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


class ShapeSpy:
    """Records the shape and dtype of every tensor that the package hands
    a kernel wrapper between install() and remove(), by wrapping the three
    names under which the blocked LU calls them; for the two fixed-point
    wrappers it keeps the inputs of the first call of each (shape, mode)
    too, so that phase 3b replays what the path handed over, and counts
    the calls of their plain versions on CUDA tensors (there must be
    none: the package launches the kernel or raises)."""

    NAMES = ("eliminate_strip", "factor_panel_fused", "factor_panel_lu")
    FIXED = ("fixed_point", "decimate")

    def __init__(self):
        self.seen = {name: {} for name in self.NAMES}   # shape key -> calls
        self.cases = {name: {} for name in self.FIXED}  # key -> [calls, in]
        self.plain_on_cuda = 0

    def install(self):
        from gaunegf_tpu_torch.ops import zlinalg
        from gaunegf_tpu_torch.ops.kernels import fixed_point as fp
        from gaunegf_tpu_torch.ops.kernels import sancho_rubio as sr
        self._saved = {name: getattr(zlinalg, name) for name in self.NAMES}
        for name, fn in self._saved.items():
            setattr(zlinalg, name, self._recording(name, fn))
        self._fixed = [(fp, "fixed_point", fp.fixed_point),
                       (sr, "decimate", sr.decimate),
                       (fp, "fixed_point_plain", fp.fixed_point_plain),
                       (sr, "decimate_plain", sr.decimate_plain)]
        for mod, name, fn in self._fixed:
            setattr(mod, name, self._plain(fn) if name.endswith("_plain")
                    else self._case(name, fn))
        return self

    def _recording(self, name, fn):
        seen = self.seen[name]

        def wrapped(x, *rest):
            key = (tuple(x.shape), str(x.dtype).split(".")[-1])
            seen[key] = seen.get(key, 0) + 1
            return fn(x, *rest)
        return wrapped

    def _case(self, name, fn):
        import inspect
        cases = self.cases[name]
        sig = inspect.signature(fn)

        def wrapped(*a, **k):
            args = sig.bind(*a, **k)
            args.apply_defaults()
            kw = dict(args.arguments)
            key = tuple((n, tuple(v.shape) if isinstance(v, torch.Tensor)
                         else v) for n, v in kw.items())
            if key in cases:
                cases[key][0] += 1
            else:
                cases[key] = [1, {n: v.clone() if isinstance(
                    v, torch.Tensor) else v for n, v in kw.items()}]
            return fn(*a, **k)
        return wrapped

    def _plain(self, fn):
        def wrapped(A, *rest, **k):
            if A.device.type == "cuda":
                self.plain_on_cuda += 1
            return fn(A, *rest, **k)
        return wrapped

    def remove(self):
        from gaunegf_tpu_torch.ops import zlinalg
        for name, fn in self._saved.items():
            setattr(zlinalg, name, fn)
        for mod, name, fn in self._fixed:
            setattr(mod, name, fn)


def phase_held(spy, se, pf, pl, device):
    """Phase 3b: each kernel against its plain version at every (batch,
    shape, dtype) that the main paths handed its wrapper (the spy's
    record), on a random case of that shape, at phase 3's bound.  The
    clusters are sized from the batch (CTAs per panel = SMs / batch), so a
    path on another energy chunk than phase 3's batch runs another launch
    shape.  Returns {kernel: rows}; raises on a mismatch."""
    out = {name: [] for name in spy.NAMES}
    for (batch, rows, m), dt in sorted(spy.seen["eliminate_strip"]):
        _, r = phase_kernel(se, device, timed=False, batch=batch,
                            heights=(m,), large=(), rows=rows, edge=False,
                            seed=batch + m)
        out["eliminate_strip"] += [
            {**x, "shape": [batch, rows, m], "dtype": dt,
             "calls": spy.seen["eliminate_strip"][(batch, rows, m), dt]}
            for x in r]
    for name, kernel, plain, config in (
            ("factor_panel_fused", pf.factor_panel_fused,
             pf.factor_panel_fused_plain,
             lambda m, bs, dtype, batch: pf.config(m, bs, batch)),
            ("factor_panel_lu", pl.factor_panel_lu, pl.factor_panel_lu_plain,
             lambda m, bs, dtype, batch: pl.config(m, dtype, batch))):
        for (batch, m, bs), dt in sorted(spy.seen[name]):
            _, r = phase_panel(kernel, plain, device, getattr(torch, dt),
                               timed=False, config=config, batch=batch,
                               heights=(m,), bs=bs, edge=False,
                               seed=batch + m)
            out[name] += [{**x, "shape": [batch, m, bs],
                           "calls": spy.seen[name][(batch, m, bs), dt]}
                          for x in r]
    for name in spy.FIXED:
        out[name] = [fixed_case(name, kw, device, calls=calls)
                     for calls, kw in spy.cases[name].values()]
    return out


def print_held(held):
    for name, rows in held.items():
        if name in ShapeSpy.FIXED:
            print(f"phase 3b held {name}: {len(rows)} cases of the main "
                  "paths replayed, kernel vs plain (max rel err "
                  f"{max((r['rel_err'] for r in rows), default=0.0):.3e}, "
                  "lanes stopped apart "
                  f"{sum(r['lanes_count_apart'] for r in rows)}, lanes on "
                  f"the spread bound {sum(r['lanes_spread'] for r in rows)}"
                  "): " + ", ".join(f"{tuple(r['shape'])} {r['launch']} "
                                    f"x{r['calls']}" for r in rows),
                  flush=True)
            continue
        print(f"phase 3b held shapes {name}: {len(rows)} shapes of the main "
              "paths, kernel == plain (pivots identical, max rel err "
              f"{max((r['rel_err'] for r in rows), default=0.0):.3e}): "
              + ", ".join(f"{tuple(r['shape'])} {r['dtype']} x{r['calls']} "
                          f"{r['launch']}" for r in rows), flush=True)


def reset_counts():
    """Set every counter of the recorder (utils/logging) to 0: each
    kernel's launch.<kernel>, the chain's chain.newton and chain.lu, and
    the wait.* counters.  Every path that reads a count resets here
    first.  The recorder records inside main's recorder.recording(); a
    phase called from elsewhere reads its counts inside one too."""
    from gaunegf_tpu_torch.utils.logging import recorder
    recorder.reset()


def launch_count(mod):
    """The launches of the kernel of module ``mod`` since the last
    reset_counts."""
    from gaunegf_tpu_torch.utils.logging import recorder
    return recorder.count("launch." + mod.__name__.rsplit(".", 1)[-1])


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
    reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    out = eng.gr_sum(E, w)
    _sync(device)
    dt = time.perf_counter() - t0
    launches = launch_count(kernels[0])
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


def reference_density_neq(negfe, device, rows=None, F=None, block=False):
    """The first FockToP density rebuilt in complex128 on the same grids:
    per-point torch.linalg.solve, full G Gamma G+ (a test reference).
    rows: the orbitals of one spin block of a block-diagonal system, solved
    on their own.  F: the Fock matrix (eV) the density was built from, if
    not negfe's present one.  block: the window's Gamma taken as the
    spectral route takes it, on the contacts' support (G's columns on the
    union of the contacts' orbitals): the last contact's sigma there,
    which holds the -1e-9j S background on the other contact's orbitals,
    and without the background's Gamma over the rest, which the full
    reference keeps."""
    from gaunegf_tpu_torch import quadrature as quad
    rows = slice(None) if rows is None else rows
    E_r, w_r = quad.real_axis_grid(negfe.Eminf, negfe.Emin, negfe.N2, 0.0)
    z_c, w_c = quad.contour_grid(negfe.Emin, negfe.mu1, negfe.N1, negfe.T)
    E_eq = np.concatenate([np.asarray(E_r, complex), np.asarray(z_c, complex)])
    w_eq = np.concatenate([-np.asarray(w_r, complex),
                           np.asarray(w_c, complex)]) / np.pi
    grids = [(E_eq, w_eq, False)]
    if negfe.mu1 != negfe.mu2:                  # no window at V = 0
        E_n, w_n = quad.bias_window_grid(negfe.mu1, negfe.mu2, negfe.Nnegf,
                                         negfe.T)
        grids.append((E_n, np.asarray(w_n) / (2 * np.pi), True))
    F = negfe.F_eV if F is None else F
    F = torch.as_tensor(F[rows, rows], dtype=torch.complex128, device=device)
    S = torch.as_tensor(negfe.S[rows, rows], dtype=torch.complex128,
                        device=device)
    sig1, sig2 = (torch.as_tensor(s[rows, rows], dtype=torch.complex128,
                                  device=device)
                  for s in negfe.g.params()["sigs"])
    gam2 = 1j * (sig2 - sig2.conj().T)
    N = F.shape[0]
    eye = torch.eye(N, dtype=torch.complex128, device=device)
    if block:                   # the contact's orbitals among the rows
        kept = list(np.arange(negfe.S.shape[0])[rows])
        c = [kept.index(i) for i in negfe.g.contact_inds() if i in kept]
        gam2 = gam2[c][:, c]
        eye_c = eye[:, c]
    P = torch.zeros((N, N), dtype=torch.complex128, device=device)
    for E, w, neq in grids:
        for i in range(0, len(E), 32):
            Eb = torch.as_tensor(np.asarray(E[i:i + 32], complex),
                                 device=device)
            wb = torch.as_tensor(np.asarray(w[i:i + 32], complex),
                                 device=device)
            A = Eb[:, None, None] * S - F - sig1 - sig2
            rhs = eye_c if neq and block else eye
            G = torch.linalg.solve(A, rhs.expand(len(Eb), *rhs.shape)
                                   .contiguous())
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
        reset_counts()
        _sync(device)
        t0 = time.perf_counter()
        counts, electrons, _ = negfe.SCF(conv=1e-5, damping=0.05,
                                         max_cycles=cycles)
        _sync(device)
        dt = time.perf_counter() - t0
    P = negfe.P
    return negfe, {"n": n, "points_per_cycle": N2 + N1 + negfe.Nnegf,
            "rel_err_first_P": p_err, "cycles": len(counts),
            "s_per_cycle": dt / len(counts),
            "launches": launch_count(kernels[0]),
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
    se, pf, pl = kernels[:3]
    F, S, n = negfe.F, negfe.S, negfe.F.shape[0]
    res = {"n": n}

    # (a) the quick start's sweep, mixed tier on the fused panel
    g_const = negfe.g
    E_a = np.linspace(-3, 3, 500)
    cfg_a = ExecutionConfig(precision="mixed", solver="lu", lu_panel="fused",
                            energy_chunk=chunk)
    tr.calculate_transmission(F, S, tr.SigmaSource(g_const), E_a[:chunk],
                              exec_cfg=cfg_a, device=device)    # warm-up
    reset_counts()
    T_a, dt = _timed(device, lambda: tr.calculate_transmission(
        F, S, tr.SigmaSource(g_const), E_a, exec_cfg=cfg_a, device=device))
    launches = {"strip_elim": launch_count(se),
                "panel_fused": launch_count(pf),
                "panel_lu": launch_count(pl)}
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
    reset_counts()
    T_b, dt_t = _timed(device, lambda: tr.calculate_transmission(
        F, S, tr.SigmaSource(g_chain), E_b, exec_cfg=cfg_b, device=device))
    (dos_b, _), dt_d = _timed(device, lambda: tr.calculate_dos(
        F, S, tr.SigmaSource(g_chain), E_b, exec_cfg=cfg_b, device=device))
    launches = _launch_dict(kernels)
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
            or b["launches"]["sancho_rubio"] <= 0 \
            or b["max_abs_err_T"] > T_HIGH_BOUND \
            or b["rel_err_dos"] > DOS_HIGH_REL_BOUND:
        raise AssertionError(f"transport (b) failed: {b}")
    if not (np.isfinite(c["current_A"]) and c["current_A"] > 0):
        raise AssertionError(f"transport (c): current {c['current_A']} is "
                             "not finite and positive at qV=0.1")


def _spectral_engine(H, S, g, device, cfg=None):
    """An engine on the default solver='auto' with its spectral runner
    built; raises if the route declines.  Returns the seconds of the
    structure detection (two probes on the card) and of the runner (the
    basis from an empty cache)."""
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.ops import spectral as sp
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    sp._BASIS_CACHE.clear()
    _, detect = _timed(device,
                       lambda: sp.detect_structure(g, S, device=device))
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


def reference_block_T(H, S, g, E, device):
    """T(E) of a constant-sigma junction in complex128 from G's contact
    columns (torch.linalg.solve on the full operator, the broadening
    background included) with each Gamma taken on its contact block, as
    the spectral route and the LU's low-rank path take it (a test
    reference, not the path)."""
    c1, c2 = g.contact_inds(0), g.contact_inds(-1)
    G12 = reference_contact_cols(H, S, g, E, c2, device)[:, list(c1)]
    s1, s2 = (torch.as_tensor(x, dtype=torch.complex128, device=device)
              for x in g.params()["sigs"])
    blk1 = s1[list(c1)][:, list(c1)]
    blk2 = s2[list(c2)][:, list(c2)]
    gam1 = 1j * (blk1 - blk1.conj().T)
    gam2 = 1j * (blk2 - blk2.conj().T)
    T = torch.einsum("bij,bji->b", gam1 @ G12,
                     gam2 @ G12.conj().transpose(1, 2)).real
    return T.cpu().numpy()


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
        reset_counts()
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
                    "launches": [launch_count(m) for m in kernels]}
    # (c): T(E) over the bench grid, G< (contact 1) over a bias window
    H, S, g = bench_system(N)
    E = np.linspace(-2.0, 2.0, n_E)
    reset_counts()
    eng, runner, _ = _spectral_engine(H, S, g, device)
    eng.transmission(E[:8])                                   # warm-up
    T, dt = _timed(device, lambda: eng.transmission(E))
    T_ref = reference_block_T(H, S, g, E, device)
    s2 = torch.as_tensor(g.params()["sigs"][1], dtype=torch.complex128,
                         device=device)
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
                "launches": [launch_count(m) for m in kernels]}
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
        reset_counts()
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
                "launches": [launch_count(m) for m in kernels]}
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
    """Counts taken around a stretch of a phase by wrapping functions of
    the package for that stretch: Fermi-search probes, pencil
    eigendecompositions, and the grid length of every engine sum.  Given
    a device, also the seconds inside the pencil eigh and inside the
    engine's density sums (density_neq_sum and density_eq_split, the eigh
    included), each timed between two synchronisations."""

    def __init__(self, device=None):
        self.device = device
        self.probes = 0
        self.last = {}              # probe energy -> electron-count error
        self.eighs = 0
        self.grids = {"gr_sum": [], "gless_sum": []}
        self.seconds = {"eigh": 0.0, "sums": 0.0}

    def _timed(self, fn, key):
        if self.device is None:
            return fn

        def wrapped(*a, **k):
            _sync(self.device)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                _sync(self.device)
                self.seconds[key] += time.perf_counter() - t0
        return wrapped

    def __enter__(self):
        from gaunegf_tpu_torch import fermi
        from gaunegf_tpu_torch.ops import greens, spectral
        spy = self
        eng = greens.EnergyEngine
        self._saved = [(fermi, "_DensityProbe", fermi._DensityProbe),
                       (spectral, "_eigh_pencil", spectral._eigh_pencil),
                       (eng, "gr_sum", eng.gr_sum),
                       (eng, "gless_sum", eng.gless_sum),
                       (eng, "density_neq_sum", eng.density_neq_sum),
                       (eng, "density_eq_split", eng.density_eq_split)]

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
        spectral._eigh_pencil = self._timed(eigh, "eigh")
        eng.gr_sum = sized("gr_sum", self._saved[2][2])
        eng.gless_sum = sized("gless_sum", self._saved[3][2])
        eng.density_neq_sum = self._timed(self._saved[4][2], "sums")
        eng.density_eq_split = self._timed(self._saved[5][2], "sums")
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def _junction(device, tmp, n, cfg=None, spin="r", exchange=0.0, N1=128,
              N2=64, mesh=None):
    """The README quick start's junction: an n-site chain with a Hubbard
    mean field, contacts [1, 2] and [n-1, n] at -0.1j, fixed grids."""
    from gaunegf_tpu_torch.models.fock import TightBindingFock
    from gaunegf_tpu_torch.scfe import NEGFE
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    backend = TightBindingFock(H0, n_electrons=n, U=0.5, n0=0.5 * np.ones(n),
                               spin=spin, exchange=exchange)
    negfe = NEGFE(backend, spin=spin, name=f"{tmp}/{spin}{n}", exec_cfg=cfg,
                  device=device, mesh=mesh, verbose=False)
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
    se, pf, pl = kernels[:3]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) setVoltage without a Fermi level: a search in every cycle
        from gaunegf_tpu_torch.ops import spectral
        spectral._BASIS_CACHE.clear()       # count every Fock's eigh
        reset_counts()
        negfe = _junction(device, tmp, n, N1=N1, N2=N2)
        negfe.setVoltage(0.1)
        a = {"n": n, "method": negfe.fermi_method,
             **_fermi_scf(negfe, device, cycles),
             "launches": [launch_count(m) for m in kernels]}
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
        reset_counts()
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
        scf_launches = [launch_count(m) for m in kernels]
        tr.calculate_transmission(d.F, d.S, src, E[:2], spin="u",
                                  exec_cfg=cfg_t, device=device)   # warm-up
        reset_counts()
        (T, Tspin), dt_T = _timed(device, lambda: tr.calculate_transmission(
            d.F, d.S, src, E, spin="u", exec_cfg=cfg_t, device=device))
        T_launches = [launch_count(m) for m in kernels]
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
            reset_counts()
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
            scf_launches = [launch_count(m) for m in kernels]
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
                "launches": [launch_count(m) for m in kernels],
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


# ---------------------------------------------------------------------------
# Phase 9: Bethe-lattice and 3D-lattice electrodes
# ---------------------------------------------------------------------------

_PLANE = (0, 1, 2, 6, 7, 8)
_PAIR = tuple((k + 6) % 12 for k in range(12))


def _bethe_negfe(device, tmp, lat, n_chain, N1, N2, cfg=None, fermi=0.0,
                 mesh=None):
    from gaunegf_tpu_torch.scfe import NEGFE
    from gaunegf_tpu_torch.tune import bethe_junction
    backend, geom, contacts, eps = bethe_junction(lat, n_chain)
    negfe = NEGFE(backend, name=f"{tmp}/bethe_{lat}", exec_cfg=cfg,
                  device=device, mesh=mesh, verbose=False)
    negfe.setContactBethe(contacts, lat_file=lat, eta=1e-5, T=0.0,
                          geometry=geom, fermi=fermi)
    negfe.setIntegralLimits(N1=N1, N2=N2)
    return negfe, eps


# A control redoes a reference with a fault put in on purpose, to show that
# the bound it is held to would catch that fault in the package.
FAULT_CONV = 1e-3           # 'conv': fixed points stopped at 100x the change


def reference_bethe_surface(H, Sl, Vl, eta, E, conv=1e-13, max_iter=5000,
                            exclusion=True):
    """The Bethe surface stack (b, 9, 9, 9) at the energies E (b,) by the
    plain Jacobi map in complex128: every lane iterated until the largest
    relative change of the whole batch is below conv (looked at every 10th
    sweep; at every sweep for a control's loose conv), no lane frozen (a
    test reference, not the path).  exclusion=False: the bulk map of the
    all-neighbour lattice closure (one shared inverse, no opposite-slot
    term)."""
    dev = E.device
    every = 10 if conv < 1e-9 else 1
    c = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.complex128,
                                  device=dev)
    H, Sl, Vl = c(H), c(Sl), c(Vl)
    z = E.to(torch.complex128) - 1j * eta
    eye = torch.eye(9, dtype=torch.complex128, device=dev)
    A = z[:, None, None] * eye - H
    B = z[:, None, None, None] * Sl - Vl
    Bd = B.conj().transpose(-1, -2)
    sig = (-1j * eye).expand(E.shape[0], 12, 9, 9).clone()
    pair = list(_PAIR)
    plane = list(_PLANE)

    def change(new, old):
        return float(((new - old).abs().amax(dim=(1, 2, 3))
                      / old.abs().amax(dim=(1, 2, 3)).clamp(min=1e-30)).max())

    for it in range(max_iter):
        if exclusion:
            g = torch.linalg.inv((A - sig.sum(1))[:, None] + sig[:, pair])
        else:
            g = torch.linalg.inv(A - sig.sum(1))[:, None]
        new = 0.5 * (B @ g @ Bd) + 0.5 * sig
        done = it % every == every - 1 and change(new, sig) < conv
        sig = new
        if done:
            break
    surf = sig[:, :9].clone()
    for it in range(max_iter):
        g = torch.linalg.inv(A - surf.sum(1))
        new = surf.clone()
        new[:, plane] = 0.5 * (B[:, plane] @ g[:, None] @ Bd[:, plane]) \
            + 0.5 * surf[:, plane]
        done = it % every == every - 1 and change(new, surf) < conv
        surf = new
        if done:
            break
    return surf


def reference_sancho(A, B, iters=60):
    """Surface GF inv(A - B g B+) by the textbook Sancho-Rubio recursion
    in complex128, a fixed number of doublings, no rescaling (a test
    reference, not the path)."""
    eps_s, eps, al, be = A, A, B, B.conj().transpose(-1, -2)
    for _ in range(iters):
        g = torch.linalg.inv(eps)
        agb, bga = al @ g @ be, be @ g @ al
        eps_s, eps = eps_s - agb, eps - agb - bga
        al, be = al @ g @ al, be @ g @ be
        if float(al.abs().max()) < 1e-300 and float(be.abs().max()) < 1e-300:
            break
    return torch.linalg.inv(eps_s)


def reference_kspace_stack(p, E, conv=1e-13):
    """The 9-slot stack of a k-space contact (in-plane slots relaxed
    around the BZ-averaged half-space term, which sits in slot 3) from
    the contact's params p, with reference_sancho per k point and the
    plain Jacobi map to conv (a test reference, not the path)."""
    dev = E.device
    c = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.complex128,
                                  device=dev)
    H, Sl, Vl = c(p["H"]), c(p["S"]), c(p["V"])
    pp, dp = c(p["plane_ph"]), c(p["down_ph"])
    eta = float(np.real(p["eta"]))
    z = E.to(torch.complex128) + 1j * eta
    eye = torch.eye(9, dtype=torch.complex128, device=dev)
    plane, down = list(_PLANE), [3, 4, 5]
    H00 = H + torch.einsum("kd,dij->kij", pp, Vl[plane])
    S00 = eye + torch.einsum("kd,dij->kij", pp, Sl[plane])
    H01 = torch.einsum("kd,dij->kij", dp, Vl[down])
    S01 = torch.einsum("kd,dij->kij", dp, Sl[down])
    zz = z[:, None, None, None]
    A = (zz * S00 - H00).reshape(-1, 9, 9)
    B = (zz * S01 - H01).reshape(-1, 9, 9)
    sig = (B @ reference_sancho(A, B) @ B.conj().transpose(-1, -2)) \
        .reshape(E.shape[0], -1, 9, 9)
    if "sym_mask" in p:
        m, D = c(p["sym_mask"]), c(p["sym_D"])
        down_sig = torch.zeros((E.shape[0], 9, 9), dtype=torch.complex128,
                               device=dev)
        for r in range(m.shape[0]):
            for o in range(m.shape[1]):
                if m[r, o] != 0:
                    down_sig += D[o] @ sig[:, r] @ D[o].T
        down_sig = down_sig / round(float(m.real.sum()))
    else:
        down_sig = sig.mean(1)
    A1 = z[:, None, None] * eye - H - down_sig
    B1 = z[:, None, None, None] * Sl - Vl
    Bp, Bdp = B1[:, plane], B1[:, plane].conj().transpose(-1, -2)
    st = torch.zeros((E.shape[0], 9, 9, 9), dtype=torch.complex128,
                     device=dev)
    every = 10 if conv < 1e-9 else 1
    for it in range(5000):
        g = torch.linalg.inv(A1 - st.sum(1))
        new = st.clone()
        new[:, plane] = 0.5 * (Bp @ g[:, None] @ Bdp) + 0.5 * st[:, plane]
        d = float(((new - st).abs().amax(dim=(1, 2, 3))
                   / st.abs().amax(dim=(1, 2, 3)).clamp(min=1e-30)).max()) \
            if it % every == every - 1 else 1.0
        st = new
        if d < conv:
            break
    st[:, 3] = down_sig
    return st


def reference_bethe_sigmas(prov, E, fault=None):
    """Per-contact (b, N, N) self-energies of a spin-'r' Bethe or
    3D-lattice provider at the energies E (b,) on E's device: tightly
    converged reference stacks, the embedding redone from _static_key
    (per-atom slot subtraction, dense Xi sig Xi for orthogonal sets).
    fault (a control): 'conv' stops the fixed points at FAULT_CONV,
    'slots' leaves out the subtraction of the matched slots."""
    inds, nind, N, spin, orthogonal = prov._static_key()[:5]
    assert spin == "r" and fault in (None, "conv", "slots")
    params = prov.params()["contacts"]
    conv = FAULT_CONV if fault == "conv" else 1e-13
    if orthogonal:
        Xi = torch.as_tensor(prov.Xi, dtype=torch.complex128,
                             device=E.device)
    sigs = []
    for i, g in enumerate(prov.g_list):
        if getattr(prov, "kspace", False):
            surf = reference_kspace_stack(params[i], E, conv)
        else:
            surf = reference_bethe_surface(g.H, g.Slist, g.Vlist, g.eta, E,
                                           conv)
        sig = torch.zeros((E.shape[0], N, N), dtype=torch.complex128,
                          device=E.device)
        for n_inds, f_inds in zip(nind[i], inds[i]):
            atom = surf.sum(1)
            for k in n_inds:
                if k < 9 and fault != "slots":
                    atom = atom - surf[:, k]
            f = torch.as_tensor(f_inds, device=E.device)
            sig[:, f[:, None], f[None, :]] = atom
        if orthogonal:
            sig = Xi @ sig @ Xi
        sigs.append(sig)
    return sigs


def _bethe_terms(F, S, prov, E, device, fn, chunk=32, fault=None,
                 sigmas=None):
    """fn(E chunk, G, sigs) over the grid in chunks, with G the dense
    complex128 inverse on the reference sigmas (sigmas(E chunk) where
    given, e.g. a spin layout's expansion of the spin-'r' ones)."""
    Fd = torch.as_tensor(np.asarray(F), dtype=torch.complex128, device=device)
    Sd = torch.as_tensor(np.asarray(S), dtype=torch.complex128, device=device)
    E = np.asarray(E, dtype=complex).ravel()
    for i in range(0, len(E), chunk):
        Eb = torch.as_tensor(E[i:i + chunk], device=device)
        sigs = (reference_bethe_sigmas(prov, Eb, fault) if sigmas is None
                else sigmas(Eb))
        G = torch.linalg.inv(Eb[:, None, None] * Sd - Fd - sum(sigs))
        fn(slice(i, i + chunk), Eb, G, sigs)


def reference_bethe_gr_sum(F, S, prov, E, w, device, fault=None):
    N = np.shape(F)[0]
    acc = torch.zeros((N, N), dtype=torch.complex128, device=device)
    w = np.asarray(w, dtype=complex).ravel()

    def fn(sl, Eb, G, sigs):
        wb = torch.as_tensor(w[sl], device=device)
        acc.add_((wb[:, None, None] * G).sum(0))
    _bethe_terms(F, S, prov, E, device, fn, fault=fault)
    return acc.cpu().numpy()


def reference_bethe_density(negfe, device, fault=None, sigmas=None):
    """negfe's first FockToP density on its own grids from the reference
    sigmas (or sigmas(E), see _bethe_terms) and dense complex128 inverses
    (full G Gamma G+ in the window)."""
    from gaunegf_tpu_torch import quadrature as quad
    E_r, w_r = quad.real_axis_grid(negfe.Eminf, negfe.Emin, negfe.N2, 0.0)
    z_c, w_c = quad.contour_grid(negfe.Emin, negfe.mu1, negfe.N1, negfe.T)
    E_eq = np.concatenate([np.asarray(E_r, complex), np.asarray(z_c, complex)])
    w_eq = np.concatenate([-np.asarray(w_r, complex),
                           np.asarray(w_c, complex)]) / np.pi
    N = negfe.F_eV.shape[0]
    P = torch.zeros((N, N), dtype=torch.complex128, device=device)

    def eq(sl, Eb, G, sigs):
        wb = torch.as_tensor(w_eq[sl], device=device)
        P.add_((wb[:, None, None] * G).sum(0).imag)
    _bethe_terms(negfe.F_eV, negfe.S, negfe.g, E_eq, device, eq, fault=fault,
                 sigmas=sigmas)
    if negfe.mu1 != negfe.mu2:
        E_n, w_n = quad.bias_window_grid(negfe.mu1, negfe.mu2, negfe.Nnegf,
                                         negfe.T)
        w_n = np.asarray(w_n, complex) / (2 * np.pi)

        def neq(sl, Eb, G, sigs):
            wb = torch.as_tensor(w_n[sl], device=device)
            gam = 1j * (sigs[-1] - sigs[-1].conj().transpose(1, 2))
            P.add_((wb[:, None, None]
                    * (G @ gam @ G.conj().transpose(1, 2))).sum(0))
        _bethe_terms(negfe.F_eV, negfe.S, negfe.g, E_n, device, neq,
                     fault=fault, sigmas=sigmas)
    return P.cpu().numpy()


def reference_bethe_transport(F, S, prov, E, device):
    """(T(E), total DOS, least eigenvalue of both Gammas) from the
    reference sigmas and dense complex128 inverses."""
    n = len(E)
    T, dos, gmin = np.empty(n), np.empty(n), []

    def fn(sl, Eb, G, sigs):
        g1 = 1j * (sigs[0] - sigs[0].conj().transpose(1, 2))
        g2 = 1j * (sigs[-1] - sigs[-1].conj().transpose(1, 2))
        T[sl] = torch.einsum("bij,bji->b", g1 @ G,
                             g2 @ G.conj().transpose(1, 2)).real.cpu().numpy()
        dos[sl] = (-G.diagonal(dim1=1, dim2=2).imag.sum(1)
                   / np.pi).cpu().numpy()
        gmin.append(float(torch.linalg.eigvalsh(g1).min()))
        gmin.append(float(torch.linalg.eigvalsh(g2).min()))
    _bethe_terms(F, S, prov, E, device, fn)
    return T, dos, min(gmin)


def _sigma_check(prov, E, device):
    """The provider's per-contact sigmas at the real energies E, from its
    contact_apply functions on the device in complex128, against the
    reference sigmas: the largest relative error over the contacts, the
    least eigenvalue of the Gammas, and the two controls (the references
    with a fault against the reference).  Sigma is held directly because a
    density hardly moves with it: a fixed point stopped at 1e-3 shifts the
    first density of this junction by ~2e-6 of max |P|."""
    from gaunegf_tpu_torch.models.selfenergy import tree_map
    E_d = torch.as_tensor(np.asarray(E) + 0j, device=device)
    refs = reference_bethe_sigmas(prov, E_d)
    faulty = {f: reference_bethe_sigmas(prov, E_d, f)
              for f in ("conv", "slots")}
    rel = lambda x, ref: float((x - ref).abs().max() / ref.abs().max())
    out = {"rel_err_sigma": 0.0, "gamma_min_eig": float("inf"),
           "control_rel_err": {f: float("inf") for f in faulty},
           "finite": True}
    for i, ref in enumerate(refs):
        fn, params = prov.contact_apply(i)
        sig = fn(tree_map(lambda v: torch.as_tensor(
            np.asarray(v), dtype=torch.complex128, device=device), params),
            E_d)
        gam = 1j * (sig - sig.conj().transpose(1, 2))
        out["rel_err_sigma"] = max(out["rel_err_sigma"], rel(sig, ref))
        out["gamma_min_eig"] = min(out["gamma_min_eig"],
                                   float(torch.linalg.eigvalsh(gam).min()))
        out["finite"] &= bool(torch.isfinite(sig.abs()).all())
        for f, bad in faulty.items():
            out["control_rel_err"][f] = min(out["control_rel_err"][f],
                                            rel(bad[i], ref))
    return out


def _sigma_failed(s):
    """True unless a _sigma_check result is finite, retarded, within
    BETHE_SIGMA_BOUND of the reference, and both faulty references miss
    that bound."""
    return not (s["finite"] and s["rel_err_sigma"] <= BETHE_SIGMA_BOUND
                and s["gamma_min_eig"] >= BETHE_GAMMA_MIN
                and min(s["control_rel_err"].values()) > BETHE_SIGMA_BOUND)


def _route(negfe, device):
    """Which route serves negfe's sums: 'spectral', 'lu-warm' or 'lu'."""
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    eng = EnergyEngine(negfe.F_eV, negfe.S, negfe.g, negfe.exec_cfg,
                       device=device)
    if eng._spectral_runner() is not None:
        return "spectral"
    return "lu-warm" if eng._use_warm() else "lu"


LU_KERNELS = ("strip_elim", "panel_fused", "panel_lu")


def _launch_dict(kernels):
    from gaunegf_tpu_torch.ops.kernels import fixed_point as fp
    from gaunegf_tpu_torch.ops.kernels import sancho_rubio as sr
    return {"strip_elim": launch_count(kernels[0]),
            "panel_fused": launch_count(kernels[1]),
            "panel_lu": launch_count(kernels[2]),
            "fixed_point": launch_count(fp), "sancho_rubio": launch_count(sr)}


def _bethe_scf(negfe, eps, kernels, device, cycles, n_sample=3):
    """The provider's sigmas at n_sample energies in the lattice s band
    against the reference, the first density against the reference at
    V = 0 and at V = 0.1, the timed cycles of both, and one instrumented
    FockToP (sweeps per energy, the providers' share of its time)."""
    from gaunegf_tpu_torch.models import bethe
    from gaunegf_tpu_torch.tune import ProviderClock
    out = {"route": _route(negfe, device),
           "sigma": _sigma_check(
               negfe.g, np.linspace(eps - 1.0, eps + 1.0, n_sample), device)}
    for key, qV in (("eq", 0.0), ("bias", 0.1)):
        negfe.setVoltage(qV, fermi=0.0)
        negfe.FockToP()
        P_first = negfe.P.copy()
        P_ref = reference_bethe_density(negfe, device)
        controls = {f: rel_err(reference_bethe_density(negfe, device, f),
                               P_ref) for f in ("conv", "slots")}
        reset_counts()
        _sync(device)
        t0 = time.perf_counter()
        counts, electrons, _ = negfe.SCF(conv=1e-10, damping=0.05,
                                         max_cycles=cycles)
        _sync(device)
        dt = time.perf_counter() - t0
        out[key] = {"qV": qV, "rel_err_first_P": rel_err(P_first, P_ref),
                    "max_P": float(np.abs(P_ref).max()),
                    "control_rel_err": controls,
                    "cycles": len(counts), "s_per_cycle": dt / len(counts),
                    "points_per_cycle": negfe.N1 + negfe.N2
                    + (negfe.Nnegf if qV else 0),
                    "launches": _launch_dict(kernels),
                    "nelec": float(electrons[-1]),
                    "finite": bool(np.isfinite(negfe.P).all())}
    with bethe.SweepCounter() as counter, ProviderClock(device) as clock:
        _, dt = _timed(device, negfe.FockToP)
    sweeps = counter.counts()
    out["instrumented"] = {
        "seconds": dt, "provider_seconds": clock.seconds,
        "provider_share": clock.seconds / dt, "provider_calls": clock.calls,
        "sweeps_mean": float(sweeps.mean()), "sweeps_max": int(sweeps.max()),
        "fixed_point_lanes": int(sweeps.size)}
    return out


def _bethe_transport(negfe, eps, kernels, device, n_T, with_lu):
    """T(E) and DOS over n_T points inside the lattice s band on negfe's
    result: the default configuration (and, with_lu, solver='lu', where a
    provider with a static support would otherwise stay on the spectral
    route), warm and cold, against the dense reference."""
    from gaunegf_tpu_torch import transport as tr
    from gaunegf_tpu_torch.config import ExecutionConfig
    F, S, g = negfe.F_eV, negfe.S, negfe.g
    E = np.linspace(eps - 2.0, eps + 2.0, n_T)
    T_ref, dos_ref, gam_min = reference_bethe_transport(F, S, g, E, device)
    out = {"points": n_T, "T_max": float(T_ref.max()),
           "gamma_min_eig": gam_min}
    cfgs = {"default": ExecutionConfig(),
            "cold": ExecutionConfig(warm_start=False)}
    if with_lu:
        cfgs["lu_warm"] = ExecutionConfig(solver="lu")
        cfgs["lu_cold"] = ExecutionConfig(solver="lu", warm_start=False)
    src = tr.SigmaSource(g)
    tr.calculate_transmission(F, S, src, E[:8], device=device)   # warm-up
    for name, cfg in cfgs.items():
        reset_counts()
        T, dt = _timed(device, lambda: tr.calculate_transmission(
            F, S, src, E, exec_cfg=cfg, device=device))
        out[name] = {"T_pts_per_s": n_T / dt,
                     "max_abs_err_T": float(np.abs(T - T_ref).max()),
                     "min_T": float(T.min()),
                     "launches": _launch_dict(kernels),
                     "finite": bool(np.isfinite(T).all())}
        if name in ("default", "cold"):
            (dos, _), dt = _timed(device, lambda: tr.calculate_dos(
                F, S, src, E, exec_cfg=cfg, device=device))
            out[name]["dos_pts_per_s"] = n_T / dt
            out[name]["rel_err_dos"] = rel_err(dos, dos_ref)
    # one sweep on the fused panel (kernel 2)
    reset_counts()
    cfg = ExecutionConfig(solver="lu", lu_panel="fused")
    T, dt = _timed(device, lambda: tr.calculate_transmission(
        F, S, src, E, exec_cfg=cfg, device=device))
    out["fused"] = {"T_pts_per_s": n_T / dt,
                    "max_abs_err_T": float(np.abs(T - T_ref).max()),
                    "min_T": float(T.min()),
                    "launches": _launch_dict(kernels),
                    "finite": bool(np.isfinite(T).all())}
    return out


def _plane_junction(n_dev):
    """tests/test_lattice3d.py's single hexagonal contact plane of 4
    atoms, one on each side of a chain of n_dev single-orbital sites."""
    from gaunegf_tpu_torch.models.bethe import BetheGeometry
    d = 2.88
    u1 = np.array([1.0, 0.0, 0.0]) * d
    u2 = np.array([0.5, np.sqrt(3) / 2, 0.0]) * d
    top = [np.zeros(3), u1, u2, u1 + u2]
    dev_atoms = [np.array([1.0, 0.6, -5.0 - 1.8 * k]) for k in range(n_dev)]
    bottom = [c + np.array([0, 0, dev_atoms[-1][2] - 5.0]) for c in top]
    coords = np.stack(top + dev_atoms + bottom)
    n_atoms = len(coords)
    metal = set(range(1, 5)) | set(range(n_atoms - 3, n_atoms + 1))
    orb_atoms = []
    for atom in range(1, n_atoms + 1):
        orb_atoms += [atom] * (9 if atom in metal else 1)
    contacts = [[1, 2, 3, 4], list(range(n_atoms - 3, n_atoms + 1))]
    return BetheGeometry(coords, np.asarray(orb_atoms), None), contacts


def _lattice3d(device, kernels, n_dev, n_E, n_T, nk, n_sample=3):
    """9d: Lattice3DSelfEnergy beside an N ~ 1000 device, gamma-point and
    k-space (symmetry-reduced and full grid): the sigmas at n_sample
    energies, one gr_sum over n_E points above the real axis and an
    n_T-point T(E), against the references."""
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.models import slater_koster as sk
    from gaunegf_tpu_torch.models.lattice3d import Lattice3DSelfEnergy
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    geom, contacts = _plane_junction(n_dev)
    N = 72 + n_dev
    params = sk.parse_bethe_file("demo")
    eps = params.onsite["s"] + 0.4
    F = np.zeros((N, N))
    idx = np.arange(36, 36 + n_dev)
    for a in list(range(0, 36, 9)) + list(range(36 + n_dev, N, 9)):
        F[a:a + 9, a:a + 9] = params.h0()
    F[idx, idx] = eps
    F[idx[:-1], idx[1:]] = F[idx[1:], idx[:-1]] = -0.8
    for a in (0, 9, 18, 27):
        F[a, idx[0]] = F[idx[0], a] = -0.4
        F[idx[-1] + 1 + a, idx[-1]] = F[idx[-1], idx[-1] + 1 + a] = -0.4
    S = np.eye(N)
    E = np.linspace(eps - 2.0, eps + 2.0, n_E) + 0.05j
    w = np.cos(np.arange(n_E)) + 0j
    E_T = np.linspace(eps - 2.0, eps + 2.0, n_T)
    out = {"N": N}
    for name, kw in (("gamma", {}),
                     ("kspace_sym", {"gamma_point_only": False, "nk": nk}),
                     ("kspace_full", {"gamma_point_only": False, "nk": nk,
                                      "bz_symmetry": False})):
        prov = Lattice3DSelfEnergy(F, S, contacts, geom, lat_file="demo",
                                   eta=1e-5, T=0.0, fermi=0.0, device=device,
                                   verbose=False, **kw)
        eng = EnergyEngine(F, S, prov, ExecutionConfig(), device=device)
        route = "spectral" if eng._spectral_runner() is not None else (
            "lu-warm" if eng._use_warm() else "lu")
        eng.gr_sum(E[:8], w[:8])                            # warm-up
        reset_counts()
        G, dt = _timed(device, lambda: eng.gr_sum(E, w))
        G_ref = reference_bethe_gr_sum(F, S, prov, E, w, device)
        controls = {f: rel_err(reference_bethe_gr_sum(F, S, prov, E, w,
                                                      device, f), G_ref)
                    for f in ("conv", "slots")}
        T, dt_T = _timed(device, lambda: eng.transmission(E_T))
        T_ref, _, gam_min = reference_bethe_transport(F, S, prov, E_T, device)
        # the same sweep on the warm-started LU engine (contact columns)
        lu = EnergyEngine(F, S, prov, ExecutionConfig(solver="lu"),
                          device=device)
        T_lu, dt_lu = _timed(device, lambda: lu.transmission(E_T))
        out[name] = {"route": route, "gr_pts_per_s": n_E / dt,
                     "sigma": _sigma_check(prov, np.linspace(
                         eps - 1.0, eps + 1.0, n_sample), device),
                     "k_points": (int(prov._phases[0][0].shape[0])
                                  if prov.kspace else 0),
                     "rel_err_gr_sum": rel_err(G, G_ref),
                     "control_rel_err": controls,
                     "T_pts_per_s": n_T / dt_T,
                     "max_abs_err_T": float(np.abs(T - T_ref).max()),
                     "T_max": float(T_ref.max()), "min_T": float(T.min()),
                     "lu_warm": lu._use_warm(),
                     "T_lu_pts_per_s": n_T / dt_lu,
                     "max_abs_err_T_lu": float(np.abs(T_lu - T_ref).max()),
                     "gamma_min_eig": gam_min,
                     "launches": _launch_dict(kernels),
                     "finite": bool(np.isfinite(G).all()
                                    and np.isfinite(T).all())}
    return out


def phase_bethe(kernels, device, n_chain=946, N1=128, N2=64, cycles=3,
                n_T=200, n_dev=928, n_E3=128, n_T3=100, nk=8, n_sample=3):
    """Phase 9; returns the result dict."""
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.models import harrison
    from gaunegf_tpu_torch.models.bethe import BetheSelfEnergy
    from gaunegf_tpu_torch.ops import greens
    t0 = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 9a: demo.bethe, non-orthogonal: static support, spectral route
        negfe_a, eps_a = _bethe_negfe(device, tmp, "demo", n_chain, N1, N2)
        res["a"] = {"N": int(negfe_a.F_eV.shape[0]),
                    **_bethe_scf(negfe_a, eps_a, kernels, device, cycles,
                                 n_sample)}
        # 9b: Au.bethe, orthogonal: dense Xi sig Xi, the LU's full inverses
        negfe_b, eps_b = _bethe_negfe(device, tmp, "Au", n_chain, N1, N2)
        res["b"] = {"N": int(negfe_b.F_eV.shape[0]),
                    **_bethe_scf(negfe_b, eps_b, kernels, device, cycles,
                                 n_sample)}
        # once more on the high tier: complex128 LU, sigma at conv 1e-11
        negfe_h, _ = _bethe_negfe(device, tmp, "Au", n_chain, N1, N2,
                                  cfg=ExecutionConfig(precision="high"))
        negfe_h.setVoltage(0.0, fermi=0.0)
        reset_counts()
        _, dt = _timed(device, negfe_h.FockToP)
        res["b"]["high"] = {
            "seconds": dt, "launches": _launch_dict(kernels),
            "rel_err_first_P": rel_err(
                negfe_h.P, reference_bethe_density(negfe_h, device)),
            "finite": bool(np.isfinite(negfe_h.P).all())}
        # 9c: transport on both results
        res["c"] = {
            "demo": _bethe_transport(negfe_a, eps_a, kernels, device, n_T,
                                     with_lu=True),
            "Au": _bethe_transport(negfe_b, eps_b, kernels, device, n_T,
                                   with_lu=False)}
        # 9e: setContactBethe without a Fermi level: the contact search on
        # the 117 x 117 extended lattice, on two arithmetic paths
        levels = {}
        for name, cfg in (("default", ExecutionConfig()),
                          ("exact_lu", ExecutionConfig(precision="exact",
                                                       solver="lu"))):
            calls = [0]
            init = greens.EnergyEngine.__init__

            def counted(self, *a, **k):
                calls[0] += 1
                init(self, *a, **k)
            greens.EnergyEngine.__init__ = counted
            try:
                (negfe_e, _), dt = _timed(device, lambda: _bethe_negfe(
                    device, tmp, "demo", n_chain, N1, N2, cfg=cfg,
                    fermi=None))
            finally:
                greens.EnergyEngine.__init__ = init
            levels[name] = {"fermi": float(negfe_e.g.fermi), "seconds": dt,
                            "engine_calls": calls[0]}
        res["e"] = {"search": levels}
        from gaunegf_tpu_torch.tune import bethe_junction
        _, geom, contacts, _ = bethe_junction("Au", n_chain)
        hp = harrison.bethe_params("Au")
        prov = BetheSelfEnergy(negfe_b.F_eV, negfe_b.S, contacts, geom,
                               lat_file=hp, eta=1e-5, T=0.0, fermi=0.0,
                               verbose=False, device=device)
        res["e"]["harrison"] = {
            "orthogonal": bool(prov.orthogonal),
            "contact_inds": prov.contact_inds() is not None,
            **_sigma_check(prov, np.linspace(eps_b - 1.0, eps_b + 1.0,
                                             n_sample), device)}
    # 9d: the 3D-lattice provider, gamma-point and k-space
    res["d"] = _lattice3d(device, kernels, n_dev, n_E3, n_T3, nk, n_sample)
    res["seconds"] = time.perf_counter() - t0
    return res


def check_bethe(res, cycles=3):
    """Raise unless phase 9 stayed finite, took the expected routes, ran
    its kernels and met its bounds."""
    a, b = res["a"], res["b"]
    if a["route"] != "spectral" or b["route"] != "lu-warm":
        raise AssertionError(f"bethe: routes {a['route']}, {b['route']}; "
                             "expected spectral (demo) and lu-warm (Au)")
    for name, r in (("a", a), ("b", b)):
        for key in ("eq", "bias"):
            s = r[key]
            if not s["finite"] or s["cycles"] < cycles \
                    or s["rel_err_first_P"] > BETHE_P_BOUND:
                raise AssertionError(f"bethe ({name}) {key} failed: {s}")
            if s["control_rel_err"]["slots"] <= BETHE_P_BOUND:
                raise AssertionError(
                    f"bethe ({name}) {key}: a faulty embedding passes the "
                    f"bound {BETHE_P_BOUND:g}: {s['control_rel_err']}")
        if _sigma_failed(r["sigma"]):
            raise AssertionError(f"bethe ({name}) sigma failed (bound "
                                 f"{BETHE_SIGMA_BOUND:g}): {r['sigma']}")
    if any(a[k]["launches"][n] for k in ("eq", "bias") for n in LU_KERNELS):
        raise AssertionError(f"bethe (a): an LU kernel launched on the "
                             f"spectral route: {a}")
    if min(b[k]["launches"]["strip_elim"] for k in ("eq", "bias")) <= 0:
        raise AssertionError(f"bethe (b): the LU's full inverses launched "
                             f"no strip kernel: {b}")
    # every Bethe sigma of phase 9 goes through kernel A; the k-space
    # half-space terms through kernel B
    if min(r[k]["launches"]["fixed_point"] for r in (a, b)
           for k in ("eq", "bias")) <= 0:
        raise AssertionError(f"bethe: a cycle launched no fixed_point "
                             f"kernel: {a}, {b}")
    for lat, c in res["c"].items():
        for name, r in c.items():
            if isinstance(r, dict) and "launches" in r \
                    and r["launches"]["fixed_point"] <= 0:
                raise AssertionError(f"bethe (c) {lat} {name}: no "
                                     f"fixed_point launch: {r}")
    for name, d in res["d"].items():
        if isinstance(d, dict) and (
                d["launches"]["fixed_point"] <= 0
                or name != "gamma" and d["launches"]["sancho_rubio"] <= 0):
            raise AssertionError(f"bethe (d) {name}: the fixed-point kernels "
                                 f"did not launch: {d['launches']}")
    h = b["high"]
    if not h["finite"] or h["launches"]["panel_lu"] <= 0 \
            or h["launches"]["fixed_point"] <= 0 \
            or h["rel_err_first_P"] > BETHE_HIGH_BOUND:
        raise AssertionError(f"bethe (b) high tier failed: {h}")
    for lat, c in res["c"].items():
        lu = lat == "Au"
        t_bound = BETHE_T_REL_BOUND * max(1.0, c["T_max"])
        if c["gamma_min_eig"] < BETHE_GAMMA_MIN:
            raise AssertionError(f"bethe (c) {lat}: Gamma not positive: {c}")
        for name, r in c.items():
            if not isinstance(r, dict) or "max_abs_err_T" not in r:
                continue
            on_lu = lu or name != "default" and name != "cold"
            bound = max(t_bound, T_MIXED_BOUND) if on_lu else t_bound
            if not r["finite"] or r["max_abs_err_T"] > bound \
                    or r["min_T"] < BETHE_T_MIN - (T_MIXED_BOUND if on_lu
                                                   else 0.0):
                raise AssertionError(
                    f"bethe (c) {lat} {name} failed (bound {bound:g}): {r}")
            if "rel_err_dos" in r and r["rel_err_dos"] > BETHE_DOS_REL_BOUND:
                raise AssertionError(f"bethe (c) {lat} {name} DOS: {r}")
        if c["fused"]["launches"]["panel_fused"] <= 0:
            raise AssertionError(f"bethe (c) {lat}: the fused sweep "
                                 f"launched no panel_fused kernel: {c}")
    if res["c"]["demo"]["lu_warm"]["launches"]["strip_elim"] <= 0:
        raise AssertionError("bethe (c): demo with solver='lu' launched no "
                             f"strip kernel: {res['c']['demo']}")
    for name, d in res["d"].items():
        if not isinstance(d, dict):
            continue
        if not d["finite"] or d["rel_err_gr_sum"] > BETHE_P_BOUND \
                or d["max_abs_err_T"] > BETHE_T_REL_BOUND * max(1.0,
                                                                d["T_max"]) \
                or d["min_T"] < BETHE_T_MIN or not d["lu_warm"] \
                or d["max_abs_err_T_lu"] > max(
                    T_MIXED_BOUND, BETHE_T_REL_BOUND * d["T_max"]) \
                or d["gamma_min_eig"] < BETHE_GAMMA_MIN:
            raise AssertionError(f"bethe (d) {name} failed: {d}")
        if d["control_rel_err"]["slots"] <= BETHE_P_BOUND \
                or _sigma_failed(d["sigma"]):
            raise AssertionError(
                f"bethe (d) {name}: sigma or its controls failed (bounds "
                f"{BETHE_SIGMA_BOUND:g}, {BETHE_P_BOUND:g}): {d['sigma']}, "
                f"{d['control_rel_err']}")
    s = res["e"]["search"]
    if not all(np.isfinite(v["fermi"]) for v in s.values()) \
            or abs(s["default"]["fermi"] - s["exact_lu"]["fermi"]) \
            > BETHE_FERMI_BOUND:
        raise AssertionError(f"bethe (e): contact Fermi search: {s}")
    hz = res["e"]["harrison"]
    if not hz["orthogonal"] or hz["contact_inds"] or _sigma_failed(hz):
        raise AssertionError(f"bethe (e): Harrison provider: {hz}")


# ---------------------------------------------------------------------------
# Phase 10: the reference's entry points through the facade (compat/)
# ---------------------------------------------------------------------------

# (a) the facade's first density against phase 9b's path on the same
# matrices: only the Hartree and Bohr round trips of the Gaussian bridge
# differ (~1e-16 relative), which moves the mixed tier's complex64 seeds
# by an ulp at most; the refined result stays within 1e-10 of max |P|.
COMPAT_PATH_BOUND = 1e-10


def _load_fake_gauopen():
    """tests/fake_gauopen.py, loaded by path."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent / "tests" / \
        "fake_gauopen.py"
    spec = importlib.util.spec_from_file_location("fake_gauopen", path)
    fake = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fake)
    return fake


def stand_in_gaussian(fake, ibftyp=None):
    """Register ``fake`` (the module of tests/fake_gauopen.py) as
    ``gauopen``; with ``ibftyp``, its BinAr also carries those per-orbital
    type codes (the fake has none; a Bethe contact reads them to order
    each metal atom's s, p, d orbitals).  Returns ``fake``."""
    pkg = fake.install()
    if ibftyp is not None:
        class BinAr(fake.BinAr):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.ibftyp = np.asarray(ibftyp)
        pkg.QCBinAr.BinAr = BinAr
    return fake


def type_codes(orb_atoms):
    """Per-orbital type codes whose abs // 1000 sorts a 9-orbital atom's
    s, p, d orbitals in that order (s 0; p 1000-1002; d 2000-2004); 0 for
    a single-orbital atom."""
    codes = np.zeros(len(orb_atoms), dtype=int)
    nine = [0, 1000, 1001, 1002, 2000, 2001, 2002, 2003, 2004]
    for atom in np.unique(orb_atoms):
        idx = np.where(orb_atoms == atom)[0]
        if len(idx) == 9:
            codes[idx] = nine
    return codes


class _FockClock:
    """Seconds spent in the backend's Fock rebuild (bridge and stand-in
    Gaussian) and, inside it, in the stand-in's update(dofock='DENSITY'),
    by wrapping both on one GaussianFock."""

    def __init__(self, backend):
        self.fock_s = self.update_s = 0.0
        self.calls = 0
        fock, update = backend.fock, backend.bar.update

        def timed_update(*a, **k):
            t0 = time.perf_counter()
            try:
                return update(*a, **k)
            finally:
                self.update_s += time.perf_counter() - t0

        def timed_fock(P):
            t0 = time.perf_counter()
            try:
                return fock(P)
            finally:
                self.fock_s += time.perf_counter() - t0
                self.calls += 1
        backend.fock, backend.bar.update = timed_fock, timed_update


def phase_compat(kernels, device, n_chain=946, N1=128, N2=64, cycles=3,
                 n_T=200, n_u=1000):
    """Phase 10; returns the result dict."""
    from gaunegf_tpu_torch import compat
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.transport import SigmaSource
    from gaunegf_tpu_torch.tune import bethe_junction
    from gaunegf_tpu_torch.units import BOHR_TO_ANG, EOVERH, HAR_TO_EV
    backend, geom, contacts, eps = bethe_junction("Au", n_chain)
    H = backend.H0
    N = H.shape[0]
    n_atoms = int(geom.orbital_atoms.max())
    fake = stand_in_gaussian(_load_fake_gauopen(),
                             type_codes(geom.orbital_atoms))
    res = {"N": N}
    t_phase = time.perf_counter()
    try:
        fake.configure(H / HAR_TO_EV, np.eye(N), ibfatm=geom.orbital_atoms,
                       ne=n_chain, U=0.1 / HAR_TO_EV,
                       coords=geom.coords / BOHR_TO_ANG)
        compat.install(device=device)
        from gauNEGF.scfE import NEGFE
        from gauNEGF.transport import DOSE, cohTransE, current
        with tempfile.TemporaryDirectory() as tmp:
            fn = f"{tmp}/au_junction"
            t0 = time.perf_counter()
            negf = NEGFE(fn, basis="lanl2dz", func="b3lyp", verbose=False)
            negf.setContactBethe([[1, 2, 3],
                                  [n_atoms - 2, n_atoms - 1, n_atoms]],
                                 "Au", 1e-5, 0, fermi=0)
            negf.setIntegralLimits(N1=N1, N2=N2)
            negf.setVoltage(0.1, fermi=0)
            setup_s = time.perf_counter() - t0
            _, dt_first = _timed(device, negf.FockToP)
            P_first = negf.P.copy()
            P_ref = reference_bethe_density(negf, device)
            # phase 9b's path on the same matrices in eV, geometry given
            path, _ = _bethe_negfe(device, tmp, "Au", n_chain, N1, N2)
            path.setVoltage(0.1, fermi=0.0)
            path.FockToP()
            a = {"setup_s": setup_s, "first_focktop_s": dt_first,
                 "route": _route(negf, device),
                 "contact_devices": _devices(negf.g),
                 "max_P": float(np.abs(P_ref).max()),
                 "rel_err_first_P_ref": rel_err(P_first, P_ref),
                 "rel_err_first_P_path": rel_err(P_first, path.P),
                 "max_abs_F_eV_diff": float(np.abs(negf.F_eV
                                                   - path.F_eV).max())}
            clock = _FockClock(negf.backend)
            reset_counts()
            _sync(device)
            t0 = time.perf_counter()
            counts, electrons, _ = negf.SCF(conv=1e-10, damping=0.05,
                                            max_cycles=cycles)
            _sync(device)
            dt = time.perf_counter() - t0
            n_cyc = len(counts)
            a.update({
                "cycles": n_cyc, "s_per_cycle": dt / n_cyc,
                "fock_rebuild_s_per_cycle": clock.fock_s / n_cyc,
                "stand_in_update_s_per_cycle": clock.update_s / n_cyc,
                "rest_s_per_cycle": (dt - clock.fock_s) / n_cyc,
                "fock_rebuilds": clock.calls,
                "launches": _launch_dict(kernels),
                "strip_launches_per_cycle":
                    launch_count(kernels[0]) / n_cyc,
                "density_updates": [c["dofock"] for c in
                                    negf.backend.bar.update_calls].count(
                                        "DENSITY"),
                "nelec": float(electrons[-1]),
                "finite": bool(np.isfinite(negf.P).all())})
            res["a"] = a
            # (b) the reference's transport calls on that result
            F, S, g = negf.F_eV, negf.S, negf.g
            E = np.linspace(eps - 2.0, eps + 2.0, n_T)
            T_ref, dos_ref, gam_min = reference_bethe_transport(F, S, g, E,
                                                                device)
            cohTransE(E[:8], F, S, g)                        # warm-up
            reset_counts()
            T, dt_T = _timed(device, lambda: cohTransE(E, F, S, g))
            T_launches = _launch_dict(kernels)
            (dos, _), dt_D = _timed(device, lambda: DOSE(E, F, S, g))
            # the current through the contacts' Sigma at the chain level,
            # a bias window of 0.1 V around it (the default dE = 1 meV)
            sig1, sig2 = negf.getSigma(eps)
            I, dt_I = _timed(device, lambda: current(F, S, sig1, sig2,
                                                     eps, 0.1))
            E_I = np.arange(eps - 0.05, eps + 0.05, 0.001)
            T_I, _ = reference_transport(
                F, S, SigmaSource(sig1, sig2).provider, E_I, device)
            I_ref = float(2 * EOVERH * np.trapezoid(T_I, E_I))
            T = np.asarray(T)
            res["b"] = {
                "points": n_T, "T_pts_per_s": n_T / dt_T,
                "dos_pts_per_s": n_T / dt_D, "T_max": float(T_ref.max()),
                "max_abs_err_T": float(np.abs(T - T_ref).max()),
                "min_T": float(T.min()), "gamma_min_eig": gam_min,
                "rel_err_dos": rel_err(np.asarray(dos), dos_ref),
                "T_launches": T_launches,
                "current": I, "current_ref": I_ref,
                "current_abs_err": abs(I - I_ref),
                "current_bound": 2 * EOVERH * 0.1 * T_MIXED_BOUND,
                "current_s": dt_I,
                "finite": bool(np.isfinite(T).all()
                               and np.isfinite(dos).all())}
            # writeChk and runDFT on the same object
            negf.writeChk()
            F_boot = negf.runDFT()
            a["chk_written"] = negf.backend.bar.written == [fn + ".chk"]
            a["runDFT_is_bootstrap"] = bool(np.array_equal(
                F_boot, H / HAR_TO_EV))
            # once more at precision='high': one FockToP (kernel 3)
            high = NEGFE(f"{tmp}/au_high", basis="lanl2dz", func="b3lyp",
                         verbose=False,
                         exec_cfg=ExecutionConfig(precision="high"))
            high.setContactBethe([[1, 2, 3],
                                  [n_atoms - 2, n_atoms - 1, n_atoms]],
                                 "Au", 1e-5, 0, fermi=0)
            high.setIntegralLimits(N1=N1, N2=N2)
            high.setVoltage(0.1, fermi=0)
            reset_counts()
            _, dt_h = _timed(device, high.FockToP)
            a["high"] = {"seconds": dt_h, "launches": _launch_dict(kernels),
                         "contact_devices": _devices(high.g),
                         "rel_err_first_P": rel_err(high.P, P_ref),
                         "finite": bool(np.isfinite(high.P).all())}
            # (c) spin 'u' through GaussianFock at 2N = 2 n_u
            Hu = -1.0 * (np.eye(n_u, k=1) + np.eye(n_u, k=-1))
            fake.configure(Hu / HAR_TO_EV, np.eye(n_u), ne=n_u,
                           U=0.1 / HAR_TO_EV)
            u = NEGFE(f"{tmp}/u{n_u}", spin="u", verbose=False)
            u.setSigma([1, 2], [n_u - 1, n_u], sig=-0.1j)
            u.setIntegralLimits(N1=N1, N2=N2)
            u.setVoltage(0.1, fermi=0.0)
            _, dt_u = _timed(device, u.FockToP)
            blocks = (slice(0, n_u), slice(n_u, 2 * n_u))
            p_err = max(rel_err(u.P[b, b],
                                reference_density_neq(u, device, b))
                        for b in blocks)
            clock_u = _FockClock(u.backend)
            reset_counts()
            counts_u, _, _ = u.SCF(conv=1e-10, damping=0.05, max_cycles=1)
            res["c"] = {
                "N": 2 * n_u, "route": _route(u, device),
                "contact_devices": _devices(u.g),
                "first_focktop_s": dt_u, "rel_err_first_P": p_err,
                "cross_block_P": float(np.abs(u.P[blocks[0],
                                                  blocks[1]]).max()),
                "locs_signed": bool((u.locs[:n_u] > 0).all()
                                    and (u.locs[n_u:] < 0).all()),
                "fock_rebuild_s": clock_u.fock_s,
                "cycles": len(counts_u), "launches": _launch_dict(kernels),
                "finite": bool(np.isfinite(u.P).all())}
        res["seconds"] = time.perf_counter() - t_phase
    finally:
        fake.uninstall()
        for k in [k for k in sys.modules if k.split(".")[0] == "gauNEGF"]:
            del sys.modules[k]
    return res


def _devices(g):
    """The device types where a contact provider and its atoms' fixed
    points evaluate their one-energy methods (getSigma, the DOS walk)."""
    return sorted({torch.device(x.device).type
                   for x in [g] + list(getattr(g, "g_list", []))})


def print_compat(res):
    a, b, c = res["a"], res["b"], res["c"]
    print(f"phase 10 compat (a) gauNEGF.scfE.NEGFE + setContactBethe, "
          f"N={res['N']}: {a['s_per_cycle']:.3f} s/cycle = stand-in "
          f"Gaussian Fock rebuild {a['fock_rebuild_s_per_cycle']:.3f} (its "
          f"update {a['stand_in_update_s_per_cycle']:.3f}) + rest "
          f"{a['rest_s_per_cycle']:.3f}; kernel-1 launches per cycle "
          f"{a['strip_launches_per_cycle']:g}; first P "
          f"{a['rel_err_first_P_path']:.3e} "
          f"from phase 9b's path (bound {COMPAT_PATH_BOUND:g}), "
          f"{a['rel_err_first_P_ref']:.3e} from the reference (bound "
          f"{BETHE_P_BOUND:g}); high tier {a['high']['rel_err_first_P']:.3e} "
          f"(bound {BETHE_HIGH_BOUND:g}), kernel-3 launches "
          f"{a['high']['launches']['panel_lu']}", flush=True)
    print(f"phase 10 compat (b) cohTransE {b['T_pts_per_s']:.1f} pts/s, "
          f"|dT| {b['max_abs_err_T']:.3e}, DOSE {b['dos_pts_per_s']:.1f} "
          f"pts/s rel err {b['rel_err_dos']:.3e}, current "
          f"{b['current']:.6e} vs {b['current_ref']:.6e} (|dI| "
          f"{b['current_abs_err']:.3e}, bound {b['current_bound']:.3e})",
          flush=True)
    print(f"phase 10 compat (c) spin 'u' 2N={c['N']}: first P "
          f"{c['rel_err_first_P']:.3e} (bound {SP_P_BOUND:g}), route "
          f"{c['route']}; phase 10 took {res['seconds']:.1f} s", flush=True)
    print(f"phase 10 compat: {json.dumps(res)}", flush=True)


def check_compat(res, cycles=3):
    """Raise unless phase 10 stayed finite, ran its kernels, wrote and
    replayed through the bridge and met its bounds."""
    a, b, c = res["a"], res["b"], res["c"]
    for part in (a, a["high"], c):
        if part["contact_devices"] != ["cuda"]:
            raise AssertionError("compat: a contact of the facade's NEGFE "
                                 "evaluates off the card: "
                                 f"{part['contact_devices']}")
    if a["route"] != "lu-warm" or not a["finite"] or a["cycles"] < cycles \
            or a["rel_err_first_P_path"] > COMPAT_PATH_BOUND \
            or a["rel_err_first_P_ref"] > BETHE_P_BOUND:
        raise AssertionError(
            f"compat (a) failed (bounds {COMPAT_PATH_BOUND:g} against phase "
            f"9b's path, {BETHE_P_BOUND:g} against the reference): {a}")
    if a["launches"]["strip_elim"] <= 0 or a["launches"]["fixed_point"] <= 0:
        raise AssertionError(f"compat (a): no strip or fixed_point kernel "
                             f"launched: {a}")
    if b["T_launches"]["fixed_point"] <= 0:
        raise AssertionError(f"compat (b): cohTransE launched no "
                             f"fixed_point kernel: {b}")
    if a["density_updates"] < cycles or a["fock_rebuilds"] < cycles:
        raise AssertionError(f"compat (a): the cycles did not go through "
                             f"dofock='DENSITY': {a}")
    if not (a["chk_written"] and a["runDFT_is_bootstrap"]):
        raise AssertionError(f"compat (a): writeChk / runDFT: {a}")
    h = a["high"]
    if not h["finite"] or h["launches"]["panel_lu"] <= 0 \
            or h["rel_err_first_P"] > BETHE_HIGH_BOUND:
        raise AssertionError(f"compat (a) high tier failed (bound "
                             f"{BETHE_HIGH_BOUND:g}): {h}")
    t_bound = max(BETHE_T_REL_BOUND * max(1.0, b["T_max"]), T_MIXED_BOUND)
    if not b["finite"] or b["max_abs_err_T"] > t_bound \
            or b["min_T"] < BETHE_T_MIN - T_MIXED_BOUND \
            or b["rel_err_dos"] > BETHE_DOS_REL_BOUND \
            or b["gamma_min_eig"] < BETHE_GAMMA_MIN \
            or b["current_abs_err"] > b["current_bound"]:
        raise AssertionError(f"compat (b) failed (T bound {t_bound:g}): {b}")
    if c["route"] != "spectral" or not c["finite"] or not c["locs_signed"] \
            or c["rel_err_first_P"] > SP_P_BOUND \
            or c["cross_block_P"] > SPIN_FLIP_BOUND:
        raise AssertionError(f"compat (c) 'u' failed (bound "
                             f"{SP_P_BOUND:g}): {c}")


# ---------------------------------------------------------------------------
# Phase 12: Newton-Schulz continuation and the XLA panels
# ---------------------------------------------------------------------------

# lanes of the chain on phase 12's paths: the JAX rule's cap (an explicit
# energy_chunk is the lane count); (b) sweeps CHAIN_SWEEP
CHAIN_LANES = 32
CHAIN_SWEEP = (8, 16, 32, 128)
# (a) the first density of the 'contour' cycle against the complex128
# build: the mixed gate promises r^4 < 8e-7 a point, with a margin of 10;
# the False cycle is held to phase 5's SCF_P_BOUND
CHAIN_P_BOUND = 1e-5
# (b) gr_sum on the chain against a complex128 torch.linalg.solve sum, as
# a share of the sum's largest entry
CHAIN_GR_BOUND = {"fast": 1e-4, "mixed": 1e-5, "strict": 1e-9}
XLA_PANELS = ("xla", "virtual", "split", "psplit")


def _chain_cycle(device, tmp, n, N1, N2, continuation, lanes, mesh=None):
    """Phase 5's chain at V = 0 and a fixed Fermi level on the LU route,
    mixed tier, ``lanes`` energies a chunk: NEGFE.FockToP takes
    density_eq_n, whose contour rides the chain for 'contour'."""
    from gaunegf_tpu_torch.config import ExecutionConfig
    cfg = ExecutionConfig(precision="mixed", solver="lu", energy_chunk=lanes,
                          continuation=continuation)
    negfe = _junction(device, tmp, n, cfg=cfg, N1=N1, N2=N2, mesh=mesh)
    negfe.setVoltage(0.0, fermi=0.0)
    return negfe


def _chain_counts(se):
    from gaunegf_tpu_torch.utils.logging import recorder
    return {"newton": recorder.count("chain.newton"),
            "lu": recorder.count("chain.lu"), "strip_elim": launch_count(se)}


def _gr_engine(F, S, g, device, precision, lanes, continuation, **kw):
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    return EnergyEngine(F, S, g, ExecutionConfig(
        precision=precision, solver="lu", energy_chunk=lanes,
        continuation=continuation, **kw), device=device)


def phase_chain(kernels, device, n=1000, N1=128, N2=64, lanes=CHAIN_LANES,
                cycles=3, rounds=2, N_big=2000, sweep=CHAIN_SWEEP,
                bench=(1000, 256, BATCH), panels=XLA_PANELS):
    """Phase 12.  (a) the V = 0 cycle on the LU route, 'contour' against
    False in ABBA order ``rounds`` times; (b) gr_sum with
    continuation=True over (a)'s contour per tier and at N_big, with the
    lane sweep; (c) one gr_sum at the bench shape per XLA panel name.
    Returns the result dict."""
    from gaunegf_tpu_torch import quadrature as quad
    from gaunegf_tpu_torch.models.fock import TightBindingFock
    from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
    from gaunegf_tpu_torch.tune import bench_system
    se = kernels[0]
    t_phase = time.perf_counter()
    res = {"lanes": lanes}

    # (a) the cycle, each mode's first density against the same reference
    a = {"cycles": cycles, "rounds": rounds,
         "modes": {"contour": {"s_per_cycle": []}, "off": {"s_per_cycle": []}}}
    with tempfile.TemporaryDirectory() as tmp:
        ref = None
        for mode, cont in (("contour", "contour"), ("off", False)):
            negfe = _chain_cycle(device, tmp, n, N1, N2, cont, lanes)
            reset_counts()
            negfe.FockToP()
            a["modes"][mode]["first"] = _chain_counts(se)
            if ref is None:
                ref = reference_density_neq(negfe, device)
            a["modes"][mode]["rel_err_first_P"] = rel_err(negfe.P, ref)
            a["modes"][mode]["finite"] = bool(np.isfinite(negfe.P).all())
        a["contour_points"] = N1
        for _ in range(rounds):
            for mode, cont in (("contour", "contour"), ("off", False),
                               ("off", False), ("contour", "contour")):
                negfe = _chain_cycle(device, tmp, n, N1, N2, cont, lanes)
                reset_counts()
                _sync(device)
                t0 = time.perf_counter()
                counts, _, _ = negfe.SCF(conv=1e-12, damping=0.05,
                                         max_cycles=cycles, checkpoint=False)
                _sync(device)
                a["modes"][mode]["s_per_cycle"].append(
                    (time.perf_counter() - t0) / len(counts))
                a["modes"][mode]["cycle_counts"] = _chain_counts(se)
        z_c, w_c = quad.contour_grid(negfe.Emin, negfe.mu1, N1, negfe.T)
        F1, S1, g1 = negfe.F_eV, negfe.S, negfe.g
    res["a"] = a

    # (b) gr_sum on the chain over (a)'s contour
    z_c = np.asarray(z_c, complex)
    w_c = np.asarray(w_c, complex)
    H2 = -1.0 * (np.eye(N_big, k=1) + np.eye(N_big, k=-1))
    fock2 = TightBindingFock(H2, n_electrons=N_big, U=0.5,
                             n0=0.5 * np.ones(N_big))
    F2, S2 = fock2.initial_fock(), fock2.overlap()
    g2 = ConstantSelfEnergy(F2, S2, [[0, 1], [N_big - 2, N_big - 1]],
                            sig1=-0.1j, device=device)
    systems = {n: (F1, S1, g1), N_big: (F2, S2, g2)}
    refs = {N: reference_gr_terms(*systems[N], z_c, w_c, device)[0]
            for N in systems}
    b = {"points": int(z_c.size), "cases": [], "sweep": []}

    def timed_pair(N, precision, ln):
        F, S, g = systems[N]
        engines = {c: _gr_engine(F, S, g, device, precision, ln, c)
                   for c in (True, False)}
        out, secs = {}, {True: [], False: []}
        for c in (True, False):
            out[c] = engines[c].gr_sum(z_c, w_c)          # warm-up
        counts = None
        for c in (True, False, False, True):
            reset_counts()
            v, dt = _timed(device, lambda: engines[c].gr_sum(z_c, w_c))
            secs[c].append(dt)
            if c:
                counts, out[c] = _chain_counts(se), v
        row = {"N": N, "precision": precision, "lanes": ln,
               "chain_pts_per_s": z_c.size / float(np.median(secs[True])),
               "lu_pts_per_s": z_c.size / float(np.median(secs[False])),
               "rel_err_chain": rel_err(out[True], refs[N]),
               "rel_err_lu": rel_err(out[False], refs[N]),
               "finite": bool(np.isfinite(out[True]).all()),
               "counts": counts}
        return row

    for N, precision in ((n, "fast"), (n, "mixed"), (n, "strict"),
                         (N_big, "mixed")):
        b["cases"].append(timed_pair(N, precision, lanes))
    for ln in sweep:
        b["sweep"].append(timed_pair(n, "mixed", ln))
    res["b"] = b

    # (c) one gr_sum at the bench shape per XLA panel name, on 256 of its
    # 512 points since phase 13 (the launch-bound panels took 15 s there)
    N, n_E, chunk = bench
    H, S, g = bench_system(N)
    E = np.linspace(-2.0, 2.0, n_E)
    w = np.ones(n_E)
    ref, gmax = reference_gr_terms(H, S, g, E, w, device)
    far = gmax <= GR_FAR_MAX_G
    ref_far, _ = reference_gr_terms(H, S, g, E[far], w[far], device)
    c = {"N": N, "points": n_E, "chunk": chunk, "panels": {}}
    for p in panels:
        eng = _gr_engine(H, S, g, device, "mixed", chunk, False, lu_panel=p,
                         near_pole_warn=False)
        eng.gr_sum(E[:chunk], w[:chunk])                  # warm-up
        reset_counts()
        out, dt = _timed(device, lambda: eng.gr_sum(E, w))
        launches = _launch_dict(kernels)
        c["panels"][p] = {
            "pts_per_s": n_E / dt, "seconds": dt, "launches": launches,
            "rel_err_full": rel_err(out, ref),
            "rel_err_far": rel_err(eng.gr_sum(E[far], w[far]), ref_far),
            "finite": bool(np.isfinite(out).all())}
    res["c"] = c
    res["seconds"] = time.perf_counter() - t_phase
    return res


def print_chain(res, beside=None):
    a, b, c = res["a"], res["b"], res["c"]
    for mode, m in a["modes"].items():
        s = m["s_per_cycle"]
        print(f"phase 12a V=0 cycle on the LU route, continuation="
              f"{'contour' if mode == 'contour' else False}, "
              f"{res['lanes']} lanes: s/cycle {', '.join(f'{x:.4f}' for x in s)}"
              f" (ABBA x{a['rounds']}, median {np.median(s):.4f}); first "
              f"density rel err {m['rel_err_first_P']:.3e}; first FockToP "
              f"{m['first']}, last {a['cycles']} cycles {m['cycle_counts']}",
              flush=True)
    for row in b["cases"] + b["sweep"]:
        print(f"phase 12b gr_sum continuation=True N={row['N']} "
              f"{row['precision']} {row['lanes']} lanes over "
              f"{b['points']} contour points: {row['chain_pts_per_s']:.1f} "
              f"pts/s (False: {row['lu_pts_per_s']:.1f}); rel err "
              f"{row['rel_err_chain']:.3e} (False {row['rel_err_lu']:.3e}); "
              f"{row['counts']}", flush=True)
    line = ", ".join(f"{p} {r['pts_per_s']:.1f}" for p, r in
                     c["panels"].items())
    if beside:
        line += " (phase 6d: " + ", ".join(
            f"{p} {beside[p]:.1f}" for p in ("pstrip", "fused", "pallas")) \
            + ")"
    print(f"phase 12c gr_sum at the bench shape per XLA panel, pts/s: "
          f"{line}; psplit kernel-1 launches "
          f"{c['panels'].get('psplit', {}).get('launches')}; rel err "
          + json.dumps({p: [r["rel_err_far"], r["rel_err_full"]]
                        for p, r in c["panels"].items()}), flush=True)
    print(f"phase 12: {res['seconds']:.2f} s", flush=True)


def check_chain(res):
    a, b, c = res["a"], res["b"], res["c"]
    for mode, bound in (("contour", CHAIN_P_BOUND), ("off", SCF_P_BOUND)):
        m = a["modes"][mode]
        if not m["finite"] or m["rel_err_first_P"] > bound:
            raise AssertionError(f"phase 12a {mode}: first density off the "
                                 f"complex128 build (bound {bound:g}): {m}")
        if m["first"]["strip_elim"] <= 0 or \
                m["cycle_counts"]["strip_elim"] <= 0:
            raise AssertionError(f"phase 12a {mode}: kernel 1 did not "
                                 f"launch: {m}")
    steps = {mode: m["first"]["newton"] + m["first"]["lu"]
             for mode, m in a["modes"].items()}
    if steps["contour"] != -(-a["contour_points"] // res["lanes"]) \
            or steps["off"] != 0:
        raise AssertionError(f"phase 12a: the contour's chain steps "
                             f"{steps} (the chain only for 'contour', one "
                             "step per point of a lane)")
    for row in b["cases"] + b["sweep"]:
        if not row["finite"] \
                or row["rel_err_chain"] > CHAIN_GR_BOUND[row["precision"]]:
            raise AssertionError(f"phase 12b off the complex128 sum (bound "
                                 f"{CHAIN_GR_BOUND[row['precision']]:g}): "
                                 f"{row}")
        if row["precision"] != "strict" and row["counts"]["strip_elim"] <= 0:
            raise AssertionError(f"phase 12b: kernel 1 did not launch: {row}")
    for p, r in c["panels"].items():
        if not r["finite"] or r["rel_err_far"] > GR_FAR_BOUND \
                or r["rel_err_full"] > GR_FULL_BOUND:
            raise AssertionError(f"phase 12c {p} off the complex128 sum: {r}")
    if c["panels"]["psplit"]["launches"]["strip_elim"] <= 0:
        raise AssertionError("phase 12c: psplit did not launch kernel 1")


def chain_launches(res):
    """Kernel 1's launches on phase 12's paths: (12a, 12b, 12c)."""
    a = sum(m["first"]["strip_elim"] + m["cycle_counts"]["strip_elim"]
            for m in res["a"]["modes"].values())
    b = sum(r["counts"]["strip_elim"]
            for r in res["b"]["cases"] + res["b"]["sweep"])
    c = res["c"]["panels"]["psplit"]["launches"]["strip_elim"]
    return a, b, c


# ---------------------------------------------------------------------------
# Phase 11: multi-device execution over torch.distributed
# ---------------------------------------------------------------------------

# Phase 11 sizes: the bench shape and the quick-start junction at full
# width; the high tier's gr_sum on 128 of the bench points in chunks of 32
# (a complex128 lane takes ~168 N^2 bytes, and four ranks share one card).
# n_E: 256 of the bench grid's 512 points since phase 13, to keep the
# whole run near 630 s
MULTI_SIZES = {"n": 1000, "n_chain": 946, "N1": 128, "N2": 64, "N": 1000,
               "n_E": 256, "chunk": BATCH, "n_E_high": 128,
               "chunk_high": 32, "n_T": 500}
MULTI_RANKS = 4
# sharded against serial on the card: complex128 paths to 1e-10 of the
# largest entry, as the JAX dry run asserts in x64; the mixed-tier LU at
# its own bounds (phase 4's GR_FAR_BOUND / GR_FULL_BOUND, 6a's
# T_MIXED_BOUND: the column blocks round their complex64 products
# differently, and near a pole the tier's error itself is that large); the
# warm Au cycle at 9b's BETHE_P_BOUND (once the grid is split, each rank's
# lanes start their fixed points from other seeds).
MULTI_C128_BOUND = 1e-10


def _multi_bench(sz, device, mesh, far, **cfg):
    """Phase 4's LU gr_sum at the bench shape (mixed tier, 'pstrip'
    panels): (whole grid, the far points' grid)."""
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    from gaunegf_tpu_torch.tune import bench_system
    H, S, g = bench_system(sz["N"])
    E = np.linspace(-2.0, 2.0, sz["n_E"])
    w = np.ones(sz["n_E"])
    eng = EnergyEngine(H, S, g, ExecutionConfig(
        precision="mixed", solver="lu", lu_panel="pstrip",
        energy_chunk=sz["chunk"], near_pole_warn=False, **cfg), mesh,
        device=device)              # phase 4 warns of the near-pole points
    return np.stack([eng.gr_sum(E, w), eng.gr_sum(E[far], w[far])])


def _multi_high(sz, device, mesh, far):
    """precision='high' gr_sum on the bench junction (the complex128 LU on
    the swap-pivoted panel)."""
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    from gaunegf_tpu_torch.tune import bench_system
    H, S, g = bench_system(sz["N"])
    E = np.linspace(-2.0, 2.0, sz["n_E_high"])
    eng = EnergyEngine(H, S, g, ExecutionConfig(
        precision="high", energy_chunk=sz["chunk_high"]), mesh,
        device=device)
    return eng.gr_sum(E, np.ones(sz["n_E_high"]))


def _multi_scf(sz, device, mesh, far, solver=None):
    """Phase 7d's biased cycle on the default configuration (spectral
    route), or with solver='lu': one SCF cycle at n; the density."""
    from gaunegf_tpu_torch.config import ExecutionConfig
    cfg = ExecutionConfig() if solver is None else ExecutionConfig(
        solver=solver, energy_chunk=sz["chunk"])
    with tempfile.TemporaryDirectory() as tmp:
        negfe = _junction(device, tmp, sz["n"], cfg=cfg, N1=sz["N1"],
                          N2=sz["N2"], mesh=mesh)
        negfe.setVoltage(0.1, fermi=0.0)
        negfe.SCF(conv=1e-5, damping=0.05, max_cycles=1)
    return negfe.P


def _multi_warm(sz, device, mesh, far):
    """Phase 9b's Au junction on the warm-started LU engines (kernel 1 on
    full inverses): one SCF cycle at V = 0.1; the density.  The automatic
    chunk (128): each of the 4 'e' ranks' contiguous segments holds a
    quarter of the contour and of the 50-point bias window
    (parallel/mesh.warm_segment), so every rank launches kernel 1."""
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    with tempfile.TemporaryDirectory() as tmp:
        negfe, _ = _bethe_negfe(device, tmp, "Au", sz["n_chain"], sz["N1"],
                                sz["N2"], cfg=ExecutionConfig(solver="lu"),
                                mesh=mesh)
        if not EnergyEngine(negfe.F_eV, negfe.S, negfe.g, negfe.exec_cfg,
                            mesh, device=device)._use_warm():
            raise AssertionError("the Au cycle left the warm engines")
        negfe.setVoltage(0.1, fermi=0.0)
        negfe.SCF(conv=1e-10, damping=0.05, max_cycles=1)
    return negfe.P


def _multi_chain(sz, device, mesh, far):
    """Phase 12a's 'contour' cycle (V = 0, the LU route, the contour on
    the Newton-Schulz chain over CHAIN_LANES lanes): one SCF cycle at n;
    the density.  Under (4, 1) each rank chains its own segment of the
    contour and gates its own steps."""
    with tempfile.TemporaryDirectory() as tmp:
        negfe = _chain_cycle(device, tmp, sz["n"], sz["N1"], sz["N2"],
                             "contour", CHAIN_LANES, mesh=mesh)
        negfe.SCF(conv=1e-12, damping=0.05, max_cycles=1, checkpoint=False)
    return negfe.P


def _multi_T(sz, device, mesh, far):
    """Phase 6a's sweep on the quick-start junction (its first Fock
    matrix): T(E) over 500 points, mixed tier on the fused panel (kernel
    2), contact columns."""
    from gaunegf_tpu_torch import transport as tr
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.models.fock import TightBindingFock
    from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
    n = sz["n"]
    backend = TightBindingFock(-1.0 * (np.eye(n, k=1) + np.eye(n, k=-1)),
                               n_electrons=n, U=0.5, n0=0.5 * np.ones(n))
    F, S = backend.initial_fock(), backend.overlap()
    g = ConstantSelfEnergy(F, S, [[0, 1], [n - 2, n - 1]], sig1=-0.1j,
                           device=device)
    cfg = ExecutionConfig(precision="mixed", solver="lu", lu_panel="fused",
                          energy_chunk=sz["chunk"])
    return tr.calculate_transmission(
        F, S, tr.SigmaSource(g), np.linspace(-3, 3, sz["n_T"]),
        exec_cfg=cfg, device=device, mesh=mesh)


# leg: (layout 'm' size, function, keyword arguments, kernel that must
# launch on every rank or None, bound kind)
MULTI_LEGS = {
    "scf_spectral": (1, _multi_scf, {}, None, "c128"),
    "scf_warm_lu": (1, _multi_warm, {}, "strip_elim", "bethe"),
    "scf_chain": (1, _multi_chain, {}, "strip_elim", "chain"),
    "gr_sum_cols": (2, _multi_bench, {}, "strip_elim", "gr"),
    "gr_sum_dist": (2, _multi_bench, {"distribute_lu": True}, "strip_elim",
                    "gr"),
    "gr_sum_high": (2, _multi_high, {}, "panel_lu", "c128"),
    "T_cols": (2, _multi_T, {}, "panel_fused", "T"),
}


def _multi_rank(sz, far, rank_device, backend):
    """One rank of phase 11(b): every leg under the mesh of its layout
    ((4, 1) and (2, 2) over the same world), each with its launches
    (counts set to 0 just before the leg, read just after), its seconds
    and the shapes it handed the kernel wrappers."""
    from gaunegf_tpu_torch.ops.kernels import panel_fused as pf
    from gaunegf_tpu_torch.ops.kernels import panel_lu as pl
    from gaunegf_tpu_torch.ops.kernels import strip_elim as se
    from gaunegf_tpu_torch.parallel.mesh import energy_mesh
    from gaunegf_tpu_torch.utils.logging import recorder
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {m: energy_mesh(model_parallel=m, device=rank_device,
                             backend=backend) for m in (1, 2)}
    device = meshes[1].device
    spy = ShapeSpy().install()
    out = {"rank": meshes[1].rank, "device": str(device), "legs": {},
           "shapes": {m: dict(mesh.shape) for m, mesh in meshes.items()}}
    with recorder.recording():              # a spawned process of its own
        for name, (m, fn, kw, _, _) in MULTI_LEGS.items():
            mesh = meshes[m]
            reset_counts()
            mesh.barrier()
            value, dt = _timed(device,
                               lambda: fn(sz, device, mesh, far, **kw))
            out["legs"][name] = {"value": value, "seconds": dt,
                                 "launches": _launch_dict((se, pf, pl)),
                                 "coords": dict(mesh.coords)}
    spy.remove()
    out["seen"] = spy.seen
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else None)
    return out


def phase_multi(kernels, device, spy, sizes=MULTI_SIZES,
                backend_one="nccl", backend_ranks="gloo"):
    """Phase 11.  (a) a world of one rank over backend_one on ``device``:
    7d's cycle, phase 4's gr_sum and 9b's warm cycle under the mesh are
    equal bit for bit to the same runs without it.  (b) MULTI_RANKS ranks
    sharing ``device`` over backend_ranks: each leg of MULTI_LEGS on its
    layout against the serial run here.  Returns the result dict."""
    import torch.distributed as dist
    from gaunegf_tpu_torch.parallel.launch import spawn_ranks
    from gaunegf_tpu_torch.parallel.mesh import energy_mesh
    from gaunegf_tpu_torch.tune import bench_system
    t_phase = time.perf_counter()
    sz = dict(sizes)
    H, S, g = bench_system(sz["N"])
    E = np.linspace(-2.0, 2.0, sz["n_E"])
    _, gmax = reference_gr_terms(H, S, g, E, np.ones(sz["n_E"]), device)
    far = gmax <= GR_FAR_MAX_G
    serial, serial_s = {}, {}
    for name, (_, fn, kw, _, _) in MULTI_LEGS.items():
        if name == "gr_sum_dist":
            continue                      # its serial run is gr_sum_cols'
        serial[name], serial_s[name] = _timed(
            device, lambda: fn(sz, device, None, far, **kw))
    serial["gr_sum_dist"] = serial["gr_sum_cols"]
    res = {"far_points": int(far.sum()), "serial_seconds": serial_s}

    # (a) a world of one rank: the mesh's plumbing changes nothing
    mesh = energy_mesh(device=device.type, backend=backend_one)
    one = {}
    for name in ("scf_spectral", "gr_sum_cols", "scf_warm_lu"):
        _, fn, kw, _, _ = MULTI_LEGS[name]
        got = fn(sz, device, mesh, far, **kw)
        one[name] = bool(np.array_equal(got, serial[name]))
    dist.destroy_process_group()
    res["a"] = {"backend": backend_one, "equal": one,
                "mesh": dict(mesh.shape)}

    # (b) ranks sharing the card; the kernels are built (phase 2), so the
    # ranks load them
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as init_dir:
        ranks = spawn_ranks(MULTI_RANKS, _multi_rank,
                            (sz, far, device.type, backend_ranks),
                            backend=backend_ranks, init_dir=init_dir,
                            threads=2, timeout=900)
    res["b"] = {"ranks": MULTI_RANKS, "backend": backend_ranks,
                "seconds": time.perf_counter() - t0,
                "peak_bytes": [r["peak_bytes"] for r in ranks],
                "devices": [r["device"] for r in ranks]}
    for r in ranks:                       # the ranks' shapes join phase 3b
        for kname, seen in r["seen"].items():
            for key, calls in seen.items():
                spy.seen[kname][key] = spy.seen[kname].get(key, 0) + calls
    legs = {}
    for name in ranks[0]["legs"]:
        vals = [r["legs"][name]["value"] for r in ranks]
        kind = MULTI_LEGS[name][4]
        got, ref = vals[0], serial[name]
        row = {"layout": ranks[0]["shapes"][MULTI_LEGS[name][0]],
               "ranks_equal": all(np.array_equal(v, got)
                                  for v in vals[1:]),
               "finite": bool(np.isfinite(got).all()),
               "seconds": max(r["legs"][name]["seconds"] for r in ranks),
               "serial_seconds": serial_s.get(name,
                                              serial_s["gr_sum_cols"]),
               "launches": [r["legs"][name]["launches"] for r in ranks],
               "must_launch": MULTI_LEGS[name][3], "kind": kind}
        if kind == "gr":
            row["rel_err_full"] = rel_err(got[0], ref[0])
            row["rel_err_far"] = rel_err(got[1], ref[1])
        elif kind == "T":
            row["max_abs_err_T"] = float(np.abs(got - ref).max())
        else:
            row["rel_err"] = rel_err(got, ref)
        legs[name] = row
    res["b"]["legs"] = legs
    res["seconds"] = time.perf_counter() - t_phase
    return res


def print_multi(res):
    print(f"phase 11a multi-device, world of 1 over {res['a']['backend']}: "
          + ", ".join(f"{k} {'torch.equal' if v else 'DIFFERS'}"
                      for k, v in res["a"]["equal"].items()), flush=True)
    b = res["b"]
    print(f"phase 11b multi-device, {b['ranks']} ranks over {b['backend']} "
          "time-sharing one card; no scaling number (phase 11: "
          f"{res['seconds']:.2f} s with its serial references)", flush=True)
    print(f"  ranks on {b['devices']}: {b['seconds']:.2f} s with their "
          f"start; peak bytes per rank {b['peak_bytes']}", flush=True)
    for name, row in b["legs"].items():
        errs = {k: row[k] for k in ("rel_err", "rel_err_full",
                                    "rel_err_far", "max_abs_err_T")
                if k in row}
        print(f"  {name} {row['layout']}: {row['seconds']:.3f} s (4 ranks "
              f"time-sharing one card; no scaling number; serial "
              f"{row['serial_seconds']:.3f} s), ranks equal "
              f"{row['ranks_equal']}, {json.dumps(errs)}, launches per rank "
              f"{row['launches']}", flush=True)
    print("  host staging by parallel/mesh.py: none (gloo's own CUDA "
          "all_reduce, all_gather and broadcast carry the collectives, "
          "through host memory inside gloo)", flush=True)


def check_multi(res):
    bad = [k for k, v in res["a"]["equal"].items() if not v]
    if bad:
        raise AssertionError(f"phase 11a: a world of one rank changed {bad}")
    for name, row in res["b"]["legs"].items():
        if not (row["ranks_equal"] and row["finite"]):
            raise AssertionError(f"phase 11b {name}: ranks differ or "
                                 f"non-finite: {row}")
        kind = row["kind"]
        ok = {"c128": lambda: row["rel_err"] <= MULTI_C128_BOUND,
              "bethe": lambda: row["rel_err"] <= BETHE_P_BOUND,
              "chain": lambda: row["rel_err"] <= CHAIN_P_BOUND,
              "gr": lambda: (row["rel_err_far"] <= GR_FAR_BOUND
                             and row["rel_err_full"] <= GR_FULL_BOUND),
              "T": lambda: row["max_abs_err_T"] <= T_MIXED_BOUND}[kind]()
        if not ok:
            raise AssertionError(f"phase 11b {name} off the serial run: "
                                 f"{row}")
        k = row["must_launch"]
        if k and not all(l[k] > 0 for l in row["launches"]):
            raise AssertionError(f"phase 11b {name}: {k} did not launch on "
                                 f"every rank: {row['launches']}")


def multi_launches(res, name):
    """Kernel ``name``'s launches over every rank and leg of phase 11b."""
    return sum(l[name] for row in res["b"]["legs"].values()
               for l in row["launches"])


# ---------------------------------------------------------------------------
# Phase 13: BASELINE's I-V sweep at N = 2000, the chain's warm engines, the
# examples on the card, and the ported paths no earlier phase runs
# ---------------------------------------------------------------------------

# 13a, BASELINE.json configs[4] on the quick start's chain at 2000
# orbitals, default configuration (the spectral route).  integralCheck at
# the sweep's largest bias sets N1, N2 and Nnegf (the window grid only
# grows with the bias), which every point keeps; each point's SCF runs to
# IV_CONV from the previous point's density, then the Landauer current on
# the reference's window grid (dE = IV_DE).  Damping IV_DAMPING with
# Pulay converged each point of a five-point sweep (qV 0, 0.1, ..., 0.4)
# in 6-11 cycles on the H100; at 0.05 (the JAX test's) the mixing takes
# no Pulay step and the residual shrinks by 0.95 a cycle.  That sweep ran
# 13a in 156.7 s, over its 150 s, so the points are tests/test_iv_sweep.py's
# three.  Checks: every point converged; its first density within
# SP_BLOCK_P_BOUND of the complex128 rebuild with the window's Gamma on
# the contacts' support, as the route takes it (the route's G< leaves out
# the -1e-9j S background's Gamma over the other orbitals, 7d's reason;
# that gap grows with the window, 3.2e-7 to 1.24e-6 of max |P| from
# qV = 0.1 to 0.4 against the full Gamma on the H100, so the full
# reference would hold the background and not the route: ROADMAP,
# divergences of the reference); I(0) = 0 and I rising strictly
# with qV; each current within 2 e/h |qV| IV_T_BOUND of a trapezoid over
# the complex128 T(E) on the same grid, Gamma on the contact blocks (7c's
# |dT| <= 1e-11 with a margin of 10).  The LU leg at the last point: one
# FockToP and the current on the mixed tier ('pstrip': kernel 1 at
# N = 2000) within SCF_P_BOUND (phase 5's) of the spectral density and
# 2 e/h |qV| T_MIXED_BOUND (6a's T bound) of its current.
IV_N = 2000
IV_VOLTAGES = (0.0, 0.2, 0.4)
IV_CONV = 1e-5
IV_DAMPING = 0.2
IV_MAX_CYCLES = 40
IV_DE = 0.01
IV_T_BOUND = 1e-10
# 13d, upd_fermi with Bethe contacts: the search's own count and the
# exact-tier rebuild of the found level differ by more than sums do
# (8a's FERMI_PROBE_BOUND), since the search's sigma stops at conv 1e-5
# and the rebuild's at 1e-11: 3.76e-6 electrons on the H100, held at 10x.
BETHE_PROBE_BOUND = 4e-5


def reference_current(F, S, g, qV, device, fermi=0.0, T=0.0, dE=IV_DE):
    """(I, width): the Landauer current on calculate_current's window grid
    (np.arange from muL to muR, spread by N_KT kT at finite T, weighted by
    the Fermi difference) by a trapezoid over reference_block_T, and the
    grid's width."""
    from gaunegf_tpu_torch import quadrature as quad
    from gaunegf_tpu_torch.config import N_KT
    from gaunegf_tpu_torch.units import EOVERH, KB
    muL, muR = fermi - qV / 2, fermi + qV / 2
    spread = N_KT * KB * T
    E = np.arange(muL - spread, muR + spread, dE)
    df = np.ones_like(E) if T == 0 else np.abs(
        quad.fermi_dirac(E, muR, T) - quad.fermi_dirac(E, muL, T))
    T_ref = reference_block_T(F, S, g, E, device)
    return (float(2 * EOVERH * np.trapezoid(T_ref * df, E)),
            float(E[-1] - E[0]))


def _current(negfe, qV, device, cfg=None, fermi=0.0, T=0.0):
    from gaunegf_tpu_torch import transport as tr
    kw = {} if cfg is None else {"exec_cfg": cfg}
    return tr.calculate_current(negfe.F_eV, negfe.S, tr.SigmaSource(negfe.g),
                                fermi=fermi, qV=qV, T=T, dE=IV_DE,
                                device=device, **kw)


def _iv_point(negfe, qV, grids, kernels, device, damping, max_cycles):
    """One voltage point of the sweep: SCF to IV_CONV from negfe's present
    density with the first FockToP's density and Fock matrix kept, the
    cycle's pieces timed, then the current; both against their
    references."""
    from gaunegf_tpu_torch.units import EOVERH
    negfe.setVoltage(qV, fermi=0.0)
    negfe.setIntegralLimits(**grids)      # setVoltage resets Nnegf to 50
    first = {}
    focktop = negfe.FockToP

    def recorded():
        F = negfe.F_eV.copy()
        out = focktop()
        if not first:
            first.update(P=negfe.P.copy(), F=F)
        return out
    negfe.FockToP = recorded
    reset_counts()
    try:
        with _Spy(device) as clock:
            (counts, _, _), dt = _timed(device, lambda: negfe.SCF(
                conv=IV_CONV, damping=damping, max_cycles=max_cycles,
                checkpoint=False))
    finally:
        del negfe.FockToP
    launches = [launch_count(m) for m in kernels]
    n = len(counts)
    I, dt_I = _timed(device, lambda: _current(negfe, qV, device))
    t0 = time.perf_counter()
    I_ref = reference_current(negfe.F_eV, negfe.S, negfe.g, qV, device)[0] \
        if qV else 0.0
    P_ref = reference_density_neq(negfe, device, F=first["F"], block=True)
    sec = clock.seconds
    return {"qV": qV, "cycles": n, "conv_level": float(negfe.conv_level),
            "seconds": dt, "s_per_cycle": dt / n,
            "eigh_s_per_cycle": sec["eigh"] / n,
            "sums_s_per_cycle": (sec["sums"] - sec["eigh"]) / n,
            "host_s_per_cycle": (dt - sec["sums"]) / n,
            "eighs": clock.eighs,
            "points_per_focktop": grids["N1"] + grids["N2"]
            + (grids["Nnegf"] if qV else 0),
            "rel_err_first_P": rel_err(first["P"], P_ref),
            "reference_s": time.perf_counter() - t0,
            "current_A": I, "current_ref_A": I_ref,
            "current_abs_err": abs(I - I_ref),
            "current_bound": 2 * EOVERH * abs(qV) * IV_T_BOUND,
            "current_s": dt_I, "launches": launches,
            "nelec": float(negfe.nelec),
            "finite": bool(np.isfinite(negfe.P).all() and np.isfinite(I))}


def phase_iv(kernels, device, n=IV_N, voltages=IV_VOLTAGES,
             damping=IV_DAMPING, max_cycles=IV_MAX_CYCLES, check_cycles=2):
    """13a; returns the result dict (raises if the spectral route
    declines)."""
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.units import EOVERH
    res = {"n": n, "conv": IV_CONV, "damping": damping,
           "max_cycles": max_cycles, "dE": IV_DE,
           "check_cycles": check_cycles}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # the quick start's grids (N1 = 128, N2 = 64, Nnegf = 50) for
        # integralCheck's warm-up cycles, then the grids it fits
        negfe = _junction(device, tmp, n, cfg=ExecutionConfig())
        _spectral_engine(negfe.F_eV, negfe.S, negfe.g, device,
                         negfe.exec_cfg)          # raises if it declines
        negfe.setVoltage(max(voltages), fermi=0.0)
        scf = negfe.SCF

        def timed_scf(*a, **k):
            out, res["integral_check_scf_s"] = _timed(
                device, lambda: scf(*a, **k))
            return out
        negfe.SCF = timed_scf
        try:
            _, res["integral_check_s"] = _timed(
                device, lambda: negfe.integralCheck(cycles=check_cycles))
        finally:
            del negfe.SCF
        grids = {"N1": negfe.N1, "N2": negfe.N2, "Nnegf": negfe.Nnegf,
                 "Emin": negfe.Emin}
        res["grids"] = dict(grids)
        res["points"] = [_iv_point(negfe, qV, grids, kernels, device,
                                   damping, max_cycles) for qV in voltages]
        # the LU leg at the last point: one FockToP of the converged Fock
        # matrix on each configuration
        qV = voltages[-1]
        negfe.FockToP()
        P_spec = negfe.P.copy()
        I_spec = res["points"][-1]["current_A"]
        cfg = ExecutionConfig(precision="mixed", solver="lu",
                              lu_panel="pstrip")
        negfe.exec_cfg = cfg
        reset_counts()
        _, dt = _timed(device, negfe.FockToP)
        focktop_launches = launch_count(kernels[0])
        I_lu, dt_I = _timed(device, lambda: _current(negfe, qV, device,
                                                     cfg))
        res["lu"] = {
            "qV": qV, "seconds": dt, "current_s": dt_I,
            "rel_err_P": rel_err(negfe.P, P_spec),
            "current_A": I_lu, "current_abs_err": abs(I_lu - I_spec),
            "current_bound": 2 * EOVERH * abs(qV) * T_MIXED_BOUND,
            "focktop_launches": focktop_launches,
            "launches": [launch_count(m) for m in kernels],
            "finite": bool(np.isfinite(negfe.P).all()
                           and np.isfinite(I_lu))}
    res["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else float("nan"))
    res["seconds"] = time.perf_counter() - t_phase
    return res


def check_iv(res):
    """Raise unless 13a's sweep converged everywhere and met its bounds."""
    pts = res["points"]
    for p in pts:
        if not p["finite"] or p["conv_level"] >= res["conv"] \
                or p["rel_err_first_P"] > SP_BLOCK_P_BOUND \
                or p["current_abs_err"] > p["current_bound"] \
                or not p["cycles"] - 1 <= p["eighs"] <= p["cycles"]:
            raise AssertionError(f"iv (a) point failed: {p}")
    I = [p["current_A"] for p in pts]
    if I[0] != 0.0 or not all(b > a for a, b in zip(I, I[1:])):
        raise AssertionError(f"iv (a): currents not 0 then rising: {I}")
    lu = res["lu"]
    if not lu["finite"] or lu["rel_err_P"] > SCF_P_BOUND \
            or lu["current_abs_err"] > lu["current_bound"] \
            or lu["focktop_launches"] <= 0:
        raise AssertionError(f"iv (a) LU leg failed: {lu}")


def print_iv(res):
    print(f"phase 13a iv: N={res['n']} grids {res['grids']} (integralCheck "
          f"{res['integral_check_s']:.2f} s, its {res['check_cycles']} SCF "
          f"cycles {res['integral_check_scf_s']:.2f} s), conv "
          f"{res['conv']:g}, damping "
          f"{res['damping']}, cap {res['max_cycles']} cycles, "
          f"{res['seconds']:.2f} s, peak {res['peak_bytes'] / 1e9:.3f} GB",
          flush=True)
    for p in res["points"]:
        print(f"  qV {p['qV']:.1f}: {p['cycles']} cycles {p['seconds']:.3f} s"
              f" ({p['s_per_cycle']:.4f} s/cycle: eigh "
              f"{p['eigh_s_per_cycle']:.4f}, sums {p['sums_s_per_cycle']:.4f},"
              f" host {p['host_s_per_cycle']:.4f}), {p['points_per_focktop']}"
              f" points/FockToP, conv {p['conv_level']:.2e}, first P "
              f"{p['rel_err_first_P']:.3e}, I {p['current_A']:.9e} A (ref "
              f"err {p['current_abs_err']:.2e}, bound "
              f"{p['current_bound']:.2e}, {p['current_s']:.3f} s), "
              f"launches {p['launches']}", flush=True)
    print(f"  LU leg: {json.dumps(res['lu'])}", flush=True)


def phase_chain_warm(kernels, device, n=1000, n_T=200):
    """13b: 6b's setContact1D junction on the mixed LU, T(E) and DOS over
    200 points with warm_start="force" (the warm engines) against False
    (the cold route), and against the complex128 reference."""
    from gaunegf_tpu_torch import transport as tr
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    with tempfile.TemporaryDirectory() as tmp:
        negfe = _junction(device, tmp, n)
        negfe.setContact1D([[1], [n]], tau_list=[np.array([[-1.0]])] * 2,
                           stau_list=[np.zeros((1, 1))] * 2, eta=1e-4)
    F, S, g = negfe.F_eV, negfe.S, negfe.g
    src = tr.SigmaSource(g)
    E = np.linspace(-2.5, 2.5, n_T)
    T_ref, dos_ref = reference_transport(F, S, g, E, device)
    res = {"n": n, "points": n_T}
    for key, ws in (("force", "force"), ("cold", False)):
        cfg = ExecutionConfig(precision="mixed", solver="lu", warm_start=ws)
        kw = dict(exec_cfg=cfg, device=device)
        tr.calculate_transmission(F, S, src, E[:8], **kw)         # warm-up
        reset_counts()
        T, dt = _timed(device, lambda: tr.calculate_transmission(
            F, S, src, E, **kw))
        T_launches = launch_count(kernels[0])
        (dos, _), dt_d = _timed(device, lambda: tr.calculate_dos(
            F, S, src, E, **kw))
        launches = [launch_count(m) for m in kernels]
        res[key] = {
            "warm": EnergyEngine(F, S, g, cfg, device=device)._use_warm(),
            "T": T, "dos": dos, "T_pts_per_s": n_T / dt,
            "dos_pts_per_s": n_T / dt_d, "T_launches": T_launches,
            "launches": launches,
            "max_abs_err_T": float(np.abs(T - T_ref).max()),
            "rel_err_dos": rel_err(dos, dos_ref),
            "finite": bool(np.isfinite(T).all() and np.isfinite(dos).all())}
    f, c = res["force"], res["cold"]
    res["force_vs_cold_T"] = float(np.abs(f.pop("T") - c.pop("T")).max())
    res["force_vs_cold_dos"] = rel_err(f.pop("dos"), c.pop("dos"))
    res["force_over_cold"] = f["T_pts_per_s"] / c["T_pts_per_s"]
    return res


def check_chain_warm(res):
    f, c = res["force"], res["cold"]
    if not (f["warm"] and not c["warm"] and f["finite"] and c["finite"]) \
            or res["force_vs_cold_T"] > T_MIXED_BOUND \
            or res["force_vs_cold_dos"] > SPIN_DOS_REL_BOUND \
            or f["max_abs_err_T"] > T_MIXED_BOUND \
            or f["rel_err_dos"] > SPIN_DOS_REL_BOUND \
            or f["T_launches"] <= 0 or c["T_launches"] <= 0 \
            or min(f["launches"][4], c["launches"][4]) <= 0:
        raise AssertionError(f"chain warm (b) failed: {res}")


# 13c: what tests/test_torch_examples.py asserts of each example's numbers,
# held on the card's run and the CPU's; where it gives a number a
# tolerance (au_electrode_kspace's 5e-5 and 0.05 %, the electron counts'
# 0.05 and 0.5) the card's number is held to the CPU's at it.
def _example_failures(name, out):
    bad = []
    ok = lambda cond, what: bad.append(what) if not cond else None
    if name == "au_electrode_kspace":
        ok(all(np.isfinite(v) and v > 0 for v in out.values()), "finite")
    elif name == "integral_demo":
        for key in ("negf", "negfe"):
            ok(out[key]["conv"] < 1e-4, f"{key} conv")
            ok(abs(out[key]["nelec"] - 16) < 0.05, f"{key} nelec")
            ok(abs(out[key]["fermi"]) < 0.5, f"{key} fermi")
        ok(0 < out["dP"] < 1e-2, "dP")
        cur = [i for _, i in out["iv"]]
        ok(all(np.isfinite(cur)) and 0 < cur[0] < cur[1] < cur[2], "iv")
    elif name == "reference_migration":
        ok(0 < out["T0"] <= 1 + 1e-9, "T0")
        ok(0 < out["T0_static"] <= 3 + 1e-9, "T0_static")
        ok(out["dos0"] > 0, "dos0")
        ok(abs(out["ne"] - 10) < 0.5, "ne")
    elif name == "si_nanowire_scf":
        ok(np.isfinite(out["fermi"]) and -5 < out["fermi"] < 5, "fermi")
        ok(0.9 < out["max_T1"] <= 1 + 1e-6, "max_T1")
        ok(0.9 < out["max_T2"] <= 1 + 1e-6, "max_T2")
        ok(out["conv2"] < 1e-3, "conv2")
        ok(np.isfinite(out["conv3"]), "conv3")
    elif name == "tb_chain_transport":
        ok(out["ranks"] == 1, "ranks")
        ok(0.9 < out["max_T"] <= 1 + 1e-6, "max_T")
        ok(0 < out["dos_integral"] <= 64 + 1, "dos_integral")
        ok(np.isfinite(out["current"]) and out["current"] > 0, "current")
    return bad


EXAMPLE_TOLERANCES = {
    "au_electrode_kspace": {("bethe_gamma_max",): 5e-5,
                            ("kspace_gamma_max",): 5e-5,
                            ("rel_diff",): 5e-4},
    "integral_demo": {("negf", "nelec"): 0.05, ("negfe", "nelec"): 0.05},
    "reference_migration": {("ne",): 0.5}}


def _leaves(out, prefix=()):
    """(path, float) of every number in an example's returned dict."""
    if isinstance(out, dict):
        for k, v in out.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            yield from _leaves(v, prefix + (i,))
    elif isinstance(out, (int, float, np.floating, np.integer)):
        yield prefix, float(out)


def phase_examples(device, devices=("cuda", "cpu")):
    """13c: each example's main('cuda') and main('cpu') (``devices``: the
    run held and the run it is held to)."""
    import importlib

    import torch.distributed as dist
    from gaunegf_tpu_torch.compat import _device as compat_device
    from gaunegf_tpu_torch.examples import EXAMPLES
    res = {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"gaunegf_tpu_torch.examples.{name}")
        runs = {}
        for dev in devices:
            saved = compat_device._state["device"]
            try:
                runs[dev] = _timed(device, lambda: mod.main(dev))
            finally:
                compat_device._state["device"] = saved
                if dist.is_initialized():
                    dist.destroy_process_group()
                for k in [k for k in sys.modules
                          if k.split(".")[0] == "gauNEGF"]:
                    del sys.modules[k]
        held, to = (runs[dev] for dev in devices)
        ref = dict(_leaves(to[0]))
        diffs = {path: abs(v - ref[path]) for path, v in _leaves(held[0])}
        res[name] = {
            "seconds": [held[1], to[1]], "returned": held[0],
            "max_abs_diff": max(diffs.values()),
            "failures": [_example_failures(name, r[0]) for r in (held, to)],
            "over_tolerance": {"/".join(map(str, p)): diffs[p]
                               for p, tol in EXAMPLE_TOLERANCES.get(
                                   name, {}).items() if diffs[p] > tol}}
    return res


def check_examples(res):
    for name, r in res.items():
        if any(r["failures"]) or r["over_tolerance"]:
            raise AssertionError(f"examples (c) {name} failed: {r}")


# 13d: the ported paths that no earlier phase runs, each one cycle's
# density or one sweep at N <= 1000 on a junction of phases 5-10, held to
# a complex128 reference at the bound of the phase it is nearest to.  A
# leg counts the launches of the stretches that drive the port's path
# (with path: ...), not those of its references.

class _PathCounts:
    """Kernel launches summed over the with blocks of a leg: each block
    sets every count to 0 on entry and adds the counts up on exit, so
    that the references run between blocks count nothing."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.launches = [0] * len(kernels)

    def __enter__(self):
        reset_counts()
        return self

    def __exit__(self, *exc):
        self.launches = [n + launch_count(m)
                         for n, m in zip(self.launches, self.kernels)]
        reset_counts()


def _leg_finite_T(path, device, tmp, n, N1, N2):
    """The quick start's biased cycle and its current at T = 300 K."""
    d = _junction(device, tmp, n, N1=N1, N2=N2)
    d.setSigma([1, 2], [n - 1, n], sig=-0.1j, T=300.0)
    d.setIntegralLimits(N1=N1, N2=N2)
    d.setVoltage(0.1, fermi=0.0)
    with path:
        _, dt = _timed(device, d.FockToP)
        I, dt_I = _timed(device, lambda: _current(d, 0.1, device, T=300.0))
    I_ref, width = reference_current(d.F_eV, d.S, d.g, 0.1, device, T=300.0)
    from gaunegf_tpu_torch.units import EOVERH
    return {"nearest": "13a", "seconds": dt,
            "current_s": dt_I, "current_A": I, "route": _route(d, device),
            "checks": [
                ("rel_err_first_P", rel_err(d.P, reference_density_neq(
                    d, device, block=True)), SP_BLOCK_P_BOUND),
                ("current_abs_err", abs(I - I_ref),
                 2 * EOVERH * width * IV_T_BOUND)]}


def _leg_band_edge(path, device, tmp, n, N1, N2):
    """A bias window across the chain's upper band edge (2 eV): Fermi
    level 1.9, qV = 0.4, the window [1.7, 2.1]."""
    from gaunegf_tpu_torch.units import EOVERH
    d = _junction(device, tmp, n, N1=N1, N2=N2)
    d.setVoltage(0.4, fermi=1.9)
    with path:
        _, dt = _timed(device, d.FockToP)
        I, dt_I = _timed(device, lambda: _current(d, 0.4, device,
                                                  fermi=1.9))
    I_ref, _ = reference_current(d.F_eV, d.S, d.g, 0.4, device, fermi=1.9)
    return {"nearest": "13a", "seconds": dt,
            "current_s": dt_I, "current_A": I, "route": _route(d, device),
            "checks": [
                ("rel_err_first_P", rel_err(d.P, reference_density_neq(
                    d, device, block=True)), SP_BLOCK_P_BOUND),
                ("current_abs_err", abs(I - I_ref),
                 2 * EOVERH * 0.4 * IV_T_BOUND)]}


def _leg_ro(path, device, tmp, n, N1, N2):
    """Spin 'ro' at 2N = 2n: the first density per spin block."""
    d = _junction(device, tmp, n, spin="ro", exchange=0.2, N1=N1, N2=N2)
    d.setVoltage(0.1, fermi=0.0)
    with path:
        _, dt = _timed(device, d.FockToP)
    blocks = (slice(0, n), slice(n, 2 * n))
    return {"nearest": "8d ('u')", "N": 2 * n, "seconds": dt,
            "route": _route(d, device),
            "checks": [
                ("rel_err_first_P", max(
                    rel_err(d.P[b, b], reference_density_neq(d, device, b,
                                                            block=True))
                    for b in blocks), SP_BLOCK_P_BOUND),
                ("cross_block_P", float(np.abs(d.P[blocks[0],
                                                   blocks[1]]).max()),
                 SPIN_FLIP_BOUND)]}


def _expand(sigs, spin, N):
    """Spin-'r' sigmas (b, N, N) in a spin layout: block-diagonal for
    'u' / 'ro', spinor-interleaved for 'g'."""
    out = []
    for s in sigs:
        z = torch.zeros((s.shape[0], 2 * N, 2 * N), dtype=s.dtype,
                        device=s.device)
        if spin == "g":
            z[:, 0::2, 0::2] = s
            z[:, 1::2, 1::2] = s
        else:
            z[:, :N, :N] = s
            z[:, N:, N:] = s
        out.append(z)
    return out


def _leg_bethe_spin(path, device, tmp, n_chain, N1, N2):
    """'u' and 'g' with Au Bethe contacts (9b's junction, N = n_chain + 54
    orbitals a spin): the first biased density against dense complex128
    inverses on the spin-'r' reference sigmas in the layout's
    expansion."""
    from gaunegf_tpu_torch.scfe import NEGFE
    from gaunegf_tpu_torch.tune import bethe_junction
    r, _ = _bethe_negfe(device, tmp, "Au", n_chain, N1, N2)
    r.setVoltage(0.1, fermi=0.0)      # its lattices aligned as the legs'
    N = r.F_eV.shape[0]
    out = {"nearest": "9b", "N": 2 * N, "checks": []}
    for spin in ("u", "g"):
        backend, geom, contacts, _ = bethe_junction("Au", n_chain, spin=spin)
        d = NEGFE(backend, spin=spin, name=f"{tmp}/bethe_{spin}",
                  device=device, verbose=False)
        d.setContactBethe(contacts, lat_file="Au", eta=1e-5, T=0.0,
                          geometry=geom, fermi=0.0)
        d.setIntegralLimits(N1=N1, N2=N2)
        d.setVoltage(0.1, fermi=0.0)
        before = path.launches[0]
        with path:
            _, out[f"{spin}_seconds"] = _timed(device, d.FockToP)
        out[f"{spin}_strip_launches"] = path.launches[0] - before
        out[f"{spin}_route"] = _route(d, device)
        P_ref = reference_bethe_density(d, device, sigmas=lambda Eb: _expand(
            reference_bethe_sigmas(r.g, Eb), spin, N))
        out["checks"].append((f"{spin}_rel_err_first_P",
                              rel_err(d.P, P_ref), BETHE_P_BOUND))
    return out


def _leg_bethe_fermi(path, device, tmp, n_chain, N1, N2):
    """setVoltage(0.1) without a Fermi level on demo.bethe contacts (the
    spectral route): one FockToP with its search from 0.03 eV, 8a's
    checks, and the search must report convergence.  The junction's
    electron count is the one its Fermi level 0 holds: bethe_junction
    counts the chain's electrons only, its 54 contact-atom orbitals hold
    their own, and for that count no level is within conv, so the search
    stops unconverged near -8 eV in both packages (ROADMAP, known faults
    of the reference).  A probe realigns both lattices to the probed
    level and counts the contour's electrons above the lower segment
    counted at the search's start, so the exact-tier rebuild of the found
    level does the same (8a's _search_once rebuilds with the provider as
    FockToP leaves it, which for constant contacts is the same thing)."""
    from gaunegf_tpu_torch import density as dens
    from gaunegf_tpu_torch.config import FERMI_CALCULATION_TOL, ExecutionConfig
    d, _ = _bethe_negfe(device, tmp, "demo", n_chain, N1, N2)
    d.setVoltage(0.0, fermi=0.0)
    with path:
        d.FockToP()
    d.backend.n_electrons = 2 * float(np.einsum("ij,ji->", d.P, d.S).real)
    d.fermi = 0.03
    d.setVoltage(0.1)
    conv = min(d.conv_level, FERMI_CALCULATION_TOL)
    target = d.backend.n_electrons / 2
    Emin, mus, g = d.Emin, (d.mu1, d.mu2), d.g
    with _Spy() as spy, path:
        _, dt = _timed(device, d.FockToP)
    cfg = ExecutionConfig(precision="exact", solver="lu")
    g.setF(g.F, *mus)
    low = dens.density_real_n(d.F_eV, d.S, g, d.Eminf, Emin, d.N2, T=0,
                              exec_cfg=cfg, device=device)
    g.setF(g.F, d.fermi, d.fermi)
    con = dens.density_complex_n(d.F_eV, d.S, g, Emin, d.fermi, N=d.N1,
                                 T=d.T, exec_cfg=cfg, device=device)
    g.setF(g.F, d.mu1, d.mu2)
    n_err_ref = float(np.einsum("ij,ji->", low + con, d.S).real) - target
    own = spy.last.get(d.fermi)
    return {"nearest": "8a", "route": _route(d, device), "seconds": dt,
            "fermi": d.fermi, "probes": spy.probes, "eighs": spy.eighs,
            "conv": conv, "n_err_ref": n_err_ref, "n_err_search": own,
            "checks": [
                # the muller search returns a level it probed
                ("search_unconverged",
                 int(own is None or abs(own) > conv), 0),
                ("n_err_ref", abs(n_err_ref), conv),
                ("search_vs_rebuild", float("inf") if own is None
                 else abs(n_err_ref - own), BETHE_PROBE_BOUND),
                # at most one eigh a Fock matrix (the count's FockToP
                # above may have cached this one)
                ("eighs_over_one", max(0, spy.eighs - 1), 0),
                ("no_probe", int(spy.probes < 1), 0)]}


def _plane_fock(n_dev):
    """9d's junction: demo.bethe blocks on the two 4-atom planes, a chain
    of n_dev sites 0.4 eV above the lattice's s level.  Returns (F, chain
    orbitals, chain level)."""
    from gaunegf_tpu_torch.models import slater_koster as sk
    N = 72 + n_dev
    params = sk.parse_bethe_file("demo")
    eps = params.onsite["s"] + 0.4
    F = np.zeros((N, N))
    idx = np.arange(36, 36 + n_dev)
    for a in list(range(0, 36, 9)) + list(range(36 + n_dev, N, 9)):
        F[a:a + 9, a:a + 9] = params.h0()
    F[idx, idx] = eps
    F[idx[:-1], idx[1:]] = F[idx[1:], idx[:-1]] = -0.8
    for a in (0, 9, 18, 27):
        F[a, idx[0]] = F[idx[0], a] = -0.4
        F[idx[-1] + 1 + a, idx[-1]] = F[idx[-1], idx[-1] + 1 + a] = -0.4
    return F, idx, eps


def _leg_kspace(path, device, tmp, n_dev, N1, N2, nk=8, nk_gr=16,
                n_E=64):
    """One biased SCF cycle with k-space Lattice3DSelfEnergy contacts at
    nk = 8 (the first density against the reference, then the cycle
    timed), and one gr_sum at nk = 16."""
    from gaunegf_tpu_torch.config import ExecutionConfig
    from gaunegf_tpu_torch.models.fock import TightBindingFock
    from gaunegf_tpu_torch.models.lattice3d import Lattice3DSelfEnergy
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    from gaunegf_tpu_torch.scfe import NEGFE
    geom, contacts = _plane_junction(n_dev)
    F, idx, eps = _plane_fock(n_dev)
    U = np.zeros(F.shape[0])
    U[idx] = 0.5
    backend = TightBindingFock(F, n_electrons=float(n_dev), U=U,
                               n0=np.zeros(F.shape[0]), coords=geom.coords,
                               locs=geom.orbital_atoms)
    d = NEGFE(backend, name=f"{tmp}/kspace", device=device, verbose=False)
    # the contacts set, then their provider replaced (the reference's
    # negf.g = surfG3(...))
    d.setSigma(contacts[0], contacts[-1], T=0.0)
    prov = lambda k: Lattice3DSelfEnergy(
        d.F_eV, d.S, contacts, geom, lat_file="demo", eta=1e-5, T=0.0,
        fermi=0.0, gamma_point_only=False, nk=k, device=device,
        verbose=False)
    d.g = prov(nk)
    d.setIntegralLimits(N1=N1, N2=N2)
    d.setVoltage(0.1, fermi=0.0)
    with path:
        _, dt = _timed(device, d.FockToP)
    p_err = rel_err(d.P, reference_bethe_density(d, device))
    E = np.linspace(eps - 2.0, eps + 2.0, n_E) + 0.05j
    w = np.cos(np.arange(n_E)) + 0j
    with path:
        (counts, _, _), dt_c = _timed(device, lambda: d.SCF(
            conv=1e-10, damping=0.05, max_cycles=0, checkpoint=False))
        g16 = prov(nk_gr)
        eng = EnergyEngine(F, np.eye(F.shape[0]), g16, ExecutionConfig(),
                           device=device)
        G, dt_g = _timed(device, lambda: eng.gr_sum(E, w))
    G_ref = reference_bethe_gr_sum(F, np.eye(F.shape[0]), g16, E, w, device)
    return {"nearest": "9b (density), 9d (gr_sum)", "N": F.shape[0],
            "route": _route(d, device), "first_focktop_s": dt,
            "s_per_cycle": dt_c / len(counts),
            "k_points": [int(p._phases[0][0].shape[0]) for p in (d.g, g16)],
            "gr_sum_s": dt_g, "gr_points": n_E,
            "checks": [("rel_err_first_P", p_err, BETHE_P_BOUND),
                       ("rel_err_gr_sum_nk16", rel_err(G, G_ref),
                        BETHE_P_BOUND)]}


def _au_atom(device):
    """The Au lattice atom of 9b's contacts: (H, S list, V list, level)."""
    from gaunegf_tpu_torch.models.bethe import BetheSelfEnergy
    from gaunegf_tpu_torch.tune import bethe_junction
    backend, geom, contacts, eps = bethe_junction("Au", 30)
    prov = BetheSelfEnergy(backend.H0, np.eye(backend.H0.shape[0]), contacts,
                           geom, lat_file="Au", eta=1e-5, T=0.0, fermi=0.0,
                           verbose=False, device=device)
    g = prov.g_list[0]
    return g.H, g.Slist, g.Vlist, eps


def _lattice_sigma_check(got, H, Sl, Vl, eta, E, device):
    """Surface stacks got (b, 9, 9, 9) at the energies E (b,) against the
    all-neighbour (lattice) closure's reference, and the tree closure's
    reference as a control that must miss the bound."""
    E_d = torch.as_tensor(np.asarray(E) + 0j, device=device)
    ref = reference_bethe_surface(H, Sl, Vl, eta, E_d, exclusion=False)
    tree = reference_bethe_surface(H, Sl, Vl, eta, E_d)
    got = torch.as_tensor(got, device=device)
    rel = lambda x: float((x - ref).abs().max() / ref.abs().max())
    return rel(got), rel(tree)


def _leg_closure_lattice(path, device, tmp):
    """BetheAtomGF(closure='lattice') on the card: the Au atom's surface
    stack at 3 energies in the s band (eta 1e-3, the reference's
    surfGAt setting)."""
    from gaunegf_tpu_torch.models.bethe import BetheAtomGF
    H, Sl, Vl, eps = _au_atom(device)
    atom = BetheAtomGF(H, Sl, Vl, eta=1e-3, T=0.0, closure="lattice",
                       device=device)
    E = np.linspace(eps - 1.0, eps + 1.0, 3)
    with path:
        got, dt = _timed(device, lambda: np.stack([atom.sigma(e)
                                                    for e in E]))
    err, control = _lattice_sigma_check(got, H, Sl, Vl, 1e-3, E, device)
    return {"nearest": "9 (sigma)", "seconds": dt,
            "dos": [atom.DOS(e) for e in E],
            "checks": [("rel_err_sigma", err, BETHE_SIGMA_BOUND),
                       ("control_missed", int(control <= BETHE_SIGMA_BOUND),
                        0)],
            "control_rel_err": control}


def _leg_grid_trap(path, device, tmp, n, N1, N2, n_trap=100):
    """density_grid_trap over the quick start's 0.1 V window (the
    reference's default 100-point grid) against complex128 G Gamma G+ on
    its own midpoints."""
    from gaunegf_tpu_torch import density as dens
    from gaunegf_tpu_torch import quadrature as quad
    d = _junction(device, tmp, n, N1=N1, N2=N2)
    d.setVoltage(0.1, fermi=0.0)
    with path:
        P, dt = _timed(device, lambda: dens.density_grid_trap(
            d.F_eV, d.S, d.g, d.mu1, d.mu2, ind=-1, N=n_trap, T=d.T,
            device=device))
    lo, hi, sgn, Emin, Emax = dens._bias_window(d.mu1, d.mu2, d.T)
    grid = np.linspace(Emin, Emax, n_trap)
    E = 0.5 * (grid[1:] + grid[:-1])
    w = (quad.fermi_dirac(E, hi, d.T) - quad.fermi_dirac(E, lo, d.T)) \
        * np.diff(grid) * sgn / (2 * np.pi)
    return {"nearest": "13a", "seconds": dt, "points": len(E),
            "route": _route(d, device),
            "checks": [("rel_err_P", rel_err(
                np.asarray(P), reference_gless(d, E, w, device)),
                SP_BLOCK_P_BOUND)]}


def reference_gless(negfe, E, w, device, chunk=32):
    """sum_k w_k G Gamma_2 G+ on negfe's matrices at the energies E in
    complex128 by torch.linalg.solve on the last contact's columns, with
    its Gamma on the contacts' support as the spectral route takes it
    (reference_density_neq's block; a test reference, not the path)."""
    F = torch.as_tensor(negfe.F_eV, dtype=torch.complex128, device=device)
    S = torch.as_tensor(negfe.S, dtype=torch.complex128, device=device)
    sig1, sig2 = (torch.as_tensor(s, dtype=torch.complex128, device=device)
                  for s in negfe.g.params()["sigs"])
    c = list(negfe.g.contact_inds())
    gam2 = (1j * (sig2 - sig2.conj().T))[c][:, c]
    N = F.shape[0]
    cols = torch.eye(N, dtype=torch.complex128, device=device)[:, c]
    P = torch.zeros((N, N), dtype=torch.complex128, device=device)
    for i in range(0, len(E), chunk):
        Eb = torch.as_tensor(np.asarray(E[i:i + chunk], complex),
                             device=device)
        wb = torch.as_tensor(np.asarray(w[i:i + chunk], complex),
                             device=device)
        Y = torch.linalg.solve(Eb[:, None, None] * S - F - sig1 - sig2,
                               cols.expand(len(Eb), N, len(c)).contiguous())
        P += (wb[:, None, None] * (Y @ gam2 @ Y.conj().transpose(1, 2))
              ).sum(0)
    return P.cpu().numpy()


def _leg_compat(path, device, tmp, n, N1, N2, n_T=40, n_dev=120):
    """Through compat/: cohTransSpinE on a 'u' chain (T_uu, T_dd against
    complex128 solves of each spin block), surfGAt's warm-started lattice
    closure, surfG3 on 9d's planes, and the facade's NEGFE with 'ro' on
    the stand-in Gaussian (first density against the complex128 rebuild
    per spin block).  Not 'g': GaussianFock.overlap gives the N x N
    overlap for the 2N x 2N spinor Fock matrix, so NEGF's constructor
    fails in both packages."""
    from gaunegf_tpu_torch import compat
    from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
    from gaunegf_tpu_torch.models.fock import TightBindingFock
    from gaunegf_tpu_torch.units import HAR_TO_EV
    out = {"nearest": "8d (spin), 9 (sigma), 10c (facade)", "checks": []}
    checks = out["checks"]
    fake = stand_in_gaussian(_load_fake_gauopen())
    try:
        compat.install(device=device)
        from gauNEGF.scfE import NEGFE
        from gauNEGF.surfG3D import surfG3, surfGAt
        from gauNEGF.transport import cohTransSpinE
        # cohTransSpinE on a 'u' chain of 2n orbitals, 6a's mixed LU
        d = _junction(device, tmp, n, spin="u", exchange=0.2, N1=N1, N2=N2)
        E = np.linspace(-3, 3, n_T)
        with path:
            (T, Tspin), dt = _timed(device, lambda: cohTransSpinE(
                E, d.F_eV, d.S, d.g, spin="u"))
        out["cohTransSpinE"] = {"seconds": dt, "points": n_T,
                                "strip_launches": path.launches[0]}
        ends = [np.arange(2), np.arange(n - 2, n)]
        for ch, b in ((0, slice(0, n)), (3, slice(n, 2 * n))):
            F_b, S_b = d.F_eV[b, b], d.S[b, b]
            T_ref, _ = reference_transport(F_b, S_b, ConstantSelfEnergy(
                F_b, S_b, ends, sig1=-0.1j), E, device)
            checks.append((f"cohTransSpinE_T{ch}", float(np.abs(
                np.asarray(Tspin)[:, ch] - T_ref).max()), T_MIXED_BOUND))
        checks.append(("cohTransSpinE_spin_flip", float(np.abs(
            np.asarray(Tspin)[:, 1:3]).max()), SPIN_FLIP_BOUND))
        # surfGAt: the lattice closure, each energy seeded by the last
        H, Sl, Vl, eps = _au_atom(device)
        E = np.linspace(eps - 1.0, eps + 1.0, 3)
        with path:
            at = surfGAt(H, Sl, Vl, 1e-3)
            got = np.stack([at.sigma(e) for e in E])
        err, control = _lattice_sigma_check(got, H, Sl, Vl, 1e-3, E, device)
        checks += [("surfGAt_rel_err_sigma", err, BETHE_SIGMA_BOUND),
                   ("surfGAt_control_missed",
                    int(control <= BETHE_SIGMA_BOUND), 0)]
        # surfG3 on 9d's planes (gamma point)
        geom, contacts = _plane_junction(n_dev)
        F, _, eps3 = _plane_fock(n_dev)
        bar = TightBindingFock(F, coords=geom.coords,
                               locs=geom.orbital_atoms)
        with path:
            g3 = surfG3(F, np.eye(F.shape[0]), contacts, bar, "demo",
                        eta=1e-5, T=0.0, fermi=0.0, verbose=False)
        s3 = _sigma_check(g3, np.linspace(eps3 - 1.0, eps3 + 1.0, 3), device)
        out["surfG3"] = s3
        checks += [("surfG3_rel_err_sigma", s3["rel_err_sigma"],
                    BETHE_SIGMA_BOUND),
                   ("surfG3_failed", int(_sigma_failed(s3)), 0)]
        # the facade's NEGFE with 'ro' on the stand-in Gaussian
        H1 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
        fake.configure(H1 / HAR_TO_EV, np.eye(n), ne=n, U=0.1 / HAR_TO_EV)
        f = NEGFE(f"{tmp}/ro{n}", spin="ro", verbose=False)
        f.setSigma([1, 2], [n - 1, n], sig=-0.1j)
        f.setIntegralLimits(N1=N1, N2=N2)
        f.setVoltage(0.1, fermi=0.0)
        with path:
            _, out["negfe_ro_s"] = _timed(device, f.FockToP)
        out["negfe_ro_route"] = _route(f, device)
        checks.append(("negfe_ro_rel_err_first_P", max(
            rel_err(f.P[b, b], reference_density_neq(f, device, b,
                                                       block=True))
            for b in (slice(0, n), slice(n, 2 * n))), SP_BLOCK_P_BOUND))
    finally:
        fake.uninstall()
        for k in [k for k in sys.modules if k.split(".")[0] == "gauNEGF"]:
            del sys.modules[k]
    return out


def _leg_sigma_memory(path, device, tmp, n_chain, N1, N2):
    """The peak device bytes of 9b's warm cycle (Au.bethe, the warm LU on
    full inverses) at the automatic chunk, against (b, N, N) complex128
    sigma stacks of that chunk; the first density at 9b's bound."""
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    d, _ = _bethe_negfe(device, tmp, "Au", n_chain, N1, N2)
    d.setVoltage(0.1, fermi=0.0)
    N = d.F_eV.shape[0]
    chunk = EnergyEngine(d.F_eV, d.S, d.g, d.exec_cfg,
                         device=device).exec_cfg.energy_chunk
    peak = float("nan")
    if device.type == "cuda":
        _sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    with path:
        _, dt = _timed(device, d.FockToP)
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) - base
    stack = chunk * N * N * 16
    return {"nearest": "9b", "N": N, "chunk": chunk, "seconds": dt,
            "peak_bytes": peak, "stack_bytes": stack,
            "peak_in_stacks": peak / stack,
            "checks": [("rel_err_first_P", rel_err(
                d.P, reference_bethe_density(d, device)), BETHE_P_BOUND)]}


NEVER_RUN_LEGS = ("finite_T", "band_edge", "ro", "bethe_spin",
                  "bethe_fermi", "kspace", "closure_lattice", "grid_trap",
                  "compat", "sigma_memory")


def phase_never_run(kernels, device, n=1000, n_spin=500, n_chain=946,
                    n_chain_spin=446, n_dev=928, N1=128, N2=64, nk=8,
                    nk_gr=16, legs=NEVER_RUN_LEGS):
    """13d; returns {leg: result}, each result with its checks as (name,
    value, bound) where value <= bound passes, and the kernel launches of
    its path (its references' left out)."""
    run = {
        "finite_T": lambda t, p: _leg_finite_T(p, device, t, n, N1, N2),
        "band_edge": lambda t, p: _leg_band_edge(p, device, t, n, N1, N2),
        "ro": lambda t, p: _leg_ro(p, device, t, n_spin, N1, N2),
        "bethe_spin": lambda t, p: _leg_bethe_spin(p, device, t,
                                                   n_chain_spin, N1, N2),
        "bethe_fermi": lambda t, p: _leg_bethe_fermi(p, device, t, n_chain,
                                                     N1, N2),
        "kspace": lambda t, p: _leg_kspace(p, device, t, n_dev, N1, N2, nk,
                                           nk_gr),
        "closure_lattice": lambda t, p: _leg_closure_lattice(p, device, t),
        "grid_trap": lambda t, p: _leg_grid_trap(p, device, t, n, N1, N2),
        "compat": lambda t, p: _leg_compat(p, device, t, n_spin, N1, N2),
        "sigma_memory": lambda t, p: _leg_sigma_memory(p, device, t,
                                                       n_chain, N1, N2)}
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in legs:
            path = _PathCounts(kernels)
            t0 = time.perf_counter()
            r = run[name](tmp, path)
            r["leg_s"] = time.perf_counter() - t0
            r["launches"] = path.launches
            res[name] = r
    return res


def print_never_run(res):
    for name, r in res.items():
        print(f"phase 13d {name}: {json.dumps(r, default=str)}", flush=True)


# the 13d legs whose path runs a Bethe fixed point (kernel A, launch index
# 3) and a k-space decimation (kernel B, index 4)
NEVER_RUN_FIXED = {"bethe_spin": (3,), "bethe_fermi": (3,),
                   "kspace": (3, 4), "closure_lattice": (3,),
                   "compat": (3,), "sigma_memory": (3,)}


def check_never_run(res):
    for name, r in res.items():
        failed = [c for c in r["checks"]
                  if not (np.isfinite(c[1]) and c[1] <= c[2])]
        failed += [(f"launches[{k}]", 0, ">0")
                   for k in NEVER_RUN_FIXED.get(name, ())
                   if len(r["launches"]) > k and r["launches"][k] <= 0]
        if failed:
            raise AssertionError(f"never-run leg {name} ({r['nearest']}) "
                                 f"failed: {failed}")


def phase_iv_all(kernels, device, sizes=None):
    """Phase 13 (a-d); returns the result dict."""
    sizes = sizes or {}
    res = {}
    t0 = time.perf_counter()
    res["a"] = phase_iv(kernels, device, **sizes.get("a", {}))
    print_iv(res["a"])
    check_iv(res["a"])
    res["b"] = phase_chain_warm(kernels, device, **sizes.get("b", {}))
    print(f"phase 13b chain warm: {json.dumps(res['b'])}", flush=True)
    check_chain_warm(res["b"])
    res["c"] = phase_examples(device, **sizes.get("c", {}))
    print(f"phase 13c examples: {json.dumps(res['c'], default=float)}",
          flush=True)
    check_examples(res["c"])
    res["d"] = phase_never_run(kernels, device, **sizes.get("d", {}))
    print_never_run(res["d"])
    check_never_run(res["d"])
    res["seconds"] = time.perf_counter() - t0
    print(f"phase 13: {res['seconds']:.2f} s", flush=True)
    return res


def iv_launches(res, k):
    """Launches of kernel k (0 strip, 1 fused panel, 2 swap-pivoted
    panel) on phase 13's paths: 13a's sweep and LU leg, 13b's two legs,
    13d's legs."""
    a = res["a"]
    return {"13a": sum(p["launches"][k] for p in a["points"])
            + a["lu"]["launches"][k],
            "13b": res["b"]["force"]["launches"][k]
            + res["b"]["cold"]["launches"][k],
            "13d": sum(r["launches"][k] for r in res["d"].values())}


def check_plain_on_cuda(spy):
    """The package never ran a plain fixed point on a CUDA tensor while
    the spy was installed."""
    if spy.plain_on_cuda:
        raise AssertionError(f"a plain fixed point ran on CUDA tensors "
                             f"{spy.plain_on_cuda} times on the main paths")


def bethe_fixed_launches(beth, name):
    """Launches of the fixed-point kernel ``name`` on phase 9's paths."""
    n = sum(beth[lat][k]["launches"][name] for lat in ("a", "b")
            for k in ("eq", "bias"))
    n += beth["b"]["high"]["launches"][name]
    n += sum(r["launches"][name] for c in beth["c"].values()
             for r in c.values() if isinstance(r, dict) and "launches" in r)
    n += sum(d["launches"][name] for d in beth["d"].values()
             if isinstance(d, dict))
    return n


# ---------------------------------------------------------------------------
# Phase 14: the fixed-point kernels against their plain versions
# ---------------------------------------------------------------------------

# Kernel vs plain.  Where the two stop a lane at the same sweep, its result
# agrees to max(FP_HELD_REL, FP_SPREAD * s) of the lane's largest entry:
# Gauss-Jordan (kernel) against getrf/getri (plain) pivots differ only in
# rounding, which the iteration carries to its result amplified by the
# conditioning of the blocks it inverts on the way.  s is that lane's
# difference between the plain version on the card and on the host
# (cuSOLVER against LAPACK, two other rounding orders), computed only for
# lanes beyond FP_HELD_REL: a decimation inside the band at eta = 1e-4
# passes through nearly singular eps blocks (the host mirror of the
# kernel's own Gauss-Jordan in tests/test_torch_fixed_point.py differs
# from LAPACK by up to 7e-10 there at n = 9).  A lane may stop one sweep
# apart only where the earlier stopper's last metric lies within
# max(1e-6 conv, FP_METRIC_FLOOR) of conv: the Bethe and decimation
# metrics of two inversion orders differ by a few ulp of max|sigma|.  The
# Dyson map's metric is element-wise relative and, in the band, made from
# inverses of blocks with cond ~1e4-1e5: at conv 1e-11 it sits at its own
# rounding floor and wanders around conv for several sweeps (one lane of
# the n = 40 case stopped at 1648 sweeps in the kernel and 1642 in plain,
# last metrics 9.79e-12 / 9.997e-12; PERF.md §6).  So a Dyson lane may
# stop any number of sweeps apart where both runs met conv.  A lane that
# stopped apart agrees to 10 conv.
FP_HELD_REL = 1e-10
FP_SPREAD = 10.0
FP_METRIC_FLOOR = 1e-13
FP_BATCH = 64                     # the synthetic cases' lanes
FP_PACKED = 400                   # kernel A: three lanes a CTA, one ragged
SANCHO_NS = (1, 9, 27, 40)        # 40: beyond shared memory
# the Si nanowire's lead cell (the cluster layout, padded to 152, ten
# panels) at the lane counts its spectral chunks send: 64 and a ragged 22
SANCHO_WIDE = ((150, 64), (150, 22))
DIM9 = 9


def fixed_point_ops(counts, bulk, exclusion, surface):
    """FP64 operations of kernel A for these per-lane sweep counts (b, 2):
    a 9x9 complex inverse or product is 8 * 9^3; a bulk sweep with
    exclusion inverts 12 blocks, without one, and multiplies 24; a
    surface sweep inverts one and multiplies 12; plus ~12 operations an
    entry of each updated slot and 5 an entry of each summed slot."""
    c = counts.to(torch.float64).sum(0).tolist()
    blk = 8 * DIM9 ** 3
    ops = 0.0
    if bulk is not None:
        inv = 12 if exclusion else 1
        ops += c[0] * (blk * (inv + 24) + 81 * (12 * 12 + 12 * 5))
    if surface:
        ops += c[1] * (blk * 13 + 81 * (6 * 12 + 9 * 5))
    return ops


def decimate_ops(counts, n, mode):
    """FP64 operations of kernel B for these per-lane iteration counts:
    an n x n complex inverse or product is 8 n^3; a decimation step
    inverts once and multiplies six times (al g, be g, and four products
    with them), the Dyson map inverts once and multiplies twice; one more
    inverse a lane (the last, or the first)."""
    it = float(counts.to(torch.float64).sum())
    blk = 8 * n ** 3
    per = blk * 7 + 20 * n * n if mode == "sancho" else blk * 3 + 15 * n * n
    return it * per + counts.numel() * blk


def _fp_run(name, kw, plain=False):
    from gaunegf_tpu_torch.ops.kernels import fixed_point as fp
    from gaunegf_tpu_torch.ops.kernels import sancho_rubio as sr
    if name == "fixed_point":
        fn = fp.fixed_point_plain if plain else fp.fixed_point
        kb, ks_, c, m = fn(**kw)
        vals = [x for x in (kb, ks_) if x is not None]
        return vals, c, m
    fn = sr.decimate_plain if plain else sr.decimate
    g, c, m = fn(**kw)
    return [g], c[:, None], m[:, None]


def _on(kw, device, lanes=None):
    """kw with its tensors on device (the lanes given only)."""
    out = {}
    for k, v in kw.items():
        if isinstance(v, torch.Tensor):
            v = v if lanes is None else v[lanes]
            v = v.to(device)
        out[k] = v
    return out


def held_fixed(name, kw, vk, ck, mk, vp, cp, mp):
    """The rule above, lane by lane; returns (max rel err, lanes that
    stopped apart, lanes on the spread bound).  Raises on a lane that
    breaks it."""
    conv = kw["conv"]
    window = max(1e-6 * conv, FP_METRIC_FLOOR)
    dyson = kw.get("mode") == "dyson"
    b = ck.shape[0]
    rel = torch.zeros(b, dtype=torch.float64, device=ck.device)
    for k, p in zip(vk, vp):
        dims = tuple(range(1, k.dim()))
        rel = torch.maximum(rel, (k - p).abs().amax(dim=dims)
                            / p.abs().amax(dim=dims).clamp(min=1e-300))
    rel = rel.cpu().numpy()
    ck, cp = ck.cpu().numpy(), cp.cpu().numpy()
    mk, mp = mk.cpu().numpy(), mp.cpu().numpy()
    same = (ck == cp).all(axis=1)
    wide = np.nonzero(same & ~(rel <= FP_HELD_REL))[0]
    spread_lanes = 0
    if len(wide):
        lanes = torch.as_tensor(wide)
        vh, ch, _ = _fp_run(name, _on(kw, "cpu", lanes), plain=True)
        vp_w = [p[lanes.to(p.device)].cpu() for p in vp]
        s = np.zeros(len(wide))
        for h, p in zip(vh, vp_w):
            dims = tuple(range(1, h.dim()))
            s = np.maximum(s, ((h - p).abs().amax(dim=dims)
                               / p.abs().amax(dim=dims).clamp(min=1e-300)
                               ).numpy())
        s[~(ch.numpy() == cp[wide]).all(axis=1)] = 0.0
        for i, lane in enumerate(wide):
            if not rel[lane] <= max(FP_HELD_REL, FP_SPREAD * s[i]):
                raise AssertionError(
                    f"{name}: lane {lane} kernel vs plain {rel[lane]:.3e}, "
                    f"host vs card plain {s[i]:.3e} (counts {ck[lane]})")
        spread_lanes = len(wide)
    apart = np.nonzero(~same)[0]
    for lane in apart:
        for j in np.nonzero(ck[lane] != cp[lane])[0]:
            early = mk[lane, j] if ck[lane, j] < cp[lane, j] \
                else mp[lane, j]
            if dyson:
                stray = not (mk[lane, j] <= conv and mp[lane, j] <= conv)
            else:
                stray = abs(int(ck[lane, j]) - int(cp[lane, j])) != 1 \
                    or not abs(early - conv) <= window
            if stray:
                raise AssertionError(
                    f"{name}: lane {lane} stopped at {ck[lane]} (kernel) "
                    f"and {cp[lane]} (plain), last metrics {mk[lane]} / "
                    f"{mp[lane]}, conv {conv:g}")
        if not rel[lane] <= 10 * conv:
            raise AssertionError(f"{name}: lane {lane} stopped apart and "
                                 f"differs by {rel[lane]:.3e} > 10 conv")
    return float(rel.max(initial=0.0)), len(apart), spread_lanes


def _fp_mode(name, kw):
    if name == "fixed_point":
        return (f"bulk={kw['bulk']} exclusion={kw['exclusion']} "
                f"surface={kw['surface']} conv={kw['conv']:g}")
    return f"{kw['mode']} conv={kw['conv']:g}"


def fixed_case(name, kw, device, calls=None, timed=False, label=None):
    """Kernel vs plain on one case's inputs kw (the wrapper's arguments);
    returns its row (timed: ms, device ms, plain ms, bound)."""
    kw = _on(kw, device)
    vk, ck, mk = _fp_run(name, kw)
    vp, cp, mp = _fp_run(name, kw, plain=True)
    for v in vk:
        if not torch.isfinite(v).all():
            raise AssertionError(f"{name} {_fp_mode(name, kw)}: non-finite "
                                 "kernel values")
    rel, apart, spread = held_fixed(name, kw, vk, ck, mk, vp, cp, mp)
    err = max(float((k - p).abs().max()) for k, p in zip(vk, vp))
    b = kw["A"].shape[0]
    if name == "fixed_point":
        ops = fixed_point_ops(ck, kw["bulk"], kw["exclusion"], kw["surface"])
        nbytes = b * 16 * (81 + 972 + 2 * kw["sig"][0].numel()
                           + (81 * 9 if kw["surface"] else 0)) + b * 24
        shape = list(kw["B"].shape)
    else:
        n = kw["A"].shape[-1]
        ops = decimate_ops(ck, n, kw["mode"])
        nbytes = b * (3 * 16 * n * n + 12)
        shape = list(kw["A"].shape)
    bound_ms, bound_by = bound(ops, nbytes)
    row = {"case": label or "path", "shape": shape, "dtype": "complex128",
           "launch": _fp_mode(name, kw), "calls": calls,
           **fixed_launch(name, kw, device),
           "lanes": b, "sweeps_mean": float(ck.to(torch.float64).sum(1)
                                            .mean()),
           "sweeps_max": int(ck.max()), "rel_err": rel,
           "max_abs_err": err, "lanes_count_apart": apart,
           "lanes_spread": spread, "ops": ops, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None,
           "ms": float("nan"), "kernel_ms": float("nan"),
           "plain_ms": float("nan")}
    if timed and device.type == "cuda":
        # every variant's kernel name starts so: fixed_point_kernel,
        # sancho_scalar_kernel, sancho_column_kernel<9>, dyson_kernel, ...
        kname = "fixed_point_kernel" if name == "fixed_point" \
            else kw["mode"] + "_"
        row["ms"] = cuda_ms(lambda: _fp_run(name, kw), 20)
        row["kernel_ms"] = device_ms(lambda: _fp_run(name, kw), kname, 10)
        row["plain_ms"] = cuda_ms(lambda: _fp_run(name, kw, plain=True), 2)
        row["share"] = row["bound_ms"] / row["ms"]
    return row


def fixed_launch(name, kw, device):
    """The launch that the kernel picks for these inputs (variant, lanes
    per CTA, CTAs, threads, dynamic shared memory per CTA); off the card
    for the H100's 132 SMs."""
    from gaunegf_tpu_torch.ops.kernels import fixed_point as fp
    from gaunegf_tpu_torch.ops.kernels import sancho_rubio as sr
    b = kw["A"].shape[0]
    if name == "fixed_point":
        sms = torch.cuda.get_device_properties(device).multi_processor_count \
            if device.type == "cuda" else 132
        return fp.launch_shape(b, sms)
    cap = sr.card_clusters() if device.type == "cuda" else None
    return sr.launch_shape(kw["A"].shape[-1], b, kw["mode"], cap)


def check_launch_rules(device):
    """The wrappers' launch rules equal the C entry points' own: kernel B's
    variant for n = 1..48 and its cluster width for several (n, b, mode),
    kernel A's lanes per CTA for several batches."""
    from gaunegf_tpu_torch.ops.kernels import fixed_point as fp
    from gaunegf_tpu_torch.ops.kernels import sancho_rubio as sr
    lib_b, lib_a = sr.build(), fp.build()
    for n in range(1, 49):
        got = sr.VARIANTS[lib_b.gaunegf_sancho_rubio_variant(n)]
        if got != sr.variant(n):
            raise AssertionError(f"kernel B at n={n}: C picks {got}, the "
                                 f"wrapper says {sr.variant(n)}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cap = sr.card_clusters()
    for n, b in ((32, 37), (33, 37), (150, 1), (150, 22), (150, 64),
                 (150, 128), (257, 8)):
        for mode, name in enumerate(("sancho", "dyson")):
            got = lib_b.gaunegf_sancho_rubio_cluster_width(n, b, mode)
            if got != sr.cluster_width(n, b, name, cap):
                raise AssertionError(f"kernel B at n={n}, b={b}, {name}: C "
                                     f"takes {got} CTAs a lane, the wrapper "
                                     f"{sr.cluster_width(n, b, name, cap)}")
    for b in (1, 3, 64, 96, 129, 133, 400, 4096):
        got = lib_a.gaunegf_fixed_point_lanes_per_cta(b)
        if got != fp.lanes_per_cta(b, sms):
            raise AssertionError(f"kernel A at b={b}: C packs {got} lanes "
                                 f"a CTA, the wrapper {fp.lanes_per_cta(b, sms)}")


def _au_operators(b, seed, device, eta=1e-5):
    """Kernel A's A (b, 9, 9), B (b, 12, 9, 9) for the Au lattice at b
    energies across its bands (models/bethe._operators's construction)."""
    from gaunegf_tpu_torch.models import harrison
    from gaunegf_tpu_torch.models import slater_koster as sk
    p = harrison.bethe_params("Au")
    n_vecs = sk.fcc111_neighbor_directions(np.array([0, 0, 1.0]),
                                           np.array([1.0, 0, 0]))
    Sl = np.stack([sk.bond_matrix(p.overlap, d) for d in n_vecs])
    Vl = np.stack([sk.bond_matrix(p.hopping, d) for d in n_vecs])
    rng = np.random.default_rng(seed)
    z = rng.uniform(-10.0, 4.0, b) + 1j * rng.uniform(0.0, 0.05, b) \
        - 1j * eta
    A = z[:, None, None] * np.eye(9) - p.h0()
    B = z[:, None, None, None] * Sl - Vl
    return (torch.as_tensor(A, device=device),
            torch.as_tensor(B, device=device))


def _chain_case(n, b, seed, device):
    """Kernel B's A, B (b, n, n): a random n-orbital lead cell at b
    energies across its band, eta 1e-4."""
    rng = np.random.default_rng(seed)
    alpha = rng.standard_normal((n, n)) * 0.3
    alpha = alpha + alpha.T
    beta = -np.eye(n) + 0.1 * rng.standard_normal((n, n))
    E = np.linspace(-2.6, 2.4, b) + 1j * 1e-4
    A = E[:, None, None] * np.eye(n) - alpha
    B = np.broadcast_to(-beta, A.shape).copy()
    return (torch.as_tensor(A, device=device),
            torch.as_tensor(B, device=device))


FP_MODES = (("jacobi", True, False), ("seidel", True, False),
            ("jacobi", False, False), ("seidel", False, False),
            ("jacobi", True, True), ("jacobi", False, True),
            (None, True, True))


def phase_fixed_points(device, spy, b=FP_BATCH, packed=FP_PACKED,
                       wide=SANCHO_WIDE):
    """Phase 14: kernel A in every mode and kernel B in both modes at
    n in SANCHO_NS, and in the Sancho mode at the (n, lanes) of wide,
    against their plain versions on synthetic cases, at conv 1e-5 and
    1e-11; then each kernel timed on the main path's case that took the
    most lane-calls (kernel B: its k-space lanes, n = 9, and a chain's,
    n = 1) and kernel B on wide's first case and on twice its lanes, with
    the plain version's time and the bound from the sweeps this run's
    data needed."""
    from gaunegf_tpu_torch.config import TIGHT_CONV
    t0 = time.perf_counter()
    res = {"fixed_point": [], "sancho_rubio": []}
    rng = np.random.default_rng(14)
    for conv in (1e-5, TIGHT_CONV):
        A, B = _au_operators(b, 140, device)
        for bulk, exclusion, surface in FP_MODES:
            if bulk is None:          # the k-space mode: A shifted, warm seed
                A_s = A - 0.3j * torch.eye(9, dtype=A.dtype, device=device)
                seed = torch.as_tensor(0.05 * (
                    rng.standard_normal((b, 9, 9, 9))
                    + 1j * rng.standard_normal((b, 9, 9, 9))), device=device)
            else:
                A_s = A
                seed = (-1j * torch.eye(9, dtype=A.dtype, device=device)
                        ).expand(b, 12, 9, 9)
            kw = dict(A=A_s, B=B, sig=seed, conv=conv, mix=0.5,
                      max_iter=1000, bulk=bulk, exclusion=exclusion,
                      surface=surface)
            res["fixed_point"].append(fixed_case("fixed_point", kw, device,
                                                 label="synthetic"))
        A, B = _au_operators(packed, 141, device)         # 3 lanes a CTA
        kw = dict(A=A, B=B, sig=(-1j * torch.eye(
            9, dtype=A.dtype, device=device)).expand(packed, 12, 9, 9),
            conv=conv, mix=0.5, max_iter=1000, bulk="seidel",
            exclusion=True, surface=True)
        res["fixed_point"].append(fixed_case("fixed_point", kw, device,
                                             label=f"b={packed}"))
        for n in SANCHO_NS:
            A, B = _chain_case(n, b, 140 + n, device)
            for mode, max_iter in (("sancho", 64), ("dyson", 2000)):
                kw = dict(A=A, B=B, conv=conv, max_iter=max_iter, mode=mode,
                          relax=0.1)
                res["sancho_rubio"].append(fixed_case("decimate", kw, device,
                                                      label=f"n={n}"))
        for n, lanes in wide:
            A, B = _chain_case(n, lanes, 140 + n + lanes, device)
            kw = dict(A=A, B=B, conv=conv, max_iter=64, mode="sancho",
                      relax=0.1)
            res["sancho_rubio"].append(fixed_case(
                "decimate", kw, device, label=f"n={n} b={lanes}"))
    def most_called(name, keep=lambda kw: True):
        """The case that took the most lane-calls (calls x lanes)."""
        best = None
        for calls, kw in spy.cases[name].values():
            work = calls * kw["A"].shape[0]
            if keep(kw) and (best is None or work > best[0]):
                best = (work, calls, kw)
        return None if best is None else fixed_case(
            name, best[2], device, calls=best[1], timed=True, label="path")

    def bulk_surface(b):
        return lambda kw: kw["bulk"] is not None and kw["surface"] \
            and kw["A"].shape[0] == b

    if device.type == "cuda":
        check_launch_rules(device)
    res["timed"] = {
        "fixed_point": most_called("fixed_point"),
        "fixed_point_64": most_called("fixed_point", bulk_surface(64)),
        "fixed_point_96": most_called("fixed_point", bulk_surface(96)),
        "fixed_point_kspace": most_called(
            "fixed_point", lambda kw: kw["bulk"] is None),
        "sancho_rubio_k": most_called(
            "decimate", lambda kw: kw["A"].shape[-1] == 9),
        "sancho_rubio_chain": most_called(
            "decimate", lambda kw: kw["A"].shape[-1] == 1)}
    if wide:
        n, lanes = wide[0]
        for k in (lanes, 2 * lanes):
            A, B = _chain_case(n, k, 140 + n + k, device)
            kw = dict(A=A, B=B, conv=TIGHT_CONV, max_iter=64, mode="sancho",
                      relax=0.1)
            res["timed"][f"sancho_rubio_n{n}x{k}"] = fixed_case(
                "decimate", kw, device, timed=True, label=f"n={n} b={k}")
    res["seconds"] = time.perf_counter() - t0
    return res


def print_fixed_points(res):
    for name in ("fixed_point", "sancho_rubio"):
        rows = res[name]
        print(f"phase 14 {name}: {len(rows)} synthetic cases, kernel vs "
              f"plain max rel err {max(r['rel_err'] for r in rows):.3e}, "
              f"lanes stopped apart "
              f"{sum(r['lanes_count_apart'] for r in rows)}, lanes on the "
              f"spread bound {sum(r['lanes_spread'] for r in rows)}: "
              + "; ".join(f"{r['case']} {r['launch']} {r['rel_err']:.2e} "
                          f"sweeps {r['sweeps_mean']:.1f}" for r in rows),
              flush=True)
    for name in ("fixed_point", "sancho_rubio"):
        shapes = sorted({(r["variant"], r["lanes_per_cta"], r["threads"],
                          r["shared_bytes"], tuple(r["shape"]))
                         for r in res[name]}, key=str)
        print(f"phase 14 {name} launches (variant, lanes a CTA, threads, "
              f"shared bytes, shape): {shapes}", flush=True)
    for key, r in res["timed"].items():
        if r is not None:
            print(f"phase 14 case {key}: {r['variant']}, "
                  f"{r['lanes_per_cta']} lanes a CTA, ms {r['ms']:.4f} "
                  f"[device {r['kernel_ms']}], plain {r['plain_ms']:.3f}, "
                  f"bound {r['bound_ms']:.5f} ({r['bound_by']}), share "
                  f"{r.get('share', float('nan')):.2%}", flush=True)
        print(f"phase 14 timed {key}: " + json.dumps(r), flush=True)
    print(f"phase 14: {res['seconds']:.2f} s", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (build and kernel checks)")
    ap.add_argument("--only-fermi", action="store_true",
                    help="after the build, run phase 8 alone (prints no "
                         "kernel table and no result line)")
    ap.add_argument("--only-bethe", action="store_true",
                    help="after the build, run phase 9 and phase 14 alone "
                         "(prints no kernel table and no result line)")
    ap.add_argument("--only-compat", action="store_true",
                    help="after the build, run phase 10 alone (prints no "
                         "kernel table and no result line)")
    ap.add_argument("--only-multi", action="store_true",
                    help="after the build, run phase 11 alone (prints no "
                         "kernel table and no result line)")
    ap.add_argument("--only-chain", action="store_true",
                    help="after the build, run phase 12 alone (prints no "
                         "kernel table and no result line)")
    ap.add_argument("--only-iv", action="store_true",
                    help="after the build, run phase 13 alone (prints no "
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
    from gaunegf_tpu_torch.ops.kernels import fixed_point as fp
    from gaunegf_tpu_torch.ops.kernels import sancho_rubio as sr
    t0 = time.perf_counter()
    _build.build_libraries()
    for mod in (se, pf, pl, fp, sr):
        mod.build()
    print(f"phase 2 build: {len(_build.LIBRARIES)} libraries built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in _build.BUILD_LOGS.items():
        print(f"  ptxas {name}: {ptxas_summary(log)}", flush=True)

    if args.only_fermi:
        fermi = phase_fermi((se, pf, pl), device)
        print(f"phase 8 fermi: {json.dumps(fermi)}", flush=True)
        check_fermi(fermi)
        return 0

    if args.only_bethe:
        spy = ShapeSpy().install()
        beth = phase_bethe((se, pf, pl), device)
        spy.remove()
        print(f"phase 9 bethe: {json.dumps(beth)}", flush=True)
        check_bethe(beth)
        check_plain_on_cuda(spy)
        print_held(phase_held(spy, se, pf, pl, device))
        print_fixed_points(phase_fixed_points(device, spy))
        return 0

    if args.only_compat:
        spy = ShapeSpy().install()
        comp = phase_compat((se, pf, pl), device)
        spy.remove()
        print_compat(comp)
        check_compat(comp)
        print_held(phase_held(spy, se, pf, pl, device))
        return 0

    if args.only_multi:
        spy = ShapeSpy().install()
        multi = phase_multi((se, pf, pl), device, spy)
        spy.remove()
        print_multi(multi)
        check_multi(multi)
        print_held(phase_held(spy, se, pf, pl, device))
        return 0

    if args.only_chain:
        spy = ShapeSpy().install()
        chain = phase_chain((se, pf, pl), device)
        spy.remove()
        print_chain(chain)
        check_chain(chain)
        print_held(phase_held(spy, se, pf, pl, device))
        return 0

    if args.only_iv:
        spy = ShapeSpy().install()
        phase_iv_all((se, pf, pl, fp, sr), device)
        spy.remove()
        check_plain_on_cuda(spy)
        print_held(phase_held(spy, se, pf, pl, device))
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

    # from here to the end of phase 13 every shape that reaches a kernel
    # wrapper is recorded; phase 3b holds the kernels at those shapes
    spy = ShapeSpy().install()
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

    beth = phase_bethe((se, pf, pl), device)
    print(f"phase 9 bethe: {json.dumps(beth)}", flush=True)
    check_bethe(beth)

    comp = phase_compat((se, pf, pl), device)
    print_compat(comp)
    check_compat(comp)

    multi = phase_multi((se, pf, pl), device, spy)
    print_multi(multi)
    check_multi(multi)

    chain = phase_chain((se, pf, pl), device)
    print_chain(chain, beside=trans["d"])
    check_chain(chain)

    iv = phase_iv_all((se, pf, pl, fp, sr), device)
    spy.remove()
    check_plain_on_cuda(spy)
    held = phase_held(spy, se, pf, pl, device)
    print_held(held)
    fixed = phase_fixed_points(device, spy)
    print_fixed_points(fixed)
    # launches of the Bethe path: the orthogonal set's SCF cycles on the
    # LU's full inverses (kernel 1), the fused T(E) sweep (kernel 2), the
    # high-tier density (kernel 3)
    bethe_launches = {
        "strip_elim": sum(beth["b"][k]["launches"]["strip_elim"]
                          for k in ("eq", "bias")),
        "panel_fused": beth["c"]["Au"]["fused"]["launches"]["panel_fused"],
        "panel_lu": beth["b"]["high"]["launches"]["panel_lu"]}

    fixed_launches = {
        name: {"6b": trans["b"]["launches"][name],
               "9": bethe_fixed_launches(beth, name),
               "10": comp["a"]["launches"][name]
               + comp["b"]["T_launches"][name],
               **{k: v for k, v in iv_launches(iv, idx).items() if v}}
        for idx, name in ((3, "fixed_point"), (4, "sancho_rubio"))}
    for name, by_phase in fixed_launches.items():
        if by_phase["9"] <= 0:
            raise AssertionError(f"{name}: no launch on phase 9's path")
    fused_main = panel_rows["panel_fused"][0]          # (1024, 256)
    lu_main = next(r for r in panel_rows["panel_lu"]
                   if r["dtype"] == "complex128")      # (1024, 256)
    print(json.dumps({"kernels": [{
        "name": "strip_elim", "route": "cuda",
        "source": "gaunegf_tpu_torch/csrc/strip_elim.cu",
        "replaces": "gaunegf_tpu/ops/pallas/strip_elim.py:104",
        "launches": scf["launches"] + bethe_launches["strip_elim"]
        + comp["a"]["launches"]["strip_elim"]
        + multi_launches(multi, "strip_elim") + sum(chain_launches(chain))
        + sum(iv_launches(iv, 0).values()),
        "launches_by_phase": {"5": scf["launches"],
                              "9b": bethe_launches["strip_elim"],
                              "10a": comp["a"]["launches"]["strip_elim"],
                              "11b": multi_launches(multi, "strip_elim"),
                              **dict(zip(("12a", "12b", "12c"),
                                         chain_launches(chain))),
                              **iv_launches(iv, 0)},
        "max_abs_err": max(r["max_abs_err"]
                           for r in rows + held["eliminate_strip"]),
        "held_shapes": len(held["eliminate_strip"]),
        **timing(main_row)}, {
        "name": "panel_fused", "route": "cuda",
        "source": "gaunegf_tpu_torch/csrc/panel_fused.cu",
        "replaces": "gaunegf_tpu/ops/pallas/panel_fused.py:255",
        "launches": trans["a"]["launches"]["panel_fused"]
        + bethe_launches["panel_fused"]
        + multi_launches(multi, "panel_fused")
        + sum(iv_launches(iv, 1).values()),
        "launches_by_phase": {"6a": trans["a"]["launches"]["panel_fused"],
                              "9c": bethe_launches["panel_fused"],
                              "11b": multi_launches(multi, "panel_fused"),
                              **iv_launches(iv, 1)},
        "max_abs_err": max(r["max_abs_err"]
                           for r in panel_rows["panel_fused"]
                           + held["factor_panel_fused"]),
        "held_shapes": len(held["factor_panel_fused"]),
        **timing(fused_main)}, {
        "name": "panel_lu", "route": "cuda",
        "source": "gaunegf_tpu_torch/csrc/panel_lu.cu",
        "replaces": "gaunegf_tpu/ops/pallas/panel_lu.py:109",
        "launches": trans["b"]["launches"]["panel_lu"]
        + bethe_launches["panel_lu"]
        + comp["a"]["high"]["launches"]["panel_lu"]
        + multi_launches(multi, "panel_lu")
        + sum(iv_launches(iv, 2).values()),
        "launches_by_phase": {"6b": trans["b"]["launches"]["panel_lu"],
                              "9b": bethe_launches["panel_lu"],
                              "10a": comp["a"]["high"]["launches"][
                                  "panel_lu"],
                              "11b": multi_launches(multi, "panel_lu"),
                              **iv_launches(iv, 2)},
        "max_abs_err": max(r["max_abs_err"] for r in panel_rows["panel_lu"]
                           + held["factor_panel_lu"]),
        "held_shapes": len(held["factor_panel_lu"]),
        **timing(lu_main)}, {
        "name": "fixed_point", "route": "cuda",
        "source": "gaunegf_tpu_torch/csrc/fixed_point.cu",
        "replaces": "gaunegf_tpu/models/bethe.py:135",
        "launches": sum(fixed_launches["fixed_point"].values()),
        "launches_by_phase": fixed_launches["fixed_point"],
        "max_abs_err": max(r["max_abs_err"] for r in fixed["fixed_point"]
                           + held["fixed_point"]),
        "held_cases": len(held["fixed_point"]),
        **timing(fixed["timed"]["fixed_point"])}, {
        "name": "sancho_rubio", "route": "cuda",
        "source": "gaunegf_tpu_torch/csrc/sancho_rubio.cu",
        "replaces": "gaunegf_tpu/models/chain1d.py:108",
        "launches": sum(fixed_launches["sancho_rubio"].values()),
        "launches_by_phase": fixed_launches["sancho_rubio"],
        "max_abs_err": max(r["max_abs_err"] for r in fixed["sancho_rubio"]
                           + held["decimate"]),
        "held_cases": len(held["decimate"]),
        **timing(fixed["timed"]["sancho_rubio_k"]),
        "timed_wide": {k.split("_n")[1]: {**timing(r), "lanes": r["lanes"],
                                           "variant": r["variant"],
                                           "cluster": r.get("cluster")}
                       for k, r in fixed["timed"].items()
                       if k.startswith("sancho_rubio_n")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    from gaunegf_tpu_torch.utils.logging import recorder
    with recorder.recording():
        status = main()
    sys.exit(status)
