"""Drive the port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Imports gaunegf_tpu_torch (never JAX).  Phases, one result line each; any
failure raises and exits non-zero:

1. device   -- a CUDA device must be visible (exit 1 otherwise);
2. build    -- nvcc builds the strip-elimination kernel for sm_90a;
3. kernel   -- the kernel against its plain PyTorch version on the card, at
               the strip shapes of the N=1000 LU (batch 64, m = 1024, 896,
               ..., 128: the panel heights at bs=128, which include those
               of the automatic bs=256) plus a tie case and a zero-column case:
               identical pivots and avail, values within the bound below;
4. gr_sum   -- EnergyEngine.gr_sum at the bench shape (N=1000 junction,
               8+8 constant contacts, 512 real-axis points), mixed tier on
               the blocked LU, against a complex128 torch.linalg.solve sum;
5. scf      -- a biased NEGFE SCF on a 1000-site chain (the README quick
               start at full width): first density against a complex128
               build on the same grids, then 3 more cycles.

The second-to-last line is the kernel table (JSON), the last line
{"ok": true, "device": {...}}.
"""

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


def strip_cases(device, batch=BATCH, heights=PANEL_HEIGHTS, seed=0):
    """(label, strip (B, 32, m) complex64, avail (B, m) bool) cases."""
    rng = np.random.default_rng(seed)
    cases = []
    for m in heights:
        sb = (rng.standard_normal((batch, 32, m))
              + 1j * rng.standard_normal((batch, 32, m))).astype(np.complex64)
        av = rng.random((batch, m)) < 0.9
        av[:, :32] = True                   # at least 32 available lanes
        cases.append((f"m={m}", sb, av))
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
    return [(lbl, torch.as_tensor(sb, device=device),
             torch.as_tensor(av, device=device)) for lbl, sb, av in cases]


def phase_kernel(se, device, timed=True):
    """Kernel against plain on every case; returns (max rel err, rows)."""
    worst = 0.0
    rows = []
    for label, sb, av in strip_cases(device):
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
        ms = plain_ms = float("nan")
        if timed:
            ms = cuda_ms(lambda: se.eliminate_strip(sb, av), 20)
            plain_ms = cuda_ms(lambda: se.eliminate_strip_plain(sb, av), 3)
        rows.append({"case": label, "m": sb.shape[-1], "max_abs_err": err,
                     "rel_err": rel, "ms": ms, "plain_ms": plain_ms})
    return worst, rows


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


def phase_gr_sum(se, device, N=1000, n_E=512, chunk=BATCH):
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
    se.LAUNCHES = 0
    _sync(device)
    t0 = time.perf_counter()
    out = eng.gr_sum(E, w)
    _sync(device)
    dt = time.perf_counter() - t0
    launches = se.LAUNCHES
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


def reference_density_neq(negfe, device):
    """The first FockToP density rebuilt in complex128 on the same grids:
    per-point torch.linalg.solve, full G Gamma G+ (a test reference)."""
    from gaunegf_tpu_torch import quadrature as quad
    E_r, w_r = quad.real_axis_grid(negfe.Eminf, negfe.Emin, negfe.N2, 0.0)
    z_c, w_c = quad.contour_grid(negfe.Emin, negfe.mu1, negfe.N1, negfe.T)
    E_eq = np.concatenate([np.asarray(E_r, complex), np.asarray(z_c, complex)])
    w_eq = np.concatenate([-np.asarray(w_r, complex),
                           np.asarray(w_c, complex)]) / np.pi
    E_n, w_n = quad.bias_window_grid(negfe.mu1, negfe.mu2, negfe.Nnegf,
                                     negfe.T)
    F = torch.as_tensor(negfe.F_eV, dtype=torch.complex128, device=device)
    S = torch.as_tensor(negfe.S, dtype=torch.complex128, device=device)
    sig1, sig2 = (torch.as_tensor(s, dtype=torch.complex128, device=device)
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


def phase_scf(se, device, n=1000, N1=128, N2=64, chunk=BATCH, cycles=3):
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
        se.LAUNCHES = 0
        _sync(device)
        t0 = time.perf_counter()
        counts, electrons, _ = negfe.SCF(conv=1e-5, damping=0.05,
                                         max_cycles=cycles)
        _sync(device)
        dt = time.perf_counter() - t0
    P = negfe.P
    return {"n": n, "points_per_cycle": N2 + N1 + negfe.Nnegf,
            "rel_err_first_P": p_err, "cycles": len(counts),
            "s_per_cycle": dt / len(counts), "launches": se.LAUNCHES,
            "nelec": float(electrons[-1]),
            "finite": bool(np.isfinite(P).all()),
            "hermitian_err": float(np.max(np.abs(P - P.conj().T)))}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
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
    from gaunegf_tpu_torch.ops.kernels import strip_elim as se
    t0 = time.perf_counter()
    se.build()
    ptxas = " | ".join(line.strip() for line in
                       _build.BUILD_LOGS.get("strip_elim", "").splitlines()
                       if "registers" in line or "spill" in line)
    print(f"phase 2 build: strip_elim built in "
          f"{time.perf_counter() - t0:.2f} s; ptxas: {ptxas}", flush=True)

    worst, rows = phase_kernel(se, device)
    main_row = rows[0]
    print("phase 3 kernel: identical pivots/avail on "
          f"{len(rows)} cases, max rel err {worst:.3e} (bound "
          f"{KERNEL_REL_BOUND:.3e}); ms kernel/plain: " + ", ".join(
              f"{r['case']} {r['ms']:.4f}/{r['plain_ms']:.3f}" for r in rows),
          flush=True)

    gr = phase_gr_sum(se, device)
    print(f"phase 4 gr_sum: {json.dumps(gr)}", flush=True)
    if not gr["finite"] or gr["launches"] <= 0:
        raise AssertionError(f"gr_sum: finite={gr['finite']} "
                             f"launches={gr['launches']}")
    if gr["rel_err_far"] > GR_FAR_BOUND or gr["rel_err_full"] > GR_FULL_BOUND:
        raise AssertionError(
            f"gr_sum off the complex128 reference: far {gr['rel_err_far']:.3e}"
            f" (bound {GR_FAR_BOUND:g}), full {gr['rel_err_full']:.3e} "
            f"(bound {GR_FULL_BOUND:g})")

    scf = phase_scf(se, device)
    print(f"phase 5 scf: {json.dumps(scf)}", flush=True)
    if not scf["finite"] or scf["hermitian_err"] > 1e-6 \
            or scf["launches"] <= 0 or scf["cycles"] < 3:
        raise AssertionError(f"scf failed: {scf}")
    if scf["rel_err_first_P"] > SCF_P_BOUND:
        raise AssertionError(f"first SCF density off the complex128 "
                             f"reference: {scf['rel_err_first_P']:.3e} > "
                             f"{SCF_P_BOUND:g}")

    print(json.dumps({"kernels": [{
        "name": "strip_elim", "route": "cuda",
        "source": "gaunegf_tpu_torch/csrc/strip_elim.cu",
        "replaces": "gaunegf_tpu/ops/pallas/strip_elim.py:104",
        "launches": scf["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
