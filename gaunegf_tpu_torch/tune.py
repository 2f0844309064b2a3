"""Sweep the blocked LU's panel kernel, panel width and energy chunk, or
the spectral route's energy chunk, on the card.

    python -m gaunegf_tpu_torch.tune [--panel pstrip|fused|pallas ...]
                                     [--solver lu|spectral]
                                     [--contacts bethe]
                                     [--out FILE] [--profile] [--probe]

Times ``EnergyEngine.gr_sum`` (mixed tier) on the bench junction -- a
disordered chain with 8+8 constant contacts, S = I, real-axis grid on
[-2, 2] -- at N=1000 (512 points) and N=2000 (128 points).

--solver lu (the default): each complex64 panel named by --panel
(default pstrip; several names give an A/B in one process), panel width
and chunk, with the peak device bytes per energy lane and each kernel's
launches in the timed call.  These numbers set
``config.LU_BLOCK_SIZE``'s automatic width and
``ops/greens._LANE_BYTES_PER_N2``.

--solver spectral: the pencil's eigendecomposition at N = 1000, 1500,
2000, 3000 on the card (cuSOLVER and MAGMA) and on the host (scipy evd),
then the spectral route at chunk 8, 16, 32, 64, 64, 32, 16, 8 (ABCCBA
order) with the peak device bytes of one call.  These numbers set
``ops/spectral.spectral_chunk`` and the basis's eigensolver.

Needs a CUDA device; prints one JSON line per configuration and writes
them to --out.  --profile instead prints torch.profiler's device-time
table of one N=1000 gr_sum: per panel at the default width and chunk 64,
or (--solver spectral) on the spectral route at its automatic chunk, with
the call's wall time, device busy time and host partitioning time.
--contacts bethe times gr_sum and T(E) on the N = 1000 Bethe junction (two
3-atom Au(111) contact triangles and a 946-site chain; demo.bethe and
Au.bethe), on the default solver and on the LU, warm-started and cold,
with the share of each call spent in the providers' fixed points, the
sweeps per energy, and one cold fixed point alone.
--probe times the pieces of one probe of a Fermi search (a 128-point
contour density on a new engine, ``density.density_complex_n``) at the
quick-start junction, n = 1000, with the basis cached as from the second
probe on, and the device busy time of one probe.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models import slater_koster as sk
from gaunegf_tpu_torch.models.bethe import BetheGeometry
from gaunegf_tpu_torch.models.fock import TightBindingFock
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
from gaunegf_tpu_torch.ops import spectral as sp
from gaunegf_tpu_torch.ops.greens import EnergyEngine
from gaunegf_tpu_torch.ops.kernels import panel_fused, panel_lu, strip_elim

SWEEP = {1000: (512, (64, 128, 256), (32, 64, 128, 256)),
         2000: (128, (128, 256), (32, 64))}
SPECTRAL_CHUNKS = (8, 16, 32, 64)
BASIS_SIZES = (1000, 1500, 2000, 3000)


def bench_system(N, seed=0):
    """The bench junction (bench.py:305-321): disordered chain, S = I,
    ConstantSelfEnergy on 8+8 contact orbitals at -0.1j."""
    rng = np.random.default_rng(seed)
    H = -1.0 * (np.eye(N, k=1) + np.eye(N, k=-1)) \
        + np.diag(0.2 * rng.standard_normal(N))
    S = np.eye(N)
    g = ConstantSelfEnergy(H, S, [np.arange(8), np.arange(N - 8, N)],
                           sig1=-0.1j)
    return H, S, g


PANELS = ("pstrip", "fused", "pallas")
# the kernel modules whose launches a timed gr_sum counts
KERNELS = {"strip_elim": strip_elim, "panel_fused": panel_fused,
           "panel_lu": panel_lu}


def measure(N, n_E, bs, chunk, device, panel="pstrip"):
    H, S, g = bench_system(N)
    E = np.linspace(-2.0, 2.0, n_E)
    w = np.ones(n_E)
    eng = EnergyEngine(H, S, g, ExecutionConfig(
        precision="mixed", solver="lu", lu_panel=panel, lu_block=bs,
        energy_chunk=chunk), device=device)
    eng.gr_sum(E[:chunk], w[:chunk])                  # warm-up
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    eng.gr_sum(E[:chunk], w[:chunk])
    torch.cuda.synchronize(device)
    lane = (torch.cuda.max_memory_allocated(device) - base) / chunk
    for mod in KERNELS.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    eng.gr_sum(E, w)
    torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    return {"N": N, "points": n_E, "panel": panel, "bs": bs, "chunk": chunk,
            "pts_per_s": n_E / dt, "lane_bytes": lane,
            "lane_bytes_per_n2": lane / N ** 2,
            "launches": {k: mod.LAUNCHES for k, mod in KERNELS.items()}}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bethe_junction(lat, n_chain=946, spin="r"):
    """tests/test_bethe_scf.py's junction at full width: two 3-atom
    Au(111) contact triangles (27 orbitals each, d = 2.88 A) and a chain of
    n_chain single-orbital sites between them, Hubbard U on the chain only,
    weak coupling to the contacts' s orbitals.  The chain's level sits
    0.4 eV above the lattice's s level, inside its s band.  The contact
    atoms carry the lattice's own onsite energies (the test leaves their
    blocks at zero, which puts 54 levels a few eta wide at E = 0, inside
    the bias window around the Fermi level: a density there is decided by
    the self-energy's sixth digit).  ``spin`` is the backend's layout.
    Returns (backend, geometry, contacts, chain level)."""
    d = 2.88
    u1 = np.array([1.0, 0.0, 0.0]) * d
    u2 = np.array([0.5, np.sqrt(3) / 2, 0.0]) * d
    left = [np.zeros(3), u1, u2]
    chain = [np.array([0.8, 0.5, -2.2 - 1.8 * k]) for k in range(n_chain)]
    right = [c + np.array([0, 0, chain[-1][2] - 2.2]) for c in left]
    coords = np.stack(left + chain + right)
    n_atoms = len(coords)
    metal = set(range(1, 4)) | set(range(n_atoms - 2, n_atoms + 1))
    orb_atoms = []
    for atom in range(1, n_atoms + 1):
        orb_atoms += [atom] * (9 if atom in metal else 1)
    orb_atoms = np.asarray(orb_atoms)
    N = len(orb_atoms)
    params = sk.parse_bethe_file(lat)
    eps = params.onsite["s"] + 0.4
    H = np.zeros((N, N))
    i0, i1 = 27, 27 + n_chain - 1
    for a in list(range(0, 27, 9)) + list(range(i1 + 1, N, 9)):
        H[a:a + 9, a:a + 9] = params.h0()
    idx = np.arange(i0, i1 + 1)
    H[idx, idx] = eps
    H[idx[:-1], idx[1:]] = H[idx[1:], idx[:-1]] = -0.8
    for a in (0, 9, 18):                        # left-contact s orbitals
        H[a, i0] = H[i0, a] = -0.4
    for a in (i1 + 1, i1 + 10, i1 + 19):        # right-contact s orbitals
        H[a, i1] = H[i1, a] = -0.4
    U = np.zeros(N)
    U[idx] = 0.5
    backend = TightBindingFock(H, n_electrons=float(n_chain), U=U,
                               n0=np.zeros(N), coords=coords, locs=orb_atoms,
                               spin=spin)
    contacts = [[1, 2, 3], [n_atoms - 2, n_atoms - 1, n_atoms]]
    return backend, BetheGeometry(coords, orb_atoms, None), contacts, eps


class ProviderClock:
    """Seconds spent in the providers' surface fixed points for a stretch,
    every call timed between two device synchronisations (so the stretch
    itself must be timed with the clock on, and is slower than without)."""

    def __init__(self, device):
        self.device = device
        self.seconds = 0.0
        self.calls = 0

    def __enter__(self):
        from gaunegf_tpu_torch.models import bethe, lattice3d
        self._saved = [(bethe, "bethe_sigma_surface",
                        bethe.bethe_sigma_surface),
                       (lattice3d, "kspace_sigma_surface",
                        lattice3d.kspace_sigma_surface)]

        def timed(fn):
            def wrapped(*a, **k):
                _sync(self.device)
                t0 = time.perf_counter()
                out = fn(*a, **k)
                _sync(self.device)
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                return out
            return wrapped

        for owner, name, fn in self._saved:
            setattr(owner, name, timed(fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def measure_bethe(device, n_chain=946, n_E=192, n_T=200, reps=3):
    """gr_sum (n_E points 0.05 eV above the real axis, inside the lattice
    s band) and T(E) (n_T real-axis points) on the Bethe junction, per
    parameter set (demo: static support; Au: dense embedding), solver
    (auto, lu) and warm_start (True, False): median seconds of reps
    calls, the kernels' launches, and -- from one more call with every
    fixed-point call timed between two synchronisations -- the providers'
    share of the call and the sweeps per energy.  One JSON row each."""
    from gaunegf_tpu_torch.models import bethe
    from gaunegf_tpu_torch.models.bethe import BetheSelfEnergy
    rows = []
    for lat in ("demo", "Au"):
        backend, geom, contacts, eps = bethe_junction(lat, n_chain)
        F, S = backend.H0, np.eye(backend.H0.shape[0])
        g = BetheSelfEnergy(F, S, contacts, geom, lat_file=lat, eta=1e-5,
                            fermi=0.0, verbose=False, device=device)
        E = np.linspace(eps - 2.0, eps + 2.0, n_E) + 0.05j
        w = np.ones(n_E) + 0j
        E_T = np.linspace(eps - 2.0, eps + 2.0, n_T)
        for solver in ("auto", "lu"):
            for warm in (True, False):
                eng = EnergyEngine(F, S, g, ExecutionConfig(
                    solver=solver, warm_start=warm), device=device)
                route = ("spectral" if eng._spectral_runner() is not None
                         else "lu-warm" if eng._use_warm() else "lu")
                for name, call, n in (
                        ("gr_sum", lambda: eng.gr_sum(E, w), n_E),
                        ("transmission", lambda: eng.transmission(E_T), n_T)):
                    call()                                   # warm-up
                    for mod in KERNELS.values():
                        mod.LAUNCHES = 0
                    secs = [_sync_s(device, call)[0] for _ in range(reps)]
                    launches = {k: mod.LAUNCHES // reps
                                for k, mod in KERNELS.items()}
                    with bethe.SweepCounter() as counter, \
                            ProviderClock(device) as clock:
                        timed, _ = _sync_s(device, call)
                    sweeps = counter.counts()
                    rows.append({
                        "lat": lat, "N": int(F.shape[0]), "call": name,
                        "solver": solver, "warm_start": warm, "route": route,
                        "chunk": eng.exec_cfg.energy_chunk, "points": n,
                        "seconds": float(np.median(secs)),
                        "pts_per_s": n / float(np.median(secs)),
                        "launches": launches,
                        "clocked_seconds": timed,
                        "provider_seconds": clock.seconds,
                        "provider_share": clock.seconds / timed,
                        "provider_calls": clock.calls,
                        "sweeps_mean": float(sweeps.mean()),
                        "sweeps_max": int(sweeps.max())})
    # the fixed point alone: one cold call at an energy chunk
    g0 = g.g_list[0]
    for b in (64, 128):
        Eb = torch.as_tensor(np.linspace(eps - 2.0, eps + 2.0, b) + 0j,
                             device=device)
        p = {k: torch.as_tensor(np.asarray(v, dtype=np.complex128),
                                device=device)
             for k, v in g0.params().items()}
        call = lambda: bethe.bethe_sigma_surface(Eb, p["H"], p["S"], p["V"],
                                                 p["eta"])
        call()
        secs = float(np.median([_sync_s(device, call)[0]
                                for _ in range(reps)]))
        with bethe.SweepCounter() as counter:
            call()
        sweeps = counter.counts().reshape(2, b)             # bulk, surface
        total = int(sweeps.max(axis=1).sum())
        rows.append({"lat": "Au", "call": "bethe_sigma_surface", "b": b,
                     "seconds": secs, "sweeps_bulk_max": int(sweeps[0].max()),
                     "sweeps_surface_max": int(sweeps[1].max()),
                     "sweeps_mean": float(sweeps.sum(axis=0).mean()),
                     "us_per_sweep": 1e6 * secs / total})
    return rows


def _sync_s(device, fn):
    """Seconds of fn() on the host clock, the device synchronised."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return time.perf_counter() - t0, out


def basis_seconds(N, device, reps=3):
    """Median seconds of the bench pencil's eigendecomposition over reps
    calls: the route's spectral_basis on the card (cuSOLVER; cache
    cleared, as each new Fock finds it), torch.linalg.eigh through MAGMA,
    and scipy's divide-and-conquer eigh on the host with the eigenvectors
    copied to the card."""
    import scipy.linalg as sla
    H, S, _ = bench_system(N)
    Hd = torch.as_tensor(H, device=device)
    torch.linalg.eigh(Hd[:8, :8])               # solver handles and workspace

    def route():
        sp._BASIS_CACHE.clear()
        return sp.spectral_basis(H, S, device)

    def magma():
        torch.backends.cuda.preferred_linalg_library("magma")
        try:
            return torch.linalg.eigh(Hd)
        finally:
            torch.backends.cuda.preferred_linalg_library("default")

    def host():
        lam, C = sla.eigh(H, driver="evd")
        return lam, torch.as_tensor(C, device=device)

    row = {"N": N}
    for name, fn in (("eigh_card_s", route), ("eigh_magma_s", magma),
                     ("eigh_host_evd_s", host)):
        try:
            row[name] = float(np.median([_sync_s(device, fn)[0]
                                         for _ in range(reps)]))
        except RuntimeError as e:           # a torch built without MAGMA
            row[name] = f"unavailable: {e}"
    return row


def measure_spectral(N, n_E, chunk, device):
    """The spectral route's gr_sum at one chunk: setup (eigh, detection),
    median seconds of 3 calls on the cached basis, peak bytes of one
    call."""
    H, S, g = bench_system(N)
    E = np.linspace(-2.0, 2.0, n_E)
    w = np.ones(n_E)
    sp._BASIS_CACHE.clear()
    eng = EnergyEngine(H, S, g, ExecutionConfig(
        precision="mixed", energy_chunk=chunk), device=device)
    setup, runner = _sync_s(device, eng._spectral_runner)
    if runner is None:
        raise RuntimeError("tune: the spectral route declined the bench "
                           "junction")
    eng.gr_sum(E, w)                                  # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    times = [_sync_s(device, lambda: eng.gr_sum(E, w))[0] for _ in range(3)]
    peak = torch.cuda.max_memory_allocated(device) - base
    dt = float(np.median(times))
    return {"N": N, "points": n_E, "solver": "spectral", "chunk": chunk,
            "setup_s": setup, "pts_per_s": n_E / dt, "seconds": times,
            "peak_bytes": peak}


def profile(device, panel="pstrip"):
    H, S, g = bench_system(1000)
    E = np.linspace(-2.0, 2.0, 512)
    w = np.ones(512)
    eng = EnergyEngine(H, S, g, ExecutionConfig(
        precision="mixed", solver="lu", lu_panel=panel, energy_chunk=64),
        device=device)
    eng.gr_sum(E[:64], w[:64])                        # warm-up
    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eng.gr_sum(E, w)
        torch.cuda.synchronize(device)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                    max_name_column_width=60))


def profile_spectral(device):
    """torch.profiler's table of one spectral gr_sum at the bench shape
    (basis cached), the call's wall time, the device's busy time (sum of
    kernel times) and the host's pole-distance partitioning time."""
    H, S, g = bench_system(1000)
    E = np.linspace(-2.0, 2.0, 512)
    w = np.ones(512)
    eng = EnergyEngine(H, S, g, ExecutionConfig(precision="mixed"),
                       device=device)
    runner = eng._spectral_runner()
    eng.gr_sum(E, w)                                  # warm-up
    wall, _ = _sync_s(device, lambda: eng.gr_sum(E, w))
    t0 = time.perf_counter()
    runner._segments(E, eng.exec_cfg.spectral_dist_f32)
    host = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eng.gr_sum(E, w)
        torch.cuda.synchronize(device)
    from torch.autograd import DeviceType
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=30, max_name_column_width=70))
    print(json.dumps({"solver": "spectral", "N": 1000, "points": 512,
                      "chunk": runner.exec_cfg.energy_chunk,
                      "wall_s": wall, "device_busy_s": busy,
                      "idle_share": 1.0 - busy / wall,
                      "host_partition_s": host}))


def profile_probe(device, n=1000, N1=128, reps=5):
    """Median seconds of the pieces of one Fermi-search probe on the
    quick-start junction (n-site chain, contacts [1, 2] and [n-1, n] at
    -0.1j), the basis already cached: the new engine (H and S copied to
    the card), the runner (content digest of H and S, factors of the
    cached basis), the contour gr_sum (parameter copy, chunks, one N x N
    copy back) and the electron count on the host; then the wall and
    device busy time of one whole probe."""
    from gaunegf_tpu_torch import density as dens
    from gaunegf_tpu_torch import quadrature as quad
    from gaunegf_tpu_torch.fermi import _ne_of
    H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    S = np.eye(n)
    g = ConstantSelfEnergy(H, S, [np.arange(2), np.arange(n - 2, n)],
                           sig1=-0.1j)
    cfg = ExecutionConfig()
    z, w = quad.contour_grid(-7.0, 0.0, N1, 0.0)
    probe = lambda: dens.density_complex_n(H, S, g, -7.0, 0.0, N1, T=0.0,
                                           exec_cfg=cfg, device=device)
    P = probe()                                       # basis, warm-up
    med = lambda fn: float(np.median([_sync_s(device, fn)[0]
                                      for _ in range(reps)]))
    eng = EnergyEngine(H, S, g, cfg, device=device)
    runner = eng._spectral_runner()
    row = {
        "n": n, "points": len(z), "chunk": runner.exec_cfg.energy_chunk,
        "probe_s": med(probe),
        "engine_init_s": med(lambda: EnergyEngine(H, S, g, cfg,
                                                  device=device)),
        "runner_s": med(lambda: EnergyEngine(
            H, S, g, cfg, device=device)._spectral_runner()) ,
        "digest_s": med(lambda: sp.content_digest(H, S)),
        "param_copy_s": med(lambda: runner._params(g.params())),
        "gr_sum_s": med(lambda: eng.gr_sum(z, w, epilog="im")),
        "count_s": med(lambda: _ne_of(P, S)),
    }
    row["runner_s"] -= row["engine_init_s"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        probe()
        torch.cuda.synchronize(device)
    from torch.autograd import DeviceType
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6
    row.update({"device_busy_s": busy,
                "idle_share": 1.0 - busy / row["probe_s"]})
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=12, max_name_column_width=60))
    print(json.dumps(row))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="time the pieces of one Fermi-search probe")
    ap.add_argument("--panel", nargs="+", choices=PANELS, default=["pstrip"],
                    help="complex64 panel kernel(s) of the blocked LU")
    ap.add_argument("--solver", choices=("lu", "spectral"), default="lu",
                    help="sweep the LU panels or the spectral chunk")
    ap.add_argument("--contacts", choices=("constant", "bethe"),
                    default="constant",
                    help="bethe: time gr_sum and T(E) on the Bethe junction "
                         "instead of the sweeps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    if args.probe:
        print(card)
        profile_probe(device)
        return
    if args.profile:
        print(card)
        if args.solver == "spectral":
            profile_spectral(device)
            return
        for panel in args.panel:
            print(f"panel {panel}")
            profile(device, panel)
        return
    rows = []

    def emit(row):
        row = {"card": card, **row}
        print(json.dumps(row), flush=True)
        rows.append(row)

    if args.contacts == "bethe":
        for row in measure_bethe(device):
            emit(row)
    elif args.solver == "spectral":
        for N in BASIS_SIZES:
            emit(basis_seconds(N, device))
    for N, (n_E, widths, chunks) in ({} if args.contacts == "bethe"
                                     else SWEEP).items():
        if args.solver == "spectral":
            for chunk in SPECTRAL_CHUNKS + SPECTRAL_CHUNKS[::-1]:
                emit(measure_spectral(N, n_E, chunk, device))
            continue
        for bs in widths:
            for chunk in chunks:
                for panel in args.panel:
                    emit(measure(N, n_E, bs, chunk, device, panel))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows) + "\n")


if __name__ == "__main__":
    main()
