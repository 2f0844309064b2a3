"""Where the time goes inside the redesigned kernels, phase by phase.

    python3 tools/phase_timers.py [--batch 64] [--kernels ...]
                                  [--fused-source FILE]

Builds ``csrc/panel_lu.cu``, ``csrc/strip_elim.cu`` and
``csrc/panel_fused.cu`` once more with ``-DGAUNEGF_PHASE_CLOCKS`` (the
kernels' PHASE marks then read clock64 on thread 0 of every CTA; without
the define they compile to nothing), runs each at the main path's shapes
(m = 1024, 768, 512, 256 and 4096) on random inputs, and prints per kernel
and shape: the CUDA-event time of one launch, the launch shape, and each
phase's share of a CTA's cycles with its milliseconds at the card's
maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``; under load the
clock may be lower, so these are lower bounds).  ``--fused-source`` times
another version of kernel 2 with the same C entry points and phase marks
in place of ``csrc/panel_fused.cu`` (an earlier design, for a before and
after), with its launch shape unknown.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gaunegf_tpu_torch.ops.kernels import _build  # noqa: E402

PANEL_PHASES = ("load", "K: U-block solve", "K: rank-nb update",
                "column: scan, publish, barrier", "column: combine, swap",
                "column: multipliers, update", "store, row swaps")
STRIP_PHASES = ("load", "scan", "publish, barrier", "combine",
                "lane updates", "store")
FUSED_PHASES = ("load", "scan, publish, barrier", "combine",
                "strip lane updates", "G + W solve", "trailing update",
                "store")
HEIGHTS = (1024, 768, 512, 256, 4096)


def build(name: str, source: Path | None = None) -> ctypes.CDLL:
    src = source or _build.CSRC_DIR / f"{name}.cu"
    tag = hashlib.blake2b(src.read_bytes(), digest_size=6).hexdigest()
    out = _build.BUILD_DIR / "phase" / f"lib{name}_{tag}_phase.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise SystemExit("phase_timers: needs nvcc")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-DGAUNEGF_PHASE_CLOCKS", "-o",
                    str(out), str(src)], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(str(out))
    fn = getattr(lib, f"gaunegf_{name}_phase_clocks")
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def read_clocks(lib, name: str) -> list[int]:
    out = (ctypes.c_ulonglong * 8)()
    rc = getattr(lib, f"gaunegf_{name}_phase_clocks")(ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"reading the phase clocks failed: CUDA error {rc}")
    return list(out)


def timed(launch) -> float:
    """CUDA-event milliseconds of one launch (after one warm-up)."""
    launch()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    rc = launch()
    e1.record()
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return e0.elapsed_time(e1)


def report(label, ms, shape, cycles, ctas, phases, mhz):
    per_cta = [c / ctas for c in cycles[:len(phases)]]
    total = sum(per_cta)
    print(f"{label}: event {ms:.4f} ms, launch {shape}, a CTA's cycles "
          f"{total / 1e6:.3f} M ({total / mhz / 1e3:.4f} ms at {mhz} MHz)")
    for name, c in zip(phases, per_cta):
        print(f"    {name:32s} {100 * c / total:5.1f}%  "
              f"{c / mhz / 1e3:.4f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--kernels", nargs="+",
                    default=["panel_lu", "strip_elim", "panel_fused"],
                    choices=["panel_lu", "strip_elim", "panel_fused"])
    ap.add_argument("--fused-source", type=Path, default=None,
                    help="time this source in place of csrc/panel_fused.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phase_timers: needs a CUDA device")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    mhz = float(smi.split(",")[-1])
    B = args.batch
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)

    if "panel_lu" in args.kernels:
        time_panel_lu(B, dev, mhz)
    if "strip_elim" in args.kernels:
        time_strip_elim(B, dev, mhz)
    if "panel_fused" in args.kernels:
        time_panel_fused(B, dev, mhz, args.fused_source)
    return 0


def time_panel_lu(B, dev, mhz):
    lib = build("panel_lu")
    lib.gaunegf_panel_lu_config.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for dtype, fn in ((torch.complex128, lib.gaunegf_panel_lu_c128),
                      (torch.complex64, lib.gaunegf_panel_lu_c64)):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        for m in HEIGHTS:
            A = torch.randn(B, m, 256, dtype=dtype, device=dev)
            perm = torch.empty(B, m, dtype=torch.int64, device=dev)
            cfg = (ctypes.c_int * 3)()
            lib.gaunegf_panel_lu_config(m, A.element_size(), B,
                                        ctypes.addressof(cfg))
            read_clocks(lib, "panel_lu")       # zeroes them
            # the warm-up and the timed launch (on the factored panel: the
            # work does not depend on the values) both count: halve
            ms = timed(lambda: fn(A.data_ptr(), perm.data_ptr(), B, m, 256,
                                  None))
            cycles = read_clocks(lib, "panel_lu")
            report(f"panel_lu {str(dtype)[6:]} ({B}, {m}, 256)", ms,
                   {"nb": cfg[0], "ncta": cfg[1], "rows": cfg[2]},
                   [c / 2 for c in cycles], B * cfg[1], PANEL_PHASES, mhz)


def time_strip_elim(B, dev, mhz):
    lib = build("strip_elim")
    fn = lib.gaunegf_strip_elim_c64
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.gaunegf_strip_elim_config.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    for m in HEIGHTS:
        sb = torch.randn(B, 32, m, dtype=torch.complex64, device=dev)
        av = torch.ones(B, m, dtype=torch.bool, device=dev)
        piv = torch.empty(B, 32, dtype=torch.int32, device=dev)
        cfg = (ctypes.c_int * 3)()
        lib.gaunegf_strip_elim_config(32, m, ctypes.addressof(cfg))
        read_clocks(lib, "strip_elim")
        ms = timed(lambda: fn(sb.data_ptr(), av.data_ptr(), piv.data_ptr(),
                              B, 32, m, None))
        cycles = read_clocks(lib, "strip_elim")
        report(f"strip_elim ({B}, 32, {m})", ms,
               {"ncta": cfg[0], "lanes": cfg[1], "on_chip": cfg[2]},
               [c / 2 for c in cycles], B * cfg[0], STRIP_PHASES, mhz)


def time_panel_fused(B, dev, mhz, source):
    """Kernel 2 at (B, m, 256).  A source without the config entry
    (``source``, the first design) is taken to run one CTA a panel."""
    lib = build("panel_fused", source)
    fn = lib.gaunegf_panel_fused_c64
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    has_config = hasattr(lib, "gaunegf_panel_fused_config")
    if has_config:
        lib.gaunegf_panel_fused_config.argtypes = [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
    label = "panel_fused" if source is None else f"panel_fused [{source}]"
    for m in HEIGHTS:
        A = torch.randn(B, m, 256, dtype=torch.complex64, device=dev)
        av = torch.ones(B, m, dtype=torch.bool, device=dev)
        piv = torch.empty(B, 256, dtype=torch.int32, device=dev)
        shape, ctas = {"ncta": 1}, B
        if has_config:
            cfg = (ctypes.c_int * 3)()
            lib.gaunegf_panel_fused_config(m, 256, B, ctypes.addressof(cfg))
            shape = {"ncta": cfg[0], "lanes": cfg[1], "on_chip": cfg[2]}
            ctas = B * cfg[0]
        read_clocks(lib, "panel_fused")
        # both launches factor random values (the second the first's
        # result): the work does not depend on them; halve.  The first
        # design reads avail (all true on entry), so refill it
        def launch():
            av.fill_(True)
            return fn(A.data_ptr(), av.data_ptr(), piv.data_ptr(), B, m, 256,
                      None)
        ms = timed(launch)
        cycles = read_clocks(lib, "panel_fused")
        report(f"{label} ({B}, {m}, 256)", ms, shape,
               [c / 2 for c in cycles], ctas, FUSED_PHASES, mhz)


if __name__ == "__main__":
    sys.exit(main())
