"""What each rank of tests/test_torch_multidevice.py runs (no JAX here:
the ranks are processes of their own, and only the parent test imports
the JAX package).

``world_checks(layout)`` runs on every rank of a gloo world on the CPU,
under ``energy_mesh`` with the layout's 'm' size, and returns a dict of
NumPy results: the sharded engines, solves and drivers on small seeded
systems, and the same engines without a mesh on the same rank.
"""

import os

import numpy as np
import torch

from gaunegf_tpu_torch import transport
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.io import checkpoint as ckpt
from gaunegf_tpu_torch.models import bethe as bt
from gaunegf_tpu_torch.models.fock import TightBindingFock
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
from gaunegf_tpu_torch.ops import greens
from gaunegf_tpu_torch.ops import zlinalg as zl
from gaunegf_tpu_torch.ops.greens import EnergyEngine
from gaunegf_tpu_torch.parallel.mesh import energy_mesh, warm_segment
from gaunegf_tpu_torch.scfe import NEGFE

# ---------------------------------------------------------------------------
# Seeded systems (the parent builds the JAX side from the same arrays)
# ---------------------------------------------------------------------------


def chain(N, n_contact=4, seed=0):
    """tests/test_model_parallel.py's junction: a chain with random
    on-site levels, contacts of n_contact orbitals at each end."""
    rng = np.random.default_rng(seed)
    H = -1.0 * (np.eye(N, k=1) + np.eye(N, k=-1)) \
        + np.diag(0.2 * rng.standard_normal(N))
    inds = [np.arange(n_contact), np.arange(N - n_contact, N)]
    return H, np.eye(N), inds


def grids():
    rng = np.random.default_rng(3)
    E = np.linspace(-2, 2, 13) + 0.05j          # 13: padding on 2 'e' ranks
    w = rng.standard_normal(13)
    En = np.linspace(-0.5, 0.5, 9) + 1e-3j
    wn = rng.standard_normal(9)
    ET = np.linspace(-2, 2, 11)
    return E, w, En, wn, ET


def square(N, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    return (A + N * (0.3 + 0.1j) * np.eye(N)).astype(dtype)


def fcc_slab(d=2.88, n_dev_orb=1):
    """tests/test_torch_bethe.py's slab: a 3-atom contact triangle, the 9
    atoms of the second layer, one device atom."""
    u1 = np.array([1.0, 0.0, 0.0]) * d
    u2 = np.array([0.5, np.sqrt(3) / 2, 0.0]) * d
    z_down = np.array([0.5, 0.5 / np.sqrt(3), -np.sqrt(2.0 / 3.0)]) * d
    top = [np.zeros(3), u1, u2]
    second = [z_down + m * u1 + n * u2 for m in (-1, 0, 1)
              for n in (-1, 0, 1)]
    coords = np.stack(top + second + [np.array([1.0, 0.6, -4.5 * d])])
    orb_atoms = []
    for atom in range(1, len(coords) + 1):
        orb_atoms += [atom] * (9 if atom <= 12 else n_dev_orb)
    return coords + 7.0, np.asarray(orb_atoms)


def bethe_device():
    """The slab and one device orbital (tests/test_torch_bethe_engine.py's
    warm-against-cold system)."""
    n = 12 * 9 + 1
    F = np.zeros((n, n))
    F[-1, -1] = -8.0
    F[0, -1] = F[-1, 0] = -0.5
    return F, np.eye(n)


def _scf_junction(device, mesh, solver, name="mp_test"):
    """__graft_entry__.py's dry-run junction, biased: a 16-site chain."""
    n = 16
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    backend = TightBindingFock(H0, n_electrons=n, U=0.2,
                               n0=0.5 * np.ones(n))
    negfe = NEGFE(backend, name=name, verbose=False,
                  exec_cfg=ExecutionConfig(energy_chunk=4, solver=solver),
                  device=device, mesh=mesh)
    negfe.setSigma([1, 2], [n - 1, n], sig=-0.1j, T=0)
    negfe.setIntegralLimits(N1=32, N2=16)
    negfe.setVoltage(0.2, fermi=0.0)
    return negfe


def scf_step(device, mesh, solver):
    """__graft_entry__.py's dry-run SCF step: one biased NEGFE cycle."""
    negfe = _scf_junction(device, mesh, solver)
    negfe.FockToP()
    negfe.PMix(0.05)
    negfe.PToFock()
    return negfe.P


def checkpoint_restart(mesh, directory):
    """Two SCF runs on every rank that share one checkpoint name in one
    directory: the first stops after two cycles and leaves <name>_P.mat;
    the second loads it, converges and promotes it to <name>_Final.mat.
    Returns what each rank saw: the file after the first run, the density
    the second run loaded, its result and the files after it."""
    name = os.path.join(directory, "shared")
    calls = {"save_density": 0, "load_density": 0, "promote_final": 0}

    def counted(fn):
        def call(*a, **k):
            calls[fn.__name__] += 1
            return fn(*a, **k)
        return call

    first = _scf_junction(None, mesh, "lu", name)
    second = _scf_junction(None, mesh, "lu", name)
    loaded = []
    set_den = second.setDen
    second.setDen = lambda P: (loaded.append(np.array(P)), set_den(P))
    plain = {k: getattr(ckpt, k) for k in calls}
    for k, fn in plain.items():
        setattr(ckpt, k, counted(fn))
    try:
        first.SCF(conv=1e-12, damping=0.2, max_cycles=1)
        saved = plain["load_density"](name + "_P.mat")[0]
        second.SCF(conv=1e-4, damping=0.2)
    finally:
        for k, fn in plain.items():
            setattr(ckpt, k, fn)
    out = {"saved": saved, "loaded": loaded, "P": second.P,
           "converged": second.conv_level < 1e-4, "calls": calls,
           "files": sorted(os.listdir(directory))}
    # a T(E) sweep checkpointed to one shared file, then resumed from it
    H, S, inds = chain(16)
    g = ConstantSelfEnergy(H, S, inds, sig1=-0.1j, device="cpu")
    path = os.path.join(directory, "T.npz")
    out["T"] = [transport.calculate_transmission(
        H, S, transport.SigmaSource(g), np.linspace(-2, 2, 11),
        checkpoint_file=path, checkpoint_interval=4,
        exec_cfg=_cfg(solver="lu"), device="cpu", mesh=mesh)
        for _ in range(2)]
    return out


def _cfg(**kw):
    return ExecutionConfig(energy_chunk=4, **kw)


# ---------------------------------------------------------------------------
# The checks of each layout
# ---------------------------------------------------------------------------

def _pair(mesh, sharded, serial):
    """(the rank's sharded result, the serial one): rank 0 alone computes
    the serial reference (serial() is its thunk)."""
    return sharded, (serial() if mesh.rank == 0 else None)


def _energy_axis(mesh, out):
    """Layout (2, 1): the 'e' axis alone."""
    H, S, inds = chain(64)
    g = ConstantSelfEnergy(H, S, inds, sig1=-0.1j, device="cpu")
    E, w, En, wn, ET = grids()
    for name, cfg in (("mixed", _cfg(solver="lu")),
                      ("high", _cfg(precision="high", solver="lu")),
                      ("spectral", _cfg(solver="spectral"))):
        eng = EnergyEngine(H, S, g, cfg, mesh)
        ser = EnergyEngine(H, S, g, cfg, device="cpu")
        out[f"e_gr_{name}"] = _pair(mesh, eng.gr_sum(E, w),
                                    lambda: ser.gr_sum(E, w))
        out[f"e_gless_{name}"] = _pair(mesh, eng.gless_sum(En, wn, 0),
                                       lambda: ser.gless_sum(En, wn, 0))
        out[f"e_T_{name}"] = _pair(mesh, eng.transmission(ET),
                                   lambda: ser.transmission(ET))
    eng = EnergyEngine(H, S, g, _cfg(solver="lu"), mesh)
    ser = EnergyEngine(H, S, g, _cfg(solver="lu"), device="cpu")
    out["e_dos_mixed"] = _pair(mesh, eng.dos(ET)[1], lambda: ser.dos(ET)[1])
    out["e_gr_im_mixed"] = _pair(mesh, eng.gr_sum(E, w, epilog="im"),
                                 lambda: ser.gr_sum(E, w, epilog="im"))
    out["e_scf_lu"] = _pair(mesh, scf_step(None, mesh, "lu"),
                            lambda: scf_step("cpu", None, "lu"))
    # the warm engines: one contiguous segment per rank; 16 points in
    # chunks of 4 give every rank a full segment, as in the JAX layout.
    # The default tier's policy on complex128 (warm start, conv 1e-5),
    # as tests/test_torch_bethe.py compares with the JAX engines
    greens._TIGHT_TIERS = ()
    F, S = bethe_device()
    coords, orbs = fcc_slab()
    prov = bt.BetheSelfEnergy(F, S, [[1, 2, 3]],
                              bt.BetheGeometry(coords, orbs, None),
                              lat_file="demo", eta=1e-5, fermi=0.0,
                              device="cpu", verbose=False)
    Ew = np.linspace(-10, -6, 16) + 0.05j
    ww = np.cos(np.arange(16)) + 0j
    cfg = _cfg(solver="lu", precision="exact")
    eng = EnergyEngine(F, S, prov, cfg, mesh)
    out["warm_used"] = eng.route("gr").name == "warm"
    out["warm_gr"] = eng.gr_sum(Ew, ww)
    out["warm_T"] = eng.transmission(Ew.real)
    if mesh.rank:
        return
    # rank 0's serial references: the cold engine, and the warm engine on
    # each rank's segment (warm_segment) in turn -- the same lanes, the
    # same seeds
    ser = EnergyEngine(F, S, prov, cfg, device="cpu")
    segs = [warm_segment(16, _RankView(mesh, d), 4)[:2]
            for d in range(mesh.shape["e"])]
    out["warm_serial"] = {
        "cold": EnergyEngine(F, S, prov, _cfg(solver="lu", precision="exact",
                                              warm_start=False),
                             device="cpu").gr_sum(Ew, ww),
        "segments_gr": sum(ser.gr_sum(Ew[lo:hi], ww[lo:hi])
                           for lo, hi in segs),
        "segments_T": np.concatenate([ser.transmission(Ew.real[lo:hi])
                                      for lo, hi in segs])}


class _RankView:
    """The mesh as 'e' rank d sees it (for its grid segment)."""

    def __init__(self, mesh, d):
        self.shape = mesh.shape
        self.coords = {"e": d, "m": mesh.coords["m"]}


def _model_axis(mesh, out):
    """Layout (2, 2): the 'm' paths (and 'e' beneath them)."""
    H, S, inds = chain(64)
    g = ConstantSelfEnergy(H, S, inds, sig1=-0.1j, device="cpu")
    E, w, En, wn, ET = grids()
    cases = {
        "mixed": _cfg(solver="lu"),
        "fast": _cfg(precision="fast", solver="lu", lu_block=16),
        "full": _cfg(solver="lu", use_lowrank=False),
        "dist": _cfg(solver="lu", lu_block=16, distribute_lu=True),
        "high": _cfg(precision="high", solver="lu"),
        "exact": _cfg(precision="exact", solver="lu"),
    }
    shards = {}
    for name, cfg in cases.items():
        eng = EnergyEngine(H, S, g, cfg, mesh)
        ser = EnergyEngine(H, S, g, cfg, device="cpu")
        shards[name] = eng.route("gr").m
        out[f"m_gr_{name}"] = _pair(mesh, eng.gr_sum(E, w),
                                    lambda: ser.gr_sum(E, w))
        if name in ("high", "exact"):
            continue
        out[f"m_gless_{name}"] = _pair(mesh, eng.gless_sum(En, wn, 0),
                                       lambda: ser.gless_sum(En, wn, 0))
        out[f"m_neq_{name}"] = _pair(
            mesh, eng.density_neq_sum(E, w, En, wn, 0),
            lambda: ser.density_neq_sum(E, w, En, wn, 0))
        out[f"m_T_{name}"] = _pair(mesh, eng.transmission(ET),
                                   lambda: ser.transmission(ET))
    # contacts of 5 orbitals on 2 'm' ranks: the padded right-hand sides
    H5, S5, inds5 = chain(48, n_contact=5)
    g5 = ConstantSelfEnergy(H5, S5, inds5, sig1=-0.1j, device="cpu")
    out["m_gless_uneven"] = _pair(
        mesh,
        EnergyEngine(H5, S5, g5, cases["mixed"], mesh).gless_sum(En, wn, 0),
        lambda: EnergyEngine(H5, S5, g5, cases["mixed"],
                             device="cpu").gless_sum(En, wn, 0))
    # N = 33 does not divide by m = 2: replicated over 'm'
    H3, S3, inds3 = chain(33)
    g3 = ConstantSelfEnergy(H3, S3, inds3, sig1=-0.1j, device="cpu")
    eng = EnergyEngine(H3, S3, g3, cases["mixed"], mesh)
    shards["n33"] = eng.route("gr").m
    out["m_gr_n33"] = _pair(mesh, eng.gr_sum(E, w), lambda: EnergyEngine(
        H3, S3, g3, cases["mixed"], device="cpu").gr_sum(E, w))
    out["shards"] = shards
    # the solves themselves, gathered over 'm'
    A = torch.as_tensor(np.stack([square(64, 1), square(64, 2)]))
    X = zl.zinv_refined_cols(A, mesh, steps=1, bs=16)
    out["zinv_cols"] = _pair(mesh, mesh.gather_m(X, dim=-1).numpy(),
                             lambda: zl.zinv_refined(A, steps=1,
                                                     bs=16).numpy())
    # N = 36 pads to 48 = 3 panels of 8 per rank
    for dt, panel in ((np.complex64, "pstrip"), (np.complex128, "pallas")):
        A = torch.as_tensor(square(36, 4, dt))[None]
        B = torch.as_tensor(square(36, 5, dt)[:, :16])[None]
        r = mesh.coords["m"]
        X = zl.zsolve_dist(A, B[..., r * 8:(r + 1) * 8], mesh, bs=8,
                           panel_impl=panel)
        out[f"zsolve_dist_{panel}"] = _pair(
            mesh, mesh.gather_m(X, dim=-1).numpy(),
            lambda: zl.zsolve(A, B, method="blocked", bs=8,
                              panel_impl=panel).numpy())


def world_checks(m, directory=None):
    """Every check of the layout with 'm' size m on this rank; with 'm'
    size 1 also the SCF checkpoint shared in ``directory``."""
    mesh = energy_mesh(model_parallel=m, device="cpu", backend="gloo")
    out = {"shape": dict(mesh.shape), "coords": dict(mesh.coords)}
    if m == 1:
        out["checkpoint"] = checkpoint_restart(mesh, directory)
        _energy_axis(mesh, out)
    else:
        _model_axis(mesh, out)
    return out
