"""What decides ``correct``: the window's outputs held against the plain
reference (``negfbench/reference``), each number against its limit.

SCF cells, on a sample of the window's cycles drawn from the seed (see
``jobs.ScfJobs``), each stage followed from the program's own state:

* ``density``: the density FockToP returned, against the reference's
  dense complex128 density of the Fock matrix it was given, on the mix's
  grids (the largest gap over the sampled cycles, over the largest entry);
* ``fock``: the Fock matrix PToFock rebuilt, against the mean field of the
  mixed density it was given; and the starting Fock matrix against the
  configuration's;
* ``mixing``: the mixed density PMix kept, against the mixing rule
  stepped from the mixer's state before it; and the starting density
  against the aufbau start.

Transmission cells: T(E) at energies drawn from the seed among all the
window's sweeps, against the reference's T(E) on its own Fock matrix after
one cycle from the start (``transmission``: the largest gap over
max(1, max T)).

A control stands in for the program with ``control`` = {number: how}:
``reference_low`` puts the reference itself, in complex64 and float32, in
the program's place; ``program_fast`` is a run of the program on its
'fast' tier (the run is built so; nothing to replace here).
"""

from __future__ import annotations

import numpy as np
import torch

from negfbench.reference import negf as rn
from negfbench.reference import quadrature as rq

EMINF = -1e6            # the lower segment's far end (eV), as the API's
C64 = torch.complex64


def relmax(x, ref):
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(x) - ref)) / np.max(np.abs(ref)))


def _low(control, number):
    return (control or {}).get(number) == "reference_low"


def _grids(mod, spec, inp, job, device):
    """The reference, the density grids and their energies for the mix's
    bias, with Emin worked out on the starting Fock matrix."""
    g = job.grid
    mu = (g["mu1"], g["mu2"])
    ref = mod.reference(spec, inp, device=device, mu=mu)
    ref_emin = ref if tuple(g["emin_mu"]) == mu else mod.reference(
        spec, inp, device=device, mu=g["emin_mu"])
    Emin = rn.emin(ref.F0, ref.S, ref_emin.total_at)
    grids = rq.density_grids(EMINF, Emin, g["mu1"], g["mu2"], g["N1"],
                             g["N2"], g["Nnegf"])
    E_all = np.concatenate([E for E, _, _ in grids])
    return ref, grids, ref.sigmas(E_all)


def judge_scf(mod, spec, inp, job, seed, device, control=None):
    ref, grids, sigmas = _grids(mod, spec, inp, job, device)
    kept = job.kept.items
    fock = relmax(job.start_F, ref.F0)
    mixing = relmax(job.start_P, ref.P0())
    for rec in kept:
        f = rec["f_to_eV"]
        F_ref = ref.fock(rec["P_mixed"])
        F_got = ref.fock(rec["P_mixed"], np.float32) if _low(control, "fock") \
            else rec["F_out"] * f
        fock = max(fock, relmax(F_got, F_ref))
        args = (rec["P_back"], rec["P_out"], rec["p_list"], rec["dp_list"],
                rec["p_mat"], rec["p_b"], rec["damping"], rec["pulay"])
        M_ref = rn.mix_step(*args)
        M_got = rn.mix_step(*args, dtype=np.complex64) \
            if _low(control, "mixing") else rec["P_mixed"]
        mixing = max(mixing, relmax(M_got, M_ref))
    rng = np.random.default_rng([int(seed), 3])
    n = min(int(job.mix["density_cycles"]), len(kept))
    density = 0.0
    for i in sorted(rng.choice(len(kept), size=n, replace=False)):
        rec = kept[i]
        F_in = rec["F_in"] * rec["f_to_eV"]
        P_ref = rn.density(F_in, ref.S, sigmas, grids, device,
                           window_support=ref.window_support)
        P_got = rn.density(F_in, ref.S, sigmas, grids, device, C64,
                           ref.window_support) \
            if _low(control, "density") else rec["P_out"]
        density = max(density, relmax(P_got, P_ref))
    return {"density": density, "fock": fock, "mixing": mixing,
            "cycles_checked": float(len(kept)), "densities_checked": float(n)}


def judge_transmission(mod, spec, inp, job, seed, device, control=None):
    ref, grids, sigmas = _grids(mod, spec, inp, job, device)
    prep = job.mix["prepare"]
    P0 = ref.P0()
    P1 = rn.density(ref.F0, ref.S, sigmas, grids, device,
                    window_support=ref.window_support)
    F1 = ref.fock(P0 + prep["damping"] * (P1 - P0))
    E = np.concatenate([e for e, _ in job.sweeps])
    T = np.concatenate([t for _, t in job.sweeps])
    rng = np.random.default_rng([int(seed), 3])
    pick = np.sort(rng.choice(len(E), size=min(int(job.mix["checked_points"]),
                                               len(E)), replace=False))
    Ep = E[pick]
    sig = ref.sigmas(Ep)
    T_ref = rn.transmission(F1, ref.S, sig, Ep, device)
    T_got = rn.transmission(F1, ref.S, sig, Ep, device, C64) \
        if _low(control, "transmission") else T[pick]
    return {"transmission": float(np.max(np.abs(T_got - T_ref))
                                  / max(1.0, float(np.max(np.abs(T_ref))))),
            "points_checked": float(len(pick))}


JUDGES = {"scf": judge_scf, "transmission": judge_transmission}


def judge(mod, spec, inp, job, seed, device, control=None):
    """{number: reading} of the window's outputs (more keys than the
    limits name are counts, reported beside them)."""
    return JUDGES[job.mix["job"]](mod, spec, inp, job, seed, device, control)


def verdict(readings, limits):
    """[(name, reading, limit, ok)] for every limited number; a number
    missing from the readings fails."""
    out = []
    for name, limit in sorted(limits.items()):
        v = readings.get(name)
        ok = v is not None and np.isfinite(v) and v <= limit
        out.append((name, v, limit, ok))
    return out
