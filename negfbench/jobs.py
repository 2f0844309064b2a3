"""The one generator of the benchmark's traffic: it reads a traffic mix
(``traffic/<name>.json``) and drives the program with it.

A mix names its job kind:

* ``scf``: one researcher's script running SCF jobs back to back, each
  ``NEGFE.SCF`` from the starting density the set-up left, restarted from
  it when the job returns.  The unit is the SCF cycle (FockToP, PMix,
  PToFock, as the loop runs them); the window ends at the end of the
  first cycle that finishes after the window's seconds.
* ``transmission``: T(E) sweeps back to back with
  ``transport.calculate_transmission``, on the Fock matrix of one SCF
  cycle; each sweep a grid of ``points`` energies over 2 ``half_width_eV``
  around the configuration's band centre, shifted by a fresh offset drawn
  from the seed.  The unit is the sweep.

``setup`` is the list of NEGFE calls, in order, that set the bias and the
grids.  Every draw comes from the run's seed, so a seed gives the same
work.  What the window produced is kept for the judge: a seeded sample of
cycles (references to the arrays the program made, no copies) or every
sweep's energies and T(E).
"""

from __future__ import annotations

import time

import numpy as np
import torch


class WindowClosed(Exception):
    """Raised from the SCF callback at the cycle that closes the window."""


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def grids_of(setup):
    """What the setup calls set, by the NEGFE API's rules: the potentials
    (mu1 = fermi + qV/2 on the first contact), the fixed grids (a bias set
    after the contour grids takes the default 50-point window) and the
    potentials the contacts held when Emin was last worked out."""
    g = {"mu1": 0.0, "mu2": 0.0, "N1": None, "N2": None, "Nnegf": None,
         "emin_mu": (0.0, 0.0)}
    for call, kw in setup:
        if call == "setVoltage":
            if "fermi" not in kw:
                raise ValueError("a traffic mix fixes the Fermi level")
            g.update(mu1=kw["fermi"] + kw["qV"] / 2,
                     mu2=kw["fermi"] - kw["qV"] / 2)
            if g["N1"] is not None and g["mu1"] != g["mu2"]:
                g["Nnegf"] = 50
        elif call == "setIntegralLimits":
            g.update(N1=kw.get("N1"), N2=kw.get("N2"), Nnegf=kw.get("Nnegf"))
            g["emin_mu"] = (g["mu1"], g["mu2"])
        else:
            raise ValueError(f"unknown setup call {call!r}")
    return g


def _apply_setup(negfe, setup):
    for call, kw in setup:
        getattr(negfe, call)(**kw)
    g = grids_of(setup)
    got = (negfe.N1, negfe.N2, negfe.Nnegf, negfe.mu1, negfe.mu2)
    want = (g["N1"], g["N2"], g["Nnegf"], g["mu1"], g["mu2"])
    if got != want:
        raise RuntimeError(f"the program set {got}, the mix asks for {want}")
    return g


class Reservoir:
    """A uniform sample of k items of a stream of unknown length, drawn
    from the seed (algorithm R)."""

    def __init__(self, k, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item):
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class ScfJobs:
    unit = "cycle"

    def __init__(self, mix, system, seed):
        self.mix = mix
        self.system = system
        self.device = system.device
        negfe = self.negfe = system.negfe
        self.grid = _apply_setup(negfe, mix["setup"])
        self.points_per_unit = None
        shared = {"backend", "g", "mesh", "device", "exec_cfg"}
        self.start = {k: v for k, v in negfe.__dict__.items()
                      if k not in shared}
        self.start_P = negfe._P_stored
        self.start_F = negfe.F * negfe.f_to_eV
        self.kept = Reservoir(int(mix["kept_cycles"]),
                              np.random.default_rng([int(seed), 1]))
        self.recording = False
        self.cur = {}
        self.units = 0
        self._hook()

    def _restore(self):
        """The state the set-up left: large arrays are replaced, never
        written in place, by the loop, so they are shared; the lists and
        the small DIIS matrix it edits in place are copied."""
        negfe = self.negfe
        for k, v in self.start.items():
            if isinstance(v, list):
                v = list(v)
            elif isinstance(v, np.ndarray) and v.size <= 10_000:
                v = v.copy()
            setattr(negfe, k, v)
        negfe.backend.store_density(negfe._P_stored)
        negfe.g.set_fock(negfe.F_eV, negfe.mu1, negfe.mu2)

    def _hook(self):
        """Instance hooks that keep references to what each stage made."""
        negfe, cls = self.negfe, type(self.negfe)

        def focktop():
            if self.recording:
                self.cur = {"F_in": negfe.F, "f_to_eV": negfe.f_to_eV}
            out = cls.FockToP(negfe)
            if self.recording:
                self.cur["P_out"] = negfe.P
            return out

        def pmix(damping, pulay=False):
            if self.recording:
                self.cur.update(P_back=negfe._P_stored,
                                p_list=list(negfe.p_list),
                                dp_list=list(negfe.dp_list),
                                p_mat=negfe.p_mat.copy(), p_b=negfe.p_b,
                                damping=damping, pulay=pulay)
            out = cls.PMix(negfe, damping, pulay)
            if self.recording:
                self.cur["P_mixed"] = negfe.P
            return out

        def ptofock():
            out = cls.PToFock(negfe)
            if self.recording:
                self.cur["F_out"] = negfe.F
            return out

        negfe.FockToP, negfe.PMix, negfe.PToFock = focktop, pmix, ptofock

    def warm(self):
        """One whole cycle at the window's shapes, then back to the start."""
        self.negfe.FockToP()
        self.negfe.PMix(self.mix["scf"]["damping"], False)
        self.negfe.PToFock()
        sync(self.device)
        self._restore()

    def _run(self, deadline, max_units, record):
        """Cycles back to back from the start until the first one that
        ends after ``deadline`` (perf_counter) or the max_units-th;
        returns the end time of the last."""
        scf = self.mix["scf"]
        count = [0]
        ends = []

        def callback(negfe):
            sync(self.device)
            t = time.perf_counter()
            count[0] += 1
            ends.append(t)
            if record:
                self.kept.offer(self.cur)
            self.cur = {}
            if t >= deadline or count[0] >= max_units:
                raise WindowClosed
        self.recording = record
        if record:
            self.unit_ends = ends
        try:
            while True:
                self._restore()
                self.negfe.SCF(conv=scf["conv"], damping=scf["damping"],
                               max_cycles=scf["max_cycles"], checkpoint=False,
                               callback=callback)
        except WindowClosed:
            pass
        finally:
            self.recording = False
        return count[0], ends[-1]

    def window(self, seconds):
        t0 = time.perf_counter()
        self.units, t1 = self._run(t0 + seconds, np.inf, True)
        return self.units, t1 - t0

    def extra(self, units):
        """``units`` more cycles from the start, kept apart from the
        window's record (the traced stretch)."""
        t0 = time.perf_counter()
        n, t1 = self._run(np.inf, units, False)
        return n, t1 - t0


class TransmissionSweeps:
    unit = "sweep"

    def __init__(self, mix, system, seed):
        from gaunegf_tpu_torch import transport
        self.mix = mix
        self.system = system
        self.device = system.device
        negfe = system.negfe
        self.grid = _apply_setup(negfe, mix["setup"])
        prep = mix["prepare"]
        negfe.SCF(conv=prep["conv"], damping=prep["damping"], max_cycles=0,
                  checkpoint=False)
        self.F, self.S = negfe.F_eV, negfe.S
        self.source = transport.SigmaSource(negfe.g)
        self._transmission = transport.calculate_transmission
        n = int(mix["points"])
        hw = float(mix["half_width_eV"])
        c = system.band_center
        self.base = np.linspace(c - hw, c + hw, n)
        self.spacing = 2 * hw / (n - 1)
        self.rng = np.random.default_rng([int(seed), 2])
        self.points_per_unit = n
        self.sweeps = []
        self.units = 0

    def _sweep(self, offset):
        E = self.base + offset
        T = self._transmission(self.F, self.S, self.source, E,
                               exec_cfg=self.system.negfe.exec_cfg,
                               device=self.device)
        return E, np.asarray(T)

    def warm(self):
        self._sweep(0.5 * self.spacing)
        sync(self.device)

    def _run(self, deadline, max_units, record):
        n = 0
        if record:
            self.unit_ends = []
        while True:
            E, T = self._sweep(self.rng.uniform(0.0, self.spacing))
            sync(self.device)
            t = time.perf_counter()
            n += 1
            if record:
                self.sweeps.append((E, T))
                self.unit_ends.append(t)
            if t >= deadline or n >= max_units:
                return n, t

    def window(self, seconds):
        t0 = time.perf_counter()
        self.units, t1 = self._run(t0 + seconds, np.inf, True)
        return self.units, t1 - t0

    def extra(self, units):
        t0 = time.perf_counter()
        n, t1 = self._run(np.inf, units, False)
        return n, t1 - t0


KINDS = {"scf": ScfJobs, "transmission": TransmissionSweeps}


def make(mix, system, seed):
    return KINDS[mix["job"]](mix, system, seed)
