"""The port's Fermi searches, against the JAX package's and by property.

Three groups:

* the search properties of tests/test_fermi_properties.py (random monotone
  n(E) profiles, 8 seeds x 4 methods, the probe replaced: no engine)
  against ``gaunegf_tpu_torch.fermi``;
* each search, the contact-level searches, ``integralCheck``,
  ``setContact1D(alphas=...)`` and one NEGFE cycle per ``fermi_method``
  against the JAX package on the same NumPy inputs.  Both run complex128
  there (JAX: x64 LU route; port: 'exact' tier on the LU), so a probe's
  electron count agrees to ~1e-13 and a search takes the same steps.  A
  search stops anywhere inside |dN| < conv, so its Fermi level is held
  to 10 conv (dN/dE is 1-3 electrons per eV on these junctions), well
  inside the 1e-4 eV and 1e-5 of max |P| asked of the SCF; the contact
  searches' plain bisection to 1e-8 eV; the probe counts to equality;
* what a search costs on the default configuration: one eigh and one
  structure detection per Fock matrix, however many probes.
"""

import numpy as np
import pytest
import torch
from scipy.optimize import brentq

import gaunegf_tpu.fermi as jfermi
import gaunegf_tpu_torch.fermi as fermi
from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models.chain1d import Chain1DSelfEnergy as JaxChain
from gaunegf_tpu.models.fock import TightBindingFock as JaxFock
from gaunegf_tpu.models.selfenergy import ConstantSelfEnergy as JaxSigma
from gaunegf_tpu.scf import NEGF as JaxNEGF
from gaunegf_tpu.scfe import NEGFE as JaxNEGFE
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.density import density_complex_n
from gaunegf_tpu_torch.interop import (
    chain1d_self_energy_from_arrays, negfe_from_arrays)
from gaunegf_tpu_torch.models.chain1d import Chain1DSelfEnergy
from gaunegf_tpu_torch.models.fock import TightBindingFock
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
from gaunegf_tpu_torch.ops import spectral
from gaunegf_tpu_torch.scf import NEGF
from gaunegf_tpu_torch.scfe import NEGFE

CPU = "cpu"
JLU = JaxConfig(solver="lu")
EXACT = ExecutionConfig(precision="exact", solver="lu")
EF_BOUND = 1e-8
# Probe energies on the way: Muller's first step fits a parabola through
# three seed probes 1e-6 eV apart, which turns the ~1e-16 rounding of their
# counts into ~1e-6 eV; the iteration then contracts it again.
PROBE_BOUND = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Properties (tests/test_fermi_properties.py against the port)
# ---------------------------------------------------------------------------

class FakeG:
    """Minimal provider double: diagonal P whose trace is n(E)."""

    def __init__(self, n_of_E, n_basis=40):
        self.n_of_E = n_of_E
        self.F = np.zeros((n_basis, n_basis))
        self.S = np.eye(n_basis)

    def setF(self, F, mu1, mu2):
        pass

    def total_apply(self):
        return (lambda p, E: p["sig"]), {"sig": -0.01j * np.eye(len(self.F))}


def _monotone_profile(rng, n_basis=40):
    """Random smooth monotone n(E): sum of sigmoids (integrated DOS)."""
    k = rng.integers(3, 8)
    centers = rng.uniform(-6, 6, k)
    widths = rng.uniform(0.05, 1.0, k)
    heights = rng.uniform(0.5, 3.0, k)
    heights *= (0.8 * n_basis) / heights.sum()
    return lambda E: float(np.sum(
        heights / (1 + np.exp(-(E - centers) / widths))))


def _patch_probe(monkeypatch, g, calls=None):
    """Every contour probe returns a density with trace n(E)."""
    def fake_p_mu(g_, Emin, N, tol, T, exec_cfg, device, mesh=None,
                  method="ant"):
        def p(E):
            if calls is not None:
                calls.append(E)
            P = np.zeros_like(g.S)
            P[0, 0] = g.n_of_E(E)
            return P
        return p

    monkeypatch.setattr(fermi, "_p_mu", fake_p_mu)
    monkeypatch.setattr(
        fermi, "dos_at_energy", lambda E, F, S, sig: max(
            (g.n_of_E(E + 5e-4) - g.n_of_E(E - 5e-4)) / 1e-3, 1e-6))


def _root_of(n_of_E, ne):
    return brentq(lambda E: n_of_E(E) - ne, -50, 50, xtol=1e-12)


SEARCHES = {"bisect": fermi.calc_fermi_bisect,
            "secant": fermi.calc_fermi_secant,
            "muller": fermi.calc_fermi_muller,
            "polyfit": fermi.calc_fermi_poly_fit}


@pytest.mark.parametrize("method", sorted(SEARCHES))
@pytest.mark.parametrize("seed", range(8))
def test_search_converges_on_random_monotone_profiles(
        monkeypatch, method, seed):
    rng = np.random.default_rng(seed)
    n_of_E = _monotone_profile(rng)
    g = FakeG(n_of_E)
    _patch_probe(monkeypatch, g)
    ne = float(rng.uniform(0.15, 0.85) * n_of_E(50.0))
    root = _root_of(n_of_E, ne)
    Ef0 = root + rng.uniform(-2.0, 2.0)      # imperfect starting guess

    out = SEARCHES[method](g, ne, -10.0, Ef0, 32, conv=1e-7, max_cycles=200,
                           device=CPU)
    Ef = out[0]
    if method == "secant":
        # secant is not globally convergent (it stalls on DOS-gap
        # plateaus): its contract is to report the residual honestly so
        # NEGFE's bisect fallback can take over
        assert out[3] > 1e-7 or abs(n_of_E(Ef) - ne) < 1e-6, (seed, Ef, root)
    else:
        assert abs(n_of_E(Ef) - ne) < 1e-6, (method, seed, Ef, root)
    if method in ("muller", "polyfit"):
        u_bound, l_bound = out[4], out[5]
        if u_bound is not None:
            assert n_of_E(u_bound) >= ne - 1e-6
        if l_bound is not None:
            assert n_of_E(l_bound) <= ne + 1e-6
        if u_bound is not None and l_bound is not None:
            assert l_bound <= root <= u_bound


@pytest.mark.parametrize("seed", range(4))
def test_calc_fermi_bracketed_bisection(monkeypatch, seed):
    rng = np.random.default_rng(100 + seed)
    n_of_E = _monotone_profile(rng)
    g = FakeG(n_of_E)
    _patch_probe(monkeypatch, g)
    # calc_fermi composes p_low() + p_mu(E); route the low part to zero
    monkeypatch.setattr(fermi, "density_real_n",
                        lambda *a, **k: np.zeros_like(g.S))
    ne = float(rng.uniform(0.2, 0.8) * n_of_E(50.0))
    root = _root_of(n_of_E, ne)
    Ef, Emin, N1, N2 = fermi.calc_fermi(
        g, ne, root - 4.0, root + 4.0, fermi_guess=root + 1.5,
        N1=32, N2=16, tol=1e-7, max_cycles=200, device=CPU, verbose=False)
    assert abs(n_of_E(Ef) - ne) < 1e-6


def test_calc_fermi_raises_when_target_below_spectrum(monkeypatch):
    g = FakeG(lambda E: 0.0)
    _patch_probe(monkeypatch, g)
    monkeypatch.setattr(fermi, "density_real_n",
                        lambda *a, **k: np.eye(len(g.S)))  # ne_low = 40
    with pytest.raises(RuntimeError, match="below lowest orbital"):
        fermi.calc_fermi(g, 5.0, -4.0, 4.0, device=CPU, verbose=False)


def test_bisect_memo_skips_duplicate_probe(monkeypatch):
    """The bracket-alignment re-probe must not pay a second integral."""
    n_of_E = _monotone_profile(np.random.default_rng(7))
    g = FakeG(n_of_E)
    calls = []
    _patch_probe(monkeypatch, g, calls)
    monkeypatch.setattr(fermi, "dos_at_energy", lambda *a: 1.0)
    fermi.calc_fermi_bisect(g, 0.5 * n_of_E(50.0), -10.0, 0.5, 32, conv=1e-7,
                            max_cycles=200, device=CPU)
    assert len(calls) == len(set(calls)), "duplicate probe energies paid"


def test_muller_step_is_quadratic_root():
    poly = np.array([0.3, -1.2, 0.7])          # 0.3 E^2 - 1.2 E + 0.7
    roots = np.roots(poly)
    pts = [(float(E), float(np.polyval(poly, E))) for E in (3.1, 2.7, 2.9)]
    nearest = roots[np.argmin(np.abs(roots - 2.9))]
    assert abs(fermi._muller_step(pts) - nearest) < 1e-10
    assert fermi._muller_step(pts) == jfermi._muller_step(pts)


def test_too_many_electrons_is_rejected():
    g = FakeG(lambda E: 0.0, n_basis=4)
    for search in SEARCHES.values():
        with pytest.raises(ValueError, match="cannot exceed"):
            search(g, 4.0, -10.0, 0.0, 8, device=CPU)


# ---------------------------------------------------------------------------
# Each search against the JAX package (both complex128)
# ---------------------------------------------------------------------------

def _junction(sigma_cls, n=10):
    H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    S = np.eye(n)
    return H, S, sigma_cls(H, S, [np.arange(2), np.arange(n - 2, n)],
                           sig1=-0.2j)


def _counting(mod, calls):
    """mod._DensityProbe with every probe energy appended to calls."""
    class Probe(mod._DensityProbe):
        def __call__(self, E):
            calls.append(E)
            return super().__call__(E)
    return Probe


SEARCH_ARGS = {
    "bisect": dict(conv=1e-6, max_cycles=80),
    "secant": dict(conv=1e-6, max_cycles=50),
    "muller": dict(conv=1e-6, max_cycles=50),
    "polyfit": dict(conv=1e-6, max_cycles=50),
}


@pytest.mark.parametrize("N", [64, None], ids=["fixed_grid", "adaptive"])
@pytest.mark.parametrize("method", sorted(SEARCHES))
def test_search_matches_jax(monkeypatch, method, N):
    """Fermi level, last density and the sequence of probe energies; with
    N=None every probe is an adaptive contour integral."""
    ne, Emin, Ef0 = 5.0, -6.0, 0.1
    name = SEARCHES[method].__name__
    ref_calls, calls = [], []
    monkeypatch.setattr(jfermi, "_DensityProbe", _counting(jfermi, ref_calls))
    monkeypatch.setattr(fermi, "_DensityProbe", _counting(fermi, calls))
    ref = getattr(jfermi, name)(_junction(JaxSigma)[2], ne, Emin, Ef0, N,
                                exec_cfg=JLU, **SEARCH_ARGS[method])
    got = getattr(fermi, name)(_junction(ConstantSelfEnergy)[2], ne, Emin,
                               Ef0, N, exec_cfg=EXACT, device=CPU,
                               **SEARCH_ARGS[method])
    conv = SEARCH_ARGS[method]["conv"]
    assert abs(got[0] - ref[0]) < 10 * conv
    assert np.max(np.abs(got[2] - np.asarray(ref[2]))) < 10 * conv
    assert len(calls) == len(ref_calls) > 2
    assert np.max(np.abs(np.array(calls) - np.array(ref_calls))) < PROBE_BOUND
    if method in ("muller", "polyfit"):       # the bracket handed to NEGFE
        for b, b_ref in zip(got[4:], ref[4:]):
            assert (b is None) == (b_ref is None)
            assert b is None or abs(b - b_ref) < PROBE_BOUND


def test_found_fermi_gives_target_count():
    H, S, g = _junction(ConstantSelfEnergy)
    Ef = fermi.calc_fermi_secant(g, 5.0, -6.0, 0.1, 128, conv=1e-8,
                                 max_cycles=60, device=CPU)[0]
    P = density_complex_n(H, S, g, -6.0, Ef, 128, T=0, device=CPU)
    assert abs(np.trace(P @ S).real - 5.0) < 1e-6


def test_calc_fermi_matches_jax():
    """The bracketed bisection with its Legendre contour probes and the
    lower real-axis segment, fixed grids and N2=None (adaptive)."""
    for N2 in (16, None):
        kw = dict(fermi_guess=0.3, N1=32, N2=N2, Eminf=-200.0, tol=1e-6,
                  max_cycles=60, verbose=False)
        ref = jfermi.calc_fermi(_junction(JaxSigma)[2], 5.0, -6.0, 2.0,
                                exec_cfg=JLU, **kw)
        got = fermi.calc_fermi(_junction(ConstantSelfEnergy)[2], 5.0, -6.0,
                               2.0, exec_cfg=EXACT, device=CPU, **kw)
        assert abs(got[0] - ref[0]) < EF_BOUND and got[1:] == ref[1:]


def _contact_cell(cls, n=4, eps=0.2):
    """An isolated semi-infinite chain contact (tests/test_fermi.py)."""
    H = eps * np.eye(n) - 1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    tau = np.zeros((n, n))
    tau[0, -1] = -1.0
    return cls(H, np.eye(n), [np.arange(n)], taus=[tau],
               staus=[np.zeros((n, n))], eta=1e-4)


def test_get_fermi_contact_matches_jax():
    kw = dict(tol=1e-3, Eminf=-1000.0, verbose=False)
    ref = jfermi.get_fermi_contact(_contact_cell(JaxChain), 2.0, exec_cfg=JLU,
                                   **kw)
    got = fermi.get_fermi_contact(_contact_cell(Chain1DSelfEnergy), 2.0,
                                  exec_cfg=EXACT, device=CPU, **kw)
    assert abs(got - ref) < EF_BOUND
    assert abs(got - 0.2) < 0.05          # half filling: the band centre


def _lead_blocks(n=2, eps=0.1):
    alpha = eps * np.eye(n) - 1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    beta = np.zeros((n, n))
    beta[0, -1] = -1.0
    return alpha, beta


def _pattern_c(make, n=2):
    """A fully specified 1D-chain system (pattern c): 3-cell device."""
    alpha, beta = _lead_blocks(n)
    z = np.zeros((n, n))
    return make(np.kron(np.eye(3), alpha), np.eye(3 * n),
                [np.arange(n), np.arange(2 * n, 3 * n)],
                taus=[beta, beta.conj().T], staus=[z, z],
                alphas=[alpha, alpha], a_overlaps=[np.eye(n)] * 2,
                betas=[beta, beta], b_overlaps=[z, z], eta=1e-4)


@pytest.mark.parametrize("ind", [0, -1])
def test_get_fermi_1d_contact_matches_jax(ind):
    kw = dict(tol=1e-3, Eminf=-1000.0, verbose=False)
    ref = jfermi.get_fermi_1d_contact(_pattern_c(JaxChain), 1.0, ind,
                                      exec_cfg=JLU, **kw)
    got = fermi.get_fermi_1d_contact(
        _pattern_c(chain1d_self_energy_from_arrays), 1.0, ind,
        exec_cfg=EXACT, device=CPU, **kw)
    assert abs(got[0] - ref[0]) < EF_BOUND and got[1:] == ref[1:]
    assert abs(got[0] - 0.1) < 0.05


# ---------------------------------------------------------------------------
# NEGFE / NEGF with a Fermi level updated every cycle
# ---------------------------------------------------------------------------

def _negfe(pkg, fock, tmp_path, name, n=12, U=0.2, **kw):
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    d = pkg(fock(H0, n_electrons=n, U=U, n0=0.5 * np.ones(n)),
            name=str(tmp_path / name), verbose=False, **kw)
    d.setSigma([1, 2], [n - 1, n], sig=-0.1j, T=0)
    return d


def _pair(tmp_path, **kw):
    return (_negfe(JaxNEGFE, JaxFock, tmp_path, "jax", exec_cfg=JLU, **kw),
            _negfe(NEGFE, TightBindingFock, tmp_path, "port", exec_cfg=EXACT,
                   device=CPU, **kw))


@pytest.mark.parametrize("qV", [0.0, 0.2], ids=["eq", "biased"])
@pytest.mark.parametrize("method", ["muller", "secant", "bisect", "poly",
                                    "predict"])
def test_upd_fermi_scf_matches_jax(tmp_path, capsys, method, qV):
    """setVoltage without fermi: three SCF cycles, each with a search."""
    ref, port = _pair(tmp_path)
    for d in (ref, port):
        d.setIntegralLimits(N1=32, N2=16)
        d.setVoltage(qV, fermi_method=method)
        assert d.upd_fermi and d.fermi_method == method
        d.SCF(conv=1e-9, damping=0.05, max_cycles=2, checkpoint=False)
    out = capsys.readouterr().out
    label = {"poly": "POLYNOMIAL REGRESSION", "predict":
             "CONSTANT SELF-ENERGY APPROXIMATION"}.get(method, method.upper())
    assert out.count(f"{label}") >= 6          # 3 cycles, both packages
    assert abs(port.fermi - ref.fermi) < 1e-4
    assert abs(port.Emin - ref.Emin) < 1e-4
    assert np.max(np.abs(port.P - ref.P)) < 1e-5 * np.max(np.abs(ref.P))
    assert abs(port.nelec - ref.nelec) < 1e-6


@pytest.mark.parametrize("method", ["muller", "secant", "bisect", "poly",
                                    "predict"])
def test_upd_fermi_scf_converges_on_default_config(tmp_path, method):
    """The port alone on ExecutionConfig() (the spectral route): each
    strategy drives the electron count to its target
    (tests/test_scfe_integration.py's criterion)."""
    d = _negfe(NEGFE, TightBindingFock, tmp_path, method, device=CPU)
    d.setIntegralLimits(N1=64, N2=32)
    d.setVoltage(0.0, fermi_method=method)
    d.SCF(conv=5e-3, damping=0.05, max_cycles=60, checkpoint=False)
    assert d.conv_level < 5e-3
    assert abs(d.nelec - 12) < 0.1, (method, d.nelec)


def test_invalid_fermi_method_raises(tmp_path):
    d = _negfe(NEGFE, TightBindingFock, tmp_path, "bad", device=CPU)
    d.setIntegralLimits(N1=16, N2=8)
    d.setVoltage(0.0, fermi_method="newton")
    with pytest.raises(ValueError, match="invalid Fermi search method"):
        d.FockToP()


def test_bisect_fallback_takes_the_search_bounds(tmp_path, monkeypatch,
                                                 capsys):
    """A search that reports a residual above conv hands its bracket to
    the bisection fallback."""
    d = _negfe(NEGFE, TightBindingFock, tmp_path, "fb", exec_cfg=EXACT,
               device=CPU)
    d.setIntegralLimits(N1=32, N2=16)
    d.setVoltage(0.0, fermi_method="muller")
    seen = {}
    real_bisect = fermi.calc_fermi_bisect

    def failing_muller(g, ne, Emin, Ef, N, **kw):
        return Ef + 0.3, 0.3, None, 1.0, 1.5, -1.5

    def bisect(g, ne, Emin, Ef, N, **kw):
        seen.update(Ef=Ef, u_bound=kw["u_bound"], l_bound=kw["l_bound"])
        return real_bisect(g, ne, Emin, Ef, N, **kw)

    monkeypatch.setattr(fermi, "calc_fermi_muller", failing_muller)
    monkeypatch.setattr(fermi, "calc_fermi_bisect", bisect)
    fermi0 = d.fermi
    d.FockToP()
    assert "Switching to BISECT method" in capsys.readouterr().out
    assert seen == {"Ef": fermi0 + 0.3, "u_bound": 1.5, "l_bound": -1.5}
    assert abs(np.einsum("ij,ji->", d.P, d.S).real - 6.0) < 1e-3


@pytest.mark.parametrize("grids", ["adaptive", "fixed_eq_adaptive_window",
                                   "adaptive_lower"])
def test_adaptive_focktop_matches_jax(tmp_path, grids):
    """FockToP's branches with a grid left to its adaptive route, at a
    fixed Fermi level under bias."""
    limits = {"adaptive": {}, "fixed_eq_adaptive_window":
              dict(N1=32, N2=16), "adaptive_lower": dict(N1=32)}[grids]
    ref, port = _pair(tmp_path)
    for d in (ref, port):
        d.setIntegralLimits(**limits)
        d.setVoltage(0.2, fermi=0.05)
        if grids != "adaptive":
            d.Nnegf = None if grids == "fixed_eq_adaptive_window" else 24
        d.FockToP()
    assert np.max(np.abs(port.P - ref.P)) < 1e-8
    assert port.Emin == ref.Emin


def test_integral_check_matches_jax(tmp_path, capsys):
    ref, port = _pair(tmp_path, U=0.3)
    for d in (ref, port):
        d.setVoltage(0.2)
        d.integralCheck(cycles=2, damp=0.05)
    assert "INTEGRATION LIMITS SET!" in capsys.readouterr().out
    assert (port.N1, port.N2, port.Nnegf) == (ref.N1, ref.N2, ref.Nnegf)
    assert port.N1 >= 8 and port.N2 >= 8 and port.Nnegf >= 8
    assert abs(port.Emin - ref.Emin) < 1e-4
    assert abs(port.fermi - ref.fermi) < 1e-4
    assert np.max(np.abs(port.P - ref.P)) < 1e-5 * np.max(np.abs(ref.P))


def test_integral_check_pause_fermi(tmp_path):
    """pause_fermi runs the warm-up cycles at the starting Fermi level and
    switches the update back on for the final search."""
    d = _negfe(NEGFE, TightBindingFock, tmp_path, "pf", device=CPU)
    d.setVoltage(0.0)
    fermi0 = d.fermi
    seen = []
    d.SCF = lambda *a, **k: seen.append((d.upd_fermi, d.fermi))
    d.integralCheck(cycles=1, pause_fermi=True)
    assert seen == [(False, fermi0)] and d.upd_fermi
    assert d.N1 is not None and d.N2 is not None


def test_set_contact_1d_with_alphas_matches_jax(tmp_path):
    """The fully specified chain contact: the lead Fermi levels come from
    get_fermi_1d_contact and shift the lead blocks."""
    n = 12
    alpha, beta = _lead_blocks()
    z = np.zeros((2, 2))
    kw = dict(tau_list=[beta, beta.conj().T], stau_list=[z, z],
              alphas=[alpha, alpha], a_overlaps=[np.eye(2)] * 2,
              betas=[beta, beta], b_overlaps=[z, z], ne_list=[1.0, 1.0],
              eta=1e-4)
    ref, port = _pair(tmp_path)
    leads = []
    for d in (ref, port):
        d.setContact1D([[1, 2], [n - 1, n]], **kw)
        leads.append(list(d.g.fermi_list))
        d.setIntegralLimits(N1=32, N2=16)
        d.setVoltage(0.1, fermi=0.0)
    assert np.allclose(leads[1], leads[0], atol=EF_BOUND)
    assert abs(leads[1][0] - 0.1) < 0.05 and abs(leads[1][1] - 0.1) < 0.05
    assert port.g.fermi_list == [port.mu1, port.mu2]
    for a, b in zip(port.g.a_list, ref.g.a_list):
        assert np.max(np.abs(a - b)) < EF_BOUND
    for E in (-0.7, 0.4):
        assert np.max(np.abs(port.g.sigmaTot(E) - ref.g.sigmaTot(E))) < 1e-7
    ref.FockToP()
    port.FockToP()
    assert np.max(np.abs(port.P - ref.P)) < 1e-6


@pytest.mark.parametrize("fermi", [None, 0.1], ids=["upd_fermi", "fixed"])
def test_negf_analytic_cycle_matches_jax(tmp_path, fermi):
    """NEGF.FockToP, the analytic host route, with bisect_fermi under
    upd_fermi and the two-contact sum under bias."""
    n = 12
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1)) \
        + np.diag(0.3 * np.cos(np.arange(n)))
    runs = []
    for pkg, fock, kw in ((JaxNEGF, JaxFock, {}),
                          (NEGF, TightBindingFock, {"device": CPU})):
        d = pkg(fock(H0, n_electrons=n, U=0.3, n0=0.5 * np.ones(n)),
                name=str(tmp_path / pkg.__module__), verbose=False, **kw)
        d.setSigma([1], [n], sig=-0.1j)
        d.setVoltage(0.2, **({} if fermi is None else {"fermi": fermi}))
        d.SCF(conv=1e-9, damping=0.05, max_cycles=3, checkpoint=False)
        runs.append(d)
    ref, port = runs
    assert port.upd_fermi == (fermi is None)
    assert abs(port.fermi - ref.fermi) < 1e-10
    assert np.max(np.abs(port.P - ref.P)) < 1e-10
    assert abs(port.nelec - ref.nelec) < 1e-9


def test_interop_builds_an_updating_negfe(tmp_path):
    """negfe_from_arrays with fermi=None: upd_fermi, the method, the
    tolerance of the adaptive routes and a starting level between HOMO and
    LUMO, as the port's own setVoltage gives."""
    own = _negfe(NEGFE, TightBindingFock, tmp_path, "own", device=CPU)
    own.setIntegralLimits(N1=32, N2=16)
    own.setVoltage(0.1, fermi_method="secant")
    n = 12
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    built = negfe_from_arrays(
        own.F_eV, own.S, own.P, own.locs, n, (own.l_ind, own.r_ind),
        own._sig1, own._sig2, None, 0.1, own.Emin, 32, 16, own.Nnegf,
        backend=TightBindingFock(H0, n_electrons=n, U=0.2,
                                 n0=0.5 * np.ones(n)),
        device=CPU, fermi_method="secant", name=str(tmp_path / "built"))
    assert built.upd_fermi and built.fermi_method == "secant"
    assert built.fermi == own.fermi and built.tol == own.tol
    own.FockToP()
    built.FockToP()
    assert built.fermi == own.fermi
    assert np.max(np.abs(built.P - own.P)) < 1e-12


# ---------------------------------------------------------------------------
# Cost of a search on the default configuration
# ---------------------------------------------------------------------------

@pytest.fixture
def counters(monkeypatch):
    """Counts of pencil eigendecompositions and of the host probes of
    detect_structure (two per detection), from an empty basis cache."""
    counts = {"eigh": 0, "probes": 0}
    real_eigh, real_eval = spectral._eigh_pencil, spectral._host_eval

    def eigh(*a, **k):
        counts["eigh"] += 1
        return real_eigh(*a, **k)

    def host_eval(*a, **k):
        counts["probes"] += 1
        return real_eval(*a, **k)

    monkeypatch.setattr(spectral, "_eigh_pencil", eigh)
    monkeypatch.setattr(spectral, "_host_eval", host_eval)
    monkeypatch.setattr(spectral, "_BASIS_CACHE", {})
    return counts


@pytest.mark.parametrize("method", sorted(SEARCHES))
def test_search_costs_one_eigh_and_one_detection(counters, monkeypatch,
                                                 method):
    calls = []
    monkeypatch.setattr(fermi, "_DensityProbe", _counting(fermi, calls))
    g = _junction(ConstantSelfEnergy, n=24)[2]
    SEARCHES[method](g, 12.0, -6.0, 0.3, 32, conv=1e-6, max_cycles=40,
                     device=CPU)
    assert len(calls) >= 4
    assert counters == {"eigh": 1, "probes": 2}


def test_chain_provider_keeps_one_digest_across_probes(counters):
    """Chain1DSelfEnergy.set_fock rewrites blocks of its F in place
    (periodicity); from probe to probe that leaves the matrix, and so the
    basis cache's key, unchanged."""
    n = 16
    H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1)) \
        + np.diag(0.1 * np.cos(np.arange(n)))
    g = Chain1DSelfEnergy(H, np.eye(n), [np.arange(2), np.arange(n - 2, n)],
                          taus=[np.arange(2, 4), np.arange(n - 4, n - 2)],
                          eta=1e-4)
    fermi.calc_fermi_muller(g, 8.0, -6.0, 0.2, 32, conv=1e-6, max_cycles=30,
                            device=CPU)
    assert counters == {"eigh": 1, "probes": 2}


def test_upd_fermi_cycle_costs_one_eigh_per_fock(counters, tmp_path):
    """A whole NEGFE cycle under upd_fermi -- lower segment, search, bias
    window -- is one eigh per Fock matrix and one detection per run."""
    d = _negfe(NEGFE, TightBindingFock, tmp_path, "cost", device=CPU)
    d.setIntegralLimits(N1=32, N2=16)
    d.setVoltage(0.1)
    focks = []
    d.SCF(conv=1e-12, damping=0.05, max_cycles=2, checkpoint=False,
          callback=lambda s: focks.append(spectral.content_digest(s.F)))
    # three density builds, on the initial Fock and the first two rebuilt
    assert len(set(focks)) == 3 and counters["eigh"] == 3
    assert counters["probes"] == 2
