"""The port's density routes against the JAX package's, on the same inputs.

The system is the reference-derived golden (``golden_v1.npz``: 16
orbitals, 4+4 constant contacts at -0.1j).  The JAX package runs under x64
on its LU route (complex128 LAPACK solves); the port runs the complex128
blocked LU ('high' tier), so on the same grids the two differ by rounding
only: every route is held to 1e-8 (measured ~2e-16), the grid auto-tuning
to identical integers.  The port's default configuration (the spectral
route, complex128 throughout) is held to the goldens at 1e-9.
"""

import os
from functools import partial

import numpy as np
import pytest
import torch

from gaunegf_tpu import density as jdens
from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models.selfenergy import ConstantSelfEnergy as JaxSigma
from gaunegf_tpu_torch import density as dens
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
from gaunegf_tpu_torch.ops.greens import EnergyEngine, Route

GOLD = np.load(os.path.join(os.path.dirname(__file__), "golden",
                            "golden_v1.npz"))
CPU = "cpu"
JLU = JaxConfig(solver="lu")
HIGH = ExecutionConfig(precision="high", solver="lu")
ROUTE_BOUND = 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(sigma_cls):
    H = GOLD["dens_H"]
    S = np.eye(H.shape[0])
    return H, S, sigma_cls(H, S, [np.arange(4), np.arange(12, 16)],
                           sig1=-0.1j)


# route name -> fn(module, H, S, g, **how to name the device and config)
ROUTES = {
    "real_n_one_point": lambda d, H, S, g, kw: d.density_real_n(
        H, S, g, -6.0, 0.5, 1, T=0, **kw),
    "real_adaptive": lambda d, H, S, g, kw: d.density_real(
        H, S, g, -40.0, -6.0, 1e-5, T=0, verbose=False, **kw),
    "complex_n": lambda d, H, S, g, kw: d.density_complex_n(
        H, S, g, -4.0, 0.5, 64, T=0, **kw),
    "complex_n_300K_legendre": lambda d, H, S, g, kw: d.density_complex_n(
        H, S, g, -4.0, 0.5, 48, T=300.0, method="legendre", **kw),
    "complex_adaptive": lambda d, H, S, g, kw: d.density_complex(
        H, S, g, -4.0, 0.5, tol=1e-6, T=0, verbose=False, **kw),
    "complex_adaptive_300K": lambda d, H, S, g, kw: d.density_complex(
        H, S, g, -4.0, 0.5, tol=1e-5, T=300.0, verbose=False, **kw),
    "grid_n": lambda d, H, S, g, kw: d.density_grid_n(
        H, S, g, -0.4, 0.4, ind=1, N=64, T=0, **kw),
    "grid_adaptive": lambda d, H, S, g, kw: d.density_grid(
        H, S, g, -0.4, 0.4, ind=1, tol=1e-6, T=0, **kw),
    "grid_adaptive_300K_reversed": lambda d, H, S, g, kw: d.density_grid(
        H, S, g, 0.4, -0.4, ind=0, tol=1e-5, T=300.0, **kw),
    "grid_trap": lambda d, H, S, g, kw: d.density_grid_trap(
        H, S, g, -0.4, 0.4, ind=-1, N=40, T=300.0, **kw),
}


@pytest.fixture(scope="module")
def jax_routes():
    """Each route through the JAX package, once per module (every new grid
    length compiles)."""
    H, S, g = _system(JaxSigma)
    return {name: np.asarray(fn(jdens, H, S, g, {"exec_cfg": JLU}))
            for name, fn in ROUTES.items()}


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_matches_jax(jax_routes, route):
    H, S, g = _system(ConstantSelfEnergy)
    P = ROUTES[route](dens, H, S, g, {"exec_cfg": HIGH, "device": CPU})
    ref = jax_routes[route]
    assert P.shape == ref.shape and np.isfinite(P).all()
    assert np.max(np.abs(P - ref)) < ROUTE_BOUND


@pytest.mark.parametrize("cfg", [HIGH, ExecutionConfig()],
                         ids=["high_lu", "default_spectral"])
def test_fixed_grid_goldens(cfg):
    """tests/test_density.py's golden checks; the low-rank G< drops the
    broadening background's Gamma (~1e-7), as there."""
    H, S, g = _system(ConstantSelfEnergy)
    P = dens.density_complex_n(H, S, g, -4.0, 0.5, 64, T=0, exec_cfg=cfg,
                               device=CPU)
    assert np.max(np.abs(P - GOLD["dens_complexN"])) < 1e-9
    P = dens.density_real_n(H, S, g, -6.0, 0.5, 128, T=0, exec_cfg=cfg,
                            device=CPU)
    assert np.max(np.abs(P - GOLD["dens_realN"])) < 1e-9
    P = dens.density_grid_n(H, S, g, -0.4, 0.4, ind=1, N=64, T=0,
                            exec_cfg=cfg, device=CPU)
    assert np.max(np.abs(P - GOLD["dens_gridN"])) < 5e-7


def _gambar():
    sig = _system(partial(ConstantSelfEnergy, device=CPU))[2].sigmaTot(0.0)
    return 1j * (sig - sig.conj().T)           # S = I, so X = I


def test_density_analytic_golden_and_jax():
    V = GOLD["analytic_V"]
    Vc = np.linalg.inv(V.conj().T)
    P = dens.density_analytic(V, Vc, GOLD["analytic_D"], _gambar(), -1e6, 0.3)
    assert np.max(np.abs(P - GOLD["analytic_P"])) < 1e-10
    ref = jdens.density_analytic(V, Vc, GOLD["analytic_D"], _gambar(), -1e6,
                                 0.3)
    assert np.array_equal(P, ref)               # the same NumPy expressions


def test_bisect_fermi_golden_and_jax(capsys):
    V = GOLD["analytic_V"]
    Vc = np.linalg.inv(V.conj().T)
    f = dens.bisect_fermi(V, Vc, GOLD["analytic_D"], _gambar(), 8.0,
                          conv=1e-10, verbose=True)
    assert "Bisection fermi search converged" in capsys.readouterr().out
    assert abs(f - float(GOLD["analytic_fermi"])) < 1e-8
    assert f == jdens.bisect_fermi(V, Vc, GOLD["analytic_D"], _gambar(), 8.0,
                                   conv=1e-10, verbose=False)


def test_integral_fit_golden():
    H, S, g = _system(ConstantSelfEnergy)
    emin, n1, n2 = dens.integral_fit(H, S, g, 0.0, -1e6, 1e-4, T=0,
                                     exec_cfg=HIGH, device=CPU, verbose=False)
    assert emin == float(GOLD["fit_emin"])
    assert (n1, n2) == (int(GOLD["fit_n1"]), int(GOLD["fit_n2"]))


def test_integral_fit_negf_matches_jax():
    Hj, Sj, gj = _system(JaxSigma)
    ref = jdens.integral_fit_negf(Hj, Sj, gj, 0.1, 0.4, tol=1e-4, T=0,
                                  exec_cfg=JLU, verbose=False)
    H, S, g = _system(ConstantSelfEnergy)
    got = dens.integral_fit_negf(H, S, g, 0.1, 0.4, tol=1e-4, T=0,
                                 exec_cfg=HIGH, device=CPU, verbose=False)
    assert got == ref and got >= 16


def test_contour_equals_real_axis_route():
    """Path independence on the port's default route: the contour density
    equals a dense real-axis integration."""
    H, S, g = _system(ConstantSelfEnergy)
    Pc = dens.density_complex_n(H, S, g, -4.0, 0.2, 96, T=0, device=CPU)
    Pr = dens.density_real_n(H, S, g, -4.0, 0.2, 4096, T=0, device=CPU)
    assert np.max(np.abs(Pc - Pr)) < 5e-4


@pytest.mark.parametrize("solver", ["lu", "auto"])
@pytest.mark.parametrize("n_pts", [1, 3, 8, 11])
def test_engine_sums_take_any_grid_length(solver, n_pts):
    """One engine, grids of changing length (what the adaptive routes do):
    a single point, fewer points than the chunk, a whole chunk, a ragged
    tail; against a NumPy complex128 sum.  The LU route's G< takes Gamma
    on the contact block only (~1e-9 of background dropped), as the
    spectral one."""
    H, S, g = _system(partial(ConstantSelfEnergy, device=CPU))
    eng = EnergyEngine(H, S, g, ExecutionConfig(
        precision="mixed" if solver == "auto" else "high", solver=solver,
        energy_chunk=8), device=CPU)
    assert (eng.route("gr") == Route("spectral")) == (solver == "auto")
    rng = np.random.default_rng(n_pts)
    E = rng.uniform(-2, 2, n_pts) + 1j * rng.uniform(0.01, 0.5, n_pts)
    w = rng.standard_normal(n_pts) + 1j * rng.standard_normal(n_pts)
    sig = g.sigmaTot(0.0)
    gam = 1j * (g.sigma(0.0, 1) - g.sigma(0.0, 1).conj().T)
    G = [np.linalg.inv(e * S - H - sig) for e in E]
    ref_gr = sum(wk * Gk for wk, Gk in zip(w, G))
    ref_gl = sum(wk * Gk @ gam @ Gk.conj().T for wk, Gk in zip(w, G))
    assert np.max(np.abs(eng.gr_sum(E, w) - ref_gr)) < 1e-10
    assert np.max(np.abs(eng.gr_sum(E, w, epilog="im") - ref_gr.imag)) < 1e-10
    assert np.max(np.abs(eng.gless_sum(E, w, contact=1) - ref_gl)) < 1e-7


@pytest.mark.parametrize("cores", ["1", "64"], ids=["serial", "pool"])
def test_integrate_points(monkeypatch, cores):
    """The pool engages only with parallel=True, >= 100 points and >= 32
    cores (SLURM_CPUS_ON_NODE); both ways give the serial sum."""
    monkeypatch.setenv("SLURM_CPUS_ON_NODE", cores)
    f = lambda i: np.array([[i, 1.0], [0.5 * i, i * i]])
    want = sum(f(i) for i in range(120))
    got = dens.integrate_points(f, 120, parallel=True, num_workers=3)
    assert np.array_equal(got, want)
    assert np.array_equal(dens.integrate_points(f, 120), want)
    assert np.array_equal(
        np.asarray(jdens.integrate_points(f, 120, parallel=True,
                                          num_workers=3)), want)


def test_device_is_required():
    H, S, g = _system(ConstantSelfEnergy)
    with pytest.raises(TypeError, match="device"):
        dens.density_complex(H, S, g, -4.0, 0.5)
    with pytest.raises(TypeError, match="device"):
        dens.density_grid_trap(H, S, g, -0.4, 0.4)
