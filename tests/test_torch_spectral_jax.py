"""The port's spectral route against the JAX package's, on the same NumPy
inputs.

tests/test_spectral.py's junction (N=96, 8+8 constant contacts at -0.1j)
goes through both packages' default solver='auto' on the mixed tier.  The
JAX route carries an f32 outer product and a double-word k-chain (~3e-7),
the port complex128 throughout (~1e-14), so each sum is held to the JAX
route's own bound in tests/test_spectral.py: gr_sum 5e-6, deflated
gr_sum 1e-5, G< near a pole 2e-5, T(E) 2e-5; a biased NEGFE SCF on the
default configuration converges to the JAX package's density within
2e-5.  Each JAX engine is built and run once per module.
"""

import numpy as np
import pytest
import torch

from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models.fock import TightBindingFock as JaxFock
from gaunegf_tpu.models.selfenergy import ConstantSelfEnergy as JaxSigma
from gaunegf_tpu.ops.greens import EnergyEngine as JaxEngine
from gaunegf_tpu.scfe import NEGFE as JaxNEGFE
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models.fock import TightBindingFock
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
from gaunegf_tpu_torch.ops.greens import EnergyEngine
from gaunegf_tpu_torch.scfe import NEGFE

N = 96
BOUNDS = {"gr_far": 5e-6, "gr_deflated": 1e-5, "gless_near_pole": 2e-5,
          "transmission": 2e-5}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system():
    rng = np.random.default_rng(0)
    H = -1.0 * (np.eye(N, k=1) + np.eye(N, k=-1)) \
        + np.diag(0.2 * rng.standard_normal(N))
    return H, np.eye(N), [np.arange(8), np.arange(N - 8, N)]


def _grids(lam):
    """(E, w, kind, contact) per case: a contour, a real-axis grid with
    points at pole distances 1e-7 and 3e-5, a bias window with an exact
    hit, and a T(E) grid with near-pole points."""
    th = np.linspace(0.1, np.pi - 0.1, 24)
    zc = -1.0 + 1.5 * np.exp(1j * th)
    zr = np.linspace(-1.5, 1.5, 24)
    zr[10] = lam[N // 2] + 1e-7
    zr[15] = lam[N // 3] + 3e-5
    zg = np.linspace(-1.5, 1.5, 24)
    zg[5] = lam[20] + 1e-7
    zg[11] = lam[N // 2]
    zg[17] = lam[60] + 3e-5
    Et = np.linspace(-1.8, 1.8, 32)
    Et[7] = lam[40] + 1e-7
    return {"gr_far": (zc, (0.3 + 0.1j) * np.ones(24) / 24, "gr", None),
            "gr_deflated": (zr, np.ones(24) / 24, "gr", None),
            "gless_near_pole": (zg, np.ones(24) / 24, "gless", 0),
            "transmission": (Et, None, "T", None)}


def _run(eng, E, w, kind, contact):
    if kind == "gr":
        return eng.gr_sum(E, w)
    if kind == "gless":
        return eng.gless_sum(E, w, contact)
    return eng.transmission(E)


@pytest.fixture(scope="module")
def jax_results():
    """The JAX route's result for each case (one engine, x64 host)."""
    H, S, inds = _system()
    eng = JaxEngine(H, S, JaxSigma(H, S, inds, sig1=-0.1j),
                    JaxConfig(precision="mixed", energy_chunk=4))
    runner = eng._spectral_runner()
    assert runner is not None
    grids = _grids(runner.lam64)
    return grids, {case: _run(eng, *args) for case, args in grids.items()}


@pytest.mark.parametrize("case", list(BOUNDS))
def test_port_matches_jax_route(jax_results, case):
    grids, ref = jax_results
    H, S, inds = _system()
    eng = EnergyEngine(H, S, ConstantSelfEnergy(H, S, inds, sig1=-0.1j),
                       ExecutionConfig(precision="mixed", energy_chunk=4),
                       device="cpu")
    runner = eng._spectral_runner()
    assert runner is not None
    E = grids[case][0]
    if case != "gr_far":
        assert runner._dists(E).min() < eng.exec_cfg.spectral_dist_f32
    got = _run(eng, *grids[case])
    assert got.shape == ref[case].shape
    assert np.abs(got - ref[case]).max() / np.abs(ref[case]).max() \
        < BOUNDS[case]


def _negfe_scf(pkg_negfe, fock, tmp_path, name, **kw):
    n = 12
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    d = pkg_negfe(fock(H0, n_electrons=n, U=0.4, n0=0.5 * np.ones(n)),
                  name=str(tmp_path / name), verbose=False, **kw)
    d.setSigma([1, 2], [n - 1, n], sig=-0.1j, T=0)
    d.setIntegralLimits(N1=32, N2=16)
    d.setVoltage(0.1, fermi=0.05)
    d.SCF(conv=1e-6, damping=0.1, max_cycles=120, checkpoint=False)
    return d


def test_biased_scf_on_the_default_config_matches_jax(tmp_path):
    """tests/test_spectral.py::test_spectral_negfe_scf_matches_default's
    system under a 0.1 V bias: both packages on their default
    ExecutionConfig() (solver='auto', the spectral route, an eigh per
    cycle) converge to the same density."""
    ref = _negfe_scf(JaxNEGFE, JaxFock, tmp_path, "jax")
    port = _negfe_scf(NEGFE, TightBindingFock, tmp_path, "port",
                      device="cpu")
    assert ref.exec_cfg.solver == port.exec_cfg.solver == "auto"
    assert port.conv_level < 1e-6
    assert np.abs(port.P - ref.P).max() < 2e-5
