"""The finite-bias I-V sweep (BASELINE config 5) on gaunegf_tpu_torch at
tests/test_iv_sweep.py's scale: n = 10 chain, U = 0.3, contacts at
-0.15j, N1 = 64, N2 = 32, qV = 0, 0.2, 0.4 at Fermi level 0, each point's
SCF to conv 1e-3 from the previous point's density, then the Landauer
current.

The JAX package's whole-SCF sweep is marked slow, so the port is held to
it step by step instead, each step on the same NumPy inputs:
  * each converged Fock matrix's current against
    ``gaunegf_tpu.transport.calculate_current`` at 1e-10 relative (the
    port's exact tier against the JAX package's complex128 LU);
  * one ``FockToP`` per voltage from the same density against the JAX
    ``NEGFE.FockToP`` at 1e-8 of max |P| (the port's default spectral
    route, complex128 throughout, against the JAX complex128 LU).
"""

import numpy as np
import pytest
import torch

from gaunegf_tpu import transport as jtr
from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models.fock import TightBindingFock as JaxFock
from gaunegf_tpu.scfe import NEGFE as JaxNEGFE
from gaunegf_tpu_torch import transport as tr
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models.fock import TightBindingFock
from gaunegf_tpu_torch.scfe import NEGFE

N = 10
VOLTAGES = (0.0, 0.2, 0.4)
CPU = torch.device("cpu")


def _setup(negfe):
    negfe.setSigma([1, 2], [N - 1, N], sig=-0.15j, T=0)
    negfe.setIntegralLimits(N1=64, N2=32, Nnegf=48)
    return negfe


def _h0():
    return -1.0 * (np.eye(N, k=1) + np.eye(N, k=-1))


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The port's sweep: per voltage the converged F, P, conv level,
    current, and the first FockToP's density from the converged P."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("iv")
    try:
        backend = TightBindingFock(_h0(), n_electrons=N, U=0.3,
                                   n0=0.5 * np.ones(N))
        negfe = _setup(NEGFE(backend, name=str(tmp / "iv"), verbose=False,
                             exec_cfg=ExecutionConfig(energy_chunk=8),
                             device=CPU))
        out = []
        for qV in VOLTAGES:
            negfe.setVoltage(qV, fermi=0.0)
            negfe.SCF(conv=1e-3, damping=0.05, max_cycles=60,
                      checkpoint=False)
            F, P = negfe.F_eV.copy(), negfe.P.copy()
            I = tr.calculate_current(F, negfe.S, tr.SigmaSource(negfe.g),
                                     fermi=0.0, qV=qV, T=0, dE=0.01,
                                     device=CPU)
            I_exact = tr.calculate_current(
                F, negfe.S, tr.SigmaSource(negfe.g), fermi=0.0, qV=qV, T=0,
                dE=0.01, exec_cfg=ExecutionConfig(precision="exact"),
                device=CPU)
            negfe.setDen(P)
            negfe.FockToP()
            out.append({"qV": qV, "F": F, "P": P, "I": I,
                        "I_exact": I_exact, "conv": negfe.conv_level,
                        "P_next": negfe.P.copy()})
            negfe.setDen(P)
        return negfe, out
    finally:
        torch.set_num_threads(n_threads)


def test_sweep_converges_with_zero_then_rising_current(sweep):
    _, pts = sweep
    assert all(p["conv"] < 1e-3 for p in pts)
    I = [p["I"] for p in pts]
    assert I[0] == 0.0
    assert I[2] > I[1] > 0
    assert all(np.isfinite(p["P"]).all() for p in pts)


@pytest.mark.parametrize("k", range(len(VOLTAGES)))
def test_current_matches_jax(sweep, k):
    negfe, pts = sweep
    p = pts[k]
    ref = jtr.calculate_current(p["F"], negfe.S,
                                jtr.SigmaSource(*negfe.g.params()["sigs"]),
                                fermi=0.0, qV=p["qV"], T=0, dE=0.01,
                                exec_cfg=JaxConfig(solver="lu"))
    if p["qV"] == 0.0:
        assert ref == 0.0 and p["I_exact"] == 0.0
        return
    assert abs(p["I_exact"] - ref) <= 1e-10 * abs(ref)
    # the sweep's own default route (spectral, complex128) alike
    assert abs(p["I"] - ref) <= 1e-10 * abs(ref)


@pytest.fixture(scope="module")
def jax_negfe(tmp_path_factory):
    backend = JaxFock(_h0(), n_electrons=N, U=0.3, n0=0.5 * np.ones(N))
    return _setup(JaxNEGFE(backend,
                           name=str(tmp_path_factory.mktemp("iv_j") / "iv"),
                           verbose=False,
                           exec_cfg=JaxConfig(energy_chunk=8, solver="lu")))


@pytest.mark.parametrize("k", range(len(VOLTAGES)))
def test_fock_to_p_matches_jax(sweep, jax_negfe, k):
    _, pts = sweep
    p = pts[k]
    jax_negfe.setVoltage(p["qV"], fermi=0.0)
    jax_negfe.setDen(p["P"])
    assert np.max(np.abs(jax_negfe.F_eV - p["F"])) < 1e-12
    jax_negfe.FockToP()
    P_j = np.asarray(jax_negfe.P)
    assert np.max(np.abs(p["P_next"] - P_j)) < 1e-8 * np.max(np.abs(P_j))
