"""Two repairs of gaunegf_tpu_torch, each against the JAX package (x64) on
the same NumPy inputs:

* the split path of ``density_eq_n`` (the real segment on the batched LU,
  the contour on the Newton-Schulz chain) runs no near-pole guard, as in
  the JAX package: one ``density_eq_n`` on ``solver='lu'`` calls
  ``spectral_basis`` 0 times with ``continuation='contour'`` and once
  (the guard of the fused gr_sum) with False, in both packages;
* ``ConstantSelfEnergy.sigma_total`` / ``sigma_contact``, the provider
  protocol's static methods.
"""

import numpy as np
import pytest
import torch

import gaunegf_tpu.ops.spectral as jsp
from gaunegf_tpu import density as jdens
from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models.selfenergy import ConstantSelfEnergy as JaxSigma
from gaunegf_tpu_torch import density as dens
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models.selfenergy import (ConstantSelfEnergy,
                                                 SelfEnergyProvider)
from gaunegf_tpu_torch.ops import greens
from gaunegf_tpu_torch.ops import spectral as sp

N = 40
KW = dict(Eminf=-40.0, Emin=-4.0, mu=0.3, N1=32, N2=16)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(shift):
    """A chain with random levels, S = I, constant contacts of 4 orbitals;
    ``shift`` makes a pencil no other test has cached."""
    rng = np.random.default_rng(11)
    H = -1.0 * (np.eye(N, k=1) + np.eye(N, k=-1)) \
        + np.diag(0.1 * rng.standard_normal(N)) + shift * np.eye(N)
    return H, np.eye(N), [np.arange(4), np.arange(N - 4, N)]


def _counting(monkeypatch, module, counts):
    real = module.spectral_basis

    def spy(*args, **kw):
        counts.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(module, "spectral_basis", spy)


@pytest.mark.parametrize("continuation,want", [("contour", 0), (False, 1)])
def test_spectral_basis_calls_of_density_eq_n_match_jax(
        monkeypatch, continuation, want):
    H, S, inds = _system(1e-4 * (want + 1))
    port, jax = [], []
    _counting(monkeypatch, greens, port)
    _counting(monkeypatch, sp, port)
    _counting(monkeypatch, jsp, jax)
    P = dens.density_eq_n(
        H, S, ConstantSelfEnergy(H, S, inds, sig1=-0.1j, device="cpu"),
        exec_cfg=ExecutionConfig(solver="lu", energy_chunk=8,
                                 continuation=continuation),
        device="cpu", **KW)
    P_j = jdens.density_eq_n(
        H, S, JaxSigma(H, S, inds, sig1=-0.1j),
        exec_cfg=JaxConfig(solver="lu", energy_chunk=8,
                           continuation=continuation), **KW)
    assert len(jax) == want
    assert len(port) == len(jax)
    # the port's mixed tier against the JAX package's complex128 LU
    assert np.max(np.abs(P - np.asarray(P_j))) \
        < 2e-6 * np.max(np.abs(np.asarray(P_j)))


@pytest.mark.parametrize("sig2", [None, -0.3j, np.array([-0.1j, -0.2j,
                                                         -0.05j, -0.4j])])
def test_sigma_total_and_contact_match_jax(sig2):
    H, S, inds = _system(0.0)
    g = ConstantSelfEnergy(H, S, inds, sig1=-0.1j, sig2=sig2, device="cpu")
    g_j = JaxSigma(H, S, inds, sig1=-0.1j, sig2=sig2)
    p = {"sigs": torch.as_tensor(g.params()["sigs"])}
    E = torch.tensor([0.3 + 0j])
    tot = ConstantSelfEnergy.sigma_total(p, E)
    assert np.array_equal(tot.numpy(), np.asarray(
        JaxSigma.sigma_total(g_j.params(), 0.3)))
    for i in range(g.num_contacts()):
        assert np.array_equal(
            ConstantSelfEnergy.sigma_contact(p, E, i).numpy(),
            np.asarray(JaxSigma.sigma_contact(g_j.params(), 0.3, i)))
    # the engines' apply methods are the same functions
    fn, _ = g.total_apply()
    assert fn is ConstantSelfEnergy.sigma_total
    assert torch.equal(g.contact_apply(1)[0](p, E),
                       ConstantSelfEnergy.sigma_contact(p, E, 1))


def test_protocol_names_the_static_methods():
    names = set(dir(SelfEnergyProvider))
    assert {"sigma_total", "sigma_contact", "params", "num_contacts",
            "set_fock"} <= names
    assert isinstance(
        ConstantSelfEnergy(*_system(0.0), device="cpu"), SelfEnergyProvider)
