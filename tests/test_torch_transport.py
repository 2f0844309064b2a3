"""The port's transport layer and 1D-chain contacts vs the JAX package.

The static system is the reference-derived golden (``golden_v1.npz``:
16 orbitals, constant contact sigmas); the energy-dependent one is its
8-orbital chain with 4-orbital 1D-chain cells.  The JAX package runs
under x64 on its LU route (complex128 LAPACK solves), the truth to
~1e-14.  Each port tier is held to its contract against it: 'high'
(complex128 blocked LU on the swap-pivoted panel), 'exact' and 'strict'
to the goldens' 1e-9; 'mixed' on the fused panel to 2e-6 of the largest
value (complex64 LU refined once against the complex128 operator).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaunegf_tpu import transport as jtr
from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models import chain1d as jchain
from gaunegf_tpu.models.fock import TightBindingFock as JaxTB
from gaunegf_tpu.scfe import NEGFE as JaxNEGFE
from gaunegf_tpu_torch import transport as tr
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.interop import chain1d_self_energy_from_arrays
from gaunegf_tpu_torch.models import chain1d as tchain
from gaunegf_tpu_torch.models.fock import TightBindingFock
from gaunegf_tpu_torch.ops.greens import EnergyEngine
from gaunegf_tpu_torch.scfe import NEGFE

GOLD = np.load(os.path.join(os.path.dirname(__file__), "golden",
                            "golden_v1.npz"))
CPU = "cpu"
_JLU = JaxConfig(solver="lu")
HIGH = ExecutionConfig(precision="high", lu_panel="pallas")
TIERS = {
    "mixed+fused": (ExecutionConfig(precision="mixed", solver="lu",
                                    lu_panel="fused"), 2e-6),
    "high+pallas": (HIGH, 1e-9),
    "exact": (ExecutionConfig(precision="exact"), 1e-9),
    "strict": (ExecutionConfig(precision="strict"), 1e-9),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _static_system():
    H = GOLD["dens_H"]
    return H, np.eye(H.shape[0]), GOLD["trans_sig1"], GOLD["trans_sig2"]


@pytest.fixture(scope="module")
def jax_static():
    """The JAX package's T(E), DOS and current on the static system."""
    H, S, s1, s2 = _static_system()
    src = jtr.SigmaSource(s1, s2)
    E = GOLD["trans_E"]
    T = jtr.calculate_transmission(H, S, src, E, exec_cfg=_JLU)
    d, site = jtr.calculate_dos(H, S, src, E, exec_cfg=_JLU)
    I = jtr.calculate_current(H, S, src, 0.0, 0.5, T=300.0, dE=0.01,
                              exec_cfg=_JLU)
    return T, d, site, I


def _rel(x, ref):
    return np.max(np.abs(np.asarray(x) - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("tier", list(TIERS))
def test_transport_matches_jax(jax_static, tier):
    cfg, bound = TIERS[tier]
    H, S, s1, s2 = _static_system()
    src = tr.SigmaSource(s1, s2)
    E = GOLD["trans_E"]
    T_j, d_j, site_j, I_j = jax_static
    T = tr.calculate_transmission(H, S, src, E, exec_cfg=cfg, device=CPU)
    d, site = tr.calculate_dos(H, S, src, E, exec_cfg=cfg, device=CPU)
    I = tr.calculate_current(H, S, src, 0.0, 0.5, T=300.0, dE=0.01,
                             exec_cfg=cfg, device=CPU)
    assert T.dtype == np.float64 and site.shape == site_j.shape
    assert _rel(T, T_j) < bound
    assert _rel(d, d_j) < bound and _rel(site, site_j) < bound
    assert abs(I - I_j) < bound * abs(I_j)


def test_goldens_at_high_tier():
    """tests/test_transport.py's golden checks, on the port's complex128
    blocked LU."""
    H, S, s1, s2 = _static_system()
    src = tr.SigmaSource(s1, s2)
    T = tr.calculate_transmission(H, S, src, GOLD["trans_E"], exec_cfg=HIGH,
                                  device=CPU)
    assert np.max(np.abs(T - GOLD["trans_T"])) < 1e-9
    d, site = tr.calculate_dos(H, S, src, GOLD["trans_E"], exec_cfg=HIGH,
                               device=CPU)
    assert np.max(np.abs(d - GOLD["trans_dos_tot"])) < 1e-9
    assert np.max(np.abs(site - GOLD["trans_dos_site"])) < 1e-9
    I = tr.calculate_current(H, S, src, fermi=0.0, qV=0.5, T=0, dE=0.01,
                             exec_cfg=HIGH, device=CPU)
    assert abs(I - float(GOLD["trans_I"])) < 1e-10
    I300 = tr.calculate_current(H, S, src, fermi=0.0, qV=0.5, T=300.0,
                                dE=0.01, exec_cfg=HIGH, device=CPU)
    assert abs(I300 - float(GOLD["trans_I_300K"])) < 1e-10


def test_current_sign_conventions():
    H, S, s1, s2 = _static_system()
    src = tr.SigmaSource(s1, s2)
    Ip = tr.calculate_current(H, S, src, 0.0, 0.5, T=0, dE=0.01, device=CPU)
    Im = tr.calculate_current(H, S, src, 0.0, -0.5, T=0, dE=0.01,
                              device=CPU)
    assert Ip > 0 and Im < 0
    assert tr.calculate_current(H, S, src, 0.0, 0.0, device=CPU) == 0.0


def test_checkpoint_resume(tmp_path):
    """A resumed sweep computes only the placeholders and matches an
    uninterrupted one; a checkpoint on another grid is discarded."""
    H, S, s1, s2 = _static_system()
    src = tr.SigmaSource(s1, s2)
    E = GOLD["trans_E"]
    ckpt = str(tmp_path / "trans.npz")
    full = tr.calculate_transmission(H, S, src, E, exec_cfg=HIGH, device=CPU)
    part = full.copy()
    part[12:] = -1
    np.savez(ckpt, transmission=part, energy_list=E)
    resumed = tr.calculate_transmission(H, S, src, E, checkpoint_file=ckpt,
                                        checkpoint_interval=5, exec_cfg=HIGH,
                                        device=CPU)
    assert np.max(np.abs(resumed - full)) < 1e-12
    assert np.all(np.load(ckpt)["transmission"] != -1)
    np.savez(ckpt, transmission=np.zeros(7), energy_list=np.linspace(0, 1, 7))
    T = tr.calculate_transmission(H, S, src, E, checkpoint_file=ckpt,
                                  exec_cfg=HIGH, device=CPU)
    assert np.max(np.abs(T - GOLD["trans_T"])) < 1e-9


def test_dos_checkpoint_resume(tmp_path):
    H, S, s1, s2 = _static_system()
    src = tr.SigmaSource(s1, s2)
    E = GOLD["trans_E"]
    ckpt = str(tmp_path / "dos.npz")
    d_full, site_full = tr.calculate_dos(H, S, src, E, exec_cfg=HIGH,
                                         device=CPU)
    d_part, site_part = d_full.copy(), site_full.copy()
    d_part[10:] = -1
    site_part[10:] = -1
    np.savez(ckpt, dos_total=d_part, dos_per_site=site_part, energy_list=E)
    d_res, site_res = tr.calculate_dos(H, S, src, E, checkpoint_file=ckpt,
                                       exec_cfg=HIGH, device=CPU)
    assert np.max(np.abs(d_res - d_full)) < 1e-12
    assert np.max(np.abs(site_res - site_full)) < 1e-12


def test_single_energy_wrappers_match_goldens():
    H, S, s1, s2 = _static_system()
    src = tr.SigmaSource(s1, s2)
    E0 = float(GOLD["trans_E"][3])
    T0 = tr.transmission_single_energy(E0, H, S, src, exec_cfg=HIGH,
                                       device=CPU)
    assert isinstance(T0, float) and abs(T0 - GOLD["trans_T"][3]) < 1e-9
    d0, site0 = tr.dos_single_energy(E0, H, S, src, exec_cfg=HIGH,
                                     device=CPU)
    assert abs(d0 - GOLD["trans_dos_tot"][3]) < 1e-9
    assert np.max(np.abs(site0 - GOLD["trans_dos_site"][3])) < 1e-9


def test_legacy_api():
    H, S, s1, s2 = _static_system()
    E5 = GOLD["trans_E"][:5]
    T = tr.cohTrans(E5, H, S, s1, s2, exec_cfg=HIGH, device=CPU)
    assert np.max(np.abs(np.asarray(T) - GOLD["trans_T"][:5])) < 1e-9
    d, _ = tr.DOS(E5, H, S, s1, s2, exec_cfg=HIGH, device=CPU)
    assert np.max(np.abs(np.asarray(d) - GOLD["trans_dos_tot"][:5])) < 1e-9
    I = tr.current(H, S, s1, s2, 0.0, 0.5, T=0, spin="r", dE=0.01,
                   exec_cfg=HIGH, device=CPU)
    assert abs(I - float(GOLD["trans_I"])) < 1e-10


@pytest.mark.parametrize("spin", ["u", "ro", "g"])
def test_spin_layouts_raise(spin):
    """The three layouts run (tests/test_torch_spin.py holds them to the
    JAX package); what raises is a layout that does not exist."""
    H, S, s1, s2 = _static_system()
    H2 = np.kron(np.eye(2), H) if spin != "g" else np.kron(H, np.eye(2))
    T, Tspin = tr.calculate_transmission(
        H2, np.eye(len(H2)), tr.SigmaSource(s1, s2), [0.1], spin=spin,
        exec_cfg=HIGH, device=CPU)
    assert Tspin.shape == (1, 4)
    assert abs(T[0] - 2 * GOLD["trans_T"][0]) < 1  # two copies of the channel
    with pytest.raises(ValueError, match="unknown spin"):
        tr.calculate_transmission(H, S, tr.SigmaSource(s1, s2), [0.1],
                                  spin=spin + "x", device=CPU)


def test_device_is_explicit():
    H, S, s1, s2 = _static_system()
    with pytest.raises(TypeError, match="device"):
        tr.calculate_transmission(H, S, tr.SigmaSource(s1, s2), [0.1])


def test_contact_inds_threshold_and_lowrank():
    """_StaticSigma.contact_inds keeps weak-but-real couplings, truncates
    rows under 1e-6 of the peak, and the low-rank T(E) agrees with the
    dense one."""
    n, nc = 32, 3
    sig1 = np.zeros((n, n), complex)
    sig1[np.ix_(range(nc), range(nc))] = -0.1j * np.eye(nc)
    sig1[nc, nc] = -0.1j * 1e-5
    sig1[nc + 1, nc + 1] = -0.1j * 1e-8
    sig2 = np.zeros((n, n), complex)
    sig2[np.ix_(range(n - nc, n), range(n - nc, n))] = -0.1j * np.eye(nc)
    src = tr.SigmaSource(sig1, sig2)
    inds1 = src.provider.contact_inds(0)
    assert nc in inds1 and nc + 1 not in inds1
    H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    E = np.linspace(-1.5, 1.5, 16)
    T_lr = tr.calculate_transmission(H, np.eye(n), src, E, exec_cfg=HIGH,
                                     device=CPU)
    T_dense = tr.calculate_transmission(
        H, np.eye(n), src, E, device=CPU,
        exec_cfg=ExecutionConfig(precision="high", use_lowrank=False))
    assert _rel(T_lr, T_dense) < 1e-5
    assert tr.SigmaSource(np.diag(np.full(n, -0.1j)),
                          sig2).provider.contact_inds(0) is None


# ---------------------------------------------------------------------------
# 1D-chain contacts
# ---------------------------------------------------------------------------

def _chain_blocks(seed, n=3):
    """A, B surface blocks at 6 energies, band edges and gaps included."""
    rng = np.random.default_rng(seed)
    alpha = rng.standard_normal((n, n)) * 0.3
    alpha = alpha + alpha.T
    beta = -np.eye(n) + 0.1 * rng.standard_normal((n, n))
    E = np.array([-2.6, -1.9, -0.7, 0.05, 1.2, 2.4]) + 1j * 1e-4
    A = E[:, None, None] * np.eye(n) - alpha
    B = np.broadcast_to(-beta, A.shape).copy()
    return A, B


@pytest.mark.parametrize("method", ["sancho", "dyson"])
def test_surface_g_matches_jax_on_a_batch(method):
    A, B = _chain_blocks(3)
    jfn = jchain.surface_g_sancho if method == "sancho" \
        else jchain.surface_g_dyson
    tfn = tchain.surface_g_sancho if method == "sancho" \
        else tchain.surface_g_dyson
    ref = np.stack([np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
                    for a, b in zip(A, B)])
    got = tfn(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    # per-energy convergence: each lane stops where the JAX loop stops
    assert np.max(np.abs(got - ref)) < 1e-10 * np.max(np.abs(ref))


def test_chain_provider_matches_jax():
    """The port's provider, built by interop from the JAX one's arrays,
    gives the same Sigma (host evaluation) and the same T(E)."""
    H, S = GOLD["chain_H"], GOLD["chain_S"]
    inds = [np.arange(4), np.arange(4, 8)]
    g_j = jchain.Chain1DSelfEnergy(H, S, inds, eta=1e-4)
    g_t = chain1d_self_energy_from_arrays(H, S, inds, eta=1e-4, device="cpu")
    for E in (-0.8, 0.3, 1.7):
        for i in (0, -1):
            np.testing.assert_allclose(g_t.sigma(E, i), g_j.sigma(E, i),
                                       atol=1e-10)
        np.testing.assert_allclose(g_t.sigmaTot(E), g_j.sigmaTot(E),
                                   atol=1e-10)
    E = GOLD["transE_E"]
    T_j = jtr.calculate_transmission(H, S, jtr.SigmaSource(g_j), E,
                                     exec_cfg=_JLU)
    T_t = tr.calculate_transmission(H, S, tr.SigmaSource(g_t), E,
                                    exec_cfg=HIGH, device=CPU)
    assert np.max(np.abs(T_t - T_j)) < 1e-9
    assert g_t.warm_profitable is False


def test_energy_dependent_transmission_dyson_golden():
    """'dyson' replicates the reference's surface-GF iteration, so the
    sweep matches its golden everywhere (test_transport.py:119-129)."""
    H, S = GOLD["chain_H"], GOLD["chain_S"]
    g = tchain.Chain1DSelfEnergy(H, S, [np.arange(4), np.arange(4, 8)],
                                 eta=1e-4, method="dyson")
    T = tr.calculate_transmission(H, S, tr.SigmaSource(g), GOLD["transE_E"],
                                  exec_cfg=HIGH, device=CPU)
    assert np.max(np.abs(T - GOLD["transE_T"])) < 5e-4


def test_energy_dependent_transmission_sancho_physical():
    """'sancho' is exact: agrees with the golden where the reference
    converged and stays within [0, 4] (4 orbitals per cell)."""
    H, S = GOLD["chain_H"], GOLD["chain_S"]
    g = tchain.Chain1DSelfEnergy(H, S, [np.arange(4), np.arange(4, 8)],
                                 eta=1e-4)
    T = tr.calculate_transmission(H, S, tr.SigmaSource(g), GOLD["transE_E"],
                                  exec_cfg=ExecutionConfig(
                                      precision="mixed", solver="lu",
                                      lu_panel="fused"),
                                  device=CPU)
    assert np.median(np.abs(T - GOLD["transE_T"])) < 1e-6
    assert np.all(T >= -1e-6) and np.all(T <= 4 + 1e-6)


def test_chain_dos_engine_matches_jax():
    """EnergyEngine.dos with a 1D-chain provider (energy-dependent Sigma
    per lane) against the JAX engine."""
    H, S = GOLD["chain_H"], GOLD["chain_S"]
    inds = [np.arange(4), np.arange(4, 8)]
    E = np.linspace(-2.0, 2.0, 9) + 1e-3j
    from gaunegf_tpu.ops.greens import EnergyEngine as JaxEngine
    ref_tot, ref_site = JaxEngine(
        H, S, jchain.Chain1DSelfEnergy(H, S, inds, eta=1e-4), _JLU).dos(E)
    tot, site = EnergyEngine(
        H, S, tchain.Chain1DSelfEnergy(H, S, inds, eta=1e-4), HIGH,
        device=CPU).dos(E)
    assert _rel(site, ref_site) < 1e-9 and _rel(tot, ref_tot) < 1e-9


def _chain_negfe(pkg_negfe, tb, n=12, **kw):
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    backend = tb(H0, n_electrons=n, U=0.5, n0=0.5 * np.ones(n))
    return pkg_negfe(backend, name="chain", **kw)


def test_set_contact_1d_matches_jax():
    n = 12
    lead = [np.array([[-1.0]]), np.array([[-1.0]])]
    stau = [np.zeros((1, 1))] * 2
    j = _chain_negfe(JaxNEGFE, JaxTB, n)
    j.setContact1D([[1], [n]], tau_list=lead, stau_list=stau, eta=1e-4)
    t = _chain_negfe(NEGFE, TightBindingFock, n, device=CPU, verbose=False)
    inds = t.setContact1D([[1], [n]], tau_list=lead, stau_list=stau,
                          eta=1e-4)
    assert [list(i) for i in inds] == [[0], [n - 1]]
    assert isinstance(t.g, tchain.Chain1DSelfEnergy)
    for E in (-1.0, 0.4):
        np.testing.assert_allclose(t.g.sigmaTot(E), j.g.sigmaTot(E),
                                   atol=1e-10)
    assert abs(t.Emin - j.Emin) < 1e-9
    # the fully specified form places the lead Fermi levels by a search
    # (one orbital per cell at half filling: the onsite energy, 0)
    full = dict(tau_list=lead, stau_list=stau,
                alphas=[np.zeros((1, 1))] * 2, a_overlaps=[np.eye(1)] * 2,
                betas=lead, b_overlaps=stau, ne_list=[0.5, 0.5], eta=1e-4)
    j.setContact1D([[1], [n]], **full)
    t.setContact1D([[1], [n]], **full)
    assert np.allclose(t.g.fermi_list, j.g.fermi_list, atol=1e-6)
    assert np.allclose(t.g.fermi_list, 0.0, atol=0.05)
