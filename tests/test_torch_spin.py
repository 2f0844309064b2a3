"""The spin layouts 'u', 'ro' and 'g' in the port against the JAX package.

Transforms (spin.py), the SCF classes' spin handling (NEGF analytic route,
NEGFE contour route) and the spin-resolved transport, each on the same
NumPy inputs through both packages and compared per site and per channel:
a wrong inverse of the spinor permutation passes a trace check and fails
a per-site one.  Both packages run complex128 (JAX: x64 LU route; port:
'exact' tier, solver='lu'), so T(E), DOS and the golden are held to 1e-9
and an SCF of a few cycles to 1e-8.  One test shows which route of the
engine serves each layout in both packages.
"""

import os

import numpy as np
import pytest
import torch

from gaunegf_tpu import spin as jspin
from gaunegf_tpu import transport as jtr
from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models.chain1d import Chain1DSelfEnergy as JaxChain
from gaunegf_tpu.models.fock import TightBindingFock as JaxFock
from gaunegf_tpu.models.selfenergy import ConstantSelfEnergy as JaxSigma
from gaunegf_tpu.ops.greens import EnergyEngine as JaxEngine
from gaunegf_tpu.scf import NEGF as JaxNEGF
from gaunegf_tpu.scfe import NEGFE as JaxNEGFE
from gaunegf_tpu_torch import spin as spinmod
from gaunegf_tpu_torch import transport as tr
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.interop import negfe_from_arrays
from gaunegf_tpu_torch.models.chain1d import Chain1DSelfEnergy
from gaunegf_tpu_torch.models.fock import TightBindingFock
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
from gaunegf_tpu_torch.ops.greens import EnergyEngine, Route
from gaunegf_tpu_torch.scf import NEGF
from gaunegf_tpu_torch.scfe import NEGFE

GOLD = np.load(os.path.join(os.path.dirname(__file__), "golden",
                            "golden_v1.npz"))
CPU = "cpu"
JLU = JaxConfig(solver="lu")
EXACT = ExecutionConfig(precision="exact", solver="lu")
LAYOUTS = ["u", "ro", "g"]
T_BOUND = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# spin.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spin", ["r"] + LAYOUTS)
def test_host_transforms_match_jax(spin):
    rng = np.random.default_rng(3)
    m = rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3))
    v = rng.standard_normal(3)
    assert np.array_equal(spinmod.expand_matrix(m, spin),
                          jspin.expand_matrix(m, spin))
    assert np.array_equal(spinmod.expand_vector(v, spin),
                          jspin.expand_vector(v, spin))
    assert np.array_equal(spinmod.spinor_block_perm(5),
                          jspin.spinor_block_perm(5))


@pytest.mark.parametrize("spin", ["r"] + LAYOUTS)
def test_wrapped_sigma_fns(spin):
    """wrap_expand_fn on a batched (b, N, N) and an energy-independent
    (N, N) sigma equals the host expansion; wrap_permute_fn moves
    spinor-interleaved entries to block layout; both keep one identity."""
    rng = np.random.default_rng(4)
    sig = rng.standard_normal((2, 3, 3)) + 1j * rng.standard_normal((2, 3, 3))

    def batched(params, E):
        return params["s"]

    def single(params, E):
        return params["s"][0]

    p = {"s": torch.as_tensor(sig)}
    w = spinmod.wrap_expand_fn(batched, spin)
    assert w is spinmod.wrap_expand_fn(batched, spin)
    assert (w is batched) == (spin == "r")
    out = w(p, None).numpy()
    for b in range(2):
        assert np.array_equal(out[b], spinmod.expand_matrix(sig[b], spin))
    assert np.array_equal(spinmod.wrap_expand_fn(single, spin)(p, None).numpy(),
                          spinmod.expand_matrix(sig[0], spin))
    if spin == "g":
        big = spinmod.wrap_expand_fn(batched, "g")
        perm_fn = spinmod.wrap_permute_fn(big, 3)
        assert perm_fn is spinmod.wrap_permute_fn(big, 3)
        got = perm_fn(p, None).numpy()
        for b in range(2):      # block layout of kron(sig, 1_2) is kron(1_2, sig)
            assert np.array_equal(got[b], np.kron(np.eye(2), sig[b]))


# ---------------------------------------------------------------------------
# NEGF and NEGFE
# ---------------------------------------------------------------------------

def _backend(fock, spin, n=8, U=0.8, exchange=0.5):
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    return fock(H0, n_electrons=n, U=U, n0=0.5 * np.ones(n), spin=spin,
                exchange=exchange)


def _both(jax_cls, port_cls, spin, tmp_path, **kw):
    return (jax_cls(_backend(JaxFock, spin), spin=spin,
                    name=str(tmp_path / "jax"), verbose=False, **kw),
            port_cls(_backend(TightBindingFock, spin), spin=spin,
                     name=str(tmp_path / "port"), verbose=False, device=CPU,
                     **kw))


@pytest.mark.parametrize("spin", LAYOUTS)
def test_negf_state_by_layout(tmp_path, spin):
    """nelec, the HOMO/LUMO pick, the initial Fermi level and the contact
    indices over both spins."""
    ref, port = _both(JaxNEGF, NEGF, spin, tmp_path)
    assert port.nsto == 16 and (port.nae, port.nbe) == (ref.nae, ref.nbe)
    assert abs(port.nelec - ref.nelec) < 1e-12 and abs(port.nelec - 8) < 1e-9
    assert np.allclose(port.getHOMOLUMO(), ref.getHOMOLUMO(), atol=1e-12)
    for d in (ref, port):
        d.setSigma([1, 2], [7, 8], sig=-0.1j)
        d.setVoltage(0.0)
    assert np.array_equal(port.l_ind, ref.l_ind)
    assert np.array_equal(port.r_ind, ref.r_ind)
    assert len(port.l_ind) == 4 and abs(port.fermi - ref.fermi) < 1e-12


@pytest.mark.parametrize("form", ["vector", "matrix"])
@pytest.mark.parametrize("spin", LAYOUTS)
def test_set_sigma_expands_half_length_forms(tmp_path, spin, form):
    """A per-orbital vector or matrix sigma covers both spins (scf.py:478
    rules), for contacts of different sizes."""
    ref, port = _both(JaxNEGFE, NEGFE, spin, tmp_path)
    if form == "vector":
        sig, sig2 = np.array([-0.1j]), np.array([-0.2j, -0.3j])
    else:
        sig = np.array([[-0.1j]])
        sig2 = np.array([[-0.2j, 0.01], [0.01, -0.3j]])
    for d in (ref, port):
        d.setSigma([1], [7, 8], sig=sig, sig2=sig2)
    assert port.sigma1.shape == (16, 16)
    assert np.array_equal(port.sigma1, ref.sigma1)
    assert np.array_equal(port.sigma2, ref.sigma2)
    assert np.array_equal(port.g.params()["sigs"], ref.g.params()["sigs"])
    with pytest.raises(ValueError, match="dimension mismatch"):
        port.setSigma([1], [7, 8], sig=sig2, sig2=sig2)


@pytest.mark.parametrize("spin", LAYOUTS)
def test_negf_analytic_scf_matches_jax(tmp_path, spin):
    """The analytic route with the Fermi level updated every cycle (n_exp
    by layout), per site."""
    ref, port = _both(JaxNEGF, NEGF, spin, tmp_path)
    for d in (ref, port):
        d.setSigma([1], [8], sig=-0.1j)
        d.setVoltage(0.1)
        d.SCF(conv=1e-12, damping=0.1, max_cycles=5, checkpoint=False)
    assert abs(port.fermi - ref.fermi) < 1e-9
    assert np.max(np.abs(port.P - ref.P)) < 1e-9
    assert abs(port.nelec - 8) < 1e-2
    if spin == "g":     # the transverse field populates the spin-flip blocks
        assert np.max(np.abs(port.P[0::2, 1::2].diagonal())) > 1e-3
    else:               # exchange and Hubbard U polarize the chain
        occ = np.real(np.diag(port.P))
        assert abs(occ[:8].sum() - occ[8:].sum()) > 0.05


@pytest.mark.parametrize("spin", LAYOUTS)
def test_negfe_scf_matches_jax(tmp_path, spin):
    """The contour route under bias, fixed Fermi level, per site."""
    ref, port = _both(JaxNEGFE, NEGFE, spin, tmp_path)
    ref.exec_cfg, port.exec_cfg = JLU, EXACT
    for d in (ref, port):
        d.setSigma([1, 2], [7, 8], sig=-0.1j * np.ones(2), T=0)
        d.setIntegralLimits(N1=32, N2=16)
        d.setVoltage(0.2, fermi=0.05)
        d.SCF(conv=1e-12, damping=0.1, max_cycles=3, checkpoint=False)
    assert np.max(np.abs(port.P - ref.P)) < 1e-8
    assert abs(port.nelec - ref.nelec) < 1e-8
    assert abs(port.total_E - ref.total_E) < 1e-8


@pytest.mark.parametrize("spin", ["u", "g"])
def test_negfe_upd_fermi_counts_both_spins(tmp_path, capsys, spin):
    """Under upd_fermi the target count is all electrons, not half."""
    ref, port = _both(JaxNEGFE, NEGFE, spin, tmp_path)
    ref.exec_cfg, port.exec_cfg = JLU, EXACT
    for d in (ref, port):
        d.setSigma([1, 2], [7, 8], sig=-0.1j, T=0)
        d.setIntegralLimits(N1=32, N2=16)
        d.setVoltage(0.0)
        d.SCF(conv=1e-12, damping=0.1, max_cycles=2, checkpoint=False)
    assert "MULLER METHOD" in capsys.readouterr().out
    assert abs(port.fermi - ref.fermi) < 1e-4
    assert np.max(np.abs(port.P - ref.P)) < 1e-5 * np.max(np.abs(ref.P))
    assert abs(np.einsum("ij,ji->", port.P, port.S).real - 8) < 0.05


def test_save_mat_records_the_layout(tmp_path):
    _, port = _both(JaxNEGF, NEGF, "u", tmp_path)
    port.setSigma([1], [8], sig=-0.1j)
    port.setVoltage(0.1, fermi=0.0)
    port.FockToP()
    path = str(tmp_path / "out.mat")
    port.saveMAT(path)
    import scipy.io
    m = scipy.io.loadmat(path)
    assert str(m["spin"][0]) == "u" and m["F"].shape == (16, 16)
    I = tr.currentF(path, dE=0.02, exec_cfg=EXACT, device=CPU)
    Iu, ch = tr.calculate_current(
        port.F_eV, port.S, tr.SigmaSource(port.sigma1, port.sigma2), 0.0,
        0.1, spin="u", dE=0.02, exec_cfg=EXACT, device=CPU)
    assert I == (Iu, ch) and Iu > 0


def test_interop_takes_a_layout(tmp_path):
    _, own = _both(JaxNEGFE, NEGFE, "g", tmp_path)
    own.setSigma([1, 2], [7, 8], sig=-0.1j, T=0)
    own.setIntegralLimits(N1=32, N2=16)
    own.setVoltage(0.2, fermi=0.05)
    built = negfe_from_arrays(
        own.F_eV, own.S, own.P, own.locs, 8, (own.l_ind, own.r_ind),
        own._sig1, own._sig2, 0.05, 0.2, own.Emin, 32, 16, own.Nnegf,
        backend=_backend(TightBindingFock, "g"), spin="g", device=CPU,
        name=str(tmp_path / "built"))
    assert built.spin == "g" and abs(built.nelec - own.nelec) < 1e-12
    own.FockToP()
    built.FockToP()
    assert np.max(np.abs(built.P - own.P)) < 1e-12


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spin", ["r"] + LAYOUTS)
def test_which_route_serves_each_layout(spin):
    """On the default configuration the spectral route serves the sums of
    every layout in both packages: TightBindingFock's matrices are real
    and symmetric in all four ('g' carries a transverse field, sigma_x),
    and both the SCF classes' provider and transport's wrapped providers
    expose contact_inds.  No layout is declined as such: a pencil with a
    non-zero imaginary part (a sigma_y term) is, for any layout.  The
    spin channels of T(E) and the DOS need the full G and run on the LU
    route in both packages."""
    n = 8
    be = _backend(TightBindingFock, spin)
    F, _ = be.fock(be.initial_density())
    S = be.overlap()
    locs = np.abs(be.locs)
    inds = [np.where(np.isin(locs, [1, 2]))[0],
            np.where(np.isin(locs, [n - 1, n]))[0]]
    ej = JaxEngine(F, S, JaxSigma(F, S, inds, sig1=-0.1j), JaxConfig())
    et = EnergyEngine(F, S, ConstantSelfEnergy(F, S, inds, sig1=-0.1j),
                      ExecutionConfig(), device=CPU)
    assert ej._spectral_runner() is not None
    assert et.route("gr") == Route("spectral")
    if spin == "r":
        return
    s1 = -0.1j * np.diag((np.arange(n) < 2) * 1.0)
    s2 = -0.1j * np.diag((np.arange(n) >= n - 2) * 1.0)
    Fj, Sj, pj = jtr._prep_spin(F, S, jtr.SigmaSource(s1, s2), spin)
    Ft, St, pt = tr._prep_spin(F, S, tr.SigmaSource(s1, s2), spin)
    assert np.array_equal(Ft, Fj) and np.array_equal(St, Sj)
    assert pt.contact_inds(None) == pj.contact_inds(None)
    assert pt.contact_inds(0) == pj.contact_inds(0)
    assert pt.contact_inds(-1) == pj.contact_inds(-1)
    assert JaxEngine(Fj, Sj, pj, JaxConfig())._spectral_runner() is not None
    wrapped = EnergyEngine(Ft, St, pt, ExecutionConfig(), device=CPU)
    assert wrapped.route("gr") == Route("spectral")
    # a complex pencil declines whatever the layout
    Fc = F.astype(complex)
    Fc[0, 1] += 0.1j
    Fc[1, 0] -= 0.1j
    assert EnergyEngine(Fc, S, ConstantSelfEnergy(Fc, S, inds, sig1=-0.1j),
                        ExecutionConfig(), device=CPU
                        ).route("gr") == Route("lu")
    assert JaxEngine(Fc, S, JaxSigma(Fc, S, inds, sig1=-0.1j),
                     JaxConfig())._spectral_runner() is None


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

def _golden_u():
    H = GOLD["dens_H"]
    n = H.shape[0]
    H2 = np.block([[H, np.zeros_like(H)],
                   [np.zeros_like(H), H + 0.2 * np.eye(n)]])
    return H2, np.eye(2 * n), n


@pytest.mark.parametrize("sigmas", ["full", "expanded_from_nxn"])
def test_unrestricted_golden(sigmas):
    H2, S2, n = _golden_u()
    s1, s2 = GOLD["trans_sig1"], GOLD["trans_sig2"]
    if sigmas == "full":
        s1, s2 = np.kron(np.eye(2), s1), np.kron(np.eye(2), s2)
    Tu, Tspin = tr.calculate_transmission(
        H2, S2, tr.SigmaSource(s1, s2), GOLD["trans_E"], spin="u",
        exec_cfg=EXACT, device=CPU)
    assert np.max(np.abs(Tu - GOLD["trans_Tu"])) < T_BOUND
    assert np.max(np.abs(Tspin - GOLD["trans_Tspin"])) < T_BOUND


def test_generalized_layout_is_a_permutation_of_the_block_one():
    """The golden block system, interleaved: the same channels, and the
    per-site DOS comes back in the interleaved ordering."""
    H2, S2, n = _golden_u()
    perm = np.argsort(spinmod.spinor_block_perm(n))   # block -> interleaved
    Hg = H2[np.ix_(perm, perm)]
    src = tr.SigmaSource(GOLD["trans_sig1"], GOLD["trans_sig2"])
    E = GOLD["trans_E"]
    Tg, Tspin = tr.calculate_transmission(Hg, S2, src, E, spin="g",
                                          exec_cfg=EXACT, device=CPU)
    assert np.max(np.abs(Tg - GOLD["trans_Tu"])) < T_BOUND
    assert np.max(np.abs(Tspin - GOLD["trans_Tspin"])) < T_BOUND
    du, site_u, spin_u = tr.calculate_dos(H2, S2, src, E, spin="u",
                                          exec_cfg=EXACT, device=CPU)
    dg, site_g, spin_g = tr.calculate_dos(Hg, S2, src, E, spin="g",
                                          exec_cfg=EXACT, device=CPU)
    assert np.max(np.abs(site_g - site_u[:, perm])) < T_BOUND
    assert np.max(np.abs(spin_g - spin_u)) < T_BOUND
    assert np.max(np.abs(spin_u[:, 0] - spin_u[:, 1])) > 1e-3


def _scf_state(spin):
    """F of a few analytic SCF cycles in the layout (complex for 'g'),
    from the JAX package, and N x N contact sigmas."""
    n = 8
    d = JaxNEGF(_backend(JaxFock, spin), spin=spin, name="unused",
                verbose=False)
    d.setSigma([1], [n], sig=-0.2j)
    d.setVoltage(0.0, fermi=0.0)
    d.SCF(conv=1e-12, damping=0.1, max_cycles=4, checkpoint=False)
    s1 = np.zeros((n, n), complex)
    s1[0, 0] = -0.2j
    s2 = np.zeros((n, n), complex)
    s2[-1, -1] = -0.2j
    return np.asarray(d.F), np.asarray(d.S), s1, s2


@pytest.fixture(scope="module")
def jax_spin_transport():
    out = {}
    E = np.linspace(-2, 2, 13)
    for spin in LAYOUTS:
        F, S, s1, s2 = _scf_state(spin)
        src = jtr.SigmaSource(s1, s2)
        chain = JaxChain(F, S, [np.arange(2), np.arange(14, 16)], eta=1e-3)
        out[spin] = {
            "state": (F, S, s1, s2), "E": E,
            "T": jtr.calculate_transmission(F, S, src, E, spin=spin,
                                            exec_cfg=JLU),
            "dos": jtr.calculate_dos(F, S, src, E, spin=spin, exec_cfg=JLU),
            "I": jtr.calculate_current(F, S, src, 0.0, 0.3, T=300.0,
                                       spin=spin, dE=0.02, exec_cfg=JLU),
            "T_chain": jtr.calculate_transmission(
                F, S, jtr.SigmaSource(chain), E, spin=spin, exec_cfg=JLU),
            "T1": jtr.transmission_single_energy(0.3, F, S, src, spin=spin,
                                                 exec_cfg=JLU),
            "dos1": jtr.dos_single_energy(0.3, F, S, src, spin=spin,
                                          exec_cfg=JLU),
        }
    return out


@pytest.mark.parametrize("spin", LAYOUTS)
def test_spin_resolved_transport_matches_jax(jax_spin_transport, spin):
    """T(E) with its four channels, total / per-site / per-spin DOS, the
    current with its channels and the single-energy probes, N x N sigmas
    expanded by the source."""
    ref = jax_spin_transport[spin]
    F, S, s1, s2 = ref["state"]
    src = tr.SigmaSource(s1, s2)
    E = ref["E"]
    kw = dict(spin=spin, exec_cfg=EXACT, device=CPU)
    T, Tspin = tr.calculate_transmission(F, S, src, E, **kw)
    assert Tspin.shape == (13, 4) and np.allclose(T, Tspin.sum(axis=1))
    assert np.max(np.abs(T - ref["T"][0])) < T_BOUND
    assert np.max(np.abs(Tspin - ref["T"][1])) < T_BOUND
    if spin == "g":                       # the transverse field flips spins
        assert np.max(Tspin[:, 1] + Tspin[:, 2]) > 1e-4
    else:
        assert np.max(np.abs(Tspin[:, 1:3])) < 1e-12
        assert np.max(np.abs(Tspin[:, 0] - Tspin[:, 3])) > 1e-3
    dos = tr.calculate_dos(F, S, src, E, **kw)
    assert dos[1].shape == (13, 16) and dos[2].shape == (13, 2)
    for got, want in zip(dos, ref["dos"]):
        assert np.max(np.abs(got - want)) < T_BOUND
    I, ch = tr.calculate_current(F, S, src, 0.0, 0.3, T=300.0, dE=0.02, **kw)
    assert abs(I - ref["I"][0]) < T_BOUND * abs(ref["I"][0])
    assert np.allclose(ch, ref["I"][1], rtol=1e-9, atol=1e-20)
    assert tr.calculate_current(F, S, src, 0.0, 0.0, **kw) == (0.0, [0.0] * 4)
    T1, ch1 = tr.transmission_single_energy(0.3, F, S, src, **kw)
    assert abs(T1 - ref["T1"][0]) < T_BOUND and len(ch1) == 4
    assert np.allclose(ch1, ref["T1"][1], atol=T_BOUND)
    d1 = tr.dos_single_energy(0.3, F, S, src, **kw)
    assert len(d1) == 4 and abs(d1[0] - ref["dos1"][0]) < T_BOUND
    for got, want in zip(d1[1:], ref["dos1"][1:]):
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) < T_BOUND


@pytest.mark.parametrize("spin", LAYOUTS)
def test_energy_dependent_provider_at_full_size(jax_spin_transport, spin):
    """A 1D-chain provider built on the 2N x 2N matrices needs no
    expansion ('g' still permutes it)."""
    ref = jax_spin_transport[spin]
    F, S, _, _ = ref["state"]
    chain = Chain1DSelfEnergy(F, S, [np.arange(2), np.arange(14, 16)],
                              eta=1e-3)
    res = tr.cohTransSpinE(ref["E"], F, S, chain, spin=spin, exec_cfg=EXACT,
                           device=CPU)
    assert np.max(np.abs(res[0] - ref["T_chain"][0])) < T_BOUND
    assert np.max(np.abs(res[1] - ref["T_chain"][1])) < T_BOUND


@pytest.mark.parametrize("spin", ["u", "g"])
def test_legacy_spin_api(jax_spin_transport, spin):
    ref = jax_spin_transport[spin]
    F, S, s1, s2 = ref["state"]
    kw = dict(exec_cfg=EXACT, device=CPU)
    T, Tspin = tr.cohTransSpin(ref["E"], F, S, s1, s2, spin=spin, **kw)
    assert isinstance(T, list)
    assert np.max(np.abs(Tspin - ref["T"][1])) < T_BOUND
    ch = tr.currentSpin(F, S, s1, s2, 0.0, 0.3, T=300.0, spin=spin, dE=0.02,
                        **kw)
    assert np.allclose(ch, ref["I"][1], rtol=1e-9, atol=1e-20)
    n = s1.shape[0]
    assert tr.currentSpin(F[:n, :n], S[:n, :n], s1, s2, 0.0, 0.3, spin="r",
                          dE=0.05, **kw) == [0, 0, 0, 0]
    Tr, zeros = tr.cohTransSpin(ref["E"][:3], F[:n, :n], S[:n, :n], s1, s2,
                                spin="r", **kw)
    assert len(Tr) == 3 and not zeros.any()


@pytest.mark.parametrize("spin", ["u", "g"])
def test_spin_checkpoint_resume(jax_spin_transport, tmp_path, spin):
    """The spin sweeps checkpoint spin_transmission (n, 4) and dos_spin
    (n, 2) too; a resumed sweep fills only the placeholders."""
    ref = jax_spin_transport[spin]
    F, S, s1, s2 = ref["state"]
    src = tr.SigmaSource(s1, s2)
    E = ref["E"]
    kw = dict(spin=spin, exec_cfg=EXACT, device=CPU)
    path = str(tmp_path / "t.npz")
    part, part4 = ref["T"][0].copy(), ref["T"][1].copy()
    part[5:], part4[5:] = -1, -1
    part4[:5] += 7.0                      # marks what must not be recomputed
    np.savez(path, transmission=part, spin_transmission=part4, energy_list=E)
    T, Tspin = tr.calculate_transmission(F, S, src, E, checkpoint_file=path,
                                         checkpoint_interval=4, **kw)
    assert np.max(np.abs(T - ref["T"][0])) < T_BOUND
    assert np.max(np.abs(Tspin[5:] - ref["T"][1][5:])) < T_BOUND
    assert np.array_equal(Tspin[:5], part4[:5])
    saved = np.load(path)
    assert saved["spin_transmission"].shape == (13, 4)
    assert np.all(saved["transmission"] != -1)
    path = str(tmp_path / "d.npz")
    tot, site, dspin = (x.copy() for x in ref["dos"])
    tot[6:], site[6:], dspin[6:] = -1, -1, -1
    np.savez(path, dos_total=tot, dos_per_site=site, dos_spin=dspin,
             energy_list=E)
    res = tr.calculate_dos(F, S, src, E, checkpoint_file=path, **kw)
    for got, want in zip(res, ref["dos"]):
        assert np.max(np.abs(got - want)) < T_BOUND
    assert np.load(path)["dos_spin"].shape == (13, 2)


def test_default_config_spin_sweep_runs_the_mixed_lu(jax_spin_transport):
    """On ExecutionConfig() the spin channels come from the mixed tier's
    full G (complex64 LU refined once): 2e-6 of the largest value, the
    tier's contract in tests/test_torch_transport.py."""
    ref = jax_spin_transport["g"]
    F, S, s1, s2 = ref["state"]
    T, Tspin = tr.calculate_transmission(F, S, tr.SigmaSource(s1, s2),
                                         ref["E"], spin="g", device=CPU)
    assert np.max(np.abs(Tspin - ref["T"][1])) < 2e-6 * np.max(ref["T"][1])
