"""NEGFE.setContactBethe, transport and interop of gaunegf_tpu_torch on
the 56-orbital Bethe junction of tests/test_bethe_scf.py against the JAX
package (x64, CPU): the SCF density cycle for cycle to 1e-6 of max |P|
(and to 1e-5 once Pulay mixing has set in), T(E) and DOS to 1e-6."""

import inspect

from gaunegf_tpu import transport as jtr
from gaunegf_tpu.scfe import NEGFE as JaxNEGFE
from gaunegf_tpu_torch import interop
from gaunegf_tpu_torch import transport as tr
from gaunegf_tpu_torch.scfe import NEGFE
import numpy as np
import pytest
import torch

from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models import bethe as jbt
from gaunegf_tpu.models.fock import TightBindingFock as JaxFock
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models import bethe as bt
from gaunegf_tpu_torch.models.fock import TightBindingFock
from gaunegf_tpu_torch.ops import greens
from test_torch_bethe import (                      # helpers, no tests
    CONTACTS, _default_policy, _junction, _rel, jax_calc_fermi)

torch.set_num_threads(1)
CPU = torch.device("cpu")

# ---------------------------------------------------------------------------
# NEGFE.setContactBethe, transport, interop
# ---------------------------------------------------------------------------

def test_set_contact_bethe_signature():
    assert str(inspect.signature(NEGFE.setContactBethe)) \
        == str(inspect.signature(JaxNEGFE.setContactBethe))


@pytest.fixture(scope="module")
def scf_pair(tmp_path_factory):
    """The 56-orbital junction's SCF (N1=48, N2=24) in both packages on
    the same explicit energy chunk (the automatic chunks differ, and with
    them which energy seeds which): 5 damped cycles, whose densities are
    kept, then on to 40 cycles with Pulay mixing."""
    tmp = tmp_path_factory.mktemp("bethe_scf")
    jbe, jgeom = _junction(JaxFock, jbt.BetheGeometry)
    ref = JaxNEGFE(jbe, name=str(tmp / "jax"), verbose=False,
                   exec_cfg=JaxConfig(energy_chunk=16))
    ref.setContactBethe(CONTACTS, lat_file="demo", eta=1e-5, T=0.0,
                        geometry=jgeom, fermi=0.0)
    ref.setIntegralLimits(N1=48, N2=24)
    ref.setVoltage(0.0, fermi=0.0)
    ref.SCF(conv=1e-12, damping=0.05, max_cycles=4, pulay=False,
            checkpoint=False)
    ref.P_damped = ref.P.copy()
    ref.SCF(conv=5e-3, damping=0.05, max_cycles=40)
    be, geom = _junction(TightBindingFock, bt.BetheGeometry)
    mp = pytest.MonkeyPatch()
    mp.setattr(greens.EnergyEngine, "_tight", lambda self: False)
    try:
        port = NEGFE(be, name=str(tmp / "port"), device="cpu", verbose=False,
                     exec_cfg=ExecutionConfig(precision="exact", solver="lu",
                                              energy_chunk=16))
        port.setContactBethe(CONTACTS, lat_file="demo", eta=1e-5, T=0.0,
                             geometry=geom, fermi=0.0)
        port.setIntegralLimits(N1=48, N2=24)
        port.setVoltage(0.0, fermi=0.0)
        port.SCF(conv=1e-12, damping=0.05, max_cycles=4, pulay=False,
                 checkpoint=False)
        port.P_damped = port.P.copy()
        port.SCF(conv=5e-3, damping=0.05, max_cycles=40)
    finally:
        mp.undo()
    return port, ref


def test_bethe_contact_scf_matches_jax(scf_pair):
    """Cycle for cycle the density is within 1e-6 of max |P| of the JAX
    run (5 damped cycles).  With Pulay mixing both converge, to within
    1e-5: a Pulay step is taken only where sum |coeff| < 1e3 on an
    ill-conditioned Gram matrix, a gate that rounding flips (here the JAX
    run takes the step at cycle 24 and the port at 29), so the two runs
    reach the fixed point along different paths."""
    port, ref = scf_pair
    assert port.conv_level < 5e-3 and ref.conv_level < 5e-3
    assert np.isfinite(port.P).all()
    assert port.Emin == pytest.approx(ref.Emin, abs=1e-9)
    assert np.array_equal(port.l_ind, ref.l_ind)
    assert np.array_equal(port.r_ind, ref.r_ind)
    assert _rel(port.P_damped, ref.P_damped) < 1e-6
    assert _rel(port.P, ref.P) < 1e-5
    occ = np.real(np.diag(port.P))
    assert occ[27] > occ[28] > 0


def test_bethe_transmission_matches_jax(scf_pair, _default_policy):
    port, ref = scf_pair
    E = np.linspace(-10, -6, 9)
    cfg = ExecutionConfig(precision="exact", solver="lu", energy_chunk=4)
    T = tr.calculate_transmission(port.F_eV, port.S, tr.SigmaSource(port.g),
                                  E, exec_cfg=cfg, device="cpu")
    Tj = jtr.calculate_transmission(ref.F_eV, ref.S, jtr.SigmaSource(ref.g),
                                    E, exec_cfg=JaxConfig(energy_chunk=4))
    assert T.shape == (9,) and np.all(T >= -1e-8) and T.max() > 1e-6
    assert np.abs(T - Tj).max() < 1e-6
    dos, _ = tr.calculate_dos(port.F_eV, port.S, tr.SigmaSource(port.g), E,
                              exec_cfg=cfg, device="cpu")
    dj, _ = jtr.calculate_dos(ref.F_eV, ref.S, jtr.SigmaSource(ref.g), E,
                              exec_cfg=JaxConfig(energy_chunk=4))
    assert _rel(dos, dj) < 1e-6


def test_set_contact_bethe_without_fermi(tmp_path):
    """Without a given level the contact search runs on the extended
    lattice, on the NEGFE's device."""
    be, geom = _junction(TightBindingFock, bt.BetheGeometry)
    port = NEGFE(be, name=str(tmp_path / "p"), device="cpu", verbose=False)
    port.setContactBethe(CONTACTS, lat_file="demo", eta=1e-5, geometry=geom)
    g0 = port.g.g_list[0]
    atom = bt.BetheAtomGF(g0.H, g0.Slist, g0.Vlist, g0.eta, g0.T)
    ref = jax_calc_fermi(atom, port.g.params_sk.ne / 2, 1e-3, tmp_path)
    assert abs(port.g.fermi - ref) < 1e-2       # 10 tol: the JAX search
    assert -5.5 < ref < -4.5
    assert all(g.fermi == port.g.fermi for g in port.g.g_list)


@pytest.mark.parametrize("blocks", ["zero", "lattice"])
def test_window_density_against_sigma_convergence(blocks, tmp_path,
                                                  monkeypatch):
    """What the default tiers' conv = 1e-5 costs, on the exact-tier LU so
    that only sigma's stopping differs.  With the contact atoms' onsite
    blocks left at zero (tests/test_bethe_scf.py's junction) their 54
    levels sit in the bias window at E = 0, outside the lattice's bands,
    a few eta wide: the window's G Gamma G+ then follows sigma's sixth
    digit and the biased density moves by percents between conv 1e-5 and
    1e-11, in both packages alike (they stop alike).  With the lattice's
    onsite blocks on the contact atoms it moves by under 1e-5."""
    from gaunegf_tpu_torch.models import slater_koster as sk

    def density(tight):
        be, geom = _junction(TightBindingFock, bt.BetheGeometry)
        if blocks == "lattice":
            for a in (0, 9, 18, 29, 38, 47):
                be.H0[a:a + 9, a:a + 9] = sk.parse_bethe_file("demo").h0()
        with monkeypatch.context() as mp:
            if not tight:
                mp.setattr(greens.EnergyEngine, "_tight", lambda self: False)
            negfe = NEGFE(be, name=str(tmp_path / f"s{tight}"), device="cpu",
                          verbose=False, exec_cfg=ExecutionConfig(
                              precision="exact", solver="lu"))
            negfe.setContactBethe(CONTACTS, lat_file="demo", eta=1e-5,
                                  geometry=geom, fermi=0.0)
            negfe.setIntegralLimits(N1=48, N2=24)
            negfe.setVoltage(0.1, fermi=0.0)
            negfe.FockToP()
            return negfe.P.copy()

    moved = _rel(density(False), density(True))
    if blocks == "zero":
        assert 1e-3 < moved < 1.0
    else:
        assert moved < 1e-5


def test_negfe_from_arrays_takes_a_bethe_provider(scf_pair, tmp_path):
    port, ref = scf_pair
    ps = ref.g.params_sk
    prov = interop.bethe_self_energy_from_arrays(
        ref.F_eV, ref.S, ps.ne, ps.onsite, ps.hopping, ps.overlap,
        ref.g.inds_lists, ref.g.n_ind_lists, ref.g.dir_lists, ref.g.fermi,
        ref.g.spin, ref.g.eta, ref.g.T, device="cpu")
    negfe = interop.negfe_from_arrays(
        ref.F_eV, ref.S, ref.P, ref.locs, 2.0, (ref.l_ind, ref.r_ind), None,
        None, 0.0, 0.0, ref.Emin, 48, 24, None, device="cpu",
        name=str(tmp_path / "arr"), provider=prov)
    assert negfe.g is prov
    assert _rel(negfe.g.sigmaTot(-7.5), ref.g.sigmaTot(-7.5)) < 1e-10
    negfe.FockToP()
    assert np.isfinite(negfe.P).all()


@pytest.mark.parametrize("spin", ["r", "u", "ro", "g"])
def test_sigma_source_takes_a_bethe_provider(spin):
    """The provider expands itself (spin is in its static key), so
    transport's wrappers must not expand it a second time; 'g' is only
    permuted to block layout.  T(E) against the JAX package."""
    n = 56
    be, geom = _junction(TightBindingFock, bt.BetheGeometry)
    _, jgeom = _junction(JaxFock, jbt.BetheGeometry)
    H = be.H0
    if spin == "r":
        F, S = H, np.eye(n)
    elif spin == "g":
        F, S = np.kron(H, np.eye(2)), np.eye(2 * n)
    else:
        F, S = np.kron(np.eye(2), H), np.eye(2 * n)
    own = bt.BetheSelfEnergy(F, S, CONTACTS, geom, lat_file="demo",
                             spin=spin, eta=1e-5, fermi=0.0, device="cpu",
                             verbose=False)
    jp = jbt.BetheSelfEnergy(F, S, CONTACTS, jgeom, lat_file="demo",
                             spin=spin, eta=1e-5, fermi=0.0, verbose=False)
    src = tr.SigmaSource(own)
    assert src.energy_dependent
    prov = src.provider_for(spin, F.shape[0])
    assert prov is own                          # not expanded again
    _, _, wrapped = tr._prep_spin(F, S, src, spin)
    assert (wrapped is own) == (spin != "g")
    if spin == "g":                             # conv passes through
        fn, _ = wrapped.total_apply(conv=bt.TIGHT_CONV)
        assert fn is not wrapped.total_apply()[0] and wrapped.iterated
    assert src.get_sigma_total(-7.5, spin, F.shape[0],
                               device="cpu").shape == F.shape
    E = np.linspace(-9.0, -6.5, 4)
    cfg = ExecutionConfig(solver="lu", energy_chunk=4)
    out = tr.calculate_transmission(F, S, src, E, spin=spin, exec_cfg=cfg,
                                    device="cpu")
    ref = jtr.calculate_transmission(F, S, jtr.SigmaSource(jp), E, spin=spin,
                                     exec_cfg=JaxConfig(energy_chunk=4,
                                                        solver="lu"))
    if spin == "r":
        assert np.abs(out - ref).max() < 1e-4       # mixed tier, warm
    else:
        assert np.abs(out[0] - ref[0]).max() < 1e-4
        assert np.abs(out[1] - ref[1]).max() < 1e-4
