"""The 1D chain's warm interface (``Chain1DSelfEnergy.contacts_warm_apply``)
and ``warm_start="force"`` against the JAX package (x64, CPU).

The chain's warm fn solves each contact's Sancho-Rubio fixed point once
per energy and seeds nothing from the previous energy, so the warm engines
give what the cold path gives, with one solve serving Sigma_total and both
Gammas.  ``warm_profitable`` is False for chains in both packages: the
engines take the interface only under ``"force"``, and the default T(E)
stays on the cold route.  The 1e-9 comparisons with the JAX engines run
the port's complex128 ``exact`` tier with the default tier's policy
(``EnergyEngine._tight`` patched to False, as tests/test_torch_bethe.py's
``_default_policy``) on one explicit energy chunk.
"""

import os

import numpy as np
import pytest
import torch

from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models import chain1d as jchain
from gaunegf_tpu.ops.greens import EnergyEngine as JaxEngine
from gaunegf_tpu_torch import transport as tr
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models import chain1d as tchain
from gaunegf_tpu_torch.models.selfenergy import tree_map
from gaunegf_tpu_torch.ops import greens
from gaunegf_tpu_torch.ops.greens import EnergyEngine

GOLD = np.load(os.path.join(os.path.dirname(__file__), "golden",
                            "golden_v1.npz"))
CPU = torch.device("cpu")
INDS = [np.arange(4), np.arange(4, 8)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def _default_policy(monkeypatch):
    monkeypatch.setattr(greens.EnergyEngine, "_tight", lambda self: False)


def _pair(method="sancho"):
    H, S = GOLD["chain_H"], GOLD["chain_S"]
    return (H, S, tchain.Chain1DSelfEnergy(H, S, INDS, eta=1e-4,
                                           method=method, device="cpu"),
            jchain.Chain1DSelfEnergy(H, S, INDS, eta=1e-4, method=method))


def _rel(x, ref):
    return float(np.max(np.abs(np.asarray(x) - np.asarray(ref)))
                 / np.max(np.abs(ref)))


def _host(params):
    return tree_map(lambda v: torch.as_tensor(np.asarray(v, np.complex128)),
                    params)


def test_warm_interface_matches_jax():
    """Per-contact sigmas of the warm fn at three energies (a band edge
    and a gap included) against the JAX warm fn at 1e-10, the state passed
    through untouched, Sigma_total their sum."""
    _, _, g, g_j = _pair()
    wfn, params, init = g.contacts_warm_apply()
    jfn, jparams, jinit = g_j.contacts_warm_apply()
    assert len(init) == len(jinit) == 2
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(init, jinit))
    p = _host(params)
    state = tuple(torch.as_tensor(s)[None].expand(3, 4, 4) for s in init)
    E = np.array([-1.3, 0.4, 2.05])
    sigs, out = wfn(p, torch.as_tensor(E + 0j), state)
    assert all(o is s for o, s in zip(out, state))
    for k, e in enumerate(E):
        jsigs, _ = jfn(jparams, np.complex128(e), jinit)
        for i in range(2):
            assert _rel(sigs[i][k].numpy(), jsigs[i]) < 1e-10
    tot = g.total_apply()[0](p, torch.as_tensor(E + 0j))
    assert torch.equal(tot, sigs[0] + sigs[1])


def test_warm_interface_takes_conv():
    """The engines' tight tiers pass conv: the fixed point then stops
    there, as total_apply's own at that conv."""
    H, S, _, _ = _pair()
    tight = tchain.Chain1DSelfEnergy(H, S, INDS, eta=1e-4, conv=1e-12,
                                     device="cpu")
    _, _, g, _ = _pair()
    wfn, params, init = g.contacts_warm_apply(conv=1e-12)
    E = torch.tensor([0.7 + 0j])
    sigs, _ = wfn(_host(params), E, init)
    ref = tight.total_apply()[0](_host(tight.params()), E)
    assert torch.equal(sigs[0] + sigs[1], ref)


def test_dyson_has_no_warm_interface():
    _, _, g, g_j = _pair("dyson")
    assert g.contacts_warm_apply is None and g_j.contacts_warm_apply is None
    eng = EnergyEngine(g.F.real, g.S, g, ExecutionConfig(
        solver="lu", warm_start="force"), device=CPU)
    assert not eng._use_warm()


def _engines(g, g_j, H, S, chunk=8, **kw):
    port = EnergyEngine(H, S, g, ExecutionConfig(
        energy_chunk=chunk, solver="lu", precision="exact", **kw),
        device=CPU)
    jax = JaxEngine(H, S, g_j, JaxConfig(energy_chunk=chunk, solver="lu",
                                         **kw))
    return port, jax


def test_force_matches_jax_force(_default_policy):
    """T(E) and gr_sum of the warm engines under "force" against the JAX
    engines under "force" on the same chunk at 1e-9, and against the
    port's cold path ("force" against False)."""
    H, S, g, g_j = _pair()
    E = np.linspace(-1.5, 1.5, 29)
    z = np.linspace(-2.0, 2.0, 21) + 0.05j
    w = np.cos(np.arange(21)) + 0j
    port, jax = _engines(g, g_j, H, S, warm_start="force")
    cold, _ = _engines(g, g_j, H, S, warm_start=False)
    assert port._use_warm() and jax._use_warm() and not cold._use_warm()
    T, T_j, T_c = port.transmission(E), jax.transmission(E), \
        cold.transmission(E)
    assert np.max(np.abs(T - T_j)) < 1e-9 * max(1.0, np.abs(T_j).max())
    assert np.max(np.abs(T - T_c)) < 1e-11
    G, G_j = port.gr_sum(z, w), jax.gr_sum(z, w)
    assert _rel(G, G_j) < 1e-9
    assert _rel(G, cold.gr_sum(z, w)) < 1e-12
    assert _rel(port.gless_sum(z, w, 0), jax.gless_sum(z, w, 0)) < 1e-9


def test_force_engages_the_warm_engines(monkeypatch):
    """Under "force" the mixed tier's sums and T(E) run the warm engines
    (one chain solve per contact and energy); the tight tiers never do."""
    H, S, g, _ = _pair()
    calls = []
    real = EnergyEngine._warm_chunks

    def spy(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)
    monkeypatch.setattr(EnergyEngine, "_warm_chunks", spy)
    eng = EnergyEngine(H, S, g, ExecutionConfig(
        solver="lu", energy_chunk=8, warm_start="force"), device=CPU)
    eng.transmission(np.linspace(-1, 1, 9))
    eng.gr_sum(np.linspace(-1, 1, 9) + 0.1j, np.ones(9))
    assert len(calls) == 2
    for precision in ("high", "exact", "strict"):
        assert not EnergyEngine(H, S, g, ExecutionConfig(
            solver="lu", precision=precision, warm_start="force"),
            device=CPU)._use_warm()


@pytest.mark.parametrize("cfg", [
    {"solver": "lu"},
    {"precision": "mixed", "solver": "lu", "lu_panel": "fused"},
    {"precision": "high", "lu_panel": "pallas"}])
def test_default_chain_transmission_stays_cold(monkeypatch, cfg):
    """Without "force" a chain's T(E), DOS and gr_sum take the cold route:
    no warm chunk runs, and the results equal those of the same provider
    with its warm interface removed (the provider before the port had
    one)."""
    H, S, g, _ = _pair()
    bare = tchain.Chain1DSelfEnergy(H, S, INDS, eta=1e-4, device="cpu")
    bare.contacts_warm_apply = None

    def no_warm(self, *a, **kw):
        raise AssertionError("warm chunk on the default chain route")
    E = np.linspace(-1.5, 1.5, 17)
    z = E + 0.05j
    cfg = ExecutionConfig(energy_chunk=8, **cfg)
    ref_T = tr.calculate_transmission(H, S, tr.SigmaSource(bare), E,
                                      exec_cfg=cfg, device=CPU)
    ref_d, _ = tr.calculate_dos(H, S, tr.SigmaSource(bare), E,
                                exec_cfg=cfg, device=CPU)
    ref_G = EnergyEngine(H, S, bare, cfg, device=CPU).gr_sum(z, np.ones(17))
    monkeypatch.setattr(EnergyEngine, "_warm_chunks", no_warm)
    eng = EnergyEngine(H, S, g, cfg, device=CPU)
    assert eng._has_warm() and not eng._use_warm()
    assert np.array_equal(tr.calculate_transmission(
        H, S, tr.SigmaSource(g), E, exec_cfg=cfg, device=CPU), ref_T)
    assert np.array_equal(tr.calculate_dos(
        H, S, tr.SigmaSource(g), E, exec_cfg=cfg, device=CPU)[0], ref_d)
    assert np.array_equal(eng.gr_sum(z, np.ones(17)), ref_G)
