"""The port's examples (gaunegf_tpu_torch/examples/) on the CPU.

Each runs through its ``main(device='cpu')`` and returns the numbers it
prints.  Where the JAX example runs in a few seconds and writes no file
(au_electrode_kspace: ~3 s) its printed numbers are captured here, under
conftest's x64, and the port's returned ones are held to them at the
printed precision.  The others are held to what the physics bounds: finite
numbers, transmissions between 0 and the channel count, electron counts
near the filling.  (integral_demo, si_nanowire_scf and tb_chain_transport
write their files to fixed paths under /tmp in the JAX package, and
reference_migration takes ~20 s there.)
"""

import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from gaunegf_tpu_torch.compat import _device
from gaunegf_tpu_torch.examples import EXAMPLES

PORT_ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One torch thread; the facade's device restored and no gauNEGF
    module left behind for the next file of this xdist worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setitem(_device._state, "device", _device._state["device"])
    try:
        yield
    finally:
        torch.set_num_threads(n)
        for k in [k for k in sys.modules if k.split(".")[0] == "gauNEGF"]:
            del sys.modules[k]


def _run(name):
    import importlib
    return importlib.import_module(
        f"gaunegf_tpu_torch.examples.{name}").main("cpu")


def test_au_electrode_kspace_matches_the_jax_example(capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_au_example", PORT_ROOT / "examples" / "au_electrode_kspace.py")
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)
    jax_example.main()
    printed = capsys.readouterr().out
    ref = [float(x) for x in re.findall(r"E_F = ([0-9.]+) eV", printed)]
    pct = float(re.search(r"difference: ([0-9.]+)%", printed).group(1))
    got = _run("au_electrode_kspace")
    assert len(ref) == 2
    assert abs(got["bethe_gamma_max"] - ref[0]) <= 5e-5 + 1e-12
    assert abs(got["kspace_gamma_max"] - ref[1]) <= 5e-5 + 1e-12
    assert abs(100 * got["rel_diff"] - pct) <= 0.05 + 1e-12


def test_integral_demo():
    out = _run("integral_demo")
    for key in ("negf", "negfe"):
        assert out[key]["conv"] < 1e-4
        assert abs(out[key]["nelec"] - 16) < 0.05
        assert abs(out[key]["fermi"]) < 0.5
    assert 0 < out["dP"] < 1e-2
    currents = [i for _, i in out["iv"]]
    assert all(np.isfinite(currents)) and 0 < currents[0] < currents[1] \
        < currents[2]


def test_reference_migration():
    out = _run("reference_migration")
    assert 0 < out["T0"] <= 1 + 1e-9            # one chain channel
    assert 0 < out["T0_static"] <= 3 + 1e-9     # 3 contact orbitals
    assert out["dos0"] > 0
    assert abs(out["ne"] - 10) < 0.5            # half filling of 20 sites


def test_si_nanowire_scf():
    out = _run("si_nanowire_scf")
    assert np.isfinite(out["fermi"]) and -5 < out["fermi"] < 5
    assert 0.9 < out["max_T1"] <= 1 + 1e-6
    assert 0.9 < out["max_T2"] <= 1 + 1e-6
    assert out["conv2"] < 1e-3
    assert np.isfinite(out["conv3"])


def test_tb_chain_transport_on_a_world_of_one_rank():
    import torch.distributed as dist
    try:
        out = _run("tb_chain_transport")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert out["ranks"] == 1
    assert 0.9 < out["max_T"] <= 1 + 1e-6
    assert 0 < out["dos_integral"] <= 64 + 1
    assert np.isfinite(out["current"]) and out["current"] > 0


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_refuse_a_missing_gpu(name):
    """--device defaults to 'cuda', and without a GPU the example raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    code = (f"from gaunegf_tpu_torch.examples import {name} as ex, cli; "
            "cli(ex.main, ex.__doc__, [])")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(PORT_ROOT))
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr or "cuda" in proc.stderr
