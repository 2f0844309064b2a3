"""gaunegf_tpu_torch stands alone: it imports without JAX and names none."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

PORT = pathlib.Path(__file__).resolve().parents[1] / "gaunegf_tpu_torch"
SLICE_MODULES = [
    "gaunegf_tpu_torch", "gaunegf_tpu_torch.config", "gaunegf_tpu_torch.units",
    "gaunegf_tpu_torch.quadrature", "gaunegf_tpu_torch.ops.kernels._build",
    "gaunegf_tpu_torch.ops.kernels.strip_elim",
    "gaunegf_tpu_torch.ops.kernels.panel_fused",
    "gaunegf_tpu_torch.ops.kernels.panel_lu",
    "gaunegf_tpu_torch.ops.kernels.fixed_point",
    "gaunegf_tpu_torch.ops.kernels.sancho_rubio",
    "gaunegf_tpu_torch.models.chain1d", "gaunegf_tpu_torch.transport",
    "gaunegf_tpu_torch.ops.zlinalg", "gaunegf_tpu_torch.models.selfenergy",
    "gaunegf_tpu_torch.models.fock", "gaunegf_tpu_torch.ops.spectral",
    "gaunegf_tpu_torch.ops.greens",
    "gaunegf_tpu_torch.density", "gaunegf_tpu_torch.io.checkpoint",
    "gaunegf_tpu_torch.scf", "gaunegf_tpu_torch.scfe",
    "gaunegf_tpu_torch.interop", "gaunegf_tpu_torch.tune",
    "gaunegf_tpu_torch.fermi", "gaunegf_tpu_torch.spin",
    "gaunegf_tpu_torch.fermi_search_dos",
    "gaunegf_tpu_torch.models.slater_koster",
    "gaunegf_tpu_torch.models.harrison", "gaunegf_tpu_torch.models.bethe",
    "gaunegf_tpu_torch.models.kspace", "gaunegf_tpu_torch.models.lattice3d",
    "gaunegf_tpu_torch.io.gaussian", "gaunegf_tpu_torch.utils",
    "gaunegf_tpu_torch.utils.logging", "gaunegf_tpu_torch.compat",
    "gaunegf_tpu_torch.parallel", "gaunegf_tpu_torch.parallel.mesh",
    "gaunegf_tpu_torch.parallel.launch", "gaunegf_tpu_torch.entry",
    "gaunegf_tpu_torch.examples",
] + [f"gaunegf_tpu_torch.examples.{m}" for m in (
    "au_electrode_kspace", "integral_demo", "reference_migration",
    "si_nanowire_scf", "tb_chain_transport")] + [
    f"gaunegf_tpu_torch.compat.{m}" for m in (
    "_device", "config", "density", "fermiSearch", "integrate", "matTools",
    "scf", "scfE", "surfG1D", "surfG3D", "surfGBethe", "surfGTester",
    "transport", "utils")]
NO_JAX = ("assert not any(m.split('.')[0] in ('jax', 'jaxlib', 'gaunegf_tpu') "
          "for m, v in sys.modules.items() if v is not None), "
          "sorted(m for m in sys.modules if m.startswith(('jax', "
          "'gaunegf_tpu.')))")


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_imports_with_jax_absent(module):
    """sys.modules['jax'] = None makes any `import jax` raise."""
    code = ("import sys; sys.modules['jax'] = None; "
            f"import importlib; importlib.import_module({module!r}); "
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m, v in sys.modules.items() if v is not None)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=str(PORT.parent))
    assert proc.returncode == 0, proc.stderr


_SETUP = """
import sys; sys.modules['jax'] = None
import numpy as np, torch
torch.set_num_threads(1)
from gaunegf_tpu_torch import density as dens, fermi
from gaunegf_tpu_torch.models.chain1d import Chain1DSelfEnergy
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
n = 8
H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
S = np.eye(n)
g = ConstantSelfEnergy(H, S, [np.arange(2), np.arange(n - 2, n)], sig1=-0.1j)
"""
CALLS = {
    "density_complex": "dens.density_complex(H, S, g, -4.0, 0.2, T=300.0, "
                       "device='cpu', verbose=False)",
    "density_grid": "dens.density_grid(H, S, g, -0.2, 0.2, ind=-1, T=300.0, "
                    "device='cpu')",
    "density_grid_trap": "dens.density_grid_trap(H, S, g, -0.2, 0.2, ind=0, "
                         "N=12, T=300.0, device='cpu')",
    "get_fermi_1d_contact": (
        "a = 0.1 * np.eye(2) - (np.eye(2, k=1) + np.eye(2, k=-1)); "
        "b = np.zeros((2, 2)); b[0, -1] = -1.0; z = np.zeros((2, 2)); "
        "c = Chain1DSelfEnergy(np.kron(np.eye(3), a), np.eye(6), "
        "[np.arange(2), np.arange(4, 6)], taus=[b, b.T], staus=[z, z], "
        "alphas=[a, a], a_overlaps=[np.eye(2)] * 2, betas=[b, b], "
        "b_overlaps=[z, z], eta=1e-4); "
        "fermi.get_fermi_1d_contact(c, 1.0, 0, Eminf=-1000.0, "
        "device='cpu', verbose=False)"),
}


# the electrode models: every function whose JAX counterpart imports the
# JAX package inside its body (complexio, config, fermi, bethe, kspace)
_BETHE_SETUP = """
from gaunegf_tpu_torch.models import bethe, kspace, slater_koster as sk
from gaunegf_tpu_torch.models.lattice3d import Lattice3DSelfEnergy
p = sk.parse_bethe_file('demo')
nv = sk.fcc111_neighbor_directions(np.array([0, 0, 1.0]),
                                   np.array([1.0, 0, 0]))
Sl = np.stack([sk.bond_matrix(p.overlap, d) for d in nv])
Vl = np.stack([sk.bond_matrix(p.hopping, d) for d in nv])
d = 2.88
u1 = np.array([1.0, 0.0, 0.0]) * d
u2 = np.array([0.5, np.sqrt(3) / 2, 0.0]) * d
coords = np.stack([np.zeros(3), u1, u2, u1 + u2, np.array([1.0, 0.6, -5.0])])
geom = bethe.BetheGeometry(coords, np.repeat(np.arange(1, 6),
                                             [9, 9, 9, 9, 4]), None)
F40, S40 = np.zeros((40, 40)), np.eye(40)
E2 = torch.tensor([-2.0 + 0j, -7.5 + 0.05j])
"""
CALLS.update({
    "bethe_sigma_surface": _BETHE_SETUP
    + "out = bethe.bethe_sigma_surface(E2, p.h0(), Sl, Vl, 1e-6); "
      "assert out.shape == (2, 9, 9, 9)",
    "BetheSelfEnergy.sigmaTot": _BETHE_SETUP
    + "g = bethe.BetheSelfEnergy(F40, S40, [[1, 2, 3]], geom, 'demo', "
      "eta=1e-6, fermi=0.0, device='cpu', verbose=False); "
      "assert g.sigmaTot(-2.0).shape == (40, 40)",
    "BetheAtomGF.calc_fermi": _BETHE_SETUP
    + "a = bethe.BetheAtomGF(p.h0(), Sl, Vl, eta=1e-5); "
      "assert np.isfinite(a.calc_fermi(p.ne / 2, tol=1e-2, device='cpu', "
      "verbose=False))",
    "kspace_sigma_surface": _BETHE_SETUP
    + "pp, dp = kspace.kspace_phases(nv, 2); "
      "out = kspace.kspace_sigma_surface(E2, p.h0(), Sl, Vl, pp, dp, 1e-6); "
      "assert out[0].shape == (2, 9, 9, 9) and out[1].shape == (2, 9, 9)",
    "Lattice3DSelfEnergy.sigmaTot": _BETHE_SETUP
    + "g = Lattice3DSelfEnergy(F40, S40, [[1, 2, 3, 4]], geom, 'demo', "
      "eta=1e-6, fermi=0.0, device='cpu', verbose=False, "
      "gamma_point_only=False, nk=2); "
      "assert g.sigmaTot(-2.0).shape == (40, 40)",
})


# the Newton-Schulz chain (gr_sum and the split equilibrium sum), the
# four XLA panels through zinv, one example, and the lazy submodules
CALLS["continuation chain"] = """
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.ops.greens import EnergyEngine
from gaunegf_tpu_torch.utils.logging import recorder
E = np.linspace(-1.5, 1.5, 64) + 0.1j
with recorder.recording():
    for cont in (True, False):
        eng = EnergyEngine(H, S, g, ExecutionConfig(
            precision='strict', energy_chunk=4, continuation=cont),
            device='cpu')
        out = eng.gr_sum(E, np.ones(64)), eng.density_eq_split(
            E[:8], np.ones(8), E[8:], np.ones(56))
        if cont:
            chain = out
    assert recorder.count('chain.newton') > 0, recorder.totals().counters
# the strict gate (5e-3 on the largest entry of A X - I) and the polish
# leave ~1e-9 of the LU's sum on this grid
for a, b in zip(chain, out):
    assert np.abs(a - b).max() < 1e-8 * np.abs(b).max()
"""
CALLS["XLA panels"] = """
from gaunegf_tpu_torch.ops import zlinalg as zl
A = torch.randn(2, 80, 80, dtype=torch.complex64) + 8 * torch.eye(80)
for p in ('xla', 'virtual', 'split', 'psplit'):
    X = zl.zinv(A, bs=32, panel_impl=p)
    assert (A @ X - torch.eye(80)).abs().max() < 1e-3, p
"""
CALLS["example au_electrode_kspace"] = """
from gaunegf_tpu_torch.examples import au_electrode_kspace
out = au_electrode_kspace.main('cpu')
assert abs(out['bethe_gamma_max'] - 7.895) < 1e-3, out
"""
CALLS["lazy submodules"] = """
import gaunegf_tpu_torch as gt
assert gt.transport.__name__ == 'gaunegf_tpu_torch.transport'
assert callable(gt.fermi_search_dos.matrix_finite_difference)
assert gt.parallel.local_device_count() == torch.cuda.device_count()
try:
    gt.not_a_module
except AttributeError:
    pass
else:
    raise AssertionError('gaunegf_tpu_torch.not_a_module resolved')
"""


# the facade: a reference script on the fake gauopen, with both barred
CALLS["compat NEGFE + cohTrans"] = f"""
sys.modules['gaunegf_tpu'] = None
sys.path.insert(0, {str(PORT.parent / "tests")!r})
import fake_gauopen
fake_gauopen.install()
fake_gauopen.configure(H / 27.211386, S, ne=n, U=0.01)
import gaunegf_tpu_torch.compat as compat
compat.install(device='cpu')
from gauNEGF.scfE import NEGFE
from gauNEGF.transport import cohTrans
import tempfile
negf = NEGFE(tempfile.mkdtemp() + '/mol', basis='lanl2dz', func='b3lyp',
             verbose=False)
negf.setSigma([1, 2], [n - 1, n], sig=-0.1j)
negf.setIntegralLimits(N1=16, N2=8)
negf.setVoltage(0.1, fermi=0.0)
counts, _, _ = negf.SCF(conv=1e-12, damping=0.05, max_cycles=1,
                        checkpoint=False)
assert counts[-1] == 1 and np.isfinite(negf.P).all(), counts
assert negf.backend.bar.update_calls[-1]['dofock'] == 'DENSITY'
s1, s2 = negf.getSigma(0.0)
T = cohTrans([-0.5, 0.0, 0.5], negf.F_eV, negf.S, s1, s2)
assert len(T) == 3 and all(0 < t < 2 for t in T), T
"""


@pytest.mark.parametrize("call", list(CALLS))
def test_calls_leave_jax_and_the_jax_package_out(call):
    """The functions whose JAX counterparts import inside their bodies
    (units, config, models.chain1d): running them loads neither jax nor
    gaunegf_tpu."""
    code = _SETUP + CALLS[call] + "\n" + NO_JAX
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(PORT.parent))
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_in_source():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|gaunegf_tpu)\b", re.M)
    sources = sorted(PORT.rglob("*.py"))
    scanned = {str(p.relative_to(PORT)) for p in sources}
    assert {"io/gaussian.py", "utils/logging.py", "compat/__init__.py",
            "compat/surfG3D.py", "compat/scfE.py"} <= scanned
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []


def test_dryrun_multichip_stands_alone(tmp_path):
    """dryrun_multichip(2) on the CPU over gloo, in a process where `jax`
    and `gaunegf_tpu` are packages that refuse to import -- and so in its
    two ranks too, which inherit the path."""
    for name in ("jax", "gaunegf_tpu"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} is barred here')\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(tmp_path), str(PORT.parent)]))
    code = ("from gaunegf_tpu_torch.entry import dryrun_multichip; "
            "d = dryrun_multichip(2, device='cpu', backend='gloo'); "
            "assert set(d) >= {'scf', 'mp', 'dist', 'high', 'spectral'}")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr
    assert "dryrun_multichip OK on 2 ranks" in proc.stdout
    assert proc.stderr.count("# dryrun: leg") == 5


def test_entry_command_needs_device_and_backend():
    """`python -m gaunegf_tpu_torch.entry` with no arguments exits
    non-zero: it never picks the CPU, or a backend, for the caller."""
    proc = subprocess.run([sys.executable, "-m", "gaunegf_tpu_torch.entry"],
                          capture_output=True, text=True, timeout=120,
                          cwd=str(PORT.parent))
    assert proc.returncode != 0
    assert "--device" in proc.stderr and "--backend" in proc.stderr


@pytest.mark.parametrize("argv", [["--backend", "gloo"], ["--device", "cpu"]])
def test_entry_command_refuses_a_missing_option(argv):
    from gaunegf_tpu_torch.entry import main
    with pytest.raises(SystemExit) as exc:
        main(["--n", "2", *argv])
    assert exc.value.code != 0
