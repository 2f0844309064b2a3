"""A biased NEGFE in both packages: first density, then SCF cycles.

The JAX NEGFE is set up the README way (TightBindingFock chain n=48,
constant contacts, fixed Fermi level, bias 0.1 V) and runs under x64
(complex128 LAPACK: the truth).  The port's NEGFE is rebuilt from its
NumPy state through ``interop.negfe_from_arrays`` and runs the mixed tier
on the CPU.  The density is a sum over ~100 grid points of G(E) held to
~6e-8 each, so the first density must agree to 1e-6 of its largest
entry; three SCF cycles of damped/Pulay mixing (linear in the densities)
and the Hubbard Fock rebuild keep that to 1e-5.
"""

import numpy as np
import pytest
import torch

from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models.fock import TightBindingFock as JaxFock
from gaunegf_tpu.scfe import NEGFE as JaxNEGFE
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.interop import negfe_from_arrays
from gaunegf_tpu_torch.models.fock import TightBindingFock
from gaunegf_tpu_torch.scfe import NEGFE

n = 48
P_REL = 1e-6
SCF_REL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    t = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(t)


def _h0():
    return -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))


def _jax_negfe(tmp_path):
    be = JaxFock(_h0(), n_electrons=n, U=0.5, n0=0.5 * np.ones(n))
    negfe = JaxNEGFE(be, name=str(tmp_path / "jax"), verbose=False,
                     exec_cfg=JaxConfig(solver="lu"))
    negfe.setSigma([1, 2], [n - 1, n], sig=-0.1j)
    negfe.setIntegralLimits(N1=32, N2=16)
    negfe.setVoltage(0.1, fermi=0.0)
    return negfe


def _port_from(jax_negfe, tmp_path):
    return negfe_from_arrays(
        jax_negfe.F_eV, jax_negfe.S, jax_negfe.P, jax_negfe.locs,
        jax_negfe.backend.n_electrons, (jax_negfe.l_ind, jax_negfe.r_ind),
        jax_negfe._sig1, jax_negfe._sig2, jax_negfe.fermi, jax_negfe.qV,
        jax_negfe.Emin, jax_negfe.N1, jax_negfe.N2, jax_negfe.Nnegf,
        backend=TightBindingFock(_h0(), n_electrons=n, U=0.5,
                                 n0=0.5 * np.ones(n)),
        T=jax_negfe.T, Eminf=jax_negfe.Eminf, device="cpu",
        exec_cfg=ExecutionConfig(solver="lu", lu_panel="pstrip"),
        name=str(tmp_path / "port"))


def _rel(x, ref):
    return np.max(np.abs(x - ref)) / np.max(np.abs(ref))


def test_first_density_matches_jax(tmp_path):
    ref = _jax_negfe(tmp_path)
    port = _port_from(ref, tmp_path)
    ref.FockToP()
    port.FockToP()
    assert np.isfinite(port.P).all()
    assert _rel(port.P, ref.P) < P_REL


def test_scf_cycles_match_jax(tmp_path):
    ref = _jax_negfe(tmp_path)
    port = _port_from(ref, tmp_path)
    kw = dict(conv=1e-5, damping=0.05, max_cycles=3, checkpoint=False,
              pulay=True)
    c_ref, e_ref, en_ref = ref.SCF(**kw)
    c_port, e_port, en_port = port.SCF(**kw)
    assert c_port == c_ref
    assert _rel(port.P, ref.P) < SCF_REL
    assert np.allclose(e_port, e_ref, rtol=SCF_REL, atol=0)
    assert np.allclose(en_port, en_ref, rtol=SCF_REL, atol=0)
    assert np.max(np.abs(port.P - port.P.conj().T)) < 1e-10


def test_port_setup_matches_jax_setup(tmp_path):
    """The port's own setSigma / setIntegralLimits / setVoltage give the
    JAX package's state: contacts, sigmas, Emin search and grids."""
    ref = _jax_negfe(tmp_path)
    be = TightBindingFock(_h0(), n_electrons=n, U=0.5, n0=0.5 * np.ones(n))
    port = NEGFE(be, name=str(tmp_path / "own"), verbose=False,
                 device="cpu")
    port.setSigma([1, 2], [n - 1, n], sig=-0.1j)
    port.setIntegralLimits(N1=32, N2=16)
    port.setVoltage(0.1, fermi=0.0)
    assert np.array_equal(port.l_ind, ref.l_ind)
    assert np.array_equal(port.r_ind, ref.r_ind)
    assert np.array_equal(port.g.params()["sigs"], ref.g.params()["sigs"])
    assert port.Emin == ref.Emin
    assert (port.N1, port.N2, port.Nnegf) == (ref.N1, ref.N2, ref.Nnegf)
    assert (port.mu1, port.mu2) == (ref.mu1, ref.mu2)
    assert np.allclose(port.X, ref.X, atol=1e-12)
    assert np.allclose(port.g.sigmaTot(0.3), ref.g.sigmaTot(0.3), atol=1e-15)


def test_equilibrium_density_matches_jax(tmp_path):
    """Without bias FockToP takes the fused equilibrium build."""
    ref = _jax_negfe(tmp_path)
    ref.setVoltage(0.0, fermi=0.0)
    port = _port_from(ref, tmp_path)
    ref.FockToP()
    port.FockToP()
    assert _rel(port.P, ref.P) < P_REL


def test_unported_paths_raise(tmp_path):
    """What the package still lacks says so: an unknown spin layout is
    refused; the XLA panel names of the JAX package, the Bethe contacts
    (setContactBethe, with the JAX package's signature), the Fermi
    searches, the adaptive grids and the spin layouts, which used to raise
    or be absent here, run (each panel name's inverse equal to the JAX
    package's on the same name)."""
    import inspect
    import jax.numpy as jnp
    import torch
    from gaunegf_tpu.ops import zlinalg as jzl
    from gaunegf_tpu.scfe import NEGFE as JaxNEGFE
    from gaunegf_tpu_torch.ops import zlinalg as zl
    be = TightBindingFock(_h0(), n_electrons=n, U=0.5, n0=0.5 * np.ones(n))
    with pytest.raises(ValueError, match="spin"):
        NEGFE(be, spin="x", device="cpu", verbose=False)
    A = (torch.eye(4, dtype=torch.complex64) * (2 + 1j)
         + torch.ones(4, 4, dtype=torch.complex64))[None]
    for panel in ("split", "psplit", "virtual", "xla"):
        X = zl.zinv(A, method="blocked", panel_impl=panel).numpy()
        X_j = np.asarray(jzl.zinv(jnp.asarray(A.numpy()), method="blocked",
                                  panel_impl=panel))
        assert np.abs(X - X_j).max() < 1e-6
    port = NEGFE(be, name=str(tmp_path / "x"), device="cpu", verbose=False)
    assert str(inspect.signature(port.setContactBethe)) == str(
        inspect.signature(JaxNEGFE.setContactBethe)).replace("(self, ", "(")
    port.setSigma([1, 2], [n - 1, n], sig=-0.1j)
    assert (port.N1, port.N2, port.Nnegf) == (None, None, None)
    port.setVoltage(0.1)                  # fermi=nan -> Fermi search
    assert port.upd_fermi and port.fermi_method == "muller"
    port.FockToP()                        # adaptive grids, Muller search
    assert np.isfinite(port.P).all()
    assert abs(np.einsum("ij,ji->", port.P, port.S).real - n / 2) < 0.05
