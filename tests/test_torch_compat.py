"""The reference-named facade of gaunegf_tpu_torch (``compat/``) against
the JAX package's, and the port's logging module.

Checks: (1) every public name and method of the reference's modules (the
lists of tests/test_compat.py) exists on the port's facade; (2) install()
registers ``gauNEGF`` and refuses to shadow another module of that name,
the JAX facade included; (3) the facade's device is 'cuda' unless asked,
and raises here, where there is no GPU; (4) the camelCase wrappers
delegate to the port's functions with the same arguments (equal arrays)
and agree with the JAX package on the same NumPy inputs -- against the
JAX function on its complex128 LU (x64) at the tolerances of
tests/test_torch_density.py / test_torch_fermi.py, since the port's
default route is complex128 and the JAX default route holds ~3e-7; (5)
the Gaussian-coupled NEGFE's first density, port against JAX, within
1e-6 of max |P| with constant, 1D-chain and Bethe-lattice contacts; (6)
the reference's surfGAt warm start; (7) utils/logging.
"""

import logging
import pathlib
import sys

import numpy as np
import pytest
import torch

import fake_gauopen
from gaunegf_tpu import compat as jcompat
from gaunegf_tpu import density as jdens
from gaunegf_tpu import fermi as jfermi
from gaunegf_tpu import transport as jtr
from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.ops.greens import weighted_gless_sum as j_gless
from gaunegf_tpu.ops.greens import weighted_gr_sum as j_gr
from gaunegf_tpu_torch import compat
from gaunegf_tpu_torch import density as tdens
from gaunegf_tpu_torch import fermi as tfermi
from gaunegf_tpu_torch.compat import _device
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models import slater_koster as sk
from gaunegf_tpu_torch.units import BOHR_TO_ANG, HAR_TO_EV
from gaunegf_tpu_torch.utils import logging as tlog
from test_compat import REFERENCE_METHODS, REFERENCE_NAMES

sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))
from chip_smoke import stand_in_gaussian, type_codes  # noqa: E402

JLU = JaxConfig(solver="lu")
ROUTE_BOUND = 1e-8          # tests/test_torch_density.py
EF_BOUND = 1e-2             # 10 conv: a search stops anywhere in |dN| < conv
P_FIRST_BOUND = 1e-6        # the JAX route's ~3e-7 contract


@pytest.fixture(autouse=True)
def _facade_on_cpu(monkeypatch):
    """The facade's device is the CPU for every test (a test of the default
    puts 'cuda' back); one torch thread; no gauNEGF or gauopen module left
    behind for the next file of this xdist worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setitem(_device._state, "device", torch.device("cpu"))
    try:
        yield
    finally:
        torch.set_num_threads(n)
        for k in [k for k in sys.modules
                  if k.split(".")[0] in ("gauopen", "gauNEGF")]:
            del sys.modules[k]


def _rel(x, ref):
    return float(np.max(np.abs(np.asarray(x) - ref)) / np.max(np.abs(ref)))


def _tb(n=16, nc=3):
    rng = np.random.default_rng(0)
    H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1)) \
        + np.diag(0.1 * rng.standard_normal(n))
    return H, np.eye(n), [np.arange(nc), np.arange(n - nc, n)]


# ---------------------------------------------------------------------------
# Surface, install, device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", sorted(REFERENCE_NAMES))
def test_every_reference_name_exists(module):
    mod = getattr(compat, module)
    missing = [n for n in REFERENCE_NAMES[module] if not hasattr(mod, n)]
    assert not missing, f"compat.{module} is missing {missing}"


@pytest.mark.parametrize("owner", sorted(REFERENCE_METHODS),
                         ids=lambda o: ".".join(o))
def test_every_reference_method_exists(owner):
    cls = getattr(getattr(compat, owner[0]), owner[1])
    missing = [n for n in REFERENCE_METHODS[owner] if not hasattr(cls, n)]
    assert not missing, f"compat.{owner[0]}.{owner[1]} is missing {missing}"


def test_install_makes_gauNEGF_importable():
    assert "gauNEGF" not in sys.modules
    compat.install(device="cpu")
    from gauNEGF.density import densityComplexN  # noqa: F401
    from gauNEGF.scfE import NEGFE
    from gauNEGF.transport import cohTrans
    import gauNEGF.scf
    assert gauNEGF.scf is compat.scf and NEGFE is compat.scfE.NEGFE
    assert cohTrans is compat.transport.cohTrans
    compat.install()                       # installing twice is harmless
    assert sys.modules["gauNEGF"] is compat


def test_install_refuses_to_shadow():
    sys.modules["gauNEGF"] = sys           # any foreign module
    with pytest.raises(RuntimeError, match="refusing"):
        compat.install()
    del sys.modules["gauNEGF"]
    jcompat.install()                      # the JAX package's facade
    with pytest.raises(RuntimeError, match="refusing"):
        compat.install(device="cpu")
    assert sys.modules["gauNEGF"] is jcompat
    for k in [k for k in sys.modules if k.split(".")[0] == "gauNEGF"]:
        del sys.modules[k]
    compat.install(device="cpu")           # and the other way round
    with pytest.raises(RuntimeError):
        jcompat.install()
    assert sys.modules["gauNEGF.scfE"] is compat.scfE


def test_facade_device_is_cuda_and_never_falls_back(monkeypatch):
    """Without a device the facade asks for 'cuda'; where torch sees no
    GPU every facade entry point raises instead of running on the CPU."""
    assert _device.DEFAULT_DEVICE == "cuda"
    monkeypatch.setitem(_device._state, "device", _device.DEFAULT_DEVICE)
    H, S, inds = _tb()
    s1 = compat.matTools.formSigma(inds[0], -0.1j, 16)
    s2 = compat.matTools.formSigma(inds[1], -0.1j, 16)
    g = compat.surfGTester.surfGTest(H, S, inds, sig1=-0.1j, device="cpu")
    fake_gauopen.install()
    fake_gauopen.configure(H, S)
    calls = {
        "get_device": lambda: compat.get_device(),
        "set_device": lambda: compat.set_device("cuda"),
        "install": lambda: compat.install(device="cuda"),
        "utils.inv": lambda: compat.utils.inv(np.eye(2)),
        "GrInt": lambda: compat.integrate.GrInt(H, S, g, [0.1j], [1.0]),
        "densityComplexN": lambda: compat.density.densityComplexN(
            H, S, g, -3.0, 0.0, N=4, showText=False),
        "cohTrans": lambda: compat.transport.cohTrans([0.0], H, S, s1, s2),
        "SigmaCalculator": lambda: compat.transport.SigmaCalculator(
            s1, s2).get_sigma(0.0, 0),
        "surfGTest": lambda: compat.surfGTester.surfGTest(H, S, inds),
        "surfG": lambda: compat.surfG1D.surfG(H, S, inds),
        "NEGF": lambda: compat.scf.NEGF("unused"),
        "NEGFE": lambda: compat.scfE.NEGFE("unused"),
    }
    if torch.cuda.is_available():
        assert compat.get_device().type == "cuda"
    else:
        for name, call in calls.items():
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    assert "gauNEGF" not in sys.modules     # a refused install leaves none
    # an explicit device overrides the facade's
    assert compat.utils.inv(np.eye(2), device="cpu").shape == (2, 2)


def test_set_device_and_install_set_the_facade_device(monkeypatch):
    monkeypatch.setitem(_device._state, "device", _device.DEFAULT_DEVICE)
    assert compat.set_device("cpu") == torch.device("cpu")
    assert compat.get_device() == torch.device("cpu")
    monkeypatch.setitem(_device._state, "device", _device.DEFAULT_DEVICE)
    compat.install(device="cpu")
    H, S, inds = _tb()
    g = compat.surfGTester.surfGTest(H, S, inds)
    assert g.device == torch.device("cpu")


def test_providers_evaluate_on_the_callers_device(tmp_path):
    """The contacts that NEGFE builds evaluate their one-energy methods on
    NEGFE's device; a provider made without a device raises there rather
    than run on the host."""
    from gaunegf_tpu_torch.models.bethe import BetheAtomGF
    from gaunegf_tpu_torch.models.chain1d import Chain1DSelfEnergy
    from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
    H, S, inds = _tb()
    fake_gauopen.install()
    fake_gauopen.configure(H * 0.1, S)
    negf = compat.scfE.NEGFE(str(tmp_path / "m"), device="cpu")
    negf.setSigma([1], [16], -0.1j)
    assert negf.g.device == torch.device("cpu")
    assert negf.getSigma(0.1)[0].shape == (16, 16)
    negf.setContact1D([[1, 2], [15, 16]])
    assert negf.g.device == torch.device("cpu")
    for g, call in [
            (ConstantSelfEnergy(H, S, inds), lambda g: g.sigma(0.1, 0)),
            (Chain1DSelfEnergy(H, S, inds), lambda g: g.sigmaTot(0.1)),
            (BetheAtomGF(sk.parse_bethe_file("Au").h0(), np.zeros((12, 9, 9)),
                         np.zeros((12, 9, 9))), lambda g: g.sigma_k(0.1))]:
        with pytest.raises(TypeError, match="device is required"):
            call(g)


# ---------------------------------------------------------------------------
# utils, matTools, fermiSearch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["inv", "eig", "eigh",
                                  "fractional_matrix_power"])
def test_utils_numpy_in_numpy_out(name):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((6, 6))
    A = A @ A.T + 6 * np.eye(6)
    args = (0.5,) if name == "fractional_matrix_power" else ()
    out = getattr(compat.utils, name)(A, *args)
    ref = getattr(jcompat.utils, name)(A, *args)
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    assert all(isinstance(x, np.ndarray) for x in outs)
    if name in ("eig", "eigh"):                    # eigenvectors up to phase
        w, v = outs
        np.testing.assert_allclose(np.sort(np.real(w)),
                                   np.sort(np.real(np.asarray(refs[0]))),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(A @ v, v * w[None, :], rtol=0, atol=1e-10)
    else:
        np.testing.assert_allclose(outs[0], np.asarray(refs[0]), rtol=0,
                                   atol=1e-12)
    t = getattr(compat.utils, name)(torch.as_tensor(A), *args)
    t0 = t[0] if isinstance(t, tuple) else t
    assert isinstance(t0, torch.Tensor)


def test_formSigma_and_matrix_bridge_match_jax():
    H, S, inds = _tb()
    for V, S_ in ((-0.1j, 0), (np.full((3, 3), -0.05j), S)):
        assert np.array_equal(compat.matTools.formSigma(inds[0], V, 16, S_),
                              jcompat.matTools.formSigma(inds[0], V, 16, S_))
    fake_gauopen.install()
    fake_gauopen.configure(H, S, ne=16)
    bar = fake_gauopen.BinAr()
    bar.update(model="uhf", dofock=True)
    for name in ("getDen", "getEnergies"):
        assert np.array_equal(getattr(compat.matTools, name)(bar, "u"),
                              getattr(jcompat.matTools, name)(bar, "u"))
    F, locs = compat.matTools.getFock(bar, "u")
    Fj, locsj = jcompat.matTools.getFock(bar, "u")
    assert np.array_equal(F, Fj) and np.array_equal(locs, locsj)
    P = np.kron(np.eye(2), np.eye(16) / 3)
    compat.matTools.storeDen(bar, P, "u")
    assert np.array_equal(bar.matlist["BETA SCF DENSITY MATRIX"].expand(),
                          np.eye(16) / 3)


def test_DOSFermiSearch_matches_jax():
    dos = lambda E: 5.0 + np.tanh(np.asarray(E))
    steps = []
    for mod in (compat, jcompat):
        s = mod.fermiSearch.DOSFermiSearch(1.0, 10.0, deltaE=0.05,
                                           numPoints=3)
        steps.append((s.step(dos, 8.0, stepLim=1.0), s.getAccuracy(),
                      mod.fermiSearch.matrixFiniteDifference(dos, 0.3, 0.01,
                                                             5)))
    assert steps[0][:2] == steps[1][:2]
    assert np.array_equal(steps[0][2], steps[1][2])


# ---------------------------------------------------------------------------
# density, integrate, transport: the wrappers against the JAX package
# ---------------------------------------------------------------------------

# wrapper -> (facade call, the port's function with the same arguments,
# the JAX function on its complex128 LU)
def _routes(H, S, g, gj):
    return {
        "densityComplexN": (
            lambda: compat.density.densityComplexN(H, S, g, -3.0, 0.0, N=24,
                                                   showText=False),
            lambda: tdens.density_complex_n(H, S, g, -3.0, 0.0, N=24,
                                            device="cpu"),
            lambda: jdens.density_complex_n(H, S, gj, -3.0, 0.0, N=24,
                                            exec_cfg=JLU)),
        "densityRealN": (
            lambda: compat.density.densityRealN(H, S, g, -40.0, -3.0, N=16,
                                                showText=False),
            lambda: tdens.density_real_n(H, S, g, -40.0, -3.0, N=16,
                                         device="cpu"),
            lambda: jdens.density_real_n(H, S, gj, -40.0, -3.0, N=16,
                                         exec_cfg=JLU)),
        "densityGridN": (
            lambda: compat.density.densityGridN(H, S, g, -0.2, 0.2, ind=-1,
                                                N=16, showText=False),
            lambda: tdens.density_grid_n(H, S, g, -0.2, 0.2, ind=-1, N=16,
                                         device="cpu"),
            lambda: jdens.density_grid_n(H, S, gj, -0.2, 0.2, ind=-1, N=16,
                                         exec_cfg=JLU)),
        "densityGridTrap": (
            lambda: compat.density.densityGridTrap(H, S, g, -0.2, 0.2,
                                                   ind=0, N=12, T=300.0),
            lambda: tdens.density_grid_trap(H, S, g, -0.2, 0.2, ind=0, N=12,
                                            T=300.0, device="cpu"),
            lambda: jdens.density_grid_trap(H, S, gj, -0.2, 0.2, ind=0,
                                            N=12, T=300.0, exec_cfg=JLU)),
    }


@pytest.fixture(scope="module")
def constant_system():
    H, S, inds = _tb()
    return (H, S, compat.surfGTester.surfGTest(H, S, inds, sig1=-0.1j,
                                               device="cpu"),
            jcompat.surfGTester.surfGTest(H, S, inds, sig1=-0.1j))


@pytest.mark.parametrize("route", ["densityComplexN", "densityRealN",
                                   "densityGridN", "densityGridTrap"])
def test_density_wrapper_matches_port_and_jax(constant_system, route):
    facade, port, ref = _routes(*constant_system)[route]
    P = facade()
    assert np.array_equal(P, port())
    assert np.max(np.abs(P - np.asarray(ref()))) < ROUTE_BOUND


def test_calcFermiMuller_and_getFermi1DContact_match_jax(constant_system):
    H, S, g, gj = constant_system
    Ef = compat.density.calcFermiMuller(g, 8.0, -3.0, 0.2, 24, conv=1e-4)
    Efj = jfermi.calc_fermi_muller(gj, 8.0, -3.0, 0.2, 24, conv=1e-4,
                                   exec_cfg=JLU)
    assert abs(Ef[0] - Efj[0]) < EF_BOUND
    assert Ef[0] == tfermi.calc_fermi_muller(
        g, 8.0, -3.0, 0.2, 24, conv=1e-4, device="cpu")[0]
    kw = dict(tol=1e-3, Eminf=-1000.0)
    got = compat.density.getFermi1DContact(_lead_chain(compat), 1.0, 0,
                                           **kw)
    ref = jfermi.get_fermi_1d_contact(_lead_chain(jcompat), 1.0, 0,
                                      exec_cfg=JLU, verbose=False, **kw)
    assert abs(got[0] - ref[0]) < EF_BOUND and abs(got[0] - 0.1) < 0.05


def _lead_chain(mod):
    """A fully specified 1D-chain system (pattern c): a 3-cell device of
    2-orbital cells (tests/test_torch_fermi.py::_pattern_c)."""
    alpha = 0.1 * np.eye(2) - (np.eye(2, k=1) + np.eye(2, k=-1))
    beta = np.zeros((2, 2))
    beta[0, -1] = -1.0
    z = np.zeros((2, 2))
    return mod.surfG1D.surfG(
        np.kron(np.eye(3), alpha), np.eye(6),
        [np.arange(2), np.arange(4, 6)], taus=[beta, beta.T],
        staus=[z, z], alphas=[alpha, alpha], aOverlaps=[np.eye(2)] * 2,
        betas=[beta, beta], bOverlaps=[z, z], eta=1e-4)


def test_GrInt_GrLessInt_match_jax(constant_system):
    """G< on the spectral route drops the broadening background's Gamma
    (~1e-7 here), as tests/test_torch_density.py allows."""
    H, S, g, gj = constant_system
    E = np.linspace(-1.5, 1.5, 6) + 0.05j
    w = np.linspace(0.5, 1.0, 6)
    assert _rel(compat.integrate.GrInt(H, S, g, E, w),
                np.asarray(j_gr(H, S, gj, E, w, exec_cfg=JLU))) < 1e-10
    assert _rel(compat.integrate.GrLessInt(H, S, g, E, w, ind=0),
                np.asarray(j_gless(H, S, gj, E, w, contact=0,
                                   exec_cfg=JLU))) < 1e-7


def test_transport_wrappers_match_jax(constant_system, capsys):
    H, S, g, gj = constant_system
    inds = g.inds_list
    s1 = compat.matTools.formSigma(inds[0], -0.1j, 16)
    s2 = compat.matTools.formSigma(inds[1], -0.1j, 16)
    E = np.linspace(-1.0, 1.0, 7)
    T = compat.transport.cohTrans(E, H, S, s1, s2)
    Tj = jtr.cohTrans(E, H, S, s1, s2, exec_cfg=JLU)
    assert np.abs(np.array(T) - np.array(Tj)).max() < 1e-9
    TE = compat.transport.cohTransE(E, H, S, g)
    assert np.abs(np.array(TE) - np.array(Tj)).max() < 1e-9
    # the DOS needs the full G: the LU route, mixed tier (contract ~2e-6)
    dos, site = compat.transport.DOS(E, H, S, s1, s2)
    dj, _ = jtr.DOS(E, H, S, s1, s2, exec_cfg=JLU)
    assert _rel(np.array(dos), np.array(dj)) < 1e-6 and site.shape == (7, 16)
    dE, _ = compat.transport.DOSE(E, H, S, g)
    assert _rel(np.array(dE), np.array(dj)) < 1e-6
    I = compat.transport.current(H, S, s1, s2, 0.0, 0.1, dE=0.01)
    Ij = jtr.current(H, S, s1, s2, 0.0, 0.1, dE=0.01, exec_cfg=JLU)
    assert abs(I - Ij) < 1e-9 * abs(Ij)
    sc = compat.transport.SigmaCalculator(s1, s2)
    scj = jcompat.transport.SigmaCalculator(s1, s2)
    assert isinstance(sc, compat.transport.SigmaSource)
    assert np.array_equal(sc.get_gamma(0.3, 1),
                          np.asarray(scj.get_gamma(0.3, 1)))
    assert "Transmission=" in capsys.readouterr().out


def test_surfG_and_surfGTest_match_jax():
    H, S, inds = _tb()
    a = compat.surfG1D.surfG(H, S, inds)
    b = jcompat.surfG1D.surfG(H, S, inds)
    E = 0.3 + 1e-3j
    assert _rel(a.g(E, 0), np.asarray(b.g(E, 0))) < 1e-10
    a.setContacts()                      # pattern a: re-extracted from F
    assert _rel(a.g(E, 1), np.asarray(b.g(E, 1))) < 1e-10
    a, b = _lead_chain(compat), _lead_chain(jcompat)
    assert np.abs(a.sigmaTot(E)).max() > 0.1
    assert _rel(a.sigmaTot(E), np.asarray(b.sigmaTot(E))) < 1e-10
    assert _rel(a.sigma(E, 1), np.asarray(b.sigma(E, 1))) < 1e-10
    c = compat.surfGTester.surfGTest(H, S, inds, sig1=-0.1j, sig2=-0.2j)
    d = jcompat.surfGTester.surfGTest(H, S, inds, sig1=-0.1j, sig2=-0.2j)
    assert np.array_equal(c.sigmaTot(E), np.asarray(d.sigmaTot(E)))
    assert np.array_equal(c.sigma(E, 1), np.asarray(d.sigma(E, 1)))


# ---------------------------------------------------------------------------
# surfG3D.surfGAt: the reference's warm start (tests/test_surfgat_lattice.py)
# ---------------------------------------------------------------------------

def _atom_matrices():
    p = sk.parse_bethe_file("Au")
    nv = sk.fcc111_neighbor_directions(np.array([0.0, 0.0, 1.0]),
                                       np.array([1.0, 0.0, 0.0]))
    return (p.h0(), np.stack([sk.bond_matrix(p.overlap, d) for d in nv]),
            np.stack([sk.bond_matrix(p.hopping, d) for d in nv]))


def test_surfgat_warm_start_bookkeeping():
    H, Sl, Vl = _atom_matrices()
    g = compat.surfG3D.surfGAt(H, Sl, Vl, eta=1e-3)
    gj = jcompat.surfG3D.surfGAt(H, Sl, Vl, eta=1e-3)
    assert g.closure == "lattice"
    assert g.sigmaKprev is None and g.Eprev == compat.surfG3D.Eminf
    s1 = g.sigmaK(-3.0)
    assert g.Eprev == -3.0 and g.sigmaKprev is not None
    assert _rel(s1, np.asarray(gj.sigmaK(-3.0))) < 1e-4
    s2 = g.sigmaK(-3.0 + 1e-4)              # warm from -3.0
    assert np.max(np.abs(s2 - s1)) < 1e-2
    assert _rel(s2, np.asarray(gj.sigmaK(-3.0 + 1e-4))) < 1e-4
    g.sigmaK(2.0)                            # a jump of >= 1 eV starts cold
    assert g.Eprev == 2.0


def test_surfgat_sigma_chains_warm_state():
    H, Sl, Vl = _atom_matrices()
    g = compat.surfG3D.surfGAt(H, Sl, Vl, eta=1e-3)
    gj = jcompat.surfG3D.surfGAt(H, Sl, Vl, eta=1e-3)
    g.sigma(-1.0)
    gj.sigma(-1.0)
    assert g.Eprev == -1.0 and g.sigmaKprev.shape == (12, 9, 9)
    assert _rel(g.sigmaKprev, np.asarray(gj.sigmaKprev)) < 1e-4
    s_warm = g.sigma(-1.0 + 1e-4)
    s_cold = compat.surfG3D.surfGAt(H, Sl, Vl, eta=1e-3).sigma(-1.0 + 1e-4)
    assert np.max(np.abs(s_warm - s_cold)) < 2e-3
    assert _rel(s_warm, np.asarray(gj.sigma(-1.0 + 1e-4))) < 1e-4
    out = g.sigma(-1.0, inds=[0, 5])
    assert len(out) == 2 and out[0].shape == (9, 9)
    assert np.isfinite(g.DOS(-1.0)) and g.DOS(-1.0) > 0


def test_surfgat_extended_embedding_keeps_exclusion():
    H, Sl, Vl = _atom_matrices()
    g = compat.surfG3D.surfGAt(H, Sl, Vl, eta=1e-3)
    gj = jcompat.surfG3D.surfGAt(H, Sl, Vl, eta=1e-3)
    E = -3.0
    sig_tot = g.sigmaTot(E)
    sig_k = g.sigma_k(E)
    tot = sig_k.sum(axis=0)
    for k in range(12):
        blk = sig_tot[k * 9:(k + 1) * 9, k * 9:(k + 1) * 9]
        assert np.max(np.abs(blk - (tot - sig_k[(k + 6) % 12]))) < 1e-10
    assert _rel(sig_tot, np.asarray(gj.sigmaTot(E))) < 1e-4


# ---------------------------------------------------------------------------
# The Gaussian-coupled NEGFE, first density, port against JAX
# ---------------------------------------------------------------------------

def _au_junction():
    """tests/test_torch_bethe.py's 56-orbital junction with the lattice's
    onsite blocks on the contact atoms, as Gaussian would hand it: H in
    Hartree, coordinates in Bohr, and ibftyp codes whose abs // 1000 sort
    each metal atom's s, p, d orbitals in that order."""
    d = 2.88
    u1 = np.array([1.0, 0.0, 0.0]) * d
    u2 = np.array([0.5, np.sqrt(3) / 2, 0.0]) * d
    left = [np.zeros(3), u1, u2]
    mol = [np.array([0.8, 0.5, -2.2]), np.array([0.8, 0.5, -4.0])]
    right = [c + np.array([0, 0, -6.2]) for c in left]
    coords = np.stack(left + mol + right)
    metal = (1, 2, 3, 6, 7, 8)
    orb = []
    for atom in range(1, 9):
        orb += [atom] * (9 if atom in metal else 1)
    n = len(orb)
    H = np.zeros((n, n))
    for a in (0, 9, 18, 29, 38, 47):
        H[a:a + 9, a:a + 9] = sk.parse_bethe_file("Au").h0()
    H[27, 27], H[28, 28] = -8.0, -7.0
    H[27, 28] = H[28, 27] = -0.8
    for a in (0, 9, 18):
        H[a, 27] = H[27, a] = -0.4
    for a in (29, 38, 47):
        H[a, 28] = H[28, a] = -0.4
    orb = np.asarray(orb)
    return H, coords, orb, type_codes(orb)


def _chain_H(n=12):
    return -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1)) \
        + np.diag(np.linspace(-0.1, 0.1, n))


def _first_density(tmp_path, setup):
    """The first FockToP density of the facade's NEGFE in both packages,
    each on its default configuration with an equal explicit chunk."""
    out = []
    for name, mod, kw in (
            ("port", compat, {"device": "cpu",
                              "exec_cfg": ExecutionConfig(energy_chunk=16)}),
            ("jax", jcompat, {"exec_cfg": JaxConfig(energy_chunk=16)})):
        if setup == "bethe":
            H, coords, orb, typ = _au_junction()
            stand_in_gaussian(fake_gauopen, typ)
            fake_gauopen.configure(H / HAR_TO_EV, np.eye(len(H)),
                                   ibfatm=orb, ne=2, U=0.01,
                                   coords=coords / BOHR_TO_ANG)
        else:
            H = _chain_H()
            stand_in_gaussian(fake_gauopen)
            fake_gauopen.configure(H / HAR_TO_EV, np.eye(12), ne=12, U=0.01)
        d = mod.scfE.NEGFE(str(tmp_path / name), basis="lanl2dz",
                           func="b3lyp", verbose=False, **kw)
        if setup == "sigma":
            d.setSigma([1, 2], [11, 12], sig=-0.1j)
        elif setup == "chain":
            d.setContact1D([[1, 2], [11, 12]], eta=1e-4)
        else:
            d.setContactBethe([[1, 2, 3], [6, 7, 8]], "Au", 1e-5, 0,
                              fermi=0)
        d.setIntegralLimits(N1=32, N2=16)
        d.setVoltage(0.1, fermi=0.0)
        d.FockToP()
        out.append(d)
    return out


@pytest.mark.parametrize("setup", ["sigma", "chain", "bethe"])
def test_negfe_first_density_matches_jax(tmp_path, setup):
    port, ref = _first_density(tmp_path, setup)
    assert np.array_equal(port.F_eV, ref.F_eV)
    assert port.Emin == pytest.approx(ref.Emin, abs=1e-9)
    assert np.isfinite(port.P).all()
    assert _rel(port.P, np.asarray(ref.P)) < P_FIRST_BOUND
    if setup == "bethe":                 # the geometry came from the bar
        assert port.g.orthogonal and np.array_equal(port.g.inds_lists[0][0],
                                                    np.arange(9))


# ---------------------------------------------------------------------------
# utils/logging
# ---------------------------------------------------------------------------

def test_perf_span_logs_label_and_fields_at_debug(caplog):
    caplog.set_level(logging.DEBUG, logger="gaunegf_tpu_torch")
    with tlog.perf_span("probe", nE=7, chunk=4):
        pass
    rec = [r for r in caplog.records if "probe took" in r.getMessage()]
    assert len(rec) == 1 and rec[0].levelno == logging.DEBUG
    assert rec[0].name == "gaunegf_tpu_torch.perf"
    assert rec[0].getMessage().endswith("s nE=7 chunk=4")
    caplog.clear()
    caplog.set_level(logging.INFO, logger="gaunegf_tpu_torch")
    with tlog.perf_span("quiet"):
        pass
    assert not caplog.records
    assert tlog.get_logger("engine").name == "gaunegf_tpu_torch.engine"
    assert tlog.get_logger("gaunegf_tpu_torch.x").name == "gaunegf_tpu_torch.x"


def test_profile_trace_writes_a_trace(tmp_path):
    with tlog.profile_trace(str(tmp_path / "prof")) as prof:
        torch.ones(8) @ torch.ones(8)
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert prof.key_averages() is not None


def test_engine_emits_spans(caplog):
    """gr_sum_spectral on the spectral route, gr_sum on the LU route."""
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    H, S, inds = _tb()
    g = compat.surfGTester.surfGTest(H, S, inds, sig1=-0.1j)
    E = np.linspace(-1.0, 1.0, 4) + 0.1j
    caplog.set_level(logging.DEBUG, logger="gaunegf_tpu_torch")
    EnergyEngine(H, S, g, device="cpu").gr_sum(E, np.ones(4))
    EnergyEngine(H, S, g, ExecutionConfig(solver="lu"),
                 device="cpu").gr_sum(E, np.ones(4))
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("gr_sum_spectral took") and "nE=4" in m
               for m in msgs)
    assert any(m.startswith("gr_sum took") and "warm=False" in m
               for m in msgs)
    assert sum(m.startswith("gr_sum: N=16 nE=4") for m in msgs) == 2


# the engine's other JAX spans: (configuration, call on the engine)
_SPAN_CALLS = {
    "gr_sum_chain": (dict(continuation=True),
                     lambda eng, E, w: eng.gr_sum(E, w)),
    "density_eq_split": (dict(solver="lu"),
                         lambda eng, E, w: eng.density_eq_split(
                             E[:2], w[:2], E[2:], w[2:])),
    "density_neq": (dict(solver="lu"),
                    lambda eng, E, w: eng.density_neq_sum(
                        E[:2], w[:2], E[2:], w[2:], contact=-1)),
    "gless_sum_spectral": (dict(),
                           lambda eng, E, w: eng.gless_sum(E, w, 0)),
    "transmission_spectral": (dict(),
                              lambda eng, E, w: eng.transmission(E.real)),
}


@pytest.mark.parametrize("name", sorted(_SPAN_CALLS))
def test_engine_emits_the_jax_spans(caplog, name):
    """Each dispatch that the JAX engine times under a perf_span emits the
    same name with its point count: the chain's gr_sum, the split
    equilibrium sum, the fused biased LU sum, the spectral G< and T(E)."""
    from gaunegf_tpu_torch.ops.greens import EnergyEngine
    H, S, inds = _tb()
    g = compat.surfGTester.surfGTest(H, S, inds, sig1=-0.1j)
    E = np.linspace(-1.0, 1.0, 4) + 0.1j
    cfg, call = _SPAN_CALLS[name]
    caplog.set_level(logging.DEBUG, logger="gaunegf_tpu_torch")
    call(EnergyEngine(H, S, g, ExecutionConfig(energy_chunk=2, **cfg),
                      device="cpu"), E, np.ones(4))
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith(f"{name} took") and m.endswith("nE=4")
               for m in msgs), msgs
