"""The Gaussian bridge of gaunegf_tpu_torch against the JAX package, on the
fake gauopen package (tests/fake_gauopen.py): io/gaussian, GaussianFock,
and the Gaussian-coupled analytic NEGF of the facade with runDFT and
writeChk.

The bridge is host NumPy in both packages, so it is held exactly
(np.array_equal): the OpMat packing, the +/- atom-index spin encoding of
locs, the /2 restricted density write-back, the alpha/beta blocks and the
complex typed='c' record of 'g' (reference matTools.py:39-269).  The
analytic NEGF class is host NumPy too apart from S^(-1/2), which the
port computes on its device: two SCF cycles agree to 1e-9 of max |P|.
"""

import sys

import numpy as np
import pytest
import torch

import fake_gauopen
from gaunegf_tpu import compat as jcompat
from gaunegf_tpu.io import gaussian as jio
from gaunegf_tpu.models.fock import GaussianFock as JaxGaussianFock
from gaunegf_tpu_torch import compat
from gaunegf_tpu_torch.io import gaussian as tio
from gaunegf_tpu_torch.models import fock as tfock
from gaunegf_tpu_torch.models.fock import GaussianFock

SPINS = ("r", "u", "ro", "g")
MODEL = {"r": "rhf", "u": "uhf", "ro": "rohf", "g": "ghf"}
SCF_BOUND = 1e-9


@pytest.fixture(autouse=True)
def _gauopen():
    """The fake gauopen for every test, one torch thread, and no module of
    either facade or of the fake left behind (pytest-xdist runs other
    files in this process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    fake_gauopen.install()
    try:
        yield
    finally:
        torch.set_num_threads(n)
        for k in [k for k in sys.modules
                  if k.split(".")[0] in ("gauopen", "gauNEGF")]:
            del sys.modules[k]


def _sys(n=6, seed=0):
    rng = np.random.default_rng(seed)
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1)) \
        + np.diag(rng.uniform(-0.3, 0.3, n))
    S = np.eye(n) + 0.05 * (np.eye(n, k=1) + np.eye(n, k=-1))
    ibfatm = np.repeat(np.arange(1, n // 2 + 1), 2)   # 2 orbitals/atom
    coords = rng.standard_normal((n // 2, 3))
    fake_gauopen.configure(H0, S, ibfatm=ibfatm, ne=n, U=0.4, coords=coords)
    return H0, S, ibfatm, coords


def _bar(spin):
    _sys()
    bar = fake_gauopen.BinAr()
    bar.update(model=MODEL[spin], dofock=True)
    return bar


def _hermitian(n, seed, complex_=False):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((n, n))
    if complex_:
        P = P + 1j * rng.standard_normal((n, n))
    return (P + P.conj().T) / 2


# ---------------------------------------------------------------------------
# io/gaussian.py
# ---------------------------------------------------------------------------

def test_record_names_match_jax():
    for name in ("ALPHA_SCF_DEN", "BETA_SCF_DEN", "ALPHA_FOCK", "BETA_FOCK",
                 "ALPHA_ENERGIES", "BETA_ENERGIES"):
        assert getattr(tio, name) == getattr(jio, name)


@pytest.mark.parametrize("spin", SPINS)
def test_read_side_matches_jax(spin):
    """get_fock (F and the signed locs), get_density and get_energies (eV,
    one level per electron) on the same record, exactly."""
    bar = _bar(spin)
    F, locs = tio.get_fock(bar, spin)
    Fj, locsj = jio.get_fock(bar, spin)
    assert np.array_equal(F, Fj) and np.array_equal(locs, locsj)
    assert np.array_equal(tio.get_density(bar, spin),
                          jio.get_density(bar, spin))
    assert np.array_equal(tio.get_energies(bar, spin),
                          jio.get_energies(bar, spin))
    n = 6
    if spin in ("u", "ro"):
        assert np.array_equal(locs, np.concatenate([bar.ibfatm,
                                                    -bar.ibfatm]))
        assert F.shape == (2 * n, 2 * n) and not F[:n, n:].any()
    elif spin == "g":
        assert np.array_equal(locs[0::2], bar.ibfatm)
        assert np.array_equal(locs[1::2], -bar.ibfatm)
    with pytest.raises(ValueError):
        tio.get_fock(bar, "x")


@pytest.mark.parametrize("spin", SPINS)
def test_store_density_matches_jax(spin):
    """The write-back: 'r' stores P/2 as a real record, 'u'/'ro' the two
    diagonal blocks, 'g' the complex matrix typed 'c'; the records the two
    packages leave (packed arrays, dimensions, types) are identical."""
    n = 6
    P = _hermitian(2 * n if spin != "r" else n, seed=3,
                   complex_=spin == "g")
    if spin in ("u", "ro"):
        P[:n, n:] = P[n:, :n] = 0
    if spin == "r":
        P = P + 1e-3j * np.eye(n)             # the imaginary part is dropped
    bars = [_bar(spin), _bar(spin)]
    tio.store_density(bars[0], P, spin)
    jio.store_density(bars[1], P, spin)
    keys = [tio.ALPHA_SCF_DEN] + ([tio.BETA_SCF_DEN]
                                  if spin in ("u", "ro") else [])
    for key in keys:
        a, b = bars[0].matlist[key], bars[1].matlist[key]
        assert np.array_equal(a.array, b.array)
        assert a.dimens == b.dimens and a.typed == b.typed
    stored = bars[0].matlist[tio.ALPHA_SCF_DEN]
    if spin == "r":
        assert np.array_equal(stored.expand(), np.real(P) / 2)
    elif spin == "g":
        assert stored.typed == "c" and stored.dimens == (2 * n, 2 * n)
        np.testing.assert_allclose(stored.expand(), P, rtol=0, atol=1e-15)
    else:
        assert np.array_equal(stored.expand(), P[:n, :n])
        assert np.array_equal(bars[0].matlist[tio.BETA_SCF_DEN].expand(),
                              P[n:, n:])


# ---------------------------------------------------------------------------
# GaussianFock
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spin", SPINS)
def test_gaussian_fock_matches_jax(tmp_path, spin):
    """Bootstrap, overlap, coordinates, initial F and P, and two fock(P)
    round trips (storeDen + dofock='DENSITY', escf) give the same arrays
    and the same Gaussian calls in both packages."""
    _sys()
    gf = GaussianFock(str(tmp_path / "t"), func="b3lyp", spin=spin)
    _sys()
    gj = JaxGaussianFock(str(tmp_path / "t"), func="b3lyp", spin=spin)
    assert gf.f_to_eV == gj.f_to_eV == tfock.HAR_TO_EV
    assert gf.n_electrons == gj.n_electrons == 6.0
    assert gf.method == gj.method == spin + "b3lyp"
    assert (gf.ifile, gf.chkfile, gf.ofile) == (gj.ifile, gj.chkfile,
                                                gj.ofile)
    assert np.array_equal(gf.locs, gj.locs)
    assert np.array_equal(gf.overlap(), gj.overlap())
    assert np.array_equal(gf.atom_coords(), gj.atom_coords())
    assert np.array_equal(gf.initial_fock(), gj.initial_fock())
    P = gf.initial_density()
    assert np.array_equal(P, gj.initial_density())
    for k in range(2):
        F, E = gf.fock(P)
        Fj, Ej = gj.fock(P)
        assert np.array_equal(F, Fj) and E == Ej
        P = P + 0.01 * (k + 1) * np.eye(len(P))
    assert gf.bar.update_calls == gj.bar.update_calls
    assert gf.bar.update_calls[-1]["dofock"] == "DENSITY"
    assert np.array_equal(gf.locs, gj.locs)


def test_gaussian_fock_restricted_halving(tmp_path):
    """The restricted density crosses the bridge halved: the Fock matrix
    that comes back is built from P/2 per spin (both spins: U * P)."""
    H0, S, _, _ = _sys()
    gf = GaussianFock(str(tmp_path / "r"), spin="r")
    P0 = gf.initial_density()
    np.testing.assert_allclose(np.trace(P0 @ S), 3.0, atol=1e-10)
    F, _ = gf.fock(2.0 * P0)
    occ = 2 * np.real(np.diag(P0 @ S))
    np.testing.assert_allclose(F, H0 + 0.4 * np.diag(occ), atol=1e-12)


def test_gaussian_fock_field_and_chk(tmp_path):
    _sys()
    gf = GaussianFock(str(tmp_path / "f"), spin="r")
    _sys()
    gj = JaxGaussianFock(str(tmp_path / "f"), spin="r")
    for g in (gf, gj):
        g.set_field([1.6, -2.4, 0.2])
        g.write_chk()
    for k, v in (("X-EFIELD", 2), ("Y-EFIELD", -2), ("Z-EFIELD", 0)):
        assert gf.bar.scalars[k] == gj.bar.scalars[k] == v
    assert gf.bar.written == gj.bar.written == [str(tmp_path / "f.chk")]


def test_gaussian_fock_bootstrap_routes(tmp_path, monkeypatch):
    """full_scf=True runs dofock=True and falls back to dofock='scf' when
    that raises; full_scf=False runs the GUESS route then dofock=True."""
    calls = {}
    for pkg, cls in (("port", GaussianFock), ("jax", JaxGaussianFock)):
        _sys()
        gf = cls(str(tmp_path / pkg), spin="r", full_scf=False)
        real = type(gf.bar).update

        def flaky(self, *a, **k):
            if k.get("dofock") is True:
                raise RuntimeError("no checkpoint")
            return real(self, *a, **k)
        monkeypatch.setattr(type(gf.bar), "update", flaky)
        gf._run_initial(True)
        monkeypatch.setattr(type(gf.bar), "update", real)
        calls[pkg] = [c["dofock"] for c in gf.bar.update_calls]
    assert calls["port"] == calls["jax"] == ["GUESS", True, "scf"]


def test_gaussian_fock_failed_update_keeps_going(tmp_path, monkeypatch,
                                                 capsys):
    """A failed dofock='DENSITY' update invalidates the cycle and carries
    on with the record as it stands (the reference's "CYCLE INVALID ...
    CONTINUING"), as in the JAX adapter."""
    _sys()
    gf = GaussianFock(str(tmp_path / "x"), spin="r")
    F0 = gf.initial_fock()

    def broken(self, *a, **k):
        raise RuntimeError("l502 died")
    monkeypatch.setattr(type(gf.bar), "update", broken)
    F, E = gf.fock(gf.initial_density())
    assert np.array_equal(F, F0)
    assert "CONTINUING TO NEXT CYCLE" in capsys.readouterr().out


def test_gaussian_fock_import_gate():
    """Without gauopen the port's adapter raises the JAX adapter's
    ImportError, word for word."""
    fake_gauopen.uninstall()

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.startswith("gauopen"):
                raise ImportError("gauopen blocked for test")
            return None

    blocker = _Block()
    sys.meta_path.insert(0, blocker)
    try:
        with pytest.raises(ImportError) as port:
            GaussianFock("unused")
        with pytest.raises(ImportError) as ref:
            JaxGaussianFock("unused")
    finally:
        sys.meta_path.remove(blocker)
    assert str(port.value) == str(ref.value)
    assert "gauopen" in str(port.value)


# ---------------------------------------------------------------------------
# The Gaussian-coupled analytic NEGF (compat.scf.NEGF), runDFT, writeChk
# ---------------------------------------------------------------------------

def _negf_pair(tmp_path, spin):
    n = 6
    rng = np.random.default_rng(3)
    H0 = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1)) \
        + np.diag(rng.uniform(-0.2, 0.2, n))
    out = []
    for pkg, kw in (("port", {"device": "cpu"}), ("jax", {})):
        fake_gauopen.configure(H0, np.eye(n), ibfatm=np.arange(1, n + 1),
                               ne=n, U=0.3)
        mod = compat if pkg == "port" else jcompat
        out.append(mod.scf.NEGF(str(tmp_path / pkg), basis="6-31G(d)",
                                func="b3lyp", spin=spin, nPulay=3,
                                verbose=False, **kw))
    return out


@pytest.mark.parametrize("spin", ["r", "u"])
def test_compat_negf_scf_matches_jax(tmp_path, spin):
    port, ref = _negf_pair(tmp_path, spin)
    assert np.array_equal(port.F, ref.F)
    assert np.array_equal(port.locs, ref.locs)
    for d in (port, ref):
        d.setSigma([1, 2], [5, 6], sig=-0.1j)
        d.setVoltage(0.0, fermi=0.0)
        d.SCF(conv=1e-12, damping=0.05, max_cycles=2, checkpoint=False)
    scale = np.abs(ref.P).max()
    assert np.isfinite(port.P).all()
    assert np.abs(port.P - ref.P).max() < SCF_BOUND * scale
    assert np.abs(port.F - ref.F).max() < SCF_BOUND * np.abs(ref.F).max()
    # two Fock rebuilds went through the bridge after the bootstrap
    assert [c["dofock"] for c in port.backend.bar.update_calls] \
        == [c["dofock"] for c in ref.backend.bar.update_calls]
    assert port.backend.bar.update_calls[-1]["dofock"] == "DENSITY"


def test_compat_negf_run_dft_and_write_chk(tmp_path):
    """runDFT replays the bootstrap and hands back the bootstrap Fock
    (Hartree), reloading locs; writeChk writes the .chk path."""
    port, ref = _negf_pair(tmp_path, "r")
    for d in (port, ref):
        d.setSigma([1, 2], [5, 6], sig=-0.1j)
        d.setVoltage(0.0, fermi=0.0)
        d.SCF(conv=1e-12, damping=0.05, max_cycles=1, checkpoint=False)
    F_boot = port.backend.bar.H0
    for fullSCF in (True, False):
        F = port.runDFT(fullSCF=fullSCF)
        Fj = ref.runDFT(fullSCF=fullSCF)
        assert np.array_equal(F, Fj) and np.array_equal(F, F_boot)
        assert port.F is F and np.array_equal(port.locs, ref.locs)
    assert [c["dofock"] for c in port.backend.bar.update_calls][-3:] \
        == [True, "GUESS", True]
    assert [c["dofock"] for c in port.backend.bar.update_calls] \
        == [c["dofock"] for c in ref.backend.bar.update_calls]
    port.writeChk()
    ref.writeChk()
    assert port.backend.bar.written == [str(tmp_path / "port.chk")]
    assert ref.backend.bar.written == [str(tmp_path / "jax.chk")]
