"""gaunegf_tpu_torch's Bethe-lattice electrodes against the JAX package.

The same NumPy inputs go through both packages on the CPU: JAX in x64,
the port in complex128.  Tolerances, each stated where it is used:

* copies (slater_koster, harrison, geometry detection): 1e-12;
* fixed points (bethe_sigma_k, bethe_sigma_surface): 1e-10 of max |sigma|
  against the JAX functions, the goldens at the JAX tests' own bounds
  (5e-4: the goldens come from a NumPy reference stopped at conv 1e-5),
  and a batch of energies equal to the same energies one at a time to
  1e-13 (a converged lane is frozen);
* providers (sigmaTot, sigma; 'r', 'u', 'g'; orthogonal or not): 1e-10;
* warm engines against the JAX warm engines on the same lane layout:
  1e-9; warm against cold 1e-4 (T) and 1e-5 (density), the JAX tests'
  bounds; the high tiers 2e-7 against a tightly converged reference.

Under x64 the JAX engines run every tier's LU in complex128 while keeping
the default tier's policy (warm start, sigma at conv 1e-5).  The port has
no such mode: its complex128 tiers ask for the tight sigma and start cold.
Where the two engines are compared at 1e-9 the port runs its exact-tier
LU with the default tier's policy (``_default_policy``)."""

import os

import numpy as np
import pytest
import torch

from gaunegf_tpu.config import ExecutionConfig as JaxConfig
from gaunegf_tpu.models import bethe as jbt
from gaunegf_tpu.models import harrison as jhr
from gaunegf_tpu.models import slater_koster as jsk
from gaunegf_tpu.models.fock import TightBindingFock as JaxFock
from gaunegf_tpu_torch import interop
from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models import bethe as bt
from gaunegf_tpu_torch.models import harrison as hr
from gaunegf_tpu_torch.models import slater_koster as sk
from gaunegf_tpu_torch.models.fock import TightBindingFock
from gaunegf_tpu_torch.ops import greens

torch.set_num_threads(1)
CPU = torch.device("cpu")
GOLD = np.load(os.path.join(os.path.dirname(__file__), "golden",
                            "golden_bethe.npz"))
LATS = ("Au", "Ag", "Cu", "demo")


def _rel(x, ref):
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


@pytest.fixture
def _default_policy(monkeypatch):
    """The port's complex128 tiers with the default tier's policy (warm
    start, sigma at conv 1e-5): what the JAX engines run under x64."""
    monkeypatch.setattr(greens.EnergyEngine, "_tight", lambda self: False)


# ---------------------------------------------------------------------------
# Copies: slater_koster, harrison, data, geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lat", LATS)
def test_bethe_files_are_copies_and_parse_alike(lat):
    a = os.path.join(os.path.dirname(jsk.__file__), "..", "data",
                     lat + ".bethe")
    b = os.path.join(os.path.dirname(sk.__file__), "..", "data",
                     lat + ".bethe")
    assert open(a, "rb").read() == open(b, "rb").read()
    pj, pt = jsk.parse_bethe_file(a), sk.parse_bethe_file(lat)   # bare name
    assert pt.ne == pj.ne and pt.orthogonal == pj.orthogonal
    for field in ("onsite", "hopping", "overlap"):
        assert getattr(pt, field) == getattr(pj, field)
    assert np.array_equal(pt.h0(), pj.h0())
    sk.validate_slater_koster(pt, atol=1e-8)


@pytest.mark.parametrize("seed", range(4))
def test_slater_koster_functions_match(seed):
    """bond_matrix, rotation_matrix, canonical_bond_matrix and the 12
    neighbour directions to 1e-12 on random directions."""
    rng = np.random.default_rng(seed)
    p = sk.parse_bethe_file("demo")
    d = rng.standard_normal(3)
    d /= np.linalg.norm(d)
    for M in (p.hopping, p.overlap):
        assert np.abs(sk.bond_matrix(M, d) - jsk.bond_matrix(M, d)).max() \
            < 1e-12
        assert np.abs(sk.canonical_bond_matrix(M)
                      - jsk.canonical_bond_matrix(M)).max() < 1e-12
    assert np.abs(sk.rotation_matrix(d) - jsk.rotation_matrix(d)).max() \
        < 1e-12
    normal = rng.standard_normal(3)
    normal /= np.linalg.norm(normal)
    first = np.cross(normal, d)
    first /= np.linalg.norm(first)
    assert np.abs(sk.fcc111_neighbor_directions(normal, first)
                  - jsk.fcc111_neighbor_directions(normal, first)).max() \
        < 1e-12


def test_sk_goldens():
    keys = [str(k) for k in GOLD["Au_keys"]]
    p = sk.bethe_params_from_dict(dict(zip(keys, GOLD["Au_vals"])))
    assert p.ne == 11 and not p.orthogonal
    assert np.max(np.abs(p.h0() - GOLD["H0"])) < 1e-12
    for d, Vref, Sref in zip(GOLD["sk_dirs"], GOLD["sk_V"], GOLD["sk_S"]):
        assert np.max(np.abs(sk.bond_matrix(p.hopping, d) - Vref)) < 1e-10
        assert np.max(np.abs(sk.bond_matrix(p.overlap, d) - Sref)) < 1e-10
    got = sk.fcc111_neighbor_directions(GOLD["nn_normal"], GOLD["nn_first"])
    assert np.max(np.abs(got - GOLD["nn_vecs"])) < 1e-10


@pytest.mark.parametrize("element", ["Au", "Ag", "Cu"])
def test_harrison_matches(element, tmp_path):
    a, b = hr.harrison_bethe_dict(element), jhr.harrison_bethe_dict(element)
    assert a.keys() == b.keys()
    assert max(abs(a[k] - b[k]) for k in a) < 1e-12
    p, q = hr.bethe_params(element), jhr.bethe_params(element)
    assert p.orthogonal and p.ne == q.ne
    assert np.abs(p.h0() - q.h0()).max() < 1e-12
    hr.write_bethe(str(tmp_path / "x.bethe"), element)
    r = sk.parse_bethe_file(str(tmp_path / "x.bethe"))
    assert np.abs(r.h0() - p.h0()).max() < 1e-8       # 10 printed decimals


def test_harrison_missing_inputs_raise():
    with pytest.raises((ValueError, KeyError, TypeError)):
        hr.harrison_bethe_dict(None)


def _fcc_slab(cls, d=2.88, n_dev_orb=4):
    """tests/test_bethe.py's slab: a 3-atom contact triangle, the 9 atoms
    of the second layer, one device atom."""
    u1 = np.array([1.0, 0.0, 0.0]) * d
    u2 = np.array([0.5, np.sqrt(3) / 2, 0.0]) * d
    z_down = np.array([0.5, 0.5 / np.sqrt(3), -np.sqrt(2.0 / 3.0)]) * d
    top = [np.zeros(3), u1, u2]
    second = [z_down + m * u1 + n * u2 for m in (-1, 0, 1)
              for n in (-1, 0, 1)]
    coords = np.stack(top + second + [np.array([1.0, 0.6, -4.5 * d])])
    orb_atoms = []
    for atom in range(1, len(coords) + 1):
        orb_atoms += [atom] * (9 if atom <= 12 else n_dev_orb)
    return cls(coords + 7.0, np.asarray(orb_atoms), None)


def test_geometry_detection_matches():
    a = bt._detect_contact(_fcc_slab(bt.BetheGeometry), [1, 2, 3])
    b = jbt._detect_contact(_fcc_slab(jbt.BetheGeometry), [1, 2, 3])
    for x, y in zip(a[0], b[0]):
        assert np.array_equal(x, y)
    for i in (1, 2, 3):
        assert np.abs(np.asarray(a[i]) - np.asarray(b[i])).max() < 1e-12
    assert a[4] == b[4] and all(len(n) == 5 for n in a[4])


def test_geometry_from_backend():
    be = TightBindingFock(np.zeros((3, 3)), coords=np.eye(3),
                          locs=np.array([1, 2, 3]))
    g = bt.BetheGeometry.from_backend(be)
    assert np.array_equal(g.coords, np.eye(3)) and g.orbital_types is None
    with pytest.raises(ValueError, match="coordinates"):
        bt.BetheGeometry.from_backend(TightBindingFock(np.zeros((3, 3))))


# ---------------------------------------------------------------------------
# Fixed points
# ---------------------------------------------------------------------------

def _au_matrices():
    keys = [str(k) for k in GOLD["Au_keys"]]
    p = sk.bethe_params_from_dict(dict(zip(keys, GOLD["Au_vals"])))
    nv = GOLD["nn_vecs"]
    return (p.h0(), np.stack([sk.bond_matrix(p.overlap, d) for d in nv]),
            np.stack([sk.bond_matrix(p.hopping, d) for d in nv]))


ES = np.array([0.7 + 0.013j, -3.1 + 0.05j, -8.0, 2.0, -5.5])


@pytest.mark.parametrize("exclusion", [True, False])
@pytest.mark.parametrize("update", ["jacobi", "seidel"])
def test_sigma_k_matches_jax(update, exclusion):
    H, Sl, Vl = _au_matrices()
    got = bt.bethe_sigma_k(torch.as_tensor(ES), H, Sl, Vl, 1e-6,
                           update=update, exclusion=exclusion).numpy()
    assert got.shape == (len(ES), 12, 9, 9)
    ref = np.stack([np.asarray(jbt.bethe_sigma_k(
        np.complex128(e), H, Sl, Vl, 1e-6, update=update,
        exclusion=exclusion)) for e in ES])
    assert _rel(got, ref) < 1e-10
    # frozen lanes: the batch equals its energies one at a time
    one = np.stack([bt.bethe_sigma_k(
        torch.as_tensor([e]), H, Sl, Vl, 1e-6, update=update,
        exclusion=exclusion).numpy()[0] for e in ES])
    assert np.abs(got - one).max() < 1e-13


@pytest.mark.parametrize("exclusion", [True, False])
def test_sigma_k_warm_seed_matches_jax(exclusion):
    """sig0: (12, 9, 9) for every lane or (b, 12, 9, 9) per lane."""
    H, Sl, Vl = _au_matrices()
    seed = np.asarray(jbt.bethe_sigma_k(np.complex128(-3.0), H, Sl, Vl, 1e-6,
                                        exclusion=exclusion))
    got = bt.bethe_sigma_k(torch.as_tensor(ES), H, Sl, Vl, 1e-6, sig0=seed,
                           exclusion=exclusion).numpy()
    ref = np.stack([np.asarray(jbt.bethe_sigma_k(
        np.complex128(e), H, Sl, Vl, 1e-6, sig0=seed, exclusion=exclusion))
        for e in ES])
    assert _rel(got, ref) < 1e-10
    per_lane = np.stack([seed * (1 + 0.01 * k) for k in range(len(ES))])
    got = bt.bethe_sigma_k(torch.as_tensor(ES), H, Sl, Vl, 1e-6,
                           sig0=per_lane, exclusion=exclusion).numpy()
    ref = np.stack([np.asarray(jbt.bethe_sigma_k(
        np.complex128(e), H, Sl, Vl, 1e-6, sig0=s, exclusion=exclusion))
        for e, s in zip(ES, per_lane)])
    assert _rel(got, ref) < 1e-10


@pytest.mark.parametrize("exclusion", [True, False])
def test_sigma_surface_matches_jax(exclusion):
    H, Sl, Vl = _au_matrices()
    got = bt.bethe_sigma_surface(torch.as_tensor(ES), H, Sl, Vl, 1e-6,
                                 exclusion=exclusion).numpy()
    assert got.shape == (len(ES), 9, 9, 9)
    ref = np.stack([np.asarray(jbt.bethe_sigma_surface(
        np.complex128(e), H, Sl, Vl, 1e-6, exclusion=exclusion))
        for e in ES])
    assert _rel(got, ref) < 1e-10
    one = np.stack([bt.bethe_sigma_surface(
        torch.as_tensor([e]), H, Sl, Vl, 1e-6,
        exclusion=exclusion).numpy()[0] for e in ES])
    assert np.abs(got - one).max() < 1e-13
    # with sig0 the converged bulk state comes back too
    seed = -1j * np.broadcast_to(np.eye(9), (12, 9, 9))
    surf, bulk = bt.bethe_sigma_surface(torch.as_tensor(ES), H, Sl, Vl, 1e-6,
                                        sig0=seed, exclusion=exclusion)
    js, jb = zip(*[jbt.bethe_sigma_surface(
        np.complex128(e), H, Sl, Vl, 1e-6, sig0=seed, exclusion=exclusion)
        for e in ES])
    assert _rel(surf.numpy(), np.stack([np.asarray(x) for x in js])) < 1e-10
    assert _rel(bulk.numpy(), np.stack([np.asarray(x) for x in jb])) < 1e-10


def test_fixed_point_dtype_and_tight_conv():
    """Evaluated in complex128 whatever the params' dtype, returned in it;
    conv=1e-11 lands within 1e-9 of the map iterated to 1e-13."""
    H, Sl, Vl = _au_matrices()
    E = torch.as_tensor(ES[:2])
    out = bt.bethe_sigma_surface(E.to(torch.complex64),
                                 torch.as_tensor(H).to(torch.complex64),
                                 Sl, Vl, 1e-6)
    assert out.dtype == torch.complex64
    ref = bt.bethe_sigma_surface(E, H, Sl, Vl, 1e-6)
    assert ref.dtype == torch.complex128
    assert _rel(out.numpy(), ref.numpy()) < 1e-5      # complex64 inputs
    tight = bt.bethe_sigma_surface(E, H, Sl, Vl, 1e-6, conv=bt.TIGHT_CONV)
    truth = bt.bethe_sigma_surface(E, H, Sl, Vl, 1e-6, conv=1e-13,
                                   max_iter=5000)
    assert _rel(tight.numpy(), truth.numpy()) < 1e-9
    assert _rel(ref.numpy(), truth.numpy()) > 1e-9    # the default is not


def test_sweep_counts():
    H, Sl, Vl = _au_matrices()
    with bt.SweepCounter() as counter:
        bt.bethe_sigma_k(torch.as_tensor(ES), H, Sl, Vl, 1e-6)
    n = counter.counts()
    assert n.shape == (len(ES),) and n.min() >= 10 and n.max() < 1000
    assert len(set(n.tolist())) > 1          # lanes stop on their own
    bt.bethe_sigma_k(torch.as_tensor(ES), H, Sl, Vl, 1e-6)
    assert counter.counts().size == len(ES)  # nothing recorded outside
    assert bt.SweepCounter._active is None


# ---------------------------------------------------------------------------
# BetheAtomGF
# ---------------------------------------------------------------------------

def _atoms(closure="bethe"):
    H, Sl, Vl = _au_matrices()
    return (bt.BetheAtomGF(H, Sl, Vl, eta=1e-6, T=0.0, closure=closure,
                           device="cpu"),
            jbt.BetheAtomGF(H, Sl, Vl, eta=1e-6, T=0.0, closure=closure))


def test_atom_gf_goldens():
    g, _ = _atoms()
    assert np.max(np.abs(g.F - GOLD["at_F"])) < 1e-10
    assert np.max(np.abs(g.S - GOLD["at_S"])) < 1e-10
    for E, rk, rs in zip(GOLD["at_Es"], GOLD["at_sigmaK"], GOLD["at_sigma"]):
        assert np.max(np.abs(g.sigma_k(float(E)) - rk)) < 5e-4
        assert np.max(np.abs(g.sigma(float(E)) - rs)) < 5e-4
    assert np.max(np.abs(g.sigmaTot(0.0) - GOLD["at_sigmaTot_0"])) < 5e-4
    dos = np.array([g.DOS(float(E)) for E in GOLD["at_Es"]])
    assert np.max(np.abs(dos - GOLD["at_DOS"])) < 1e-2
    assert np.all(dos > -1e-9)


@pytest.mark.parametrize("closure", ["bethe", "lattice"])
def test_atom_gf_matches_jax(closure):
    g, j = _atoms(closure)
    for E in (-8.0, -2.0, 1.5):
        assert _rel(g.sigma_k(E), j.sigma_k(E)) < 1e-10
        assert _rel(g.sigma(E), j.sigma(E)) < 1e-10
        assert _rel(g.sigmaTot(E), j.sigmaTot(E)) < 1e-10
        assert abs(g.DOS(E) - j.DOS(E)) < 1e-9
    seed = j.sigma_k(-2.0)
    assert _rel(g.sigma_k(-2.1, sig0=seed), j.sigma_k(-2.1, sig0=seed)) \
        < 1e-10
    fn, params = g.total_apply()
    assert fn is g.contact_apply(0)[0] and g.num_contacts() == 1
    assert g.total_apply(conv=bt.TIGHT_CONV)[0] is not fn
    assert g.total_apply(conv=1e-5)[0] is fn and g.iterated


def test_atom_gf_rejects_bad_input():
    H, Sl, Vl = _au_matrices()
    with pytest.raises(ValueError, match="expected H"):
        bt.BetheAtomGF(H[:8, :8], Sl, Vl)
    with pytest.raises(ValueError, match="closure"):
        bt.BetheAtomGF(H, Sl, Vl, closure="tree")
    geom = _fcc_slab(bt.BetheGeometry)
    with pytest.raises(ValueError, match="basis functions"):
        bt._detect_contact(geom, [13])          # the 4-orbital device atom


def test_atom_gf_fermi_shift():
    g, _ = _atoms()
    g.fermi = 0.0
    H, V = g.H.copy(), g.Vlist.copy()
    g.update_h(1.5)
    assert np.allclose(g.H, H + 1.5 * np.eye(9))
    assert np.allclose(g.Vlist, V + 1.5 * g.Slist)
    assert g.fermi == 1.5
    assert np.allclose(g.F[-9:, :9], g.Vlist[0])


def _demo_atom(cls):
    p = sk.parse_bethe_file("demo")
    nv = sk.fcc111_neighbor_directions(np.array([0, 0, 1.0]),
                                       np.array([1.0, 0, 0]))
    Sl = np.stack([sk.bond_matrix(p.overlap, d) for d in nv])
    Vl = np.stack([sk.bond_matrix(p.hopping, d) for d in nv])
    return cls(p.h0(), Sl, Vl, eta=1e-5), p.ne / 2


FERMI_TOL = 1e-3

_JAX_CALC_FERMI = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
from gaunegf_tpu.models import bethe
d = np.load(sys.argv[1])
g = bethe.BetheAtomGF(d["H"], d["Sl"], d["Vl"], eta=float(d["eta"]))
print(repr(float(g.calc_fermi(float(d["ne"]), tol=float(d["tol"]),
                              verbose=False))))
"""


def jax_calc_fermi(atom, ne, tol, tmp_dir):
    """gaunegf_tpu's BetheAtomGF.calc_fermi on the arrays of ``atom`` (a
    BetheAtomGF of the port), run in a process of its own with XLA on one
    thread: the search is 32 engine calls of tiny while-loops, which take
    seconds on one thread and minutes when XLA's thread pool fights the
    other test workers for the cores."""
    import subprocess
    import sys
    path = tmp_dir / "atom.npz"
    np.savez(path, H=atom.H, Sl=atom.Slist, Vl=atom.Vlist, eta=atom.eta,
             ne=ne, tol=tol)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    out = subprocess.run([sys.executable, "-c", _JAX_CALC_FERMI, str(path)],
                         env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    return float(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_demo_fermi(tmp_path_factory):
    g, ne = _demo_atom(bt.BetheAtomGF)
    return jax_calc_fermi(g, ne, FERMI_TOL, tmp_path_factory.mktemp("fermi"))


def test_calc_fermi_matches_jax(_default_policy, jax_demo_fermi):
    """Both packages' searches run on the same arrays.  A search stops
    anywhere inside |dN| < tol, so the levels are held at 10 tol, not at
    rounding.  What a probe of the search integrates, the extended
    lattice's contour density, agrees with the JAX package to 1e-9 (both
    in complex128)."""
    from gaunegf_tpu import density as jdens
    from gaunegf_tpu_torch import density as dens
    tol = FERMI_TOL
    g, ne = _demo_atom(bt.BetheAtomGF)
    gj, _ = _demo_atom(jbt.BetheAtomGF)
    assert np.array_equal(g.F, gj.F) and np.array_equal(g.S, gj.S)
    ef = g.calc_fermi(ne, tol=tol, device="cpu", verbose=False)
    assert abs(ef - jax_demo_fermi) < 10 * tol
    assert -5.5 < jax_demo_fermi < -4.5     # inside the demo set's s band
    P = dens.density_complex_n(g.F, g.S, g, -20.0, ef, 16, exec_cfg=(
        ExecutionConfig(precision="exact", solver="lu", energy_chunk=8)),
        device="cpu")
    Pj = jdens.density_complex_n(gj.F, gj.S, gj, -20.0, ef, 16,
                                 exec_cfg=JaxConfig(energy_chunk=8))
    assert _rel(P, Pj) < 1e-9
    with pytest.raises(TypeError):          # the device is required
        g.calc_fermi(ne)


def _junction(fock_cls, geom_cls):
    """tests/test_bethe_scf.py's junction: 3-atom contact patch || 2-site
    molecule || 3-atom contact patch, 56 orbitals."""
    d = 2.88
    u1 = np.array([1.0, 0.0, 0.0]) * d
    u2 = np.array([0.5, np.sqrt(3) / 2, 0.0]) * d
    left = [np.zeros(3), u1, u2]
    mol = [np.array([0.8, 0.5, -2.2]), np.array([0.8, 0.5, -4.0])]
    right = [c + np.array([0, 0, -6.2]) for c in left]
    coords = np.stack(left + mol + right)
    orb_atoms = []
    for atom in range(1, 9):
        orb_atoms += [atom] * (9 if atom in (1, 2, 3, 6, 7, 8) else 1)
    n = len(orb_atoms)
    H = np.zeros((n, n))
    H[27, 27], H[28, 28] = -8.0, -7.0
    H[27, 28] = H[28, 27] = -0.8
    for a in (0, 9, 18):
        H[a, 27] = H[27, a] = -0.4
    for a in (29, 38, 47):
        H[a, 28] = H[28, a] = -0.4
    U = np.zeros(n)
    U[[27, 28]] = 0.5
    backend = fock_cls(H, n_electrons=2.0, U=U, n0=np.zeros(n),
                       coords=coords, locs=np.asarray(orb_atoms))
    return backend, geom_cls(coords, np.asarray(orb_atoms), None)


CONTACTS = [[1, 2, 3], [6, 7, 8]]


# ---------------------------------------------------------------------------
# BetheSelfEnergy
# ---------------------------------------------------------------------------

def _system(spin="r", seed=0):
    n = 12 * 9 + 4
    n_full = n if spin == "r" else 2 * n
    rng = np.random.default_rng(seed)
    A = 0.01 * rng.standard_normal((n_full, n_full))
    S = np.eye(n_full) + (A + A.T) / 2
    F = np.zeros((n_full, n_full))
    return F, S


def _pair(lat, spin="r", eta=1e-6, F=None, S=None):
    """(port provider built by its own geometry detection, port provider
    rebuilt from the JAX provider's host state, JAX provider)."""
    if F is None:
        F, S = _system(spin)
    jp = jbt.BetheSelfEnergy(F, S, [[1, 2, 3]], _fcc_slab(jbt.BetheGeometry),
                             lat_file=lat, spin=spin, eta=eta, fermi=0.0,
                             verbose=False)
    own = bt.BetheSelfEnergy(F, S, [[1, 2, 3]], _fcc_slab(bt.BetheGeometry),
                             lat_file=lat, spin=spin, eta=eta, fermi=0.0,
                             device="cpu", verbose=False)
    ps = jp.params_sk
    arr = interop.bethe_self_energy_from_arrays(
        F, S, ps.ne, ps.onsite, ps.hopping, ps.overlap, jp.inds_lists,
        jp.n_ind_lists, jp.dir_lists, jp.fermi, jp.spin, jp.eta, jp.T,
        device="cpu")
    return own, arr, jp


@pytest.mark.parametrize("spin", ["r", "u", "g"])
@pytest.mark.parametrize("lat", ["demo", "Au"])
def test_provider_sigma_matches_jax(lat, spin):
    own, arr, jp = _pair(lat, spin)
    assert own._static_key()[:5] == jp._static_key()
    assert arr._static_key()[:5] == jp._static_key()
    assert own.orthogonal == (lat == "Au")
    if own.orthogonal:      # S^(1/2) exists only where the embedding uses it
        assert np.abs(own.Xi - jp.Xi).max() < 1e-12
        assert np.abs(arr.Xi - jp.Xi).max() < 1e-12
    else:
        assert own.Xi is None and arr.Xi is None
    for E in (-2.0, -7.5 + 0.05j):
        ref = jp.sigmaTot(E)
        assert _rel(own.sigmaTot(E), ref) < 1e-10
        assert _rel(arr.sigmaTot(E), ref) < 1e-10
        assert _rel(arr.sigma(E, 0), jp.sigma(E, 0)) < 1e-10
    want = jp.contact_inds()
    assert own.contact_inds() == want == arr.contact_inds(0)
    assert (want is None) == (lat == "Au" or spin != "r")


def test_provider_sigma_is_retarded_and_local():
    own, _, _ = _pair("demo")
    sig = own.sigmaTot(-2.0)
    assert np.max(np.abs(sig[27:, 27:])) < 1e-12
    blk = sig[:27, :27]
    assert np.max(np.abs(blk)) > 1e-3
    assert np.linalg.eigvalsh(1j * (blk - blk.conj().T)).min() > -1e-6
    s0, s1 = own.getSigma((-2.0, -2.0))
    assert np.array_equal(s0, s1) and _rel(s0, sig) < 1e-12


def test_provider_batch_and_block():
    """fn(params, E) is batched over E; total_block_apply gives the
    contact block of the total without the (b, N, N) stack, and raises
    where the embedding is dense."""
    own, _, _ = _pair("demo")
    fn, params = own.total_apply()
    p = bt._host_params(params, "cpu")
    E = torch.as_tensor(ES)
    full = fn(p, E)
    assert full.shape == (len(ES), 112, 112)
    for k, e in enumerate(ES):
        assert _rel(full[k].numpy(), own.sigmaTot(e)) < 1e-13
    c = own.contact_inds()
    blk = own.total_block_apply(c)(p, E)
    ci = np.asarray(c)
    assert np.abs(blk.numpy() - full.numpy()[:, ci[:, None], ci[None, :]]
                  ).max() < 1e-14
    c_perm = tuple(reversed(c))                 # any order of the support
    ci = np.asarray(c_perm)
    blk = own.total_block_apply(c_perm)(p, E)
    assert np.abs(blk.numpy() - full.numpy()[:, ci[:, None], ci[None, :]]
                  ).max() < 1e-14
    dense, _, _ = _pair("Au")
    with pytest.raises(ValueError, match="dense"):
        dense.total_block_apply(tuple(range(27)))


def test_closures_keep_their_identity():
    own, arr, _ = _pair("demo")
    assert own.total_apply()[0] is arr.total_apply()[0]
    assert own.contact_apply(0)[0] is own.contact_apply(-1)[0]
    assert own.contacts_warm_apply()[0] is arr.contacts_warm_apply()[0]
    tight = bt.TIGHT_CONV
    assert own.total_apply(conv=tight)[0] is not own.total_apply()[0]
    assert own.total_apply(conv=tight)[0] is arr.total_apply(conv=tight)[0]
    assert own.contacts_warm_apply(conv=tight)[0] \
        is not own.contacts_warm_apply()[0]
    c = own.contact_inds()
    assert own.total_block_apply(c) is arr.total_block_apply(c)


def test_set_fock_realigns_contacts():
    """muL / muR shift H and Vlist of the first and last contact, so
    params() must be re-read after set_fock; both packages agree."""
    F = np.zeros((56, 56))
    be, geom = _junction(TightBindingFock, bt.BetheGeometry)
    jbe, jgeom = _junction(JaxFock, jbt.BetheGeometry)
    own = bt.BetheSelfEnergy(F, np.eye(56), [[1, 2, 3], [6, 7, 8]], geom,
                             lat_file="demo", eta=1e-5, fermi=0.0,
                             device="cpu", verbose=False)
    jp = jbt.BetheSelfEnergy(F, np.eye(56), [[1, 2, 3], [6, 7, 8]], jgeom,
                             lat_file="demo", eta=1e-5, fermi=0.0,
                             verbose=False)
    before = own.params()["contacts"][0]["H"].copy()
    own.set_fock(F, 0.05, -0.05)
    jp.set_fock(F, 0.05, -0.05)
    after = own.params()["contacts"]
    assert np.allclose(after[0]["H"], before + 0.05 * np.eye(9))
    assert np.allclose(after[1]["H"], before - 0.05 * np.eye(9))
    assert own.g_list[0].fermi == 0.05 and own.g_list[-1].fermi == -0.05
    for i in (0, 1):
        assert _rel(own.sigma(-7.5, i), jp.sigma(-7.5, i)) < 1e-10
    assert _rel(own.sigmaTot(-7.5), jp.sigmaTot(-7.5)) < 1e-10


