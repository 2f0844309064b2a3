"""The port's spectral route (ops/spectral.py) against complex128 direct
solves, and its routing.

The junction is tests/test_spectral.py's: a disordered chain of N=96
orbitals with 8+8 constant contact orbitals, with and without a
non-orthogonal overlap.  The truth is a NumPy complex128 inverse per
energy point.  The route runs in float64/complex128 throughout (basis,
k-chain, stacked product, rotation), so every sum and T(E) is held to
1e-10 of its largest entry, on grids that put points at pole distances
1e-7, 3e-5 and exactly 0 (the deflated chain).  As in the JAX package,
G< and T(E) take Gamma on the contact block only: the references build
Gamma the same way (the -1j*1e-9*S broadening background enters Gamma
only through its contact-block part, minus c0*S for the total).
"""

import warnings

import numpy as np
import pytest
import torch

from gaunegf_tpu_torch.config import ExecutionConfig
from gaunegf_tpu_torch.models.chain1d import Chain1DSelfEnergy
from gaunegf_tpu_torch.models.selfenergy import ConstantSelfEnergy
from gaunegf_tpu_torch.ops import spectral as sp
from gaunegf_tpu_torch.ops.greens import EnergyEngine
from gaunegf_tpu_torch.transport import _StaticSigma

CPU = "cpu"
REL = 1e-10
C0 = -2e-9j            # two form_sigma backgrounds of -1j*1e-9*S each


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(N=96, k_per=8, seed=0, overlap=False):
    rng = np.random.default_rng(seed)
    H = -1.0 * (np.eye(N, k=1) + np.eye(N, k=-1)) \
        + np.diag(0.2 * rng.standard_normal(N))
    if overlap:
        B = rng.standard_normal((N, N)) / (10 * np.sqrt(N))
        S = np.eye(N) + 0.5 * (B + B.T)
    else:
        S = np.eye(N)
    inds = [np.arange(k_per), np.arange(N - k_per, N)]
    return H, S, inds


def _const(H, S, inds):
    return ConstantSelfEnergy(H, S, inds, sig1=-0.1j, device="cpu")


def _near_grid(lam, n=24):
    """A real-axis grid with points at pole distance 1e-7, 3e-5 and 0."""
    E = np.linspace(-1.5, 1.5, n)
    E[5] = lam[20] + 1e-7
    E[11] = lam[len(lam) // 2]
    E[17] = lam[60] + 3e-5
    return E


def _contour(n=24):
    z = -1.0 + 1.5 * np.exp(1j * np.linspace(0.1, np.pi - 0.1, n))
    return z, (0.3 + 0.1j) * np.ones(n) / n


def _truth(H, S, g, E, w, kind="gr", contact=None, c0=C0):
    """sum_j w_j G(E_j) or w_j G Gamma G^H in complex128 by np.linalg.inv;
    Gamma is taken on the union contact block c: i(X - X^H) with X the
    contact's Sigma block, or the total's minus c0*S for contact None."""
    c = list(g.contact_inds(None))
    ix = np.ix_(c, c)
    out = 0.0
    for e, ww in zip(E, w):
        sig = g.sigmaTot(e)
        G = np.linalg.inv(e * S - H - sig)
        if kind == "gr":
            out = out + ww * G
            continue
        blk = (sig[ix] - c0 * S[ix] if contact is None
               else g.sigma(e, contact)[ix])
        gam = np.zeros_like(G)
        gam[ix] = 1j * (blk - blk.conj().T)
        out = out + ww * G @ gam @ G.conj().T
    return out


def _truth_T(H, S, g, E):
    c1, c2 = list(g.contact_inds(0)), list(g.contact_inds(-1))
    T = []
    for e in E:
        G = np.linalg.inv(e * S - H - g.sigmaTot(e))[np.ix_(c1, c2)]
        s1 = g.sigma(e, 0)[np.ix_(c1, c1)]
        s2 = g.sigma(e, -1)[np.ix_(c2, c2)]
        g1 = 1j * (s1 - s1.conj().T)
        g2 = 1j * (s2 - s2.conj().T)
        T.append(np.trace(g1 @ G @ g2 @ G.conj().T).real)
    return np.asarray(T)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _engine(H, S, g, **cfg):
    cfg.setdefault("energy_chunk", 4)
    return EnergyEngine(H, S, g, ExecutionConfig(**cfg), device=CPU)


# ---------------------------------------------------------------------------
# Against complex128 direct solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overlap", [False, True])
def test_gr_sum_matches_direct(overlap):
    H, S, inds = _system(overlap=overlap)
    g = _const(H, S, inds)
    eng = _engine(H, S, g)
    runner = eng._spectral_runner()
    assert runner is not None
    E = _near_grid(runner.lam64)
    w = np.linspace(0.5, 1.5, E.size) / E.size
    assert (runner._dists(E) < 1e-4).sum() >= 3
    assert _rel(eng.gr_sum(E, w), _truth(H, S, g, E, w)) < REL
    zc, wc = _contour()
    ref = _truth(H, S, g, zc, wc)
    assert _rel(eng.gr_sum(zc, wc), ref) < REL
    im = eng.gr_sum(zc, wc, epilog="im")
    assert im.dtype == np.float64
    assert np.abs(im - ref.imag).max() < REL * np.abs(ref).max()


@pytest.mark.parametrize("contact", [None, 0, 1])
def test_gless_sum_matches_direct(contact):
    H, S, inds = _system()
    g = _const(H, S, inds)
    eng = _engine(H, S, g)
    E = _near_grid(eng._spectral_runner().lam64)
    w = np.ones(E.size) / E.size
    (_, _), (Eb, _) = eng._spectral_runner().split_grid(E, w)
    assert Eb.size == 0                     # deflation serves every point
    got = eng.gless_sum(E, w, contact)
    assert _rel(got, _truth(H, S, g, E, w, "gless", contact)) < REL


def test_density_neq_sum_matches_direct():
    H, S, inds = _system(overlap=True)
    g = _const(H, S, inds)
    eng = _engine(H, S, g)
    zc, wc = _contour(16)
    En = _near_grid(eng._spectral_runner().lam64)
    wn = np.full(En.size, 0.03)
    got = eng.density_neq_sum(zc, wc, En, wn, contact=-1)
    ref = _truth(H, S, g, zc, wc).imag \
        + _truth(H, S, g, En, wn, "gless", -1)
    assert _rel(got, ref) < REL


def test_transmission_matches_direct():
    H, S, inds = _system()
    g = _const(H, S, inds)
    eng = _engine(H, S, g)
    E = np.linspace(-1.8, 1.8, 32)
    lam = eng._spectral_runner().lam64
    E[7], E[9], E[12] = lam[40] + 1e-7, lam[20], lam[60] + 3e-5
    T = eng.transmission(E)
    assert T.shape == E.shape and T.dtype == np.float64
    assert eng._spectral_fb is None         # no LU point on this grid
    assert _rel(T, _truth_T(H, S, g, E)) < REL


def test_exact_hit_without_background():
    """c0 = 0 (no broadening background) and a grid point exactly on a
    bare eigenvalue: the capacitance stays invertible through the
    contacts' imaginary part and the sum stays finite and exact."""
    H, S, inds = _system()
    # -0.05j diagonal, no background
    g = ConstantSelfEnergy(H, S, inds, device="cpu")
    eng = _engine(H, S, g)
    runner = eng._spectral_runner()
    assert runner.c0 == 0
    E = np.linspace(-1.5, 1.5, 12)
    E[4] = runner.lam64[30]
    assert runner._dists(E).min() == 0.0
    w = np.ones(12) / 12
    got = eng.gr_sum(E, w)
    assert np.isfinite(got).all()
    assert _rel(got, _truth(H, S, g, E, w, c0=0)) < REL


def test_deflate_off_uses_the_exact_lu_fallback(monkeypatch):
    """spectral_deflate=0: the points within spectral_dist_lu of a bare
    eigenvalue (1e-7 and the exact hit) go to the exact-tier LU, the rest
    (3e-5 included) to the plain chain; the two parts sum to the truth."""
    H, S, inds = _system()
    g = _const(H, S, inds)
    eng = _engine(H, S, g, spectral_deflate=0)
    runner = eng._spectral_runner()
    E = _near_grid(runner.lam64)
    w = np.ones(E.size) / E.size
    (Eg, _), (Eb, _) = runner.split_grid(E, w)
    assert Eb.size == 2 and Eg.size == E.size - 2
    assert set(Eb.real) == {E[5], E[11]}
    fb = eng._spectral_fallback_engine()
    assert fb.exec_cfg.precision == "exact" and fb.exec_cfg.solver == "lu"
    assert fb.exec_cfg.energy_chunk == 4 and fb._spectral_runner() is None
    calls = []
    lu = fb._gr_sum_lu
    monkeypatch.setattr(fb, "_gr_sum_lu",
                        lambda *a: calls.append(len(a[0])) or lu(*a))
    assert _rel(eng.gr_sum(E, w), _truth(H, S, g, E, w)) < REL
    assert calls == [2]
    # T(E): the LU points are put back in place
    Et = np.linspace(-1.8, 1.8, 16)
    Et[3] = runner.lam64[40] + 1e-7
    assert _rel(eng.transmission(Et), _truth_T(H, S, g, Et)) < REL


def test_fast_tier_keeps_the_grid_in_complex128():
    """The fast tier's engine holds its operands in complex64, but the
    route forms z' - lam from the complex128 host grid: a point 1e-7
    from a pole must not be rounded onto it."""
    H, S, inds = _system()
    g = _const(H, S, inds)
    eng = _engine(H, S, g, precision="fast")
    assert eng.cdtype == torch.complex64
    E = _near_grid(eng._spectral_runner().lam64)
    w = np.ones(E.size) / E.size
    assert _rel(eng.gr_sum(E, w), _truth(H, S, g, E, w)) < REL


def _chain(N=40):
    H = -1.0 * (np.eye(N, k=1) + np.eye(N, k=-1))
    S = np.eye(N)
    g = Chain1DSelfEnergy(H, S, [np.arange(4), np.arange(N - 4, N)],
                          taus=[np.arange(4, 8), np.arange(N - 8, N - 4)],
                          eta=1e-4, device="cpu")
    return H, S, g


@pytest.mark.parametrize("what", ["gr_sum", "gless_sum", "transmission"])
def test_chain_provider_matches_strict(what):
    """An energy-dependent 1D-chain Sigma (Sancho-Rubio per point): only
    the bare resolvent is spectral, M(z) is re-evaluated per point.  The
    port's strict tier (complex128 torch.linalg.solve) is the truth."""
    H, S, g = _chain()
    eng = _engine(H, S, g)
    assert eng._spectral_runner() is not None
    strict = _engine(H, S, g, precision="strict")
    if what == "gr_sum":
        z = np.linspace(-1.0, 1.0, 12) + 0.05j
        w = np.ones(12) / 12
        assert _rel(eng.gr_sum(z, w), strict.gr_sum(z, w)) < REL
    elif what == "gless_sum":
        E = np.linspace(-1.5, 1.5, 17)
        w = np.ones(17) / 17
        for c in (None, 0):
            assert _rel(eng.gless_sum(E, w, c), strict.gless_sum(E, w, c)) \
                < REL
    else:
        E = np.linspace(-1.5, 1.5, 17)
        assert _rel(eng.transmission(E), strict.transmission(E)) < REL


# ---------------------------------------------------------------------------
# Routing: engage and decline as the JAX package does
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["fast", "mixed"])
@pytest.mark.parametrize("solver", ["auto", "spectral"])
def test_route_engages(precision, solver):
    H, S, inds = _system(32, 4)
    eng = _engine(H, S, _const(H, S, inds), precision=precision,
                  solver=solver)
    assert eng._spectral_runner() is not None


class _NoInds:
    """A provider without contact_inds (tests/test_spectral.py)."""

    def __init__(self, base):
        self.base = base

    def params(self):
        return {"base": self.base}

    def total_apply(self):
        return _noinds_total, self.params()

    def num_contacts(self):
        return 2


def _noinds_total(params, E):
    n = params["base"].shape[-1]
    eye = torch.eye(n, dtype=params["base"].dtype, device=E.device)
    return params["base"] * (1 + 0.1 * E[:, None, None]) - 0.05j * eye


def _leaky(H, S, inds):
    g = _const(H, S, inds)
    rng = np.random.default_rng(1)
    g._sigs = g._sigs + (-0.01j) * rng.standard_normal(g._sigs.shape[1:])
    return g


class _EnergyBackground(ConstantSelfEnergy):
    """Contact blocks plus a background that grows with E."""

    def total_apply(self):
        return _energy_background_total, self.params()


def _energy_background_total(params, E):
    sig = params["sigs"].sum(dim=0)
    n = sig.shape[-1]
    eye = torch.eye(n, dtype=sig.dtype, device=sig.device)
    return sig - 1e-3j * E[:, None, None] * eye


def _decline_case(case):
    """(H, S, provider, config) of one decline case."""
    H, S, inds = _system(32, 4)
    cfg = {}
    g = None
    if case in ("high", "exact", "strict"):
        cfg["precision"] = case
    elif case == "lu":
        cfg["solver"] = "lu"
    elif case == "continuation":
        cfg["continuation"] = True
    elif case == "no_contact_inds":
        g = _NoInds(H * 0.1)
    elif case == "leaky_sigma":
        g = _leaky(H, S, inds)
    elif case == "energy_dependent_background":
        g = _EnergyBackground(H, S, inds, sig1=-0.1j)
    elif case == "k_over_half":
        inds = [np.arange(10), np.arange(32 - 10, 32)]
    elif case == "complex_h":
        H = H.astype(complex)
        H[0, 1] += 0.1j
        H[1, 0] -= 0.1j
    elif case == "nonsymmetric_h":
        H = H.copy()
        H[0, 1] += 0.1
    return H, S, g if g is not None else _const(H, S, inds), cfg


@pytest.mark.parametrize("case", [
    "high", "exact", "strict", "lu", "continuation", "no_contact_inds",
    "leaky_sigma", "energy_dependent_background", "k_over_half",
    "complex_h", "nonsymmetric_h"])
def test_route_declines(case):
    """Each decline case keeps the LU route, which still answers."""
    H, S, g, cfg = _decline_case(case)
    eng = _engine(H, S, g, **cfg)
    assert eng._spectral_runner() is None
    z, w = _contour(8)
    assert np.isfinite(eng.gr_sum(z, w)).all()


def test_transmission_declines_outside_the_union_support(monkeypatch):
    """T(E) on the spectral route needs c1, c2 inside the union support
    c; otherwise the runner returns None and the LU route runs."""
    H, S, inds = _system(32, 4)
    g = _StaticSigma(np.diag(np.r_[np.full(4, -0.1j), np.zeros(28)]),
                     np.diag(np.r_[np.zeros(28), np.full(4, -0.1j)]))
    eng = _engine(H, S, g)
    runner = eng._spectral_runner()
    assert runner is not None and runner.c == tuple(range(4)) \
        + tuple(range(28, 32))
    E = np.linspace(-1.5, 1.5, 8)
    assert runner.transmission(g, E) is not None
    monkeypatch.setattr(g, "contact_inds",
                        lambda i=None: (0, 1, 2, 3, 4) if i == 0
                        else tuple(range(28, 32)) if i in (1, -1)
                        else tuple(range(4)) + tuple(range(28, 32)))
    assert runner.transmission(g, E) is None
    lu = _engine(H, S, g, solver="lu").transmission(E)
    assert np.allclose(eng.transmission(E), lu, rtol=0, atol=1e-12)


def test_segments_and_modes():
    """Far points run the plain chain, near ones the deflated chain (3x
    the distance for G<); an all-far grid is one plain segment, and
    deflation off is one plain segment whatever the distances."""
    H, S, inds = _system()
    g = _const(H, S, inds)
    runner = _engine(H, S, g)._spectral_runner()
    lam = runner.lam64
    far = np.linspace(-1.5, 1.5, 16) + 0.05j
    assert runner._mode(far) == "plain"
    assert [s[1] for s in runner._segments(far, 1e-4)] == [None]
    E = np.linspace(-1.5, 1.5, 16)
    E[3] = lam[30] + 1e-6
    E[9] = lam[50] + 2e-4                   # within 3e-4 but not 1e-4
    assert runner._mode(E) == "defl"
    (pos_f, i_f), (pos_n, idx) = runner._segments(E, 1e-4)
    assert i_f is None and 3 in pos_n and 9 in pos_f
    assert idx.shape == (pos_n.size, 8) and 30 in idx[list(pos_n).index(3)]
    assert 9 in runner._segments(E, 3e-4)[1][0]
    off = _engine(H, S, g, spectral_deflate=0)._spectral_runner()
    assert [s[1] for s in off._segments(E, 1e-4)] == [None]
    assert off._mode(np.array([lam[3]])) is None


def test_spectral_chunk_rule():
    """Automatic chunk: the largest power of two in [_SPECTRAL_CHUNK_MIN,
    _SPECTRAL_CHUNK_MAX] whose lanes fit the budget; the engine's runner
    takes it only when the engine's chunk was automatic."""
    for k, N in ((16, 1000), (16, 2000), (16, 40000), (256, 100000),
                 (1, 10)):
        c = sp.spectral_chunk(k, N)
        assert sp._SPECTRAL_CHUNK_MIN <= c <= sp._SPECTRAL_CHUNK_MAX
        assert c & (c - 1) == 0
        lane = sp._SPECTRAL_LANE_BYTES_PER_NK * k * N
        assert c == sp._SPECTRAL_CHUNK_MIN \
            or c * lane <= sp._SPECTRAL_CHUNK_BUDGET_BYTES
        assert c == sp._SPECTRAL_CHUNK_MAX \
            or 2 * c * lane > sp._SPECTRAL_CHUNK_BUDGET_BYTES
    H, S, inds = _system(32, 4)
    g = _const(H, S, inds)
    auto = EnergyEngine(H, S, g, ExecutionConfig(), device=CPU)
    assert auto._spectral_runner().exec_cfg.energy_chunk \
        == sp.spectral_chunk(8, 32)
    assert _engine(H, S, g, energy_chunk=3)._spectral_runner() \
        .exec_cfg.energy_chunk == 3


@pytest.mark.parametrize("overlap", [False, True])
def test_spectral_basis(overlap):
    """C^T S C = I and H C = S C diag(lam) in float64; cached by content
    and device (4 entries)."""
    H, S, _ = _system(48, 4, overlap=overlap)
    lam, C = sp.spectral_basis(H, S, CPU)
    C = C.numpy()
    assert lam.dtype == np.float64 and C.dtype == np.float64
    assert np.all(np.diff(lam) >= 0)
    assert np.abs(C.T @ S @ C - np.eye(48)).max() < 1e-12
    assert np.abs(H @ C - S @ C * lam).max() < 1e-12
    assert sp.spectral_basis(H.copy(), S.copy(), CPU)[1] is \
        sp.spectral_basis(H, S, CPU)[1]
    for i in range(sp._BASIS_CACHE_SIZE + 1):
        sp.spectral_basis(H + i * 1e-3 * np.eye(48), S, CPU)
    assert len(sp._BASIS_CACHE) == sp._BASIS_CACHE_SIZE


def test_spectral_basis_refuses():
    H, S, _ = _system(32, 4)
    Hc = H.astype(complex)
    Hc[0, 1] += 0.1j
    Hc[1, 0] -= 0.1j
    assert sp.spectral_basis(Hc, S, CPU) is None
    Hn = H.copy()
    Hn[0, 1] += 0.1
    assert sp.spectral_basis(Hn, S, CPU) is None
    assert sp.spectral_basis(H, -np.eye(32), CPU) is None  # S not definite
    assert sp.spectral_basis(H.astype(complex), S, CPU) is not None


def test_spectral_entry_points_need_a_device():
    """No CPU default: like every entry point, the basis runs only where
    the caller names."""
    H, S, inds = _system(32, 4)
    g = _const(H, S, inds)
    with pytest.raises(TypeError):
        sp.spectral_basis(H, S)
    with pytest.raises(TypeError):
        sp.spectral_basis(H, S, None)
    with pytest.raises(TypeError):
        sp.spectral_supported(g, H, S)
    with pytest.raises(TypeError):
        sp.spectral_supported(g, H, S, None)


def test_detect_structure():
    """c0 and the union support from two probes; cached on the provider;
    the k <= N//2 cap."""
    H, S, inds = _system(32, 4, overlap=True)
    g = _const(H, S, inds)
    st = sp.detect_structure(g, S, device="cpu")
    assert st.c == tuple(range(4)) + tuple(range(28, 32))
    assert abs(st.c0 - C0) < 1e-15
    assert np.allclose(st.bg_cc, C0 * S[np.ix_(st.c, st.c)], atol=1e-20)
    assert g._spectral_struct is st
    assert sp.detect_structure(g, S, device="cpu") is st
    assert sp.spectral_supported(g, H, S, CPU)
    wide = _const(H, S, [np.arange(9), np.arange(23, 32)])
    assert sp.detect_structure(wide, S, device="cpu") is None
    assert ConstantSelfEnergy(H, S, inds, sig1=-0.1j).total_block_apply(
        st.c)({"sigs": torch.as_tensor(g._sigs)}, None).shape == (8, 8)


def test_no_warning_from_the_spectral_route():
    """The route itself never runs the LU near-pole guard."""
    H, S, inds = _system()
    g = _const(H, S, inds)
    eng = _engine(H, S, g)
    E = _near_grid(eng._spectral_runner().lam64)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng.gr_sum(E, np.ones(E.size))
        eng.gless_sum(E, np.ones(E.size), 0)
