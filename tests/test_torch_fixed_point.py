"""The fixed-point kernels' plain versions against the JAX package, and
NumPy mirrors of the kernels' own schedules against the plain versions.

``ops/kernels/fixed_point.py`` (kernel A: the Bethe bulk / surface and the
k-space in-plane relaxation) and ``ops/kernels/sancho_rubio.py`` (kernel B:
Sancho-Rubio decimation and the relaxed Dyson map) each hold a plain
PyTorch version, which a CPU tensor takes.  The same NumPy inputs go
through the JAX functions (x64, CPU, one energy at a time as their
while_loops run) and the plain versions (complex128, a batch):

* every mode at the default conv and at TIGHT_CONV, warm seeds per lane,
  chains at n = 1 and 3, k-space lanes at n = 9: 1e-10 of the largest
  entry, the bound of tests/test_torch_bethe.py (both iterate the same map
  to the same stop, so they differ by the rounding of the inverses);
* a batch's per-lane sweep counts equal each energy's count alone (a
  stopped lane is frozen);
* a CPU tensor takes the plain version and leaves LAUNCHES at 0.

The CUDA kernels cannot run here.  Their arithmetic schedule is mirrored in
NumPy -- the in-place Gauss-Jordan inverse with the row swaps undone as
column swaps, the Seidel sweep as two rounds of six directions, the loop's
stop rule, the decimation's and the Dyson map's order of operations -- and
each mirror is held to the plain version: the inverse to 1e-13 of the
LAPACK inverse, the loops to 1e-12 with equal counts.
"""

import numpy as np
import pytest
import torch

from gaunegf_tpu.models import bethe as jbt
from gaunegf_tpu.models import chain1d as jchain
from gaunegf_tpu.models import kspace as jks
from gaunegf_tpu_torch.config import TIGHT_CONV
from gaunegf_tpu_torch.models import bethe as bt
from gaunegf_tpu_torch.models import chain1d as tchain
from gaunegf_tpu_torch.models import harrison as hr
from gaunegf_tpu_torch.models import kspace as ks
from gaunegf_tpu_torch.models import slater_koster as sk
from gaunegf_tpu_torch.ops.kernels import fixed_point as fpk
from gaunegf_tpu_torch.ops.kernels import sancho_rubio as srk

torch.set_num_threads(1)
ES = np.array([0.7 + 0.013j, -3.1 + 0.05j, -8.0, 2.0, -5.5])
ETA = 1e-6
MIX = 0.5


def _rel(x, ref):
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


def _au():
    p = hr.bethe_params("Au")
    n_vecs = sk.fcc111_neighbor_directions(np.array([0, 0, 1.0]),
                                           np.array([1.0, 0, 0]))
    Sl = np.stack([sk.bond_matrix(p.overlap, d) for d in n_vecs])
    Vl = np.stack([sk.bond_matrix(p.hopping, d) for d in n_vecs])
    return p.h0(), n_vecs, Sl, Vl


def _bulk_operators(E, H, Sl, Vl, eta=ETA):
    """A (b, 9, 9), B (b, 12, 9, 9) as models/bethe builds them."""
    z = np.asarray(E, complex) - 1j * eta
    A = z[:, None, None] * np.eye(9) - H
    B = z[:, None, None, None] * Sl - Vl
    return torch.as_tensor(A), torch.as_tensor(B)


def _cold(b):
    return torch.as_tensor(np.broadcast_to(-1j * np.eye(9),
                                           (b, 12, 9, 9)).copy())


def _chain_blocks(n, seed=3):
    """A, B surface blocks at 6 energies, band edges and gaps included
    (tests/test_torch_transport.py's chain)."""
    rng = np.random.default_rng(seed)
    alpha = rng.standard_normal((n, n)) * 0.3
    alpha = alpha + alpha.T
    beta = -np.eye(n) + 0.1 * rng.standard_normal((n, n))
    E = np.array([-2.6, -1.9, -0.7, 0.05, 1.2, 2.4]) + 1j * 1e-4
    A = E[:, None, None] * np.eye(n) - alpha
    B = np.broadcast_to(-beta, A.shape).copy()
    return A, B


def _kspace_blocks(nk=2, E=ES[:3]):
    """The (b*Nk, 9, 9) decimation lanes of kspace_sigma_down."""
    H, n_vecs, Sl, Vl = _au()
    pp, dp = ks.kspace_phases(n_vecs, nk)
    c = lambda x: torch.as_tensor(np.asarray(x)).to(torch.complex128)
    H00, S00, H01, S01 = ks._bloch_blocks(c(H), c(Sl), c(Vl), c(pp), c(dp))
    z = torch.as_tensor(np.asarray(E, complex) + 1j * ETA)[:, None, None,
                                                             None]
    A = (z * S00 - H00).reshape(-1, 9, 9)
    B = (z * S01 - H01).reshape(-1, 9, 9)
    return A.numpy(), B.numpy()


# ---------------------------------------------------------------------------
# Kernel A's plain version against the JAX fixed points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("conv", [1e-5, TIGHT_CONV])
@pytest.mark.parametrize("exclusion", [True, False])
@pytest.mark.parametrize("update", ["jacobi", "seidel"])
def test_bulk_plain_matches_jax(update, exclusion, conv):
    H, _, Sl, Vl = _au()
    A, B = _bulk_operators(ES, H, Sl, Vl)
    got, surf, counts, metric = fpk.fixed_point_plain(
        A, B, _cold(len(ES)), conv, MIX, 1000, bulk=update,
        exclusion=exclusion)
    assert surf is None and counts.dtype == torch.int32
    assert (counts[:, 1] == 0).all() and (metric[:, 0] <= conv).all()
    ref = np.stack([np.asarray(jbt.bethe_sigma_k(
        np.complex128(e), H, Sl, Vl, ETA, conv=conv, update=update,
        exclusion=exclusion)) for e in ES])
    assert _rel(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("exclusion", [True, False])
def test_surface_plain_matches_jax_with_warm_seeds(exclusion):
    """Bulk and surface loops in one call from a per-lane warm seed, at
    TIGHT_CONV: both stacks against the JAX bethe_sigma_surface."""
    H, _, Sl, Vl = _au()
    seed = np.asarray(jbt.bethe_sigma_k(np.complex128(-3.0), H, Sl, Vl, ETA,
                                        exclusion=exclusion))
    per_lane = np.stack([seed * (1 + 0.01 * k) for k in range(len(ES))])
    A, B = _bulk_operators(ES, H, Sl, Vl)
    bulk, surf, counts, _ = fpk.fixed_point_plain(
        A, B, torch.as_tensor(per_lane), TIGHT_CONV, MIX, 1000,
        exclusion=exclusion, surface=True)
    js, jb = zip(*[jbt.bethe_sigma_surface(
        np.complex128(e), H, Sl, Vl, ETA, conv=TIGHT_CONV, sig0=s,
        exclusion=exclusion) for e, s in zip(ES, per_lane)])
    assert _rel(surf.numpy(), np.stack([np.asarray(x) for x in js])) < 1e-10
    assert _rel(bulk.numpy(), np.stack([np.asarray(x) for x in jb])) < 1e-10
    assert (counts > 0).all()


@pytest.mark.parametrize("warm", [False, True])
def test_kspace_surface_plain_matches_jax(warm):
    """The surface loop alone around a per-lane A (Sigma_down inside), from
    zero or from a warm seed per lane, against kspace_sigma_surface."""
    H, n_vecs, Sl, Vl = _au()
    pp, dp = ks.kspace_phases(n_vecs, 2)
    E = ES[:4]
    down = ks.kspace_sigma_down(torch.as_tensor(E), H, Sl, Vl, pp, dp, ETA,
                                TIGHT_CONV)
    z = torch.as_tensor(E + 1j * ETA)
    A = z[:, None, None] * torch.eye(9, dtype=torch.complex128) \
        - torch.as_tensor(H).to(torch.complex128) - down
    B = z[:, None, None, None] * torch.as_tensor(Sl).to(torch.complex128) \
        - torch.as_tensor(Vl).to(torch.complex128)
    seeds = [None] * len(E)
    seed = torch.zeros((len(E), 9, 9, 9), dtype=torch.complex128)
    if warm:
        s0 = np.asarray(jks.kspace_sigma_surface(
            np.complex128(-3.0), H, Sl, Vl, pp, dp, ETA)[0])
        seeds = [s0 * (1 + 0.02 * k) for k in range(len(E))]
        seed = torch.as_tensor(np.stack(seeds))
    _, got, counts, _ = fpk.fixed_point_plain(A, B, seed, TIGHT_CONV, MIX,
                                              1000, bulk=None, surface=True)
    ref = np.stack([np.asarray(jks.kspace_sigma_surface(
        np.complex128(e), H, Sl, Vl, pp, dp, ETA, conv=TIGHT_CONV,
        sig0=s)[0]) for e, s in zip(E, seeds)])
    assert _rel(got.numpy(), ref) < 1e-10
    assert (counts[:, 0] == 0).all() and (counts[:, 1] > 0).all()


@pytest.mark.parametrize("surface", [False, True])
@pytest.mark.parametrize("update", ["jacobi", "seidel"])
def test_fixed_point_counts_are_per_lane(update, surface):
    """A batch's sweep counts and values equal each energy's alone."""
    H, _, Sl, Vl = _au()
    A, B = _bulk_operators(ES, H, Sl, Vl)
    bulk, surf, counts, metric = fpk.fixed_point_plain(
        A, B, _cold(len(ES)), 1e-5, MIX, 1000, bulk=update, surface=surface)
    for i in range(len(ES)):
        b1, s1, c1, m1 = fpk.fixed_point_plain(
            A[i:i + 1], B[i:i + 1], _cold(1), 1e-5, MIX, 1000, bulk=update,
            surface=surface)
        assert torch.equal(c1[0], counts[i])
        assert np.abs(b1[0].numpy() - bulk[i].numpy()).max() < 1e-13
        if surface:
            assert np.abs(s1[0].numpy() - surf[i].numpy()).max() < 1e-13
    assert len(set(counts[:, 0].tolist())) > 1    # lanes stop on their own


def test_sweep_counter_records_both_loops():
    """bethe_sigma_surface hands the bulk and the surface loop's counts to
    SweepCounter, in that order, as two (b,) arrays."""
    H, _, Sl, Vl = _au()
    A, B = _bulk_operators(ES, H, Sl, Vl)
    _, _, counts, _ = fpk.fixed_point_plain(A, B, _cold(len(ES)), 1e-5, MIX,
                                            1000, surface=True)
    with bt.SweepCounter() as counter:
        bt.bethe_sigma_surface(torch.as_tensor(ES), H, Sl, Vl, ETA)
    assert np.array_equal(counter.counts(),
                          counts.T.reshape(-1).numpy())


# ---------------------------------------------------------------------------
# Kernel B's plain version against the JAX decimations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("conv", [1e-5, TIGHT_CONV])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("mode", ["sancho", "dyson"])
def test_chain_plain_matches_jax(mode, n, conv):
    A, B = _chain_blocks(n)
    jfn = jchain.surface_g_sancho if mode == "sancho" \
        else jchain.surface_g_dyson
    max_iter = 64 if mode == "sancho" else 2000
    g, counts, metric = srk.decimate_plain(torch.as_tensor(A),
                                           torch.as_tensor(B), conv,
                                           max_iter, mode)
    ref = np.stack([np.asarray(jfn(a, b, conv)) for a, b in zip(A, B)])
    assert _rel(g.numpy(), ref) < 1e-10
    assert (counts > 0).all() and (counts <= max_iter).all()
    converged = counts < max_iter
    assert (metric[converged] <= conv).all()


def test_kspace_lanes_plain_match_jax():
    """n = 9: the (b*Nk) decimation lanes of kspace_sigma_down."""
    A, B = _kspace_blocks()
    g, counts, _ = srk.decimate_plain(torch.as_tensor(A), torch.as_tensor(B),
                                      1e-5, 64)
    ref = np.stack([np.asarray(jchain.surface_g_sancho(a, b, 1e-5))
                    for a, b in zip(A, B)])
    assert _rel(g.numpy(), ref) < 1e-10
    assert g.shape == (len(A), 9, 9) and (counts > 1).all()


@pytest.mark.parametrize("mode", ["sancho", "dyson"])
def test_decimation_counts_are_per_lane(mode):
    A, B = (torch.as_tensor(x) for x in _chain_blocks(3))
    g, counts, _ = srk.decimate_plain(A, B, 1e-8, 2000, mode)
    for i in range(len(A)):
        g1, c1, _ = srk.decimate_plain(A[i:i + 1], B[i:i + 1], 1e-8, 2000,
                                       mode)
        assert int(c1[0]) == int(counts[i])
        assert np.abs(g1[0].numpy() - g[i].numpy()).max() < 1e-13
    assert len(set(counts.tolist())) > 1


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """The model functions on CPU tensors reach the plain versions and
    launch nothing."""
    monkeypatch.setattr(fpk, "LAUNCHES", 0)
    monkeypatch.setattr(srk, "LAUNCHES", 0)
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fpk, "fixed_point_plain",
                        spy("fixed_point", fpk.fixed_point_plain))
    monkeypatch.setattr(srk, "decimate_plain",
                        spy("decimate", srk.decimate_plain))
    H, n_vecs, Sl, Vl = _au()
    E = torch.as_tensor(ES[:2])
    bt.bethe_sigma_k(E, H, Sl, Vl, ETA)
    bt.bethe_sigma_surface(E, H, Sl, Vl, ETA)
    pp, dp = ks.kspace_phases(n_vecs, 2)
    ks.kspace_sigma_surface(E, H, Sl, Vl, pp, dp, ETA)
    A, B = (torch.as_tensor(x) for x in _chain_blocks(1))
    tchain.surface_g_sancho(A, B)
    tchain.surface_g_dyson(A, B)
    assert calls == ["fixed_point", "fixed_point", "decimate", "fixed_point",
                     "decimate", "decimate"]
    assert fpk.LAUNCHES == 0 and srk.LAUNCHES == 0


def test_other_devices_raise():
    """A tensor on neither the CPU nor a CUDA device has no kernel: the
    wrappers raise rather than fall back."""
    A = torch.zeros((2, 9, 9), dtype=torch.complex128, device="meta")
    B = torch.zeros((2, 12, 9, 9), dtype=torch.complex128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fpk.fixed_point(A, B, B, 1e-5, MIX, 10)
    with pytest.raises(ValueError, match="no kernel"):
        srk.decimate(A, A, 1e-5, 10)


# ---------------------------------------------------------------------------
# NumPy mirrors of the kernels' schedules
# ---------------------------------------------------------------------------

def gj_inverse(M):
    """csrc/*.cu's inverse: Gauss-Jordan in place, partial pivoting on
    |re| + |im| (first row on ties), the row swaps undone as column swaps
    in reverse order."""
    W = np.array(M, dtype=np.complex128)
    n = W.shape[0]
    swaps = []
    for c in range(n):
        mag = np.abs(W[c:, c].real) + np.abs(W[c:, c].imag)
        p = c + int(np.argmax(mag))
        swaps.append(p)
        W[[c, p]] = W[[p, c]]
        inv = 1.0 / W[c, c]
        F = W[:, c].copy()
        W[c, c] = 1.0
        W[c] *= inv
        for r in range(n):
            if r != c:
                W[r, c] = 0.0
                W[r] -= F[r] * W[c]
    for c in reversed(range(n)):
        p = swaps[c]
        W[:, [c, p]] = W[:, [p, c]]
    return W


def mirror_fixed_point(A, B, sig, conv, mix, max_iter, bulk, exclusion,
                       surface):
    """fixed_point.cu's loops for one lane: sum and old max, then each
    direction's M, inverse and update (Seidel: directions 0..5, then
    6..11), the metric from the lane-wide maxima."""
    Bd = B.conj().transpose(0, 2, 1)
    pair, plane = fpk.PAIR, fpk.PLANE_DIRS

    def loop(sig, nslots, is_bulk):
        diff, it = np.inf, 0
        while it < max_iter and diff > conv:
            tot = sig[:nslots].sum(0)
            omax = np.abs(sig[:nslots]).max()
            old = sig.copy()
            if is_bulk and exclusion:
                rounds = [range(12)] if bulk == "jacobi" else [range(6),
                                                                range(6, 12)]
                for dirs in rounds:
                    gs = {k: gj_inverse(A - tot + sig[pair[k]]) for k in dirs}
                    for k in dirs:
                        sig[k] = mix * ((B[k] @ gs[k]) @ Bd[k]) \
                            + (1 - mix) * sig[k]
            else:
                g = gj_inverse(A - tot)
                for k in (range(12) if is_bulk else plane):
                    sig[k] = mix * ((B[k] @ g) @ Bd[k]) + (1 - mix) * sig[k]
            diff = np.abs(sig[:nslots] - old[:nslots]).max() / max(omax,
                                                                    1e-30)
            it += 1
        return sig, it

    out_bulk = None
    counts = [0, 0]
    if bulk is not None:
        sig, counts[0] = loop(sig.copy(), 12, True)
        out_bulk = sig.copy()
        sig = sig[:9].copy()
    out_surf = None
    if surface:
        out_surf, counts[1] = loop(sig.copy(), 9, False)
    return out_bulk, out_surf, counts


def mirror_sancho(A, B, conv, max_iter):
    """sancho_rubio.cu's decimation for one lane, its order of
    operations."""
    tiny = float(np.finfo(np.float32).tiny)
    eps_s, eps, al, be = A.copy(), A.copy(), B.copy(), B.conj().T.copy()
    c, diff, it = 0.0, np.inf, 0
    while it < max_iter and diff > conv:
        g = gj_inverse(eps)
        X, Y = al @ g, be @ g
        scale = np.exp2(c)
        agb, bga = (X @ be) * scale, (Y @ al) * scale
        es_new = eps_s - agb
        eps = (eps - agb) - bga
        al2, be2 = X @ al, Y @ be
        diff = np.abs(es_new - eps_s).max() / max(np.abs(es_new).max(),
                                                  1e-30)
        eps_s = es_new
        sa = np.exp2(np.ceil(np.log2(max(np.abs(al2).max(), tiny))))
        sb = np.exp2(np.ceil(np.log2(max(np.abs(be2).max(), tiny))))
        c = 2.0 * c + np.log2(sa) + np.log2(sb)
        al, be = al2 / sa, be2 / sb
        it += 1
    return gj_inverse(eps_s), it


def mirror_dyson(A, B, conv, relax, max_iter):
    """sancho_rubio.cu's Dyson map for one lane."""
    g = gj_inverse(A)
    diff, it = np.inf, 0
    while it < max_iter and diff > conv:
        gn = gj_inverse(A - (B @ g) @ B.conj().T)
        diff = (np.abs(gn - g) / np.maximum(np.abs(gn), 1e-12)).max()
        g = gn * relax + g * (1 - relax)
        it += 1
    return g, it


@pytest.mark.parametrize("n", [1, 2, 5, 9])
def test_gauss_jordan_mirror_inverts(n):
    """Random blocks, a block whose leading entries are tiny (every column
    pivots), a permutation-like block and exact magnitude ties."""
    rng = np.random.default_rng(n)
    cases = [rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))]
    tiny = cases[0].copy()
    tiny[np.arange(n), np.arange(n)] = 1e-14
    cases.append(tiny)
    perm = np.eye(n)[rng.permutation(n)] * (2 + 1j) + 1e-3 * cases[0]
    cases.append(perm)
    tie = rng.integers(-2, 3, (n, n)) + 0j
    tie[:, ::2] += 3 + 4j
    tie += 7 * np.eye(n)
    cases.append(tie)
    for M in cases:
        ref = np.linalg.inv(M)
        assert _rel(gj_inverse(M), ref) < 1e-13 * max(1.0, np.linalg.cond(M))


@pytest.mark.parametrize("mode", [("jacobi", True, False),
                                  ("seidel", True, False),
                                  ("jacobi", False, True),
                                  ("seidel", False, False),
                                  ("jacobi", True, True),
                                  (None, True, True)])
def test_fixed_point_mirror_matches_plain(mode):
    bulk, exclusion, surface = mode
    H, _, Sl, Vl = _au()
    E = ES[:3]
    A, B = _bulk_operators(E, H, Sl, Vl)
    seed = _cold(len(E)) if bulk is not None else torch.zeros(
        (len(E), 9, 9, 9), dtype=torch.complex128)
    if bulk is None:                   # the k-space mode: A with a shift
        A = A - 0.3j * torch.eye(9, dtype=torch.complex128)
    pb, ps, pc, _ = fpk.fixed_point_plain(A, B, seed, 1e-6, MIX, 1000,
                                          bulk=bulk, exclusion=exclusion,
                                          surface=surface)
    for i in range(len(E)):
        mb, ms, mc = mirror_fixed_point(A[i].numpy(), B[i].numpy(),
                                        seed[i].numpy(), 1e-6, MIX, 1000,
                                        bulk, exclusion, surface)
        assert mc == pc[i].tolist()
        if bulk is not None:
            assert _rel(mb, pb[i].numpy()) < 1e-12
        if surface:
            assert _rel(ms, ps[i].numpy()) < 1e-12


@pytest.mark.parametrize("n", [1, 3, 9])
@pytest.mark.parametrize("mode", ["sancho", "dyson"])
def test_decimation_mirror_matches_plain(mode, n):
    A, B = _kspace_blocks(nk=1, E=ES[:2]) if n == 9 else _chain_blocks(n)
    g, counts, _ = srk.decimate_plain(torch.as_tensor(A), torch.as_tensor(B),
                                      1e-8, 2000 if mode == "dyson" else 64,
                                      mode)
    for i in range(len(A)):
        if mode == "sancho":
            mg, mc = mirror_sancho(A[i], B[i], 1e-8, 64)
        else:
            mg, mc = mirror_dyson(A[i], B[i], 1e-8, 0.1, 2000)
        assert mc == int(counts[i])
        assert _rel(mg, g[i].numpy()) < 1e-12
