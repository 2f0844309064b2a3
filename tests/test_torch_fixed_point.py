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
* a CPU tensor takes the plain version and counts no launch.

The CUDA kernels cannot run here.  Their arithmetic schedule is mirrored in
NumPy -- the in-place Gauss-Jordan inverse with the row swaps undone as
column swaps, the Seidel sweep as two rounds of six directions, the loop's
stop rule, the decimation's and the Dyson map's order of operations -- and
each mirror is held to the plain version: the inverse to 1e-13 of the
LAPACK inverse, the loops to 1e-12 with equal counts.  The layouts that
serve the paths are mirrored too:

* the register-resident Gauss-Jordan of both kernels (a column a thread,
  pivot row chosen by the column's owner, two registers swapped, the row
  swaps left as a renaming of the columns) equals gj_inverse exactly,
  staged at its renamed places (kernel A) or gathered by the renaming's
  inverse (kernel B); the lane-wide max by cyclic doubling reaches every
  thread of a group of any n;
* kernel A's sweep -- the state in two copies, Seidel's second round
  reading the refreshed opposite slots, every team inverting, g B_k^+
  then B_k (.), squared maxima -- on 5 lanes three a CTA, every mode at
  conv 1e-5 and TIGHT_CONV, against the plain version and the JAX loops;
  a NaN lane stops alone;
* kernel B's layout for each n (scalar at 1, n threads a lane at 2, 9,
  16, one CTA a lane at 17) against both, both modes and convs;
* kernel B's cluster layout (the Sancho mode from n = 33): the blocked
  pivoted inverse in its panel order (to 1e-13 cond of LAPACK, the
  unblocked pivot rows), the two fused products in the tensor cores'
  k-steps of 4 and the fused epilogue, at n = 33, 40, 64 against both; a
  NaN lane stops alone;
* the launch rules (variant by n and mode, lanes a CTA by b, CTAs a lane
  by b and the clusters the card holds), the no-copy operand rule and
  the checks the wrappers run before a launch.

The mirrors and the kernels are held to the plain version and the JAX
functions at max(1e-10, 10 s) for a lane stopped at the same sweep (s: the
lane's difference between two other rounding orders, as on the card) and
10 conv for a lane one sweep apart (any number for the Dyson map).
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
from torch_recording import recording  # noqa: F401  (a fixture)

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

def test_cpu_tensors_take_the_plain_versions(monkeypatch, recording):
    """The model functions on CPU tensors reach the plain versions and
    launch nothing."""
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
    assert recording.count("launch.fixed_point") == 0
    assert recording.count("launch.sancho_rubio") == 0


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
        rows = np.arange(n) != c
        W[rows, c] = 0.0
        W[rows] -= F[rows, None] * W[c]
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


# ---------------------------------------------------------------------------
# Mirrors of the redesigned schedules: kernel A's teams of nine threads,
# several lanes a CTA; kernel B's scalar and n-threads-a-lane layouts
# ---------------------------------------------------------------------------

def gj_columns(M):
    """The register-resident Gauss-Jordan of both kernels: thread t holds
    column t; at pivot c the owner of column c picks the pivot row (first
    on ties), every thread swaps rows c and p of its own column and
    eliminates with the shuffled pivot column.  The row swaps are never
    undone as column swaps: thread t ends holding column pos(t) of the
    inverse.  Returns (columns the threads hold (n, n) -- row r of
    thread t in [r, t] --, pos, the pivot rows)."""
    W = np.array(M, dtype=np.complex128)
    n = W.shape[0]
    piv = []
    for c in range(n):
        col = W[:, c]                         # the owner's registers
        mag = np.abs(col[c:].real) + np.abs(col[c:].imag)
        p = c + int(np.argmax(mag))           # first maximum on ties
        piv.append(p)
        W[[c, p]] = W[[p, c]]                 # each thread: two registers
        inv = 1.0 / W[c, c]                   # the pivot, shuffled
        F = W[:, c].copy()                    # the pivot column, shuffled
        own = np.arange(n) == c
        wc = np.where(own, 1.0, W[c]) * inv
        W = np.where(own, 0.0, W) - F[:, None] * wc   # every row r != c
        W[c] = wc
    pos = []
    for t in range(n):                        # the renaming, in reverse
        q = t
        for c in reversed(range(n)):
            q = piv[c] if q == c else (c if q == piv[c] else q)
        pos.append(q)
    return W, pos, piv


def column_source(piv, j):
    """The thread that holds column j of the inverse: the column swaps
    applied to j forwards (the inverse of the renaming)."""
    q = j
    for c, p in enumerate(piv):
        q = p if q == c else (c if q == p else q)
    return q


def gj_gathered(M):
    """Column j of the inverse fetched by thread j from column_source."""
    W, _, piv = gj_columns(M)
    return W[:, [column_source(piv, j) for j in range(W.shape[0])]]


def gj_staged(M):
    """The inverse as kernel A stages it: thread t writes its column at
    pos(t)."""
    W, pos, _ = gj_columns(M)
    X = np.empty_like(W)
    X[:, pos] = W
    return X


def group_max(values):
    """kernel B's lane-wide max over a group of n threads: cyclic doubling
    by shuffles (each step takes the max with the thread s further on,
    mod n); returns what every thread holds (all equal)."""
    v = np.array(values, dtype=float)
    n, s = len(v), 1
    while s < n:
        w = v[(np.arange(n) + s) % n]
        v = np.where(np.isnan(v) | np.isnan(w), np.nan, np.maximum(v, w))
        s *= 2
    return v


def mirror_teams(A, B, seed, conv, mix, max_iter, bulk, exclusion, surface,
                 sms=2):
    """fixed_point.cu's redesign for a batch: CTAs of lanes_per_cta(b, sms)
    lanes, each lane on its own barrier (it stops alone); per sweep the
    state read from one copy and written to the other, every team building
    A - sum sigma (+ its pair: the old copy, or in Seidel's second round
    the refreshed one), inverting by gj_columns, staging g at its renamed
    places and forming its column of B_k (g B_k^+); maxima compared
    squared.  Returns (bulk, surface, counts (b, 2), lanes per CTA)."""
    b = A.shape[0]
    per = fpk.lanes_per_cta(b, sms)
    Bd = B.conj().transpose(0, 1, 3, 2)
    pair, plane = fpk.PAIR, fpk.PLANE_DIRS

    def update(k, W, old, lane):
        g = gj_staged(W)
        return mix * (B[lane, k] @ (g @ Bd[lane, k])) + (1 - mix) * old

    def loop(lane, sig, is_bulk):
        nslots = 12 if is_bulk else 9
        seidel = is_bulk and exclusion and bulk == "seidel"
        buf = [sig.copy(), sig.copy()]
        diff, it = np.inf, 0
        while it < max_iter and diff > conv:
            cur, nxt = buf[it & 1], buf[1 - (it & 1)]
            base = A[lane] - cur[:nslots].sum(0)
            o2 = np.max(np.abs(cur[:nslots]) ** 2)
            d2 = 0.0
            rounds = [range(6), range(6, 12)] if seidel else [
                range(12) if is_bulk else plane]
            for dirs in rounds:               # a barrier between rounds
                for k in dirs:
                    W = base.copy()
                    if is_bulk and exclusion:
                        W = W + (nxt if seidel and k >= 6 else cur)[pair[k]]
                    nxt[k] = update(k, W, cur[k], lane)
                    d2 = max(d2, np.max(np.abs(nxt[k] - cur[k]) ** 2))
            diff = np.sqrt(d2) / max(np.sqrt(o2), 1e-30)
            if np.isnan(o2) or np.isnan(d2):
                diff = np.nan
            it += 1
        return buf[it & 1], it

    out_b = np.zeros((b, 12, 9, 9), complex) if bulk else None
    out_s = np.zeros((b, 9, 9, 9), complex) if surface else None
    counts = np.zeros((b, 2), int)
    for cta in range(0, b, per):
        for lane in range(cta, min(cta + per, b)):
            sig = seed[lane].copy()
            if bulk:
                out_b[lane], counts[lane, 0] = loop(lane, sig, True)
                sig = out_b[lane][:9].copy()
            if surface:
                out_s[lane], counts[lane, 1] = loop(lane, sig, False)
    return out_b, out_s, counts, per


def mirror_decimate(A, B, conv, max_iter, mode, relax=0.1):
    """sancho_rubio.cu's redesign for a batch, by the variant n and the
    mode pick: 'scalar' (n = 1: scalar arithmetic, |.| maxima), 'column'
    (n threads a lane: gj_gathered inverses, squared maxima through
    group_max), 'cluster' (mirror_cluster_sancho) or the first design's
    CTA schedule (mirror_sancho / mirror_dyson)."""
    n = A.shape[-1]
    v = srk.variant(n, mode)
    outs, counts = [], []
    for a, bb in zip(A, B):
        if v == "cluster":
            g, it = mirror_cluster_sancho(a, bb, conv, max_iter)
        elif v in ("cta", "cta_global"):
            g, it = mirror_sancho(a, bb, conv, max_iter) if mode == "sancho" \
                else mirror_dyson(a, bb, conv, relax, max_iter)
        elif mode == "sancho":
            g, it = _mirror_sancho_lane(a, bb, conv, max_iter, v)
        else:
            g, it = _mirror_dyson_lane(a, bb, conv, relax, max_iter, v)
        outs.append(g)
        counts.append(it)
    return np.stack(outs), np.array(counts)


def _lane_max(M, v):
    """max |M| over the lane: directly (scalar), or squared per thread's
    column, the group's cyclic max, one root (column)."""
    if v == "scalar":
        return float(np.abs(M).max())
    return float(np.sqrt(group_max(np.max(np.abs(M) ** 2, axis=0))[0]))


def _mirror_sancho_lane(A, B, conv, max_iter, v):
    tiny = float(np.finfo(np.float32).tiny)
    inv = (lambda M: 1.0 / M) if v == "scalar" else gj_gathered
    eps_s, eps, al, be = A.copy(), A.copy(), B.copy(), B.conj().T.copy()
    c, diff, it = 0.0, np.inf, 0
    while it < max_iter and diff > conv:
        g = inv(eps)
        X, Y = al @ g, be @ g                 # staged, column by column
        scale = np.exp2(c)
        agb, bga = (X @ be) * scale, (Y @ al) * scale
        es_new = eps_s - agb
        eps = (eps - agb) - bga
        al2, be2 = X @ al, Y @ be
        d, s = _lane_max(es_new - eps_s, v), _lane_max(es_new, v)
        eps_s = es_new
        sa = np.exp2(np.ceil(np.log2(max(_lane_max(al2, v), tiny))))
        sb = np.exp2(np.ceil(np.log2(max(_lane_max(be2, v), tiny))))
        c = 2.0 * c + np.log2(sa) + np.log2(sb)
        al, be = al2 / sa, be2 / sb
        diff = np.nan if np.isnan(s) else d / max(s, 1e-30)
        it += 1
    return inv(eps_s), it


def _mirror_dyson_lane(A, B, conv, relax, max_iter, v):
    inv = (lambda M: 1.0 / M) if v == "scalar" else gj_gathered
    g = inv(A)
    diff, it = np.inf, 0
    while it < max_iter and diff > conv:
        gn = inv(A - (B @ g) @ B.conj().T)
        if v == "scalar":
            diff = float((np.abs(gn - g) / np.maximum(np.abs(gn), 1e-12))
                         .max())
        else:
            r2 = np.abs(gn - g) ** 2 / np.maximum(np.abs(gn) ** 2, 1e-24)
            diff = float(np.sqrt(group_max(r2.max(axis=0))[0]))
        g = gn * relax + g * (1 - relax)
        it += 1
    return g, it


def zmm_ksteps(A, B, acc=None):
    """acc + A B as the cluster layout's tensor cores form it: k-steps of 4,
    each four real products on separate planes (re += Ar Br, re += -Ai Bi,
    im += Ar Bi, im += Ai Br), no 3M trick."""
    m, K = A.shape
    acc = np.zeros((m, B.shape[1]), complex) if acc is None else acc
    re, im = acc.real.copy(), acc.imag.copy()
    for k0 in range(0, K, 4):
        ar, ai = A[:, k0:k0 + 4].real, A[:, k0:k0 + 4].imag
        br, bi = B[k0:k0 + 4].real, B[k0:k0 + 4].imag
        re = re + ar @ br
        re = re + (-ai) @ bi
        im = im + ar @ bi
        im = im + ai @ br
    return re + 1j * im


def cluster_panel_width(np_):
    return 16 if np_ <= 160 else 8


def gj_blocked(M):
    """The cluster layout's inverse of an NP x NP block: panels of
    cluster_panel_width(NP) columns in order; each panel factored by the
    unblocked steps restricted to its columns (pivot by |re| + |im|, first
    on ties), then applied to every other column with the panel's row swaps:
    W[r, j] = (r in the panel ? 0 : PW[r, j]) + sum_c Q[r, c] PW[k + c, j]
    in k-steps of 4.  Returns (W, the pivot rows); column j of the inverse
    is W's column column_source(piv, j)."""
    W = np.array(M, dtype=np.complex128)
    np_ = W.shape[0]
    pw = cluster_panel_width(np_)
    piv = []
    for k in range(0, np_, pw):
        w = min(pw, np_ - k)
        P = W[:, k:k + w].copy()
        for c in range(w):
            g = k + c
            mag = np.abs(P[g:, c].real) + np.abs(P[g:, c].imag)
            p = g + int(np.argmax(mag))
            piv.append(p)
            P[[g, p]] = P[[p, g]]
            inv = 1.0 / P[g, c]
            F = P[:, c].copy()
            P[g, c] = 1.0
            P[g] *= inv
            rows = np.arange(np_) != g
            P[rows, c] = 0.0
            P[rows] -= F[rows, None] * P[g]
        perm = np.arange(np_)
        for c in range(w):
            p = piv[k + c]
            perm[[k + c, p]] = perm[[p, k + c]]
        PW = W[perm]
        others = np.r_[0:k, k + w:np_]
        base = PW[:, others].copy()
        base[k:k + w] = 0.0
        W[:, others] = zmm_ksteps(P, PW[k:k + w][:, others], base)
        W[:, k:k + w] = P
    return W, piv


def mirror_cluster_sancho(A, B, conv, max_iter):
    """sancho_rubio.cu's cluster layout for one lane: blocks padded to NP
    (a multiple of 8; eps, eps_s with the identity, al, be with zeros), per
    iteration the blocked inverse, [X; Y] = [al; be] g and then
    [xa xb; ya yb] = [X; Y] [al | be] in k-steps of 4, the fused epilogue
    (eps_s -= xb 2^c, eps = (eps - xb 2^c) - ya 2^c, the squared maxima over
    the n x n corner), al and be kept unscaled and scaled by 1 / sa, 1 / sb
    as the next iteration reads them; the last inverse of eps_s."""
    tiny = float(np.finfo(np.float32).tiny)
    n = A.shape[0]
    np_ = -(-n // 8) * 8
    pad = lambda M, diag: np.pad(M, (0, np_ - n)) + (
        np.diag(np.r_[np.zeros(n), np.ones(np_ - n)]) if diag else 0)
    eps_s, eps = pad(A, True), pad(A, True)
    al, be = pad(B, False), pad(B.conj().T, False)
    ra = rb = 1.0
    c, diff, it = 0.0, np.inf, 0
    corner = np.s_[:n, :n]

    def inverse(M):
        W, piv = gj_blocked(M)
        return W[:, [column_source(piv, j) for j in range(np_)]]

    while it < max_iter and diff > conv:
        g = inverse(eps)
        XY = zmm_ksteps(np.vstack([al * ra, be * rb]), g)
        X, Y = XY[:np_], XY[np_:]
        out = zmm_ksteps(XY, np.hstack([al * ra, be * rb]))
        xa, xb = out[:np_, :np_], out[:np_, np_:]
        ya, yb = out[np_:, :np_], out[np_:, np_:]
        scale = np.exp2(c)
        agb, bga = xb * scale, ya * scale
        es_new = eps_s - agb
        eps = (eps - agb) - bga
        v = [np.max(np.abs(M[corner]) ** 2)
             for M in (es_new - eps_s, es_new, xa, yb)]
        eps_s = es_new
        sa = np.exp2(np.ceil(np.log2(max(np.sqrt(v[2]), tiny))))
        sb = np.exp2(np.ceil(np.log2(max(np.sqrt(v[3]), tiny))))
        c = 2.0 * c + np.log2(sa) + np.log2(sb)
        al, be, ra, rb = xa, yb, 1.0 / sa, 1.0 / sb
        s = np.sqrt(v[1])
        diff = np.nan if np.isnan(s) else np.sqrt(v[0]) / max(s, 1e-30)
        it += 1
    return inverse(eps_s)[corner], it


def held(vals, ref, counts, ref_counts, conv, spread=None, dyson=False):
    """The kernels' bound: a lane stopped at the same sweep agrees to
    max(1e-10, 10 s) of its largest entry (s: the lane's difference
    between two other rounding orders, where given); a lane one sweep
    apart (any number for the Dyson map, whose element-wise metric sits at
    its rounding floor at conv 1e-11) to 10 conv."""
    counts = np.asarray(counts).reshape(len(vals), -1)
    ref_counts = np.asarray(ref_counts).reshape(len(vals), -1)
    for i in range(len(vals)):
        rel = np.abs(vals[i] - ref[i]).max() / np.abs(ref[i]).max()
        if (counts[i] == ref_counts[i]).all():
            s = 0.0 if spread is None else spread[i]
            assert rel <= max(1e-10, 10 * s), (i, rel, s)
        else:
            gap = np.abs(counts[i] - ref_counts[i]).max()
            assert dyson or gap == 1, (i, counts[i], ref_counts[i])
            assert rel <= 10 * conv, (i, rel)


@pytest.mark.parametrize("n", [1, 2, 5, 9, 16])
def test_register_gauss_jordan_mirror(n):
    """gj_columns holds the same numbers as gj_inverse entry for entry;
    staged at its renamed places (kernel A) or fetched by column_source
    (kernel B) it is gj_inverse exactly, on random, tiny-pivot,
    permutation-like and tied blocks."""
    rng = np.random.default_rng(n + 40)
    cases = [rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))]
    tiny = cases[0].copy()
    tiny[np.arange(n), np.arange(n)] = 1e-14
    perm = np.eye(n)[rng.permutation(n)] * (2 + 1j) + 1e-3 * cases[0]
    tie = rng.integers(-2, 3, (n, n)) + 0j
    tie[:, ::2] += 3 + 4j
    tie += 7 * np.eye(n)
    for M in cases + [tiny, perm, tie]:
        ref = gj_inverse(M)
        assert np.array_equal(gj_staged(M), ref)
        assert np.array_equal(gj_gathered(M), ref)
        W, pos, _ = gj_columns(M)
        assert sorted(pos) == list(range(n))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 9, 16])
def test_group_max_reaches_every_thread(n):
    """The cyclic doubling gives every thread of a group of any n the
    group's max, NaN kept."""
    rng = np.random.default_rng(n)
    v = rng.random(n)
    assert (group_max(v) == v.max()).all()
    v[n // 2] = np.nan
    assert np.isnan(group_max(v)).all()


@pytest.mark.parametrize("conv", [1e-5, TIGHT_CONV])
@pytest.mark.parametrize("mode", [("jacobi", True, False),
                                  ("seidel", True, False),
                                  ("jacobi", False, False),
                                  ("seidel", False, False),
                                  ("jacobi", True, True),
                                  ("jacobi", False, True),
                                  (None, True, True)])
def test_team_schedule_matches_plain_and_jax(mode, conv):
    """Kernel A's redesigned schedule on 5 lanes, 3 a CTA (2 SMs: the
    second CTA ragged), against the plain version and the JAX loops."""
    bulk, exclusion, surface = mode
    H, n_vecs, Sl, Vl = _au()
    E = ES
    A, B = _bulk_operators(E, H, Sl, Vl)
    if bulk is None:                   # the k-space mode: A shifted
        A = A - 0.3j * torch.eye(9, dtype=torch.complex128)
        rng = np.random.default_rng(7)
        seed = 0.05 * (rng.standard_normal((len(E), 9, 9, 9))
                       + 1j * rng.standard_normal((len(E), 9, 9, 9)))
    else:
        seed = _cold(len(E)).numpy()
    mb, ms, mc, per = mirror_teams(A.numpy(), B.numpy(), seed, conv, MIX,
                                   1000, bulk, exclusion, surface)
    assert per == 3
    pb, ps, pc, _ = fpk.fixed_point_plain(A, B, torch.as_tensor(seed), conv,
                                          MIX, 1000, bulk=bulk,
                                          exclusion=exclusion,
                                          surface=surface)
    for m, p in ((mb, pb), (ms, ps)):
        assert (m is None) == (p is None)
        if m is not None:
            held(m, p.numpy(), mc, pc.numpy(), conv)
    if bulk is not None and not surface:
        ref = np.stack([np.asarray(jbt.bethe_sigma_k(
            np.complex128(e), H, Sl, Vl, ETA, conv=conv, update=bulk,
            exclusion=exclusion)) for e in E])
        assert _rel(mb, ref) < 1e-10
    elif bulk is not None:
        js, jb = zip(*[jbt.bethe_sigma_surface(
            np.complex128(e), H, Sl, Vl, ETA, conv=conv, sig0=s,
            exclusion=exclusion) for e, s in zip(E, seed)])
        assert _rel(ms, np.stack([np.asarray(x) for x in js])) < 1e-10
        assert _rel(mb, np.stack([np.asarray(x) for x in jb])) < 1e-10


@pytest.mark.filterwarnings("ignore:invalid value:RuntimeWarning")
def test_team_schedule_freezes_lanes_alone():
    """A NaN lane stops after its first sweep without touching the lanes
    that share its CTA; max_iter 0 leaves the seed and counts 0."""
    H, _, Sl, Vl = _au()
    A, B = _bulk_operators(ES, H, Sl, Vl)
    seed = _cold(len(ES)).numpy()
    seed[1] = np.nan
    mb, _, mc, _ = mirror_teams(A.numpy(), B.numpy(), seed, 1e-5, MIX, 1000,
                                "jacobi", True, False)
    pb, _, pc, _ = fpk.fixed_point_plain(A, B, torch.as_tensor(seed), 1e-5,
                                         MIX, 1000)
    assert mc[1, 0] == 1 == int(pc[1, 0]) and np.isnan(mb[1]).all()
    keep = [0, 2, 3, 4]
    held(mb[keep], pb.numpy()[keep], mc[keep], pc.numpy()[keep], 1e-5)
    m0, _, c0, _ = mirror_teams(A.numpy(), B.numpy(), seed, 1e-5, MIX, 0,
                                "jacobi", True, False)
    assert (c0 == 0).all() and np.array_equal(m0[0], seed[0])


@pytest.mark.parametrize("conv", [1e-5, TIGHT_CONV])
@pytest.mark.parametrize("n", [1, 2, 9, 16, 17])
@pytest.mark.parametrize("mode", ["sancho", "dyson"])
def test_decimation_layouts_match_plain_and_jax(mode, n, conv):
    """Kernel B's layout for each n (scalar at 1, n threads a lane at 2, 9,
    16, one CTA a lane at 17) against the plain version and the JAX
    loops, on the chain's in-band blocks (eta 1e-4) and, at n = 9, the
    k-space lanes.  s is each lane's difference between the plain version
    and the first design's mirror (two other rounding orders), as the card
    holds a lane to its card-vs-host plain difference."""
    blocks = [_chain_blocks(n)] + ([_kspace_blocks(nk=1, E=ES[:2])]
                                   if n == 9 else [])
    max_iter = 64 if mode == "sancho" else 2000
    jfn = jchain.surface_g_sancho if mode == "sancho" \
        else jchain.surface_g_dyson
    for A, B in blocks:
        mg, mc = mirror_decimate(A, B, conv, max_iter, mode)
        pg, pc, _ = srk.decimate_plain(torch.as_tensor(A),
                                       torch.as_tensor(B), conv, max_iter,
                                       mode)
        pg = pg.numpy()
        first = [mirror_sancho(a, b, conv, max_iter)[0] if mode == "sancho"
                 else mirror_dyson(a, b, conv, 0.1, max_iter)[0]
                 for a, b in zip(A, B)]
        spread = [np.abs(f - p).max() / np.abs(p).max()
                  for f, p in zip(first, pg)]
        held(mg, pg, mc, pc.numpy(), conv, spread, dyson=mode == "dyson")
        ref = np.stack([np.asarray(jfn(a, b, conv)) for a, b in zip(A, B)])
        held(mg, ref, mc, mc, conv, spread)


@pytest.mark.filterwarnings("ignore:invalid value:RuntimeWarning")
@pytest.mark.parametrize("n", [1, 9])
def test_decimation_layouts_freeze_lanes_alone(n):
    """A NaN lane of a warp stops at once (count 1) and its neighbours
    match plain; max_iter 0 and 1 are honoured."""
    A, B = _chain_blocks(n)
    A[2] = np.nan
    for max_iter in (0, 1, 64):
        mg, mc = mirror_decimate(A, B, 1e-8, max_iter, "sancho")
        pg, pc, _ = srk.decimate_plain(torch.as_tensor(A),
                                       torch.as_tensor(B), 1e-8, max_iter)
        assert np.array_equal(mc, pc.numpy())
        assert np.isnan(mg[2]).all()
        keep = [0, 1, 3, 4, 5]
        held(mg[keep], pg.numpy()[keep], mc[keep], pc.numpy()[keep], 1e-8)


@pytest.mark.parametrize("np_", [40, 64, 152, 168])
def test_blocked_inverse_mirror(np_):
    """The cluster layout's blocked inverse (panels of 16 columns, the last
    one of 8 at NP = 40 and 152; of 8 at NP = 168), its columns fetched by
    column_source, inverts random, tiny-pivot, permutation-like and tied
    blocks to 1e-13 cond; on the random and permutation-like blocks it
    picks the unblocked inverse's pivot rows."""
    rng = np.random.default_rng(np_)
    n = np_
    rand = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    tiny = rand.copy()
    tiny[np.arange(n), np.arange(n)] = 1e-14
    perm = np.eye(n)[rng.permutation(n)] * (2 + 1j) + 1e-3 * rand
    tie = rng.integers(-2, 3, (n, n)) + 0j
    tie[:, ::2] += 3 + 4j
    tie += 7 * np.eye(n)
    for M in (rand, tiny, perm, tie):
        W, piv = gj_blocked(M)
        got = W[:, [column_source(piv, j) for j in range(n)]]
        assert _rel(got, np.linalg.inv(M)) < 1e-13 * np.linalg.cond(M)
    for M in (rand, perm):
        assert gj_blocked(M)[1] == gj_columns(M)[2]


@pytest.mark.parametrize("conv", [1e-5, TIGHT_CONV])
@pytest.mark.parametrize("n", [33, 40, 64])
def test_cluster_schedule_matches_plain_and_jax(n, conv):
    """Kernel B's cluster layout (the Sancho mode from CLUSTER_N0 on):
    mirror_cluster_sancho -- the blocked pivoted inverse in its panel
    order, the two fused products in k-steps of 4, the fused epilogue --
    against the plain version and the JAX loop on the chain's in-band
    blocks, s from the first design's mirror as in
    test_decimation_layouts_match_plain_and_jax."""
    assert srk.variant(n, "sancho") == "cluster"
    A, B = _chain_blocks(n)
    mg, mc = mirror_decimate(A, B, conv, 64, "sancho")
    pg, pc, _ = srk.decimate_plain(torch.as_tensor(A), torch.as_tensor(B),
                                   conv, 64)
    pg = pg.numpy()
    spread = [np.abs(mirror_sancho(a, b, conv, 64)[0] - p).max()
              / np.abs(p).max() for a, b, p in zip(A, B, pg)]
    held(mg, pg, mc, pc.numpy(), conv, spread)
    ref = np.stack([np.asarray(jchain.surface_g_sancho(a, b, conv))
                    for a, b in zip(A, B)])
    held(mg, ref, mc, mc, conv, spread)


@pytest.mark.filterwarnings("ignore:invalid value:RuntimeWarning")
def test_cluster_schedule_freezes_lanes_alone():
    """In the cluster layout a NaN lane stops after one iteration (count 1,
    NaN result) and its neighbours match plain; max_iter 0 and 1 are
    honoured."""
    A, B = _chain_blocks(33)
    A[2] = np.nan
    keep = [0, 1, 3, 4, 5]
    for max_iter in (0, 1, 64):
        mg, mc = mirror_decimate(A, B, 1e-8, max_iter, "sancho")
        pg, pc, _ = srk.decimate_plain(torch.as_tensor(A),
                                       torch.as_tensor(B), 1e-8, max_iter)
        pg = pg.numpy()
        assert np.array_equal(mc, pc.numpy())
        assert np.isnan(mg[2]).all()
        spread = [np.abs(mirror_sancho(A[i], B[i], 1e-8, max_iter)[0]
                         - pg[i]).max() / np.abs(pg[i]).max() for i in keep]
        held(mg[keep], pg[keep], mc[keep], pc.numpy()[keep], 1e-8, spread)


# ---------------------------------------------------------------------------
# The wrappers' launch rules and operands
# ---------------------------------------------------------------------------

def test_launch_rules():
    """Kernel B's variant depends on n and the mode: the Sancho mode takes
    the cluster layout from CLUSTER_N0 to MAX_CLUSTER_N, as many CTAs a
    lane (up to 8) as keep all b lanes on the card at once -- the clusters
    of each width it holds, here an H100 80GB HBM3's as the C entry point
    read them there;
    kernel A packs ceil(b / SMs) lanes a CTA, at most three (shared
    memory: 63,632 bytes a lane)."""
    assert [srk.variant(n) for n in (1, 2, 9, 16, 17, 32, 33, 40)] == [
        "scalar", "column", "column", "column", "cta", "cta", "cta_global",
        "cta_global"]
    assert srk.CLUSTER_N0 == 33 and srk.MAX_CLUSTER_N == 256
    assert [srk.variant(n, "sancho") for n in (1, 9, 32, 33, 150, 256,
                                                257)] == [
        "scalar", "column", "cta", "cluster", "cluster", "cluster",
        "cta_global"]
    assert [srk.variant(n, "dyson") for n in (9, 32, 33, 150)] == [
        "column", "cta", "cta_global", "cta_global"]
    h100 = (132, 66, 39, 30, 22, 17, 15, 15)
    assert [srk.cluster_width(150, b, "sancho", h100) for b in (
        1, 15, 16, 17, 18, 22, 23, 30, 31, 39, 40, 64, 66, 67, 128, 400)] == [
        8, 8, 6, 6, 5, 5, 4, 4, 3, 3, 2, 2, 2, 1, 1, 1]
    wide = (132, 66, 44, 33, 26, 22, 18, 16)       # b C <= 132 alone
    assert [srk.cluster_width(150, b, "sancho", wide) for b in (
        16, 17, 22, 26, 33, 44, 66, 67)] == [8, 7, 6, 5, 4, 3, 2, 1]
    assert srk.cluster_width(150, 64, "dyson", h100) == 0
    assert srk.cluster_width(32, 64, "sancho", h100) == 0
    assert srk.launch_shape(150, 64, "sancho", h100) == {
        "variant": "cluster", "lanes_per_cta": 1, "ctas": 128,
        "threads": 256, "shared_bytes": 106432, "cluster": 2}
    assert srk.launch_shape(150, 64, "sancho")["cluster"] is None
    assert max(srk.launch_shape(n, 1, "sancho")["shared_bytes"]
               for n in range(33, 257)) <= 232448
    with pytest.raises(ValueError):
        srk.variant(0)
    assert srk.launch_shape(9, 4096, "sancho") == {
        "variant": "column", "lanes_per_cta": 3, "ctas": 1366,
        "threads": 32, "shared_bytes": 3 * 6 * 81 * 16}
    assert srk.launch_shape(1, 32, "dyson")["ctas"] == 1
    assert max(srk.launch_shape(n, 1, m)["shared_bytes"]
               for n in range(2, 17) for m in ("sancho", "dyson")) <= 49152
    assert [fpk.lanes_per_cta(b, 132) for b in (1, 64, 132, 133, 264, 400,
                                                4096)] == [1, 1, 1, 2, 2, 3, 3]
    assert fpk.launch_shape(400, 132)["ctas"] == 134
    assert fpk.MAX_LANES * fpk.LANE_SHARED_BYTES <= 232448


def test_wrappers_pass_contiguous_operands_without_a_copy():
    """An operand that is already contiguous with no conj or neg bit goes
    to the kernel as it is; any other becomes one contiguous copy with
    the same values and no bits."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((4, 9, 9))
                        + 1j * rng.standard_normal((4, 9, 9)))
    assert fpk.device_operand(x) is x
    for view in (x.transpose(1, 2), x.conj(), -x.conj().imag.to(x.dtype),
                 torch.neg(x.conj()), x[:, None].expand(4, 3, 9, 9)[:, 1],
                 x[::2]):
        got = fpk.device_operand(view)
        assert got.is_contiguous() and not got.is_conj() \
            and not got.is_neg()
        assert torch.equal(got, view.resolve_conj().resolve_neg())


def test_wrappers_raise_on_what_the_kernels_cannot_take():
    """The checks both wrappers run before a launch (dtype, shapes, mode,
    devices), here on CPU tensors."""
    A = torch.zeros((2, 9, 9), dtype=torch.complex128)
    B = torch.zeros((2, 12, 9, 9), dtype=torch.complex128)
    fpk.check_operands(A, B, B, "jacobi", False)
    fpk.check_operands(A, B, B[:, :9], None, True)
    with pytest.raises(TypeError):
        fpk.check_operands(A.to(torch.complex64), B, B, "jacobi", False)
    with pytest.raises(ValueError):
        fpk.check_operands(A, B, B, None, True)          # seed of 12 slots
    with pytest.raises(ValueError):
        fpk.check_operands(A, B, B, "gauss", False)
    with pytest.raises(ValueError):
        fpk.check_operands(A, B, B[:, :9], None, False)
    srk.check_operands(A, A, "sancho")
    with pytest.raises(TypeError):
        srk.check_operands(A.to(torch.complex64), A, "sancho")
    with pytest.raises(ValueError):
        srk.check_operands(A, A[:, :3, :3], "dyson")
    with pytest.raises(ValueError):
        srk.check_operands(A, A, "newton")
