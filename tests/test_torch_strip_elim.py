"""Strip elimination and the strip-scanned panel: port vs the JAX package.

The JAX side runs its Pallas kernel in interpret mode on the CPU, as
tests/test_pallas_panel.py does; the port runs the kernel's plain PyTorch
version, which is what a CPU tensor takes.  Pivots and avail must be
identical.  Values: both compute in float32 with the same formulas, but
XLA and PyTorch may round hypot's square root or fuse differently, so
they agree to float32 rounding accumulated over 32 rank-1 steps -- bound
2e-6 of the strip's largest entry (about 16 ulp).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaunegf_tpu.ops import zlinalg as jzl
from gaunegf_tpu.ops.pallas.strip_elim import eliminate_strip as jax_strip
from gaunegf_tpu_torch.ops import zlinalg as tzl
from gaunegf_tpu_torch.ops.kernels import _build
from gaunegf_tpu_torch.ops.kernels import strip_elim as se

STRIP_REL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _tie_strip(rng, m):
    sb = rng.integers(-2, 3, (32, m)).astype(np.complex64)
    sb[:, ::3] = 3 + 4j                    # |3+4i| == |5|: exact ties
    sb[:, 1::3] = 5
    return sb


def _zero_column_strip(rng, m):
    sb = _cplx(rng, (32, m))
    sb[5] = 0                              # a singular column
    return sb


def _compare(sb, av):
    o_j, p_j, a_j = jax_strip(jnp.asarray(sb), jnp.asarray(av),
                              interpret=True)
    o_t, p_t, a_t = se.eliminate_strip(torch.as_tensor(sb)[None],
                                       torch.as_tensor(av)[None])
    assert np.array_equal(np.asarray(p_j), p_t[0].numpy())
    assert np.array_equal(np.asarray(a_j), a_t[0].numpy())
    o_j = np.asarray(o_j)
    assert np.isfinite(o_t.numpy()).all()
    scale = np.max(np.abs(o_j))
    assert np.max(np.abs(o_j - o_t[0].numpy())) <= STRIP_REL * scale


@pytest.mark.parametrize("m", [64, 200, 256])
def test_strip_matches_jax_kernel(rng, m):
    _compare(_cplx(rng, (32, m)), rng.random(m) < 0.8)


@pytest.mark.parametrize("make", [_tie_strip, _zero_column_strip],
                         ids=["tie", "zero-column"])
def test_strip_edge_cases_match_jax_kernel(rng, make):
    _compare(make(rng, 96), np.ones(96, bool))


def test_strip_batch_is_independent(rng):
    """Each batch element is factored on its own (one block each on the
    card): the batched call equals the per-element calls."""
    sb = _cplx(rng, (3, 32, 80))
    av = rng.random((3, 80)) < 0.9
    out, piv, avo = se.eliminate_strip(torch.as_tensor(sb),
                                       torch.as_tensor(av))
    for b in range(3):
        o1, p1, a1 = se.eliminate_strip(torch.as_tensor(sb[b:b + 1]),
                                        torch.as_tensor(av[b:b + 1]))
        assert torch.equal(out[b], o1[0])
        assert torch.equal(piv[b], p1[0]) and torch.equal(avo[b], a1[0])


def test_zero_pivot_guard_gives_zeros(rng):
    """A column with no nonzero available entry pivots on the first
    available lane and yields zero multipliers, not NaN."""
    sb = _zero_column_strip(rng, 64)
    out, piv, _ = se.eliminate_strip(torch.as_tensor(sb)[None],
                                     torch.ones((1, 64), dtype=torch.bool))
    assert torch.isfinite(torch.view_as_real(out)).all()
    avail_before_5 = np.ones(64, bool)
    avail_before_5[piv[0, :5].numpy()] = False
    assert int(piv[0, 5]) == int(np.argmax(avail_before_5))


@pytest.mark.parametrize("m,bs", [(96, 64), (200, 64), (256, 128), (64, 32),
                                  (40, 16)])
def test_panel_scan_matches_jax(rng, m, bs):
    """The port's _factor_panel_scan vs JAX's with strip_impl='pallas':
    identical permutations, packed values to f32 rounding of the panel
    (the deferred updates are small products: 1e-5 of the largest entry)."""
    A = _cplx(rng, (m, bs))
    p_j, perm_j = jzl._factor_panel_scan(jnp.asarray(A), strip_impl="pallas")
    p_t, perm_t = tzl._factor_panel_scan(torch.as_tensor(A)[None])
    assert np.array_equal(np.asarray(perm_j), perm_t[0].numpy())
    p_j = np.asarray(p_j)
    assert np.max(np.abs(p_j - p_t[0].numpy())) <= 1e-5 * np.max(np.abs(p_j))


def test_cpu_tensor_never_launches(rng):
    before = se.LAUNCHES
    tzl.zinv(torch.as_tensor(_cplx(rng, (2, 80, 80))), bs=32)
    assert se.LAUNCHES == before


def test_cuda_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        se.build()
