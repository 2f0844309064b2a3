"""The fused panel factorization (ops/kernels/panel_fused.py) vs the JAX
package.

The same NumPy panels go through the TPU kernel
``gaunegf_tpu.ops.pallas.panel_fused.factor_panel_fused`` in interpret
mode and through the port's plain version (what the wrapper runs on the
CPU).  The eliminations are the same operations, so the pivot sequences
agree exactly.  The deferred updates are not: the JAX kernel sums the 32
terms of each strip's trailing product in one float32 dot, inverts L11^T
by a Neumann product and writes W into the pivot lanes as (U + W) - U,
while the port substitutes and accumulates one term at a time.  Each
differs from the exact update by ~32 u32 per strip, and the panel's
values grow through its strips, so the bound is 1e-5 (~84 u32) of the
panel's largest value (measured 2.4e-6 at (160, 64)).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaunegf_tpu.ops.pallas.panel_fused import factor_panel_fused
from gaunegf_tpu_torch.ops import zlinalg as tzl
from gaunegf_tpu_torch.ops.kernels import panel_fused as kpf

REL = 1e-5
MIXED_REL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _panels(seed, shape, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("m,bs,rel", [(96, 32, REL), (160, 64, REL),
                                      (64, 16, REL), (64, 64, 10 * REL)])
def test_plain_matches_jax_kernel(m, bs, rel):
    """Several strips, one strip narrower than 32, and m == bs (the last
    panel of an LU, whose last columns are sums of cancelling terms:
    measured 1.1e-5 of the largest value, bound 10x)."""
    A = _panels(m * bs, (2, m, bs))
    p_j, perm_j = factor_panel_fused(jnp.asarray(A), interpret=True)
    p_t, perm_t = kpf.factor_panel_fused(torch.as_tensor(A))
    assert perm_t.dtype == torch.int64
    assert np.array_equal(perm_t.numpy(), np.asarray(perm_j))
    p_j = np.asarray(p_j)
    assert np.max(np.abs(p_t.numpy() - p_j)) < rel * np.max(np.abs(p_j))


def test_same_pivots_as_strip_scanned_panel():
    """Kernel 2 fuses the strip-scanned panel: the pivot sequence and the
    packing are the 'pstrip' panel's."""
    A = torch.as_tensor(_panels(4, (2, 128, 64)))
    p_f, perm_f = kpf.factor_panel_fused(A)
    p_s, perm_s = tzl._factor_panel_scan(A)
    assert torch.equal(perm_f, perm_s)
    assert float((p_f - p_s).abs().max()) < REL * float(p_s.abs().max())


def test_cpu_wrapper_runs_the_plain_version():
    A = torch.as_tensor(_panels(5, (2, 64, 32)))
    before = kpf.LAUNCHES
    p_w, perm_w = kpf.factor_panel_fused(A)
    p_p, perm_p = kpf.factor_panel_fused_plain(A)
    assert kpf.LAUNCHES == before
    assert torch.equal(p_w, p_p) and torch.equal(perm_w, perm_p)


def test_fused3_resolves_to_the_fused_panel():
    assert tzl._pick_panel(1000, "fused3") == "fused"
    assert tzl._pick_panel(1000, "fused") == "fused"
    A = _panels(6, (1, 64, 64))
    X3 = tzl.zinv(torch.as_tensor(A), bs=32, panel_impl="fused3")
    X1 = tzl.zinv(torch.as_tensor(A), bs=32, panel_impl="fused")
    assert torch.equal(X3, X1)


def test_complex128_raises():
    """The JAX kernel casts a complex128 panel to float32 silently; the
    port refuses it."""
    with pytest.raises(ValueError, match="complex64"):
        tzl._pick_panel(1000, "fused", torch.complex128)
    A128 = torch.as_tensor(_panels(7, (1, 64, 64), np.complex128))
    with pytest.raises(ValueError, match="complex64"):
        tzl.zinv(A128, method="blocked", panel_impl="fused")
    with pytest.raises(ValueError, match="complex64"):
        kpf.factor_panel_fused(A128[:, :, :32])


def test_mixed_tier_zinv_on_fused_panel_holds_contract():
    """Mixed tier on the fused panel: complex64 seed + one complex128
    Newton step, against the complex128 operator (contract 2e-6)."""
    A = _panels(8, (2, 128, 128), np.complex128)
    X = tzl.zinv_refined(torch.as_tensor(A), steps=1, bs=64,
                         panel_impl="fused").numpy()
    ref = np.linalg.inv(A)
    assert X.dtype == np.complex64
    assert np.max(np.abs(X - ref)) / np.max(np.abs(ref)) < MIXED_REL
