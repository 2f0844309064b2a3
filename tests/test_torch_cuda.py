"""CUDA kernels of gaunegf_tpu_torch against their plain versions, on the
card.  Imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Elsewhere every test skips (decided inside the test, never at import).
"""

import numpy as np
import pytest
import torch

from gaunegf_tpu_torch.ops import zlinalg as tzl
from gaunegf_tpu_torch.ops.kernels import strip_elim as se


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1024, 384, 128])
def test_strip_kernel_matches_plain(card, m):
    """Identical pivots and avail, values bit for bit: both round every
    operation the same way."""
    rng = np.random.default_rng(m)
    sb = torch.as_tensor(_cplx(rng, (8, 32, m)), device=card)
    av = torch.as_tensor(rng.random((8, m)) < 0.9, device=card)
    av[:, :32] = True
    before = se.LAUNCHES
    out_k, piv_k, av_k = se.eliminate_strip(sb, av)
    assert se.LAUNCHES == before + 1
    out_p, piv_p, av_p = se.eliminate_strip_plain(sb, av)
    torch.cuda.synchronize()
    assert torch.equal(piv_k, piv_p) and torch.equal(av_k, av_p)
    assert torch.equal(out_k, out_p)


@pytest.mark.cuda
def test_strip_kernel_rejects_what_it_cannot_take(card):
    sb = torch.zeros((2, 32, 64), dtype=torch.complex64, device=card)
    av = torch.ones((2, 64), dtype=torch.bool, device=card)
    with pytest.raises(TypeError):
        se.eliminate_strip(sb.to(torch.complex128), av)
    with pytest.raises(TypeError):
        se.eliminate_strip(sb, av.to(torch.uint8))
    with pytest.raises(ValueError):
        se.eliminate_strip(torch.zeros((2, 33, 64), dtype=torch.complex64,
                                       device=card),
                           av)


@pytest.mark.cuda
def test_blocked_inverse_on_card_matches_cpu(card):
    """The blocked LU on the card (kernel strips) and on the CPU (plain
    strips) agree: same pivots, float32 rounding of different GEMMs."""
    rng = np.random.default_rng(5)
    A = _cplx(rng, (4, 300, 300))
    before = se.LAUNCHES
    X_card = tzl.zinv(torch.as_tensor(A, device=card), bs=128).cpu().numpy()
    assert se.LAUNCHES > before
    X_cpu = tzl.zinv(torch.as_tensor(A), bs=128).numpy()
    ref = np.linalg.inv(A.astype(np.complex128))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(X_card - ref)) < 1e-3 * scale
    assert np.max(np.abs(X_card - X_cpu)) < 1e-3 * scale
