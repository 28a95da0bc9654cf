"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (a hand-written
kernel has no CPU mode).  The file imports nothing of JAX, so it runs on a
machine with PyTorch and the CUDA toolkit alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance rtol 1e-5, atol 1e-5: float32 on both sides, sums in another order.
"""

import pytest
import torch

from sba_gan_tpu_torch.ops import word_attention as wa

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(cuda, b, ql, t, d, lens, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, ql, d), generator=gen).to(cuda)
    s = torch.randn((b, t, d), generator=gen).to(cuda)
    pad = None if lens is None else (
        torch.arange(t)[None, :] >= torch.tensor(lens)[:, None]).to(cuda)
    return q, s, pad


@pytest.mark.cuda
@pytest.mark.parametrize("b,ql,t,d,lens", [
    (1, 4096, 25, 32, [11]),
    (6, 4133, 25, 32, [25, 18, 9, 3, 1, 0]),  # ragged QL, all-padding row
    (2, 77, 32, 256, [32, 5]),  # the largest T and D the kernel holds
    (3, 5, 1, 1, [1, 1, 0]),
    (2, 300, 7, 16, None),  # no mask
])
def test_word_attention_matches_plain(cuda, b, ql, t, d, lens):
    q, s, pad = _inputs(cuda, b, ql, t, d, lens)
    before = wa.word_attention.launches
    ctx, att = wa.word_attention(q, s, pad)
    torch.cuda.synchronize()
    assert wa.word_attention.launches == before + 1
    ctx_p, att_p = wa.word_attention_plain(q, s, wa.pad_bias(pad, s))
    torch.testing.assert_close(ctx, ctx_p, **TOL)
    torch.testing.assert_close(att, att_p, **TOL)
    if lens is not None and 0 in lens:  # uniform over all T, not NaN
        row = att[lens.index(0)]
        torch.testing.assert_close(row, torch.full_like(row, 1.0 / t), **TOL)


@pytest.mark.cuda
def test_word_attention_refuses_what_it_does_not_take(cuda):
    q, s, pad = _inputs(cuda, 2, 64, 5, 8, [5, 2])
    with pytest.raises(TypeError):
        wa.word_attention(q.double(), s.double(), pad)
    with pytest.raises(ValueError):
        wa.word_attention(q.transpose(1, 2).contiguous().transpose(1, 2), s, pad)
    with pytest.raises(ValueError):
        wa.word_attention(q, s.cpu(), pad)
    q33, s33, _ = _inputs(cuda, 1, 8, 33, 8, None)
    with pytest.raises(ValueError):
        wa.word_attention(q33, s33, None)
    with pytest.raises(RuntimeError):
        wa.word_attention(q.requires_grad_(), s, pad)
