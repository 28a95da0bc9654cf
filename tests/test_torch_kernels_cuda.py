"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (a hand-written
kernel has no CPU mode).  The file imports nothing of JAX, so it runs on a
machine with PyTorch and the CUDA toolkit alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance rtol 1e-5, atol 1e-5 for word attention: float32 on both sides,
sums in another order.  The DAMSM kernels (K1-K3) sum over D and R through
three softmaxes: rtol 1e-4 / atol 1e-4 on sim, and rtol 1e-3 / atol 1e-3
times the largest entry on the gradients (K3's products run on the tensor
cores in 3xTF32, which keeps float32 accuracy).
"""

import pytest
import torch

from sba_gan_tpu_torch.ops import damsm_sim as ds
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
@pytest.mark.parametrize("b,t,d,tiles,extra,lens", [
    (1, 25, 32, 1, 1, [11]),  # one row past the tile
    (6, 25, 32, 3, 17, [25, 18, 9, 3, 1, 0]),  # ragged QL, all-padding row
    (1, 1, 32, 2, 0, [1]),  # one word
    (6, 32, 32, 1, 1, [32, 31, 16, 2, 1, 0]),  # every word slot
    (2, 25, 8, 1, 1, [25, 0]),  # small D: the generic instance
    (1, 32, 256, 2, 5, [7]),  # the largest D
    (6, 25, 36, 1, 3, [25, 18, 9, 3, 1, 0]),  # D not a multiple of 32
])
def test_word_attention_edges(cuda, b, t, d, tiles, extra, lens):
    ql = tiles * wa.tile_rows() + extra
    q, s, pad = _inputs(cuda, b, ql, t, d, lens, seed=ql + d)
    # scores of unit variance at every D, as the generator's are: with unit
    # queries at D 256 they would reach ~50, where float32 rounding of a sum
    # over D alone moves P by ~1e-5
    q = q * d ** -0.5
    ctx, att = wa.word_attention(q, s, pad)
    torch.cuda.synchronize()
    ctx_p, att_p = wa.word_attention_plain(q, s, wa.pad_bias(pad, s))
    torch.testing.assert_close(ctx, ctx_p, **TOL)
    torch.testing.assert_close(att, att_p, **TOL)
    if 0 in lens:
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


def _damsm_inputs(cuda, b, t, r, d, seed=0):
    gen = torch.Generator().manual_seed(seed)
    words = torch.randn((b, t, d), generator=gen).to(cuda)
    img = torch.randn((b, r, d), generator=gen).to(cuda)
    lens = torch.randint(1, t + 1, (b,), generator=gen)
    lens[0], lens[-1] = 1, t
    g = torch.randn((b, b), generator=gen).to(cuda)
    return words, img, lens, g


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,r,d", [
    (32, 20, 289, 256),  # DAMSM pretrain
    (30, 20, 289, 256),  # a batch no tile divides
    (5, 32, 17, 8),  # the largest T the kernels hold, small R and D
    (3, 1, 4, 4),
    (40, 7, 100, 36),  # D that does not divide the block
])
def test_damsm_kernels_match_plain(cuda, b, t, r, d):
    words, img, lens, g = _damsm_inputs(cuda, b, t, r, d)
    counts = [f.launches for f in (ds.damsm_sim_fwd, ds.damsm_sim_dimg,
                                   ds.damsm_sim_dwords)]
    sim = ds.damsm_sim_fwd(words, img, lens)
    d_img = ds.damsm_sim_dimg(words, img, lens, g)
    d_words = ds.damsm_sim_dwords(words, img, lens, g)
    torch.cuda.synchronize()
    assert [f.launches for f in (ds.damsm_sim_fwd, ds.damsm_sim_dimg,
                                 ds.damsm_sim_dwords)] == [c + 1 for c in counts]
    torch.testing.assert_close(sim, ds.damsm_sim_plain(words, img, lens),
                               rtol=1e-4, atol=1e-4)
    for got, want in ((d_img, ds.damsm_sim_dimg_plain(words, img, lens, g)),
                      (d_words, ds.damsm_sim_dwords_plain(words, img, lens, g))):
        torch.testing.assert_close(got, want, rtol=1e-3,
                                   atol=1e-3 * want.abs().max().item())
    pad = (torch.arange(t)[None, :] >= lens[:, None]).to(cuda)
    assert torch.all(d_words[pad] == 0)


def _check_dwords(words, img, lens, g, got):
    want = ds.damsm_sim_dwords_plain(words, img, lens, g)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * want.abs().max().item())
    pad = (torch.arange(words.shape[1])[None, :] >= lens[:, None]).to(got.device)
    assert torch.all(got[pad] == 0)  # exactly zero at padding


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,r,d", [
    (1, 20, 289, 256),  # one text, one image
    (30, 20, 289, 256),  # odd groups of two texts
    (128, 18, 289, 256),  # the GAN step's shape
    (6, 32, 289, 256),  # T 32: one text a block
    (7, 20, 300, 256),  # ragged R, past a chunk
    (5, 32, 17, 8),  # small R and D
    (3, 20, 17, 12),  # D not a multiple of 8
    (4, 1, 289, 256),  # one word
])
def test_damsm_dwords_edges(cuda, b, t, r, d):
    words, img, lens, g = _damsm_inputs(cuda, b, t, r, d, seed=b + r)
    _check_dwords(words, img, lens, g, ds.damsm_sim_dwords(words, img, lens, g))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["one", "full"])
def test_damsm_dwords_every_caption_one_or_t_words(cuda, fill):
    words, img, lens, g = _damsm_inputs(cuda, 9, 20, 289, 256, seed=3)
    lens = torch.full_like(lens, 1 if fill == "one" else 20)
    _check_dwords(words, img, lens, g, ds.damsm_sim_dwords(words, img, lens, g))


@pytest.mark.cuda
def test_damsm_dwords_is_deterministic(cuda):
    words, img, lens, g = _damsm_inputs(cuda, 32, 20, 289, 256, seed=5)
    first = ds.damsm_sim_dwords(words, img, lens, g)
    second = ds.damsm_sim_dwords(words, img, lens, g)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_damsm_function_routes_backward(cuda):
    words, img, lens, g = _damsm_inputs(cuda, 6, 5, 17, 8)
    before = (ds.damsm_sim_dimg.launches, ds.damsm_sim_dwords.launches)
    x = img.clone().requires_grad_()
    ds.damsm_sim(words, x, lens).backward(g)  # words detached: K2 only
    assert (ds.damsm_sim_dimg.launches, ds.damsm_sim_dwords.launches) == (
        before[0] + 1, before[1])
    want = ds.damsm_sim_dimg_plain(words, img, lens, g)
    torch.testing.assert_close(x.grad, want, rtol=1e-3,
                               atol=1e-3 * want.abs().max().item())


@pytest.mark.cuda
def test_damsm_wrappers_refuse_what_they_do_not_take(cuda):
    words, img, lens, g = _damsm_inputs(cuda, 2, 4, 9, 8)
    with pytest.raises(TypeError):
        ds.damsm_sim_fwd(words.double(), img.double(), lens)
    with pytest.raises(ValueError):
        ds.damsm_sim_fwd(words, img.cpu(), lens)
    with pytest.raises(ValueError):
        ds.damsm_sim_fwd(words, img, torch.tensor([0, 3]))
    with pytest.raises(ValueError):
        ds.damsm_sim_fwd(words[:, :, :6].contiguous(), img[:, :, :6].contiguous(), lens)
    w33, x33, l33, _ = _damsm_inputs(cuda, 2, 33, 9, 8)
    with pytest.raises(ValueError):
        ds.damsm_sim_fwd(w33, x33, l33)
    # T 32 against 4000 regions: two (T, R) score matrices overflow shared memory
    w, x, lw, gw = _damsm_inputs(cuda, 2, 32, 4000, 8)
    with pytest.raises(RuntimeError, match="does not take this shape"):
        ds.damsm_sim_fwd(w, x, lw)
    with pytest.raises(RuntimeError, match="does not take this shape"):
        ds.damsm_sim_dimg(w, x, lw, gw)
    with pytest.raises(RuntimeError, match="does not take this shape"):
        ds.damsm_sim_dwords(w, x, lw, gw)
