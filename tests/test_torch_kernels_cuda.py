"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (a hand-written
kernel has no CPU mode).  The file imports nothing of JAX, so it runs on a
machine with PyTorch and the CUDA toolkit alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance rtol 1e-5, atol 1e-5 for word attention: float32 on both sides,
sums in another order; rtol 1e-4 / atol 1e-4 for its gradients through the
autograd Function (kernel forward, ``bmm`` backward) against autograd of
the plain version.  The DAMSM kernels (K1-K3) sum over D and R through
three softmaxes: rtol 1e-4 / atol 1e-4 on sim, and rtol 1e-3 / atol 1e-3
times the largest entry on the gradients (their products run on the
tensor cores in 3xTF32, which keeps float32 accuracy).

The bfloat16 instantiations against the plain bfloat16 versions: K4 with
bfloat16 query and source, P as above and the context within one bfloat16
rounding of one P times the largest source value (atol 2^-8 max|S| + 1e-5:
a P computed in another order can round to the neighbouring value); K1-K3
with ``mm_dtype`` bfloat16 within the bounds of ``chip_smoke.py``'s
(rtol / atol 1e-3 on sim, 1e-2 times the largest entry on the
gradients); each at least ten times closer
to the plain bfloat16 result than that is to the plain float32 one.

Beside the kernels, two checks of the profiler on the card: the
optimizer's annotated range is told apart from the kernels it encloses,
and the bench's name for K4 finds every instance of it.
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


COCO_LENS = [12, 11, 9, 7, 5, 3, 2, 1, 0, 12, 6, 4, 8, 10]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_word_attention_generic_instance_at_coco_width(cuda, dtype):
    """K4 at coco_attn2's word-attention width (GF_DIM 48), which takes the
    D 48 instance (the generic one before it had its own): its step's batch
    14, WORDS_NUM 12, QL 64^2 and a ragged 17 rows, an all-padding row; at
    the tolerances of the D 32 cases.  Scores of
    unit variance, as in test_word_attention_edges: the pad bias -1e9 is
    exact in float32 but its neighbours lie 64 apart, so an all-padding row
    is uniform only while every score stays within 32 of 0 (with unit
    queries at D 48, whose scores have a deviation of ~7, a few of 49,356
    entries were not, in the kernel and the plain version alike)."""
    q32, s32, pad = _inputs(cuda, 14, 64 * 64 + 17, 12, 48, COCO_LENS, seed=48)
    q32 = q32 * 48 ** -0.5
    q, s = q32.to(dtype), s32.to(dtype)
    assert wa.instance(48, q.data_ptr() % 16 == 0) == 48
    before = (wa.word_attention.launches, wa.word_attention.bf16_launches)
    ctx, att = wa.word_attention(q, s, pad)
    torch.cuda.synchronize()
    bf16 = dtype == BF16
    assert (wa.word_attention.launches, wa.word_attention.bf16_launches) == (
        before[0] + 1, before[1] + bf16)
    bias = wa.pad_bias(pad, s)
    ctx_p, att_p = wa.word_attention_plain(q, s, bias)
    torch.testing.assert_close(att, att_p, **TOL)
    row = att[COCO_LENS.index(0)]  # uniform over all T, not NaN
    torch.testing.assert_close(row, torch.full_like(row, 1.0 / 12), **TOL)
    if not bf16:
        torch.testing.assert_close(ctx, ctx_p, **TOL)
        return
    ctx_f, _ = wa.word_attention_plain(q32, s32, bias)
    torch.testing.assert_close(ctx, ctx_p, rtol=1e-5,
                               atol=2.0 ** -8 * s.float().abs().max().item() + 1e-5)
    assert 10 * _gap(ctx, ctx_p) <= _gap(ctx_p, ctx_f)


def _check_d48(q, s, pad, t, lens):
    """K4 against plain at D 48 in the inputs' dtype (the bfloat16 context
    within one rounding of one P times the largest source value), and a
    uniform all-padding row."""
    ctx, att = wa.word_attention(q, s, pad)
    torch.cuda.synchronize()
    ctx_p, att_p = wa.word_attention_plain(q, s, wa.pad_bias(pad, s))
    torch.testing.assert_close(att, att_p, **TOL)
    ctx_tol = TOL if q.dtype == torch.float32 else dict(
        rtol=1e-5, atol=2.0 ** -8 * s.float().abs().max().item() + 1e-5)
    torch.testing.assert_close(ctx, ctx_p, **ctx_tol)
    if 0 in lens:
        row = att[lens.index(0)]
        torch.testing.assert_close(row, torch.full_like(row, 1.0 / t), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,tiles,extra,lens", [
    (12, 1, 1, [12, 0]),  # one row past the tile, an all-padding row
    (12, 3, 17, [12, 7, 2, 0]),  # ragged QL
    (1, 2, 0, [1, 0]),  # one word
    (16, 1, 9, [16, 3, 0]),  # the most words of two rows a warp side by side
    (20, 2, 5, [20, 13, 0]),  # eval_coco's T: 32 word slots
    (32, 1, 1, [32, 31, 0]),  # every word slot
])
def test_word_attention_d48_instance_edges(cuda, dtype, t, tiles, extra, lens):
    """The D 48 instance at the tile's edges, in float32 and bfloat16;
    queries scaled by D^-0.5, as in test_word_attention_edges."""
    ql = tiles * wa.tile_rows() + extra
    q32, s32, pad = _inputs(cuda, len(lens), ql, t, 48, lens, seed=ql + t)
    q, s = (q32 * 48 ** -0.5).to(dtype), s32.to(dtype)
    assert wa.instance(48, q.data_ptr() % 16 == 0) == 48
    _check_d48(q, s, pad, t, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,ql,lens", [
    (12, 132 * 128 + 1, [12, 5, 0]),  # one row past a 128-row tile
    (20, 132 * 128 + 77, [20, 9, 0]),  # ragged QL, 32 word slots
    (32, 132 * 128 + 1, [32, 31, 0]),  # every slot: over 48 KB of shared memory
])
def test_word_attention_d48_instance_tall_grids(cuda, dtype, t, ql, lens):
    """The D 48 instance on grids of at least three 128-row tiles for each
    of 132 SMs (B x QL >= 50,688), which take 128 query rows a block."""
    q32, s32, pad = _inputs(cuda, len(lens), ql, t, 48, lens, seed=t)
    q, s = (q32 * 48 ** -0.5).to(dtype), s32.to(dtype)
    _check_d48(q, s, pad, t, lens)


@pytest.mark.cuda
def test_word_attention_instance_selection(cuda):
    """The compile-time instances take D 32 and 48 on 16-byte aligned query
    and ctx; any other D, or an unaligned query, takes the generic one."""
    assert wa.instance(48) == 48 and wa.instance(32) == 32
    assert wa.instance(48, aligned=False) == 0 and wa.instance(32, aligned=False) == 0
    assert wa.instance(36) == 0 and wa.instance(256) == 0 and wa.instance(16) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_word_attention_unaligned_d48_query(cuda, dtype):
    """A contiguous D 48 query that starts one element past a 16-byte
    boundary (a view into a flat buffer at an odd offset) goes to the
    generic instance and still matches plain."""
    lens = [12, 5, 0]
    q32, s32, pad = _inputs(cuda, 3, 2 * wa.tile_rows() + 7, 12, 48, lens, seed=5)
    flat = torch.zeros(q32.numel() + 1, dtype=dtype, device=cuda)
    q = flat[1:].view(q32.shape)
    q.copy_(q32 * 48 ** -0.5)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    assert wa.instance(48, q.data_ptr() % 16 == 0) == 0
    _check_d48(q, s32.to(dtype), pad, 12, lens)


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
    # an input that needs a gradient is taken: the backward is word_attention_backward
    ctx, _ = wa.word_attention(q.requires_grad_(), s, pad)
    assert ctx.requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("b,ql,t,d,lens", [
    (2, 4096, 18, 32, [18, 5]),  # the GAN step's stage 2 at a small batch
    (3, 4133, 25, 32, [25, 1, 0]),  # ragged QL, all-padding row
    (2, 77, 7, 16, None),
    (3, 4113, 12, 48, [12, 6, 2]),  # the D 48 instance: COCO's stage 2, ragged
    (2, 1000, 20, 48, [20, 9]),  # the D 48 instance at 32 word slots
])
def test_word_attention_autograd_matches_plain(cuda, b, ql, t, d, lens):
    """K4 forward with the backward of the Function against autograd
    through the plain version, with cotangents on the context and on P."""
    q, s, pad = _inputs(cuda, b, ql, t, d, lens, seed=ql + t)
    gen = torch.Generator().manual_seed(1)
    d_ctx = torch.randn((b, ql, d), generator=gen).to(cuda)
    d_p = torch.randn((b, ql, t), generator=gen).to(cuda)
    qk, sk = q.clone().requires_grad_(True), s.clone().requires_grad_(True)
    before = wa.word_attention.launches
    ctx, att = wa.word_attention(qk, sk, pad)
    ((ctx * d_ctx).sum() + (att * d_p).sum()).backward()
    torch.cuda.synchronize()
    assert wa.word_attention.launches == before + 1  # the backward launches no K4
    qp, sp = q.clone().requires_grad_(True), s.clone().requires_grad_(True)
    ctx_p, att_p = wa.word_attention_plain(qp, sp, wa.pad_bias(pad, s))
    ((ctx_p * d_ctx).sum() + (att_p * d_p).sum()).backward()
    torch.testing.assert_close(ctx, ctx_p, **TOL)
    torch.testing.assert_close(att, att_p, **TOL)
    grad_tol = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(qk.grad, qp.grad, **grad_tol)
    torch.testing.assert_close(sk.grad, sp.grad, **grad_tol)


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


def _check_kernel(kernel, words, img, lens, g):
    """K1, K2 or K3 through its public wrapper against its plain version;
    returns the kernel's result."""
    if kernel == "fwd":
        got = ds.damsm_sim_fwd(words, img, lens)
        torch.testing.assert_close(got, ds.damsm_sim_plain(words, img, lens),
                                   rtol=1e-4, atol=1e-4)
        return got
    wrapper, plain = {"dimg": (ds.damsm_sim_dimg, ds.damsm_sim_dimg_plain),
                      "dwords": (ds.damsm_sim_dwords, ds.damsm_sim_dwords_plain)}[kernel]
    got = wrapper(words, img, lens, g)
    want = plain(words, img, lens, g)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * want.abs().max().item())
    if kernel == "dwords":
        pad = (torch.arange(words.shape[1])[None, :] >= lens[:, None]).to(got.device)
        assert torch.all(got[pad] == 0)  # exactly zero at padding
    return got


DAMSM_KERNELS = ["fwd", "dimg", "dwords"]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", DAMSM_KERNELS)
@pytest.mark.parametrize("b,t,r,d", [
    (1, 20, 289, 256),  # one text, one image
    (30, 20, 289, 256),  # odd groups of two texts
    (128, 18, 289, 256),  # the GAN step's shape
    (6, 32, 289, 256),  # T 32: one text a block
    (7, 20, 300, 256),  # ragged R, past a chunk; odd B: a group of one text
    (5, 32, 17, 8),  # small R and D
    (3, 20, 17, 12),  # D not a multiple of 8
    (4, 1, 289, 256),  # one word
])
def test_damsm_kernel_edges(cuda, kernel, b, t, r, d):
    words, img, lens, g = _damsm_inputs(cuda, b, t, r, d, seed=b + r)
    _check_kernel(kernel, words, img, lens, g)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", DAMSM_KERNELS)
@pytest.mark.parametrize("fill", ["one", "full"])
def test_damsm_kernels_every_caption_one_or_t_words(cuda, kernel, fill):
    words, img, lens, g = _damsm_inputs(cuda, 9, 20, 289, 256, seed=3)
    lens = torch.full_like(lens, 1 if fill == "one" else 20)
    _check_kernel(kernel, words, img, lens, g)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", DAMSM_KERNELS)
def test_damsm_kernels_are_deterministic(cuda, kernel):
    """Bit for bit from call to call: fixed order of every sum, no atomics."""
    words, img, lens, g = _damsm_inputs(cuda, 32, 20, 289, 256, seed=5)
    first = _check_kernel(kernel, words, img, lens, g)
    second = _check_kernel(kernel, words, img, lens, g)
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


BF16 = torch.bfloat16
DAMSM_BF16_FWD_TOL = dict(rtol=1e-3, atol=1e-3)  # as chip_smoke.py's
DAMSM_BF16_GRAD_RTOL = 1e-2


def _gap(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,ql,t,d,lens", [
    (1, 16384, 25, 32, [11]),  # serving
    (6, 4133, 25, 32, [25, 18, 9, 3, 1, 0]),  # ragged QL, all-padding row
    (2, 77, 32, 256, [32, 5]),  # the generic instance
    (3, 300, 7, 16, None),
])
def test_word_attention_bf16_matches_plain(cuda, b, ql, t, d, lens):
    q32, s32, pad = _inputs(cuda, b, ql, t, d, lens, seed=ql + t)
    q, s = q32.to(BF16), s32.to(BF16)
    before = (wa.word_attention.launches, wa.word_attention.bf16_launches)
    ctx, att = wa.word_attention(q, s, pad)
    torch.cuda.synchronize()
    assert (wa.word_attention.launches, wa.word_attention.bf16_launches) == (
        before[0] + 1, before[1] + 1)
    assert ctx.dtype == att.dtype == torch.float32
    bias = wa.pad_bias(pad, s)
    ctx_p, att_p = wa.word_attention_plain(q, s, bias)
    ctx_f, _ = wa.word_attention_plain(q32, s32, bias)
    torch.testing.assert_close(att, att_p, **TOL)
    torch.testing.assert_close(ctx, ctx_p, rtol=1e-5,
                               atol=2.0 ** -8 * s.float().abs().max().item() + 1e-5)
    assert 10 * _gap(ctx, ctx_p) <= _gap(ctx_p, ctx_f)


@pytest.mark.cuda
def test_word_attention_bf16_gradients(cuda):
    """The Function on bfloat16 inputs: K4's bfloat16 forward, the float32
    backward, dQ and dS back in bfloat16, as on the CPU."""
    q32, s32, pad = _inputs(cuda, 2, 4096, 18, 32, [18, 5], seed=3)
    q = q32.to(BF16).requires_grad_(True)
    s = s32.to(BF16).requires_grad_(True)
    d_ctx = torch.randn((2, 4096, 32), generator=torch.Generator().manual_seed(1)).to(cuda)
    ctx, att = wa.word_attention(q, s, pad)
    (ctx * d_ctx).sum().backward()
    assert q.grad.dtype == s.grad.dtype == BF16
    want_q, want_s = wa.word_attention_backward(q.detach(), s.detach(), att.detach(), d_ctx)
    torch.testing.assert_close(q.grad, want_q, rtol=0, atol=0)
    torch.testing.assert_close(s.grad, want_s, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", DAMSM_KERNELS)
@pytest.mark.parametrize("b,t,r,d", [
    (32, 20, 289, 256),  # DAMSM pretrain
    (30, 20, 289, 256),  # odd groups of two texts
    (128, 18, 289, 256),  # the GAN step's shape
    (6, 32, 289, 256),  # T 32: one text a block
    (7, 20, 300, 256),  # ragged R
    (3, 20, 17, 12),  # D not a multiple of 8
])
def test_damsm_kernels_bf16_match_plain(cuda, kernel, b, t, r, d):
    words, img, lens, g = _damsm_inputs(cuda, b, t, r, d, seed=b + r + 1)
    wrapper, plain = {"fwd": (ds.damsm_sim_fwd, ds.damsm_sim_plain),
                      "dimg": (ds.damsm_sim_dimg, ds.damsm_sim_dimg_plain),
                      "dwords": (ds.damsm_sim_dwords, ds.damsm_sim_dwords_plain)}[kernel]
    args = (words, img, lens) if kernel == "fwd" else (words, img, lens, g)
    before = wrapper.bf16_launches
    got = wrapper(*args, mm_dtype=BF16)
    torch.cuda.synchronize()
    assert wrapper.bf16_launches == before + 1
    want, want_f32 = plain(*args, mm_dtype=BF16), plain(*args)
    if kernel == "fwd":
        tol = DAMSM_BF16_FWD_TOL
    else:
        tol = dict(rtol=DAMSM_BF16_GRAD_RTOL,
                   atol=DAMSM_BF16_GRAD_RTOL * want.abs().max().item())
    torch.testing.assert_close(got, want, **tol)
    assert 10 * _gap(got, want) <= _gap(want, want_f32)
    if kernel == "dwords":
        pad = (torch.arange(t)[None, :] >= lens[:, None]).to(cuda)
        assert torch.all(got[pad] == 0)


@pytest.mark.cuda
def test_profiler_marks_the_adam_range_as_annotation(cuda):
    """``bench.device_events`` on a real trace of one Adam step: the
    profiler reports ``Optimizer.step#Adam.step`` on the device as a user
    annotation, so it lands in the ranges and not among the kernels whose
    device time and launches the bench and the pretrain profile sum."""
    from torch.profiler import ProfilerActivity, profile

    from sba_gan_tpu_torch.bench import device_events

    net = torch.nn.Linear(64, 64).to(cuda)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    net(torch.randn(32, 64, device=cuda)).square().sum().backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        opt.step()
        torch.cuda.synchronize()
    kernels, ranges = device_events(prof.key_averages())
    assert "Optimizer.step#Adam.step" in {e.key for e in ranges}
    assert kernels and not {e.key for e in kernels} & {e.key for e in ranges}


@pytest.mark.cuda
@pytest.mark.parametrize("b,ql,t,d", [
    (1, 4096, 25, 32),  # the D 32 instance
    (2, 1000, 12, 48),  # the D 48 instance, 32-row tiles
    (4, 16384, 12, 48),  # the D 48 instance, 128-row tiles
    (2, 300, 7, 36),  # the generic instance
])
def test_bench_counts_every_word_attention_instance(cuda, b, ql, t, d):
    """The bench finds K4 on the device's timeline by its name
    (``bench.KERNEL_NAMES``) whichever instance a launch took: one launch,
    one kernel event."""
    from torch.profiler import ProfilerActivity, profile

    from sba_gan_tpu_torch.bench import KERNEL_NAMES, device_events

    q, s, pad = _inputs(cuda, b, ql, t, d, None)
    wa.word_attention(q, s, pad)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wa.word_attention(q, s, pad)
        torch.cuda.synchronize()
    kernels, _ = device_events(prof.key_averages())
    hits = [e for e in kernels if KERNEL_NAMES["word_attention"] in e.key]
    assert sum(e.count for e in hits) == 1, [e.key for e in kernels]

