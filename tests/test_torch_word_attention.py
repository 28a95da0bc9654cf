"""The port's word attention (sba_gan_tpu_torch.ops.word_attention) against
the JAX package's: the Pallas kernel in interpret mode and the XLA path,
forward and gradients (the port's ``torch.autograd.Function`` against
``jax.grad`` through the JAX package's custom VJP), with and without a
cotangent on the attention map P.

Tolerance rtol 1e-5, atol 1e-5 forward and rtol 1e-4, atol 1e-4 gradients
(those of tests/test_word_attention_kernel.py): both sides are float32 with
sums taken in a different order.  On the CPU the wrapper runs the plain
PyTorch version; the CUDA kernel itself is held against it on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py); the backward is the same
code on both devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_gan_tpu.ops.word_attention import word_attention as jax_word_attention
from sba_gan_tpu_torch.ops import word_attention as wa

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, b, ql, t, d, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, ql, d)).astype(np.float32)
    s = rng.standard_normal((b, t, d)).astype(np.float32)
    if lens is None:
        return q, s, None
    pad = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    return q, s, pad


CASES = {
    # B, QL, T, D, lengths (None = no mask)
    "ragged": (3, 512, 7, 16, [7, 3, 5]),
    "all_padding_row": (2, 512, 6, 8, [4, 0]),
    "no_mask": (2, 512, 5, 8, None),
    "ql_not_tile_multiple": (2, 600, 25, 32, [25, 9]),
    # COCO's width (GF_DIM 48, WORDS_NUM 12), which the kernel takes through
    # its D 48 instance; an all-padding row
    "coco_width": (2, 600, 12, 48, [12, 0]),
}
# queries scaled by D^-0.5: an all-padding row is uniform only while its
# scores stay within 32 of 0 (the pad bias -1e9's float32 neighbours lie 64
# apart), which unit queries at D 48 (scores of deviation ~7) may break
Q_SCALE = {"coco_width": 48 ** -0.5}


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case, impl):
    b, ql, t, d, lens = CASES[case]
    q, s, pad = _inputs(len(case), b, ql, t, d, lens)
    q = q * np.float32(Q_SCALE.get(case, 1.0))
    ctx_j, att_j = jax_word_attention(
        jnp.asarray(q), jnp.asarray(s),
        None if pad is None else jnp.asarray(pad), impl=impl)
    before = wa.word_attention.launches
    ctx_t, att_t = wa.word_attention(
        torch.from_numpy(q), torch.from_numpy(s),
        None if pad is None else torch.from_numpy(pad))
    assert wa.word_attention.launches == before == 0  # no kernel on the CPU
    assert ctx_t.shape == (b, ql, d) and att_t.shape == (b, ql, t)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), **TOL)
    np.testing.assert_allclose(att_t.numpy(), np.asarray(att_j), **TOL)
    if lens is not None and 0 in lens:
        # additive -1e9, not -inf: a fully padded row is uniform, not NaN
        np.testing.assert_allclose(att_t[lens.index(0)].numpy(), 1.0 / t, **TOL)


def test_pad_bias():
    s = torch.zeros(2, 3, 4)
    pad = torch.tensor([[False, True, True], [False, False, False]])
    bias = wa.pad_bias(pad, s)
    assert bias.dtype == torch.float32
    assert bias.tolist() == [[0.0, -1e9, -1e9], [0.0, 0.0, 0.0]]
    assert wa.pad_bias(None, s).abs().sum() == 0


def test_kernel_wrapper_checks_the_mask_shape():
    q, s = torch.zeros(2, 5, 8), torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="shape mismatch"):
        wa._check(q, s, torch.zeros(2, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="pad_mask"):
        wa._check(q, s, torch.zeros(2, 3, 1, dtype=torch.bool))


@pytest.mark.parametrize("p_cotangent", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case, p_cotangent):
    b, ql, t, d, lens = CASES[case]
    q, s, pad = _inputs(len(case) + 1, b, ql, t, d, lens)
    q = q * np.float32(Q_SCALE.get(case, 1.0))
    rng = np.random.default_rng(len(case))
    d_ctx = rng.standard_normal((b, ql, d)).astype(np.float32)
    d_p = (rng.standard_normal((b, ql, t)).astype(np.float32) if p_cotangent
           else np.zeros((b, ql, t), np.float32))
    jpad = None if pad is None else jnp.asarray(pad)

    def loss(qj, sj):
        ctx, att = jax_word_attention(qj, sj, jpad, impl="interpret")
        return jnp.sum(ctx * d_ctx) + jnp.sum(att * d_p)

    gq_j, gs_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(s))
    qt = torch.from_numpy(q).requires_grad_(True)
    st = torch.from_numpy(s).requires_grad_(True)
    ctx_t, att_t = wa.word_attention(qt, st, None if pad is None else torch.from_numpy(pad))
    out = (ctx_t * torch.from_numpy(d_ctx)).sum()
    if p_cotangent:  # without it, no gradient reaches P at all
        out = out + (att_t * torch.from_numpy(d_p)).sum()
    out.backward()
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(gq_j), **GRAD_TOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs_j), **GRAD_TOL)


def test_backward_formula_matches_autograd_of_plain():
    """word_attention_backward against autograd through the plain version,
    in float64 (the formula itself, apart from rounding)."""
    q, s, pad = _inputs(9, 2, 33, 5, 8, [5, 2])
    q, s = torch.from_numpy(q).double(), torch.from_numpy(s).double()
    bias = wa.pad_bias(torch.from_numpy(pad), s)
    gen = torch.Generator().manual_seed(0)
    d_ctx = torch.randn((2, 33, 8), generator=gen, dtype=torch.float64)
    d_p = torch.randn((2, 33, 5), generator=gen, dtype=torch.float64)
    qa, sa = q.clone().requires_grad_(True), s.clone().requires_grad_(True)
    ctx, p = wa.word_attention_plain(qa, sa, bias)
    ((ctx * d_ctx).sum() + (p * d_p).sum()).backward()
    dq, ds = wa.word_attention_backward(q, s, p.detach(), d_ctx, d_p)
    torch.testing.assert_close(dq, qa.grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ds, sa.grad, rtol=1e-12, atol=1e-12)
    dq0, ds0 = wa.word_attention_backward(q, s, p.detach(), d_ctx, None)
    dq1, ds1 = wa.word_attention_backward(q, s, p.detach(), d_ctx, torch.zeros_like(d_p))
    torch.testing.assert_close(dq0, dq1)
    torch.testing.assert_close(ds0, ds1)
