"""The port's word attention (sba_gan_tpu_torch.ops.word_attention) against
the JAX package's: the Pallas kernel in interpret mode and the XLA path.

Tolerance rtol 1e-5, atol 1e-5 (that of tests/test_word_attention_kernel.py):
both sides are float32 with sums taken in a different order.  On the CPU the
wrapper runs the plain PyTorch version; the CUDA kernel itself is held
against it on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_gan_tpu.ops.word_attention import word_attention as jax_word_attention
from sba_gan_tpu_torch.ops import word_attention as wa

TOL = dict(rtol=1e-5, atol=1e-5)


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
}


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case, impl):
    b, ql, t, d, lens = CASES[case]
    q, s, pad = _inputs(len(case), b, ql, t, d, lens)
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
    if case == "all_padding_row":
        # additive -1e9, not -inf: a fully padded row is uniform, not NaN
        np.testing.assert_allclose(att_t[1].numpy(), 1.0 / t, **TOL)


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
