"""The port's BatchNorm (sba_gan_tpu_torch.models.norms) against flax's
``nn.BatchNorm`` as the JAX package configures it (momentum 0.9; eps 1e-5
for G and D through ``sba_gan_tpu.models.blocks.BatchNorm``, 1e-3 for the
Inception trunk): train-mode outputs, the gradients of the input, scale and
bias, and the running statistics after two calls, on (B, F) and
(B, C, H, W) inputs; eval mode on the running statistics; and the frozen
context, which must leave the buffers bit-identical.

Tolerance: float32 on both sides, sums in another order: outputs rtol 1e-5 /
atol 2e-5, gradients atol 1e-5 times the largest entry, running statistics
rtol 1e-5 / atol 1e-6.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_gan_tpu.models.blocks import BatchNorm as JaxBatchNorm
from sba_gan_tpu_torch.models.norms import BatchNorm, frozen_running_stats

SHAPES = {"2d": (6, 10), "4d": (3, 5, 4, 6)}  # torch layout; flax takes NHWC


def _flax(eps):
    if eps == 1e-5:
        return JaxBatchNorm()
    return fnn.BatchNorm(momentum=0.9, epsilon=eps)


def _to_flax(x):
    return np.transpose(x, (0, 2, 3, 1)) if x.ndim == 4 else x


def _apply_flax(module, variables, x, train=True):
    if isinstance(module, JaxBatchNorm):
        return module.apply(variables, x, train, mutable=["batch_stats"])
    return module.apply(variables, x, use_running_average=not train,
                        mutable=["batch_stats"])


def _leaves(tree, name):
    """The one leaf called ``name`` of a (possibly nested) flax tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    (leaf,) = [v for p, v in flat if p[-1].key == name]
    return np.asarray(leaf)


def _setup(shape, eps, seed):
    rng = np.random.default_rng(seed)
    xs = [(rng.standard_normal(shape) * 2.0 + 0.7).astype(np.float32) for _ in range(2)]
    cot = rng.standard_normal(shape).astype(np.float32)
    c = shape[1]
    module = _flax(eps)
    if isinstance(module, JaxBatchNorm):
        variables = module.init(jax.random.PRNGKey(0), jnp.asarray(_to_flax(xs[0])), True)
    else:
        variables = module.init(jax.random.PRNGKey(0), jnp.asarray(_to_flax(xs[0])),
                                use_running_average=False)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(scale if p[-1].key == "scale" else bias), variables["params"])
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    bn = BatchNorm(c, eps=eps)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    return xs, cot, module, variables, bn


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_train_mode_matches_flax(kind, eps):
    shape = SHAPES[kind]
    xs, cot, module, variables, bn = _setup(shape, eps, seed=len(kind) + int(eps * 1e5))
    bn.train()
    for call, x in enumerate(xs):
        def loss(params, xf):
            y, mut = _apply_flax(module, {"params": params,
                                          "batch_stats": variables["batch_stats"]}, xf)
            return jnp.sum(y * jnp.asarray(_to_flax(cot))), (y, mut)

        (_, (y_j, mut)), (g_params, g_x) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(_to_flax(x)))
        variables = {"params": variables["params"], "batch_stats": mut["batch_stats"]}

        xt = torch.from_numpy(x).requires_grad_(True)
        bn.weight.grad = bn.bias.grad = None
        y_t = bn(xt)
        (y_t * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(_to_flax(y_t.detach().numpy()), np.asarray(y_j),
                                   rtol=1e-5, atol=2e-5, err_msg=f"output, call {call}")
        for got, want, name in ((_to_flax(xt.grad.numpy()), np.asarray(g_x), "input"),
                                (bn.weight.grad.numpy(), _leaves(g_params, "scale"), "scale"),
                                (bn.bias.grad.numpy(), _leaves(g_params, "bias"), "bias")):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"{name} gradient, call {call}")
        stats = variables["batch_stats"]
        np.testing.assert_allclose(bn.running_mean.numpy(), _leaves(stats, "mean"),
                                   rtol=1e-5, atol=1e-6, err_msg=f"mean, call {call}")
        np.testing.assert_allclose(bn.running_var.numpy(), _leaves(stats, "var"),
                                   rtol=1e-5, atol=1e-6, err_msg=f"var, call {call}")
    assert int(bn.num_batches_tracked) == 2
    # the running variance took the biased value (torch's would be unbiased)
    assert not np.allclose(bn.running_var.numpy(), 1.0)

    bn.eval()
    y_eval, _ = _apply_flax(module, variables, jnp.asarray(_to_flax(xs[0])), train=False)
    with torch.no_grad():
        np.testing.assert_allclose(_to_flax(bn(torch.from_numpy(xs[0])).numpy()),
                                   np.asarray(y_eval), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_frozen_running_stats_leave_buffers_bit_identical(kind):
    shape = SHAPES[kind]
    xs, cot, _, _, bn = _setup(shape, 1e-5, seed=7)
    net = torch.nn.Sequential(bn, torch.nn.Identity())
    net.train()
    net(torch.from_numpy(xs[0]))  # move the statistics away from 0 / 1 first
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    x = torch.from_numpy(xs[1]).requires_grad_(True)
    with frozen_running_stats(net):
        y = net(x)
        (y * torch.from_numpy(cot)).sum().backward()
    for k, v in bn.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert bn.update_stats
    # batch statistics were used, not the running ones
    dims = [0] + list(range(2, x.dim()))
    mean = y.detach().mean(dim=dims)
    np.testing.assert_allclose(mean.numpy(), bn.bias.detach().numpy(), atol=1e-5)
    # outside the block the buffers move again
    net(torch.from_numpy(xs[1]))
    assert not torch.equal(bn.running_mean, before["running_mean"])


def test_bad_rank_is_refused():
    bn = BatchNorm(4)
    with pytest.raises(ValueError, match="BatchNorm takes"):
        bn(torch.zeros(2, 4, 3))
