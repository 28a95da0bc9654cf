"""The port's GAN train step (sba_gan_tpu_torch.train.gan) against the JAX
package's ``make_gan_train_step`` over two steps, from the same weights, batch
and noise: every log key, the gradients of the first step, the G, D and EMA
parameters and the G and D BatchNorm running statistics after each step.
Then, on the port alone: which DAMSM and attention paths one step takes,
lambda 0, and the state's round trip (gradient accumulation:
tests/test_torch_grad_accum.py).

Setup: BRANCH_NUM 2 (64 and 128 images), batch 4, GF/DF 8, EMBEDDING 32,
WORDS 6, Inception input 75, gammas 4/5/10, lambda 5, Adam lr 2e-4; JAX's
``z`` and ``eps`` are drawn as its step draws them and passed to the port.

Precision: float64 on both sides (JAX under ``jax.enable_x64`` with
``JAX.DTYPE`` float64, the port's modules in double), as in
tests/test_torch_damsm_pretrain.py: in float32 the train-mode BatchNorms of
tiny widths over a batch of 4 amplify rounding beyond any useful tolerance.
The JAX package still rounds through float32 in places even then: the CA
sample, the instance norm of AdaIN, the attention logits, the tanh of each
image, the Inception resize and outputs, the D logits, ``bce_logits``,
``kl_loss`` and the DAMSM losses.  So the two sides agree to float32
rounding, ~1e-7, amplified by the BatchNorms:

* logs rtol 2e-5 (measured <= 3.3e-6);
* first-step gradients (JAX's from its Adam first moment, 2 mu) atol 2e-5
  times each tensor's largest entry (measured <= 3e-6);
* running statistics atol 5e-6 times each tensor's largest entry (measured
  <= 4.5e-7).

Parameters: Adam's first update is lr * g / (|g| + 1e-8), about lr * sign(g),
so it moves an entry by at most ~1e-3 lr where the two gradients agree to
1e-3 (checked for over 99% of the entries) and by up to 2 lr where they do
not (near-zero gradients, whose sign is rounding noise).  Those entries then
differ in the second step's forward, so the second step's gradients agree
only per entry: after two steps, the entries whose gradients agreed to 1e-3
in both steps must agree within 2e-3 lr, and every entry within 4 lr (two
steps of Adam's largest move).  The EMA moves by 1e-3 of the parameters: it
must equal 0.999 EMA + 0.001 p on the port's own parameters, and JAX's
within 1e-3 of the parameter bound plus float32 rounding (2e-7).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.train.gan import build_models as jax_build_models
from sba_gan_tpu.train.gan import init_gan_state as jax_init_gan_state
from sba_gan_tpu.train.gan import make_gan_train_step as jax_make_step
from sba_gan_tpu.train.gan import noise_shape as jax_noise_shape
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.ops import damsm_sim as dsim
from sba_gan_tpu_torch.ops import word_attention as wa
from sba_gan_tpu_torch.train.gan import GANStep, build_models, init_gan_state, log_keys
from sba_gan_tpu_torch.utils import weights as W

N_WORDS, B, T, LR, STEPS = 30, 4, 6, 2e-4, 2
TINY = {"TREE": {"BRANCH_NUM": 2, "BASE_SIZE": 64},
        "GAN": {"GF_DIM": 8, "DF_DIM": 8, "Z_DIM": 8, "W_DIM": 16, "CONDITION_DIM": 8,
                "R_NUM": 1},
        "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": T},
        "MODEL": {"INCEPTION_INPUT": 75},
        "TRAIN": {"BATCH_SIZE": B, "GENERATOR_LR": LR, "DISCRIMINATOR_LR": LR,
                  "SMOOTH": {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0,
                             "LAMBDA": 5.0}}}
NETS = ("G", "D0", "D1")


def make_batch(branches=2):
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(-1, 1, (B, s, s, 3)) for s in (64, 128, 256)[:branches]]
    cap_lens = np.array([T, 3, 1, 5], np.int32)
    captions = np.zeros((B, T), np.int32)
    for i, n in enumerate(cap_lens):
        captions[i, :n] = rng.integers(1, N_WORDS, n)
    class_ids = np.array([0, 1, 0, 2], np.int32)
    return imgs, captions, cap_lens, class_ids


def _jax_tree(state) -> dict:
    """A JAX GANTrainState as the nested dicts utils.weights takes."""
    return {"g": {"params": state.g.params, "batch_stats": state.g.batch_stats},
            "g_ema": state.g_ema,
            "ds": [{"params": d.params, "batch_stats": d.batch_stats} for d in state.ds],
            "text": state.text, "image": state.image}


def _net_tensors(sds: dict, net: str) -> dict:
    return sds["generator"] if net == "G" else sds["discriminators"][int(net[1])]


def _jax_moments(state, net):
    """JAX's Adam first moments of ``net`` as a port-keyed state dict."""
    if net == "G":
        return W.g_net_state_dict(state.g.opt_state[0].mu, {})
    return W.d_net_state_dict(state.ds[int(net[1])].opt_state[0].mu, {})


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step run twice: its states (as numpy), logs, noise draws and
    per-step gradients (from the Adam first moments, mu_k = (mu_{k-1} + g_k) / 2)."""
    imgs, captions, cap_lens, class_ids = make_batch()
    with jax.enable_x64(True):
        cfg = jax_cfg_from_dict({**TINY, "JAX": {"DTYPE": "float64"}})
        models = jax_build_models(cfg, N_WORDS)
        states = [jax_init_gan_state(cfg, models, jax.random.PRNGKey(0))]
        step = jax.jit(jax_make_step(cfg, models))
        key = jax.random.PRNGKey(3)
        logs, noise = [], []
        for _ in range(STEPS):
            # the step's own draws: fold_in(rng, step), then z and the CA eps
            r = jax.random.fold_in(key, states[-1].step)
            r_z, r_ca = jax.random.split(r)
            noise.append((np.asarray(jax.random.normal(r_z, jax_noise_shape(cfg, B),
                                                       jnp.float32)),
                          np.asarray(jax.random.normal(
                              r_ca, (B, cfg.GAN.CONDITION_DIM), jnp.float32))))
            new, out = step(states[-1], tuple(jnp.asarray(i) for i in imgs),
                            jnp.asarray(captions), jnp.asarray(cap_lens),
                            jnp.asarray(class_ids), key)
            states.append(new)
            logs.append({k: float(v) for k, v in out.items()})
        states = [jax.tree.map(np.asarray, s) for s in states]
    sds = [W.gan_state_from_jax(_jax_tree(s)) for s in states]
    grads = []
    for k in range(1, STEPS + 1):
        per_net = {}
        for net in NETS:
            mu = _jax_moments(states[k], net)
            prev = _jax_moments(states[k - 1], net) if k > 1 else None
            per_net[net] = {n: 2 * v.double().numpy() - (0 if prev is None else
                                                        prev[n].double().numpy())
                            for n, v in mu.items()}
        grads.append(per_net)
    return dict(sds=sds, logs=logs, noise=noise, grads=grads)


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's step from JAX's initial state, twice, with JAX's noise; per
    step its logs, gradients and state (as float64 numpy)."""
    imgs, captions, cap_lens, class_ids = make_batch()
    cfg = cfg_from_dict(TINY)
    models = build_models(cfg, N_WORDS)
    for m in (models.text_encoder, models.image_encoder, models.generator,
              *models.discriminators):
        m.double()
    state = init_gan_state(cfg, models, device="cpu")
    state.load_state_dict(jax_run["sds"][0])
    step = GANStep(cfg, state)
    batch = ([torch.from_numpy(i) for i in imgs], torch.from_numpy(captions).long(),
             torch.from_numpy(cap_lens).long(), torch.from_numpy(class_ids).long())
    out = {"logs": [], "grads": [], "sds": [], "ema_prev": []}
    for k in range(STEPS):
        z, eps = jax_run["noise"][k]
        out["ema_prev"].append({n: v.clone() for n, v in state.g_ema.items()})
        logs = step(*batch, z=torch.tensor(z, dtype=torch.float64),
                    eps=torch.tensor(eps, dtype=torch.float64))
        out["logs"].append({n: float(v) for n, v in logs.items()})
        nets = {"G": state.generator, "D0": state.discriminators[0],
                "D1": state.discriminators[1]}
        out["grads"].append({net: {n: p.grad.double().numpy().copy()
                                   for n, p in m.named_parameters()}
                             for net, m in nets.items()})
        out["sds"].append(copy.deepcopy(state.state_dict()))
    return out


@pytest.mark.parametrize("k", range(STEPS))
def test_logs_match(jax_run, port_run, k):
    assert sorted(port_run["logs"][k]) == sorted(jax_run["logs"][k]) == sorted(log_keys(2))
    for key, want in jax_run["logs"][k].items():
        np.testing.assert_allclose(port_run["logs"][k][key], want, rtol=2e-5, err_msg=key)


@pytest.mark.parametrize("net", NETS)
def test_first_step_gradients_match(jax_run, port_run, net):
    want = jax_run["grads"][0][net]
    got = port_run["grads"][0][net]
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=2e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("k", range(STEPS))
@pytest.mark.parametrize("net", NETS)
def test_running_stats_match(jax_run, port_run, net, k):
    want = _net_tensors(jax_run["sds"][k + 1], net)
    got = _net_tensors(port_run["sds"][k], net)
    names = [n for n in want if n.endswith(("running_mean", "running_var"))]
    assert names
    for name in names:
        w = want[name].double().numpy()
        g = got[name].double().numpy()
        start = _net_tensors(jax_run["sds"][0], net)[name].double().numpy()
        assert not np.array_equal(w, start), name  # the step moved it
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-6 * np.abs(w).max(), err_msg=name)


def _agreement(jax_run, port_run, net, upto):
    """{param: entries whose gradients agree to 1e-3 in steps 1..upto}."""
    out = {}
    for k in range(upto):
        for name, w in jax_run["grads"][k][net].items():
            g = port_run["grads"][k][net][name]
            ok = np.abs(g - w) <= 1e-3 * np.abs(w)
            out[name] = ok & out.get(name, True)
    return out


@pytest.mark.parametrize("k", range(STEPS))
@pytest.mark.parametrize("net", NETS)
def test_parameters_match(jax_run, port_run, net, k):
    want = _net_tensors(jax_run["sds"][k + 1], net)
    got = _net_tensors(port_run["sds"][k], net)
    agree = _agreement(jax_run, port_run, net, k + 1)
    n_agree = n_all = 0
    for name, ok in agree.items():
        diff = np.abs(got[name].double().numpy() - want[name].double().numpy())
        n_agree, n_all = n_agree + ok.sum(), n_all + ok.size
        assert diff[ok].max(initial=0.0) <= (k + 1) * 1e-3 * LR, name
        assert diff.max() <= (k + 1) * 2 * LR, name
    if k == 0:
        assert n_agree / n_all > 0.99


@pytest.mark.parametrize("k", range(STEPS))
def test_ema_matches(jax_run, port_run, k):
    want = jax_run["sds"][k + 1]["g_ema"]
    got = port_run["sds"][k]["g_ema"]
    params = port_run["sds"][k]["generator"]
    prev = port_run["ema_prev"][k]
    assert sorted(got) == sorted(want) == sorted(prev)
    for name, w in want.items():
        own = 0.999 * prev[name] + 0.001 * params[name]
        torch.testing.assert_close(got[name], own, rtol=0, atol=1e-12)
        diff = np.abs(got[name].double().numpy() - w.double().numpy()).max()
        assert diff <= 1e-3 * (k + 1) * 2 * LR + 2e-7, name


# ---------------------------------------------------------------- port only


def _counting(monkeypatch):
    """Count the calls of the plain versions behind K4 and K1-K3."""
    calls = {"word_attention": 0, "damsm_sim_fwd": 0, "damsm_sim_dimg": 0,
             "damsm_sim_dwords": 0}

    def wrap(module, attr, key):
        fn = getattr(module, attr)

        def counted(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, attr, counted)
    wrap(wa, "word_attention_plain", "word_attention")
    wrap(dsim, "damsm_sim_fwd", "damsm_sim_fwd")
    wrap(dsim, "damsm_sim_dimg", "damsm_sim_dimg")
    wrap(dsim, "damsm_sim_dwords", "damsm_sim_dwords")
    return calls


def _port_step(cfg, seed=0):
    state = init_gan_state(cfg, build_models(cfg, N_WORDS, seed=seed), device="cpu")
    imgs, captions, cap_lens, class_ids = make_batch(cfg.TREE.BRANCH_NUM)
    batch = ([torch.from_numpy(i).float() for i in imgs], torch.from_numpy(captions).long(),
             torch.from_numpy(cap_lens).long(), torch.from_numpy(class_ids).long())
    return state, GANStep(cfg, state), batch


@pytest.mark.parametrize("smooth_lambda", [5.0, 0.0])
def test_one_step_takes_the_kernels_paths(monkeypatch, smooth_lambda):
    """With three branches: K4's forward twice (both refinement stages), K1
    once, K2 once, K3 never (the words are detached); with lambda 0 the
    DAMSM terms leave the graph.  On the CPU the wrappers run their plain
    versions and no kernel launches."""
    cfg = cfg_from_dict(TINY)
    cfg.TREE.BRANCH_NUM = 3
    cfg.TRAIN.SMOOTH.LAMBDA = smooth_lambda
    state, step, batch = _port_step(cfg)
    wrappers = (wa.word_attention, dsim.damsm_sim_fwd, dsim.damsm_sim_dimg,
                dsim.damsm_sim_dwords)
    launches = [fn.launches for fn in wrappers]
    calls = _counting(monkeypatch)
    image_before = copy.deepcopy(state.image_encoder.state_dict())
    g_stats = copy.deepcopy({n: b for n, b in state.generator.state_dict().items()
                             if "running" in n})
    logs = step(*batch)
    want = 1 if smooth_lambda else 0
    assert calls == {"word_attention": 2, "damsm_sim_fwd": want, "damsm_sim_dimg": want,
                     "damsm_sim_dwords": 0}
    assert [fn.launches for fn in wrappers] == launches  # no kernel on the CPU
    assert sorted(logs) == sorted(log_keys(3))
    assert all(v.dim() == 0 and torch.isfinite(v) for v in logs.values())
    if not smooth_lambda:
        assert float(logs["w_loss"]) == float(logs["s_loss"]) == 0.0
    # the frozen encoder keeps its weights and statistics; G's statistics move
    for n, v in state.image_encoder.state_dict().items():
        assert torch.equal(v, image_before[n]), n
    assert all(not torch.equal(state.generator.state_dict()[n], v) for n, v in g_stats.items())
    assert state.step == 1
    # the step draws its own noise when none is given: a second step differs
    z0, _ = step.draw_noise(B)
    z1, _ = step.draw_noise(B)
    assert not torch.equal(z0, z1)


def test_state_round_trip():
    cfg = cfg_from_dict(TINY)
    state, step, batch = _port_step(cfg, seed=1)
    step(*batch)
    saved = copy.deepcopy(state.state_dict())
    other = init_gan_state(cfg, build_models(cfg, N_WORDS, seed=2), device="cpu")
    other.load_state_dict(saved)
    again = other.state_dict()
    assert again["step"] == 1
    for key in ("generator", "text_encoder", "image_encoder"):
        for n, v in saved[key].items():
            assert torch.equal(again[key][n], v), (key, n)
    for n, v in saved["g_ema"].items():
        assert torch.equal(again["g_ema"][n], v)
    assert again["g_opt"]["state"].keys() == saved["g_opt"]["state"].keys()
