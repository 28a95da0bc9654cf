"""``TRAIN.GRAD_ACCUM`` 2 in the port's GAN step (sba_gan_tpu_torch.train.gan)
against the JAX package's ``make_gan_train_step`` (optax ``MultiSteps``),
in both ``GRAD_ACCUM_MODE``s, over one window of two micro-steps from the
same weights (the port's seeded random weights put into JAX's state, which
a Flax init would spend a minute on, and carried back into the port's
state by ``utils.weights.gan_state_from_jax``), batch and noise (JAX's
draws, injected).

Setup as tests/test_gan_step.py's accumulation tests: BRANCH_NUM 1 (one D,
64 images), here batch 4, GF/DF 8, EMBEDDING 32, WORDS 6, Inception input
75, gammas 4/5/10, lambda 5, Adam lr 2e-4.  Float64 on both sides (JAX
under ``jax.enable_x64``), as tests/test_torch_gan_step.py, whose
tolerances these are but for G's gradients:

* logs of each micro-step rtol 2e-5;
* gradients: the micro-step's (JAX's ``MultiSteps`` accumulator after
  micro-step 1, which holds it) and the window's mean that Adam applies
  (twice JAX's first moment after the window); in 'dfresh' the D's own
  per-micro-step gradients (from its Adam moments, mu_k = (mu_{k-1} + g_k)
  / 2).  The D's atol 2e-5 times each tensor's largest entry (measured:
  each tensor within 1.2e-6 of its norm).  G's as
  tests/test_torch_bert_paths.py holds them, per network and not per
  entry: the whole gradient within GRAD_REL of JAX's norm with a cosine of
  at least GRAD_COS, every tensor within 2 GRAD_REL of its norm (measured:
  whole 7.6e-3, worst tensor 1.7e-2, cosine 0.99997).  The losses round
  through float32 on both sides (the D logits, ``bce_logits``, the DAMSM
  terms), and G's gradient at these tiny widths over a batch of 4 carries
  that rounding up by orders of magnitude: the port's own float64
  gradient moves by 2.0e-6 (2.5e-5 without the DAMSM terms) between one
  and eight threads;
* running statistics atol 5e-6 times each tensor's largest entry;
* parameters after the window: a network that took one Adam update (G;
  the D in 'window') moved from the same start by lr g / (|g| + 1e-8) of
  its own gradient, so the two sides' parameters differ by the difference
  of those updates, within one float32 rounding of the parameter and 1e-6
  lr (JAX's parameters and Adam moments are float32; measured past the
  rounding: <= 9.1e-8 lr); the 'dfresh' D took two updates: entries whose
  gradients agreed to 1e-3 in both within 2e-3 lr, every entry within 4 lr;
* the EMA: untouched by micro-step 1 on both sides, folded once after
  micro-step 2 (its own formula to 1e-12, JAX's within 1e-3 of 2 lr plus
  2e-7).

And on the port alone: G (and in 'window' the D) hold still after micro-step
1 and move after 2, the D moves after 1 in 'dfresh', and a save and resume
between the micro-steps gives the uninterrupted window bit for bit.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_gan_state, rnn_encoder_key
from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.train.gan import build_models as jax_build_models
from sba_gan_tpu.train.gan import make_gan_train_step as jax_make_step
from sba_gan_tpu.train.gan import noise_shape as jax_noise_shape
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.train.gan import GANStep, build_models, init_gan_state, log_keys
from sba_gan_tpu_torch.utils import weights as W

N_WORDS, B, T, LR, K = 30, 4, 6, 2e-4, 2
GRAD_REL, GRAD_COS = 2e-2, 0.9999  # as tests/test_torch_bert_paths.py
MODES = ("window", "dfresh")
NETS = ("G", "D0")
TINY = {"TREE": {"BRANCH_NUM": 1, "BASE_SIZE": 64},
        "GAN": {"GF_DIM": 8, "DF_DIM": 8, "Z_DIM": 8, "W_DIM": 16, "CONDITION_DIM": 8,
                "R_NUM": 1},
        "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": T},
        "MODEL": {"INCEPTION_INPUT": 75},
        "TRAIN": {"BATCH_SIZE": B, "GENERATOR_LR": LR, "DISCRIMINATOR_LR": LR,
                  "GRAD_ACCUM": K,
                  "SMOOTH": {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0,
                             "LAMBDA": 5.0}}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's steps, as tests/test_torch_bert_paths.py:
    the suite runs six test processes on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(mode: str) -> dict:
    return {**TINY, "TRAIN": {**TINY["TRAIN"], "GRAD_ACCUM_MODE": mode}}


def make_batch():
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(-1, 1, (B, 64, 64, 3))]
    cap_lens = np.array([T, 3, 1, 5], np.int32)
    captions = np.zeros((B, T), np.int32)
    for i, n in enumerate(cap_lens):
        captions[i, :n] = rng.integers(1, N_WORDS, n)
    return imgs, captions, cap_lens, np.array([0, 1, 0, 2], np.int32)


def _port_tree(tree, net: str) -> dict:
    """A params-shaped JAX tree of ``net`` as port-keyed float64 numpy."""
    sd = W.g_net_state_dict(tree, {}) if net == "G" else W.d_net_state_dict(tree, {})
    return {n: v.double().numpy() for n, v in sd.items()}


def _jax_grads(states, mode):
    """Per micro-step and network the gradient the port's ``grad`` must
    hold: the micro-step's after step 1 (the accumulator, or a plain Adam
    D's 2 mu), the window's mean after step 2 (2 mu of the inner Adam), or
    a plain Adam D's second gradient (2 mu_2 - mu_1)."""
    out = [{}, {}]
    for net in NETS:
        opts = [s.g.opt_state if net == "G" else s.ds[0].opt_state for s in states]
        if net == "G" or mode == "window":
            out[0][net] = _port_tree(opts[1].acc_grads, net)
            out[1][net] = {n: 2 * v for n, v in
                           _port_tree(opts[2].inner_opt_state[0].mu, net).items()}
        else:
            mu1, mu2 = (_port_tree(o[0].mu, net) for o in opts[1:])
            out[0][net] = {n: 2 * v for n, v in mu1.items()}
            out[1][net] = {n: 2 * mu2[n] - mu1[n] for n in mu2}
    return out


def _jax_tree(state) -> dict:
    return {"g": {"params": state.g.params, "batch_stats": state.g.batch_stats},
            "g_ema": state.g_ema,
            "ds": [{"params": d.params, "batch_stats": d.batch_stats} for d in state.ds],
            "text": state.text, "image": state.image}


@pytest.fixture(scope="module")
def jax_runs():
    """Both modes' JAX windows from one init (the two steps compile in
    threads): per mode the states as port state dicts, the logs, the noise
    of each micro-step and the gradients of :func:`_jax_grads`."""
    imgs, captions, cap_lens, class_ids = make_batch()
    with jax.enable_x64(True):
        cfgs = {m: jax_cfg_from_dict({**tiny(m), "JAX": {"DTYPE": "float64"}})
                for m in MODES}
        models = jax_build_models(cfgs["window"], N_WORDS)
        weights = build_models(cfg_from_dict(tiny("window")), N_WORDS, seed=0)
        key = jax.random.PRNGKey(3)
        batch = (tuple(jnp.asarray(i) for i in imgs), jnp.asarray(captions),
                 jnp.asarray(cap_lens), jnp.asarray(class_ids))
        fns = {m: jax_make_step(cfgs[m], models) for m in MODES}
        inits = {}
        for m in MODES:  # in the dtypes the step returns, so one compile serves both
            init = jax_gan_state(cfgs[m], models, weights, rnn_encoder_key)
            out_state = jax.eval_shape(fns[m], init, *batch, key)[0]
            inits[m] = jax.tree.map(lambda x, s: jnp.asarray(x, s.dtype), init, out_state)
        with ThreadPoolExecutor(len(MODES)) as pool:
            compiling = {m: pool.submit(jax.jit(fns[m]).lower(inits[m], *batch, key).compile)
                         for m in MODES}
            steps = {m: c.result() for m, c in compiling.items()}
        out = {}
        for m in MODES:
            states, logs, noise = [inits[m]], [], []
            for _ in range(K):
                r_z, r_ca = jax.random.split(jax.random.fold_in(key, states[-1].step))
                noise.append((np.asarray(jax.random.normal(
                    r_z, jax_noise_shape(cfgs[m], B), jnp.float32)),
                    np.asarray(jax.random.normal(r_ca, (B, 8), jnp.float32))))
                new, log = steps[m](states[-1], *batch, key)
                states.append(new)
                logs.append({k: float(v) for k, v in log.items()})
            states = [jax.tree.map(np.asarray, s) for s in states]
            out[m] = dict(sds=[W.gan_state_from_jax(_jax_tree(s)) for s in states],
                          logs=logs, noise=noise, grads=_jax_grads(states, m))
    return out


def _port_step(mode, sd0):
    cfg = cfg_from_dict(tiny(mode))
    models = build_models(cfg, N_WORDS)
    for m in (models.text_encoder, models.image_encoder, models.generator,
              *models.discriminators):
        m.double()
    state = init_gan_state(cfg, models, device="cpu")
    state.load_state_dict(sd0)
    return state, GANStep(cfg, state)


def _batch():
    imgs, captions, cap_lens, class_ids = make_batch()
    return ([torch.from_numpy(i) for i in imgs], torch.from_numpy(captions).long(),
            torch.from_numpy(cap_lens).long(), torch.from_numpy(class_ids).long())


def _noise(run, k):
    z, eps = run["noise"][k]
    return dict(z=torch.tensor(z, dtype=torch.float64),
                eps=torch.tensor(eps, dtype=torch.float64))


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """Per mode the port's window from JAX's initial state with JAX's
    noise: per micro-step its logs, gradients and state dict, and the
    window again with a save and resume between the micro-steps."""
    out = {}
    for m in MODES:
        run = jax_runs[m]
        state, step = _port_step(m, run["sds"][0])
        res = {"logs": [], "grads": [], "sds": [copy.deepcopy(state.state_dict())]}
        for k in range(K):
            logs = step(*_batch(), **_noise(run, k))
            res["logs"].append({n: float(v) for n, v in logs.items()})
            nets = {"G": state.generator, "D0": state.discriminators[0]}
            res["grads"].append({net: {n: p.grad.numpy().copy()
                                       for n, p in mod.named_parameters()}
                                 for net, mod in nets.items()})
            res["sds"].append(copy.deepcopy(state.state_dict()))
        resumed, step = _port_step(m, run["sds"][0])
        resumed.load_state_dict(copy.deepcopy(res["sds"][1]))
        step(*_batch(), **_noise(run, 1))
        res["resumed"] = resumed.state_dict()
        out[m] = res
    return out


def _net(sd: dict, net: str) -> dict:
    return sd["generator"] if net == "G" else sd["discriminators"][int(net[1])]


@pytest.mark.parametrize("k", range(K))
@pytest.mark.parametrize("mode", MODES)
def test_logs_match(jax_runs, port_runs, mode, k):
    want, got = jax_runs[mode]["logs"][k], port_runs[mode]["logs"][k]
    assert sorted(got) == sorted(want) == sorted(log_keys(1))
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=2e-5, err_msg=key)


@pytest.mark.parametrize("k", range(K))
@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("mode", MODES)
def test_gradients_match(jax_runs, port_runs, mode, net, k):
    """After micro-step 1 the micro-step's gradient, after 2 the window's
    mean (a D in 'dfresh': its own gradient of each micro-step)."""
    want = jax_runs[mode]["grads"][k][net]
    got = port_runs[mode]["grads"][k][net]
    assert sorted(got) == sorted(want)
    if net != "G":
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=0, atol=2e-5 * np.abs(w).max(),
                                       err_msg=name)
        return
    a = np.concatenate([got[n].ravel() for n in sorted(want)])
    b = np.concatenate([want[n].ravel() for n in sorted(want)])
    assert np.linalg.norm(a - b) <= GRAD_REL * np.linalg.norm(b)
    assert a @ b >= GRAD_COS * np.linalg.norm(a) * np.linalg.norm(b)
    for name, w in want.items():
        assert np.linalg.norm(got[name] - w) <= 2 * GRAD_REL * np.linalg.norm(w), name


@pytest.mark.parametrize("k", range(K))
@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("mode", MODES)
def test_running_stats_match(jax_runs, port_runs, mode, net, k):
    want = _net(jax_runs[mode]["sds"][k + 1], net)
    got = _net(port_runs[mode]["sds"][k + 1], net)
    names = [n for n in want if n.endswith(("running_mean", "running_var"))]
    assert names
    for name in names:
        w = want[name].double().numpy()
        np.testing.assert_allclose(got[name].double().numpy(), w, rtol=0,
                                   atol=5e-6 * np.abs(w).max(), err_msg=name)


def _moved(a: dict, b: dict) -> list:
    return [n for n in a if "running" not in n and "num_batches" not in n
            and not torch.equal(a[n], b[n])]


@pytest.mark.parametrize("mode", MODES)
def test_which_networks_move(jax_runs, port_runs, mode):
    """G (and in 'window' the D) holds still after micro-step 1 and moves
    after 2; in 'dfresh' the D moves after each."""
    for sds in (jax_runs[mode]["sds"], port_runs[mode]["sds"]):
        assert not _moved(_net(sds[0], "G"), _net(sds[1], "G"))
        assert _moved(_net(sds[1], "G"), _net(sds[2], "G"))
        d_after_1 = _moved(_net(sds[0], "D0"), _net(sds[1], "D0"))
        assert bool(d_after_1) == (mode == "dfresh")
        assert _moved(_net(sds[1], "D0"), _net(sds[2], "D0"))


def _adam_first(g):
    return LR * g / (np.abs(g) + 1e-8)


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("mode", MODES)
def test_parameters_after_window(jax_runs, port_runs, mode, net):
    """Against Adam's update of each side's gradients (module docstring)."""
    want = _net(jax_runs[mode]["sds"][K], net)
    got = _net(port_runs[mode]["sds"][K], net)
    jg, pg = jax_runs[mode]["grads"], port_runs[mode]["grads"]
    ulp = np.finfo(np.float32).eps
    if not (net == "D0" and mode == "dfresh"):  # one update, of the window's mean
        for name, w in jg[K - 1][net].items():
            w_new = want[name].double().numpy()
            diff = np.abs(got[name].double().numpy() - w_new)
            step_gap = np.abs(_adam_first(pg[K - 1][net][name]) - _adam_first(w))
            assert np.all(diff <= step_gap + ulp * np.abs(w_new) + 1e-6 * LR), name
        return
    n_agree = n_all = 0
    for name in jg[0][net]:
        ok = np.ones(np.shape(jg[0][net][name]), bool)
        for k in range(K):
            ok &= np.abs(pg[k][net][name] - jg[k][net][name]) <= 1e-3 * np.abs(jg[k][net][name])
        diff = np.abs(got[name].double().numpy() - want[name].double().numpy())
        n_agree, n_all = n_agree + ok.sum(), n_all + ok.size
        assert diff[ok].max(initial=0.0) <= 2e-3 * LR, name
        assert diff.max() <= 4 * LR, name
    assert n_agree / n_all > 0.99


@pytest.mark.parametrize("mode", MODES)
def test_ema_folds_once_a_window(jax_runs, port_runs, mode):
    jsds, psds = jax_runs[mode]["sds"], port_runs[mode]["sds"]
    for sds in (jsds, psds):
        for n, v in sds[0]["g_ema"].items():
            assert torch.equal(sds[1]["g_ema"][n], v), n
    for n, w in jsds[K]["g_ema"].items():
        own = 0.999 * psds[1]["g_ema"][n] + 0.001 * psds[K]["generator"][n]
        got = psds[K]["g_ema"][n]
        torch.testing.assert_close(got, own, rtol=0, atol=1e-12)
        diff = np.abs(got.double().numpy() - w.double().numpy()).max()
        assert diff <= 1e-3 * 2 * LR + 2e-7, n
    assert _moved(psds[1]["g_ema"], psds[K]["g_ema"])


@pytest.mark.parametrize("mode", MODES)
def test_resume_mid_window_finishes_the_window(port_runs, mode):
    """The state dict after micro-step 1 holds the accumulators and the
    micro-step count; loaded into a fresh state, micro-step 2 gives the
    uninterrupted window's state bit for bit."""
    mid = port_runs[mode]["sds"][1]
    assert mid["accum"]["micro"] == 1
    assert (mid["accum"]["discriminators"][0] is None) == (mode == "dfresh")
    want, got = port_runs[mode]["sds"][K], port_runs[mode]["resumed"]
    assert got["step"] == want["step"] == K and got["accum"]["micro"] == 0
    for key in ("generator", "g_ema"):
        for n, v in want[key].items():
            assert torch.equal(got[key][n], v), (key, n)
    for n, v in want["discriminators"][0].items():
        assert torch.equal(got["discriminators"][0][n], v), n
    for n, v in want["accum"]["generator"].items():
        assert torch.equal(got["accum"]["generator"][n], v) and not v.any(), n
