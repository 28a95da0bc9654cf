"""The port's paths under ``MODEL.TEXT_ENCODER: bert`` against the JAX
package's, at a tiny width: BERT of 2 layers, hidden 16, 2 heads
(``models.text_bert.BERT_BASE`` is patched to it in this module, because
both packages always build bert-base and no test builds a full one; the
JAX models are built by hand with ``BertEncoder(bert_cfg=TINY_BERT)``);
GF/DF 8, EMBEDDING 32, WORDS 6, Inception input 75.

* one ``bird_bert`` GAN step (M_NUM 8, INIT_Z_CONCAT False; BRANCH_NUM 2)
  and one ``bird_mixing`` step ((2, B, Z) noise; BRANCH_NUM 3, so that the
  second style code reaches the third stage; lambda 0, which drops the
  DAMSM terms, the bird_bert step's, from the graph and saves the JAX
  compile of Inception's backward at 256), float64 on both sides: logs
  rtol 2e-5,
  running statistics atol 5e-6 of each tensor's largest entry; the
  first-step gradients (JAX's from its Adam first moment, 2 mu) per
  network, by norm and cosine (a LeakyReLU kink; see the test);
* (the BERT DAMSM pretrain step against JAX, and the BERT gradients
  with padded captions: tests/test_torch_text_bert.py);
* one ``Sampler`` call with BERT against JAX's ``make_sample_fn``
  (float32, rtol 1e-4 / atol 1e-5);
* serving and a reference BERT ``text_encoder.pth`` raise (the CLIs over
  wordpiece captions: tests/test_torch_bert_vocab.py).
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flax_tree_from_port, jax_gan_state
from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.models.text_bert import BertEncoder as JaxBertEncoder
from sba_gan_tpu.train.gan import build_models as jax_build_models
from sba_gan_tpu.train.gan import init_gan_state as jax_init_gan_state
from sba_gan_tpu.train.gan import make_gan_train_step, make_sample_fn
from sba_gan_tpu.train.gan import noise_shape as jax_noise_shape
from sba_gan_tpu_torch import main as gan_main
from sba_gan_tpu_torch.config import cfg_from_dict, preset
from sba_gan_tpu_torch.models import text_bert as tb
from sba_gan_tpu_torch.train.gan import GANStep, build_models, init_gan_state, log_keys
from sba_gan_tpu_torch.train.sample import Sampler
from sba_gan_tpu_torch.utils import weights as W

TINY_BERT = dict(vocab_size=300, hidden_size=16, num_layers=2, num_heads=2,
                 intermediate_size=32, max_position=24, type_vocab_size=2,
                 layer_norm_eps=1e-12)
N_WORDS, B, T, LR = 50, 4, 6, 2e-4
NEF = 32
GRAD_REL, GRAD_COS = 2e-2, 0.9999
GAN_PRESETS = ("bird_bert", "bird_mixing")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs six
    test processes on the CPU, and the many small ops of these steps slow
    down by an order of magnitude when every process spins eight threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def tiny_bert_base():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tb, "BERT_BASE", TINY_BERT)
        yield


def gan_cfg(mixing: bool) -> dict:
    return {"TREE": {"BRANCH_NUM": 3 if mixing else 2, "BASE_SIZE": 64},
            "GAN": {"GF_DIM": 8, "DF_DIM": 8, "Z_DIM": 8, "W_DIM": 16, "CONDITION_DIM": 8,
                    "R_NUM": 1, "M_NUM": 8, "INIT_Z_CONCAT": False},
            "TEXT": {"EMBEDDING_DIM": NEF, "WORDS_NUM": T},
            "MODEL": {"INCEPTION_INPUT": 75, "TEXT_ENCODER": "bert"},
            "TRAIN": {"BATCH_SIZE": B, "GENERATOR_LR": LR, "DISCRIMINATOR_LR": LR,
                      "MIXING": mixing,
                      "SMOOTH": {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0,
                                 "LAMBDA": 0.0 if mixing else 5.0}}}


def _captions(rng, lens, t=T):
    captions = np.zeros((len(lens), t), np.int32)
    for i, n in enumerate(lens):
        captions[i, :n] = rng.integers(1, N_WORDS, n)
    return captions


def jax_bert(dtype):
    return JaxBertEncoder(nef=NEF, bert_cfg=TINY_BERT, dtype=dtype)


def _jax_gan_step(mixing: bool):
    """The port's random models, one batch, and JAX's step (float64) lowered
    on the same weights and batch: (models, batch, z, eps, lowered, args)."""
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(-1, 1, (B, s, s, 3)) for s in (64, 128, 256)[:3 if mixing else 2]]
    cap_lens = np.array([T, 3, 1, 5], np.int32)
    captions = _captions(rng, cap_lens)
    class_ids = np.array([0, 1, 0, 2], np.int32)
    models = build_models(cfg_from_dict(gan_cfg(mixing)), N_WORDS, seed=0)
    assert models.text_encoder.cfg == TINY_BERT
    with jax.enable_x64(True):
        jcfg = jax_cfg_from_dict({**gan_cfg(mixing), "JAX": {"DTYPE": "float64"}})
        jmodels = jax_build_models(jcfg, N_WORDS)._replace(
            text_encoder=jax_bert(jnp.float64))
        state = jax_gan_state(jcfg, jmodels, models, W.bert_encoder_key)
        key = jax.random.PRNGKey(3)
        r_z, r_ca = jax.random.split(jax.random.fold_in(key, 0))  # the step's own draws
        z = np.asarray(jax.random.normal(r_z, jax_noise_shape(jcfg, B), jnp.float32))
        eps = np.asarray(jax.random.normal(r_ca, (B, 8), jnp.float32))
        args = (state, tuple(jnp.asarray(i) for i in imgs), jnp.asarray(captions),
                jnp.asarray(cap_lens), jnp.asarray(class_ids), key)
        lowered = jax.jit(make_gan_train_step(jcfg, jmodels)).lower(*args)
    return models, (imgs, captions, cap_lens, class_ids), z, eps, lowered, args


def _gan_case(mixing, models, batch, z, eps, step, args):
    """One step of JAX (``step``, compiled, float64) and of the port
    (float64) from the port's random weights: logs, gradients and running
    statistics per network."""
    with jax.enable_x64(True):
        new, logs = step(*args)
        new = jax.tree.map(np.asarray, new)
    want = {"logs": {k: float(v) for k, v in logs.items()},
            "grads": {"G": {k: 2 * v.double().numpy() for k, v in
                            W.g_net_state_dict(new.g.opt_state[0].mu, {}).items()},
                      **{f"D{i}": {k: 2 * v.double().numpy() for k, v in
                                   W.d_net_state_dict(d.opt_state[0].mu, {}).items()}
                         for i, d in enumerate(new.ds)}},
            "stats": {"G": W.g_net_state_dict(new.g.params, new.g.batch_stats),
                      **{f"D{i}": W.d_net_state_dict(d.params, d.batch_stats)
                         for i, d in enumerate(new.ds)}}}
    for m in (models.text_encoder, models.image_encoder, models.generator,
              *models.discriminators):
        m.double()
    cfg = cfg_from_dict(gan_cfg(mixing))
    st = init_gan_state(cfg, models, device="cpu")
    imgs, captions, cap_lens, class_ids = batch
    logs = GANStep(cfg, st)([torch.from_numpy(i) for i in imgs],
                            torch.from_numpy(captions).long(),
                            torch.from_numpy(cap_lens).long(),
                            torch.from_numpy(class_ids).long(),
                            z=torch.from_numpy(z.copy()).double(),
                            eps=torch.from_numpy(eps.copy()).double())
    nets = {"G": st.generator, **{f"D{i}": d for i, d in enumerate(st.discriminators)}}
    got = {"logs": {k: float(v) for k, v in logs.items()},
           "grads": {n: {k: p.grad.numpy() for k, p in m.named_parameters()}
                     for n, m in nets.items()},
           "stats": {n: m.state_dict() for n, m in nets.items()}}
    return want, got


@pytest.fixture(scope="module")
def gan_cases():
    """Both presets' steps.  XLA compiles each JAX step in a thread (it
    releases the GIL there) while the next is traced and the first runs."""
    with ThreadPoolExecutor(len(GAN_PRESETS)) as pool:
        prepared = {}
        for name in GAN_PRESETS:
            p = _jax_gan_step(name == "bird_mixing")
            prepared[name] = p, pool.submit(p[4].compile)
        return {name: _gan_case(name == "bird_mixing", *p[:4], compiling.result(), p[5])
                for name, (p, compiling) in prepared.items()}


def _net_grads(run, net):
    return {k: np.asarray(v, np.float64) for k, v in run["grads"][net].items()}


@pytest.mark.parametrize("preset_name", GAN_PRESETS)
def test_gan_step_matches_jax(gan_cases, preset_name):
    """Logs rtol 2e-5 and running statistics atol 5e-6 of each tensor's
    largest entry, as tests/test_torch_gan_step.py.  Gradients per network:
    the whole gradient within GRAD_REL of JAX's norm with a cosine of at
    least GRAD_COS, and every tensor within 2 GRAD_REL of its norm.  Not per
    entry: JAX rounds the fake images through float32 (the tanh of each),
    and where a D's LeakyReLU input lies within that rounding of 0 its
    slope flips, which moves D's gradient there and, through the G loss's
    D passes, every G gradient a little (measured: G's whole gradient
    7.95e-3 from JAX's, its worst tensor 1.55e-2, cosine 0.99997; the Ds'
    2.4e-7)."""
    want, got = gan_cases[preset_name]
    assert sorted(got["logs"]) == sorted(want["logs"]) == sorted(log_keys(len(got["stats"]) - 1))
    for k, v in want["logs"].items():
        np.testing.assert_allclose(got["logs"][k], v, rtol=2e-5, err_msg=k)
    for net in want["grads"]:
        w, g = _net_grads(want, net), _net_grads(got, net)
        assert sorted(g) == sorted(w)
        a = np.concatenate([g[k].ravel() for k in sorted(w)])
        b = np.concatenate([w[k].ravel() for k in sorted(w)])
        assert np.linalg.norm(a - b) <= GRAD_REL * np.linalg.norm(b), net
        assert a @ b >= GRAD_COS * np.linalg.norm(a) * np.linalg.norm(b), net
        for k in w:
            assert np.linalg.norm(g[k] - w[k]) <= 2 * GRAD_REL * np.linalg.norm(w[k]), (net, k)
    for net, sd in want["stats"].items():
        for name, w in sd.items():
            if name.endswith(("running_mean", "running_var")):
                w = w.numpy()
                np.testing.assert_allclose(got["stats"][net][name].numpy(), w, rtol=0,
                                           atol=5e-6 * np.abs(w).max(),
                                           err_msg=f"{net}.{name}")


def test_sampler_matches_jax(tmp_path):
    """One ``Sampler.with_noise`` call with BERT (float32, the port's random
    weights carried into JAX) against ``make_sample_fn``'s; the same weights
    read back from a serving ``.npz`` give the same images."""
    rng = np.random.default_rng(6)
    cfg = cfg_from_dict(gan_cfg(False))
    lens = np.array([6, 2, 1], np.int32)
    captions = _captions(rng, lens)
    z = rng.standard_normal((3, 8)).astype(np.float32)
    rng_ca = jax.random.PRNGKey(11)
    eps = np.array(jax.random.normal(rng_ca, (3, 8), jnp.float32))
    sampler = Sampler.from_config(cfg, N_WORDS, seed=0, device="cpu")
    assert isinstance(sampler.text_encoder, tb.BertEncoder)
    g_sd, text_sd = sampler.generator.state_dict(), sampler.text_encoder.state_dict()

    jcfg = jax_cfg_from_dict(gan_cfg(False))
    jmodels = jax_build_models(jcfg, N_WORDS)._replace(text_encoder=jax_bert(jnp.float32))
    abstract = jax.eval_shape(lambda: jax_init_gan_state(jcfg, jmodels,
                                                         jax.random.PRNGKey(0)))
    g = {c: flax_tree_from_port(getattr(abstract.g, c), g_sd, W.g_net_key)
         for c in ("params", "batch_stats")}
    text = {"params": flax_tree_from_port(abstract.text["params"], text_sd,
                                          W.bert_encoder_key)}
    with_noise = make_sample_fn(jcfg, jmodels).with_noise

    def sample(g, text):
        state = SimpleNamespace(text=text, g_ema=g["params"],
                                g=SimpleNamespace(batch_stats=g["batch_stats"]))
        return with_noise(state, jnp.asarray(captions), jnp.asarray(lens),
                          jnp.asarray(z), rng_ca)
    fakes_j, atts_j = jax.jit(sample)(g, text)
    fakes, atts = sampler.with_noise(captions, lens, z, eps)
    assert len(fakes) == 2 and len(atts) == 1
    for got, want in zip(fakes + atts, list(fakes_j) + list(atts_j)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    # the serving weights file (.npz of the JAX trees) with BERT's text tree
    npz = tmp_path / "weights.npz"
    np.savez(npz, **{f"g_ema/{k}": v for k, v in W.flatten_tree(g["params"]).items()},
             **{f"g/batch_stats/{k}": v for k, v in W.flatten_tree(g["batch_stats"]).items()},
             **{f"text/params/{k}": v for k, v in W.flatten_tree(text["params"]).items()})
    again = Sampler.from_config(cfg, N_WORDS, weights=str(npz), device="cpu")
    for got, want in zip(sum(again.with_noise(captions, lens, z, eps), []), fakes + atts):
        np.testing.assert_array_equal(got, want)


def test_serving_and_reference_bert_encoders_are_refused(tmp_path):
    from sba_gan_tpu_torch.serving.app import build_service
    from sba_gan_tpu_torch.utils import torch_port

    cfg = preset("bird_bert")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_service(cfg, SimpleNamespace(launch=None), {}, {}, str(tmp_path))
    ref = tmp_path / "text_encoder120.pth"
    torch.save({"bert.embeddings.word_embeddings.weight": torch.zeros(3, 2),
                "emb_words.weight": torch.zeros(2, 2)}, ref)
    assert gan_main.load_net_e(str(ref)) == (None, None, str(ref))
    enc = tb.BertEncoder(NEF, bert_cfg=TINY_BERT)
    with pytest.raises(NotImplementedError, match="reference BERT.*ROADMAP"):
        torch_port.load_rnn_encoder(enc, str(ref))
    rnn_ref = tmp_path / "rnn_text_encoder.pth"
    torch.save({"encoder.weight": torch.zeros(3, 2)}, rnn_ref)
    with pytest.raises(ValueError, match="reference RNN text encoder.*BERT"):
        torch_port.load_rnn_encoder(enc, str(rnn_ref))
