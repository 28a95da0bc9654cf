"""The port's BERT text encoder (sba_gan_tpu_torch.models.text_bert) against
the JAX package's, at a tiny width (2 layers, hidden 16, 2 heads): the
same Flax weights carried over by ``utils.weights.bert_encoder_state_dict``
and the same captions (lengths 6, 4, 3, 1 of 6).

* float32: words and sentence codes rtol 1e-5 (measured 5.4e-7 and 4.5e-7
  of their largest entries), padding exactly zero;
* bfloat16 (JAX built with ``dtype=bfloat16``, the port's ``dtype``):
  each output's distance to JAX's bfloat16 output, |port - jax| / |jax|,
  at most twice the distance of the port's float32 output to it (the
  criterion of tests/test_torch_bf16_models.py: XLA on the CPU keeps
  bfloat16 elementwise chains in float32 inside a fusion where PyTorch
  rounds each operation; measured ratios 0.98 for the words, 1.02 for the
  sentence code), and the port's bfloat16 output differs from its float32
  one (it rounds);
* LayerNorm: ``F.layer_norm`` (two-pass variance) against flax's fast
  variance E[x^2] - E[x]^2 at eps 1e-12, rtol 1e-5 (measured 2.4e-7 on
  inputs of BERT's scale, so the port keeps ``F.layer_norm``);
* the trainable mask equals JAX's ``bert_trainable_mask``; the weight map
  and its inverse (``tests/_torch_parity.flax_tree_from_port``) round-trip;
* ``utils.torch_port.load_bert`` against the JAX package's ``port_bert``
  and against ``transformers.BertModel`` on one random state dict;
* random init at flax's scale;
* one BERT DAMSM pretrain step (DAMSM/bird_bert: every BERT parameter and
  Mixed_7a/b/c train), float64 on both sides, BERT_BASE patched to the
  tiny width (both packages build bert-base), Inception input 75, batch
  8; the JAX words loss under ``DAMSM_SIM_IMPL: interpret`` (its default
  ``xla`` formulation has NaN gradients at padding words with BERT: the
  norm of a zero vector, ``losses/damsm.py:176``, times
  ``text_bert.py``'s ``words * mask``; that fault is shown below and not
  ported): logs rtol 2e-5; every BERT gradient after the text clip and the
  Mixed_7 and head gradients (JAX's from Adam's first moment, 2 mu) rtol
  1e-4, atol 1e-5 of the group's largest entry; parameters after Adam as
  tests/test_torch_damsm_pretrain.py holds them; running statistics atol
  2e-5;
* the port's BERT gradients are finite with padded captions, and the
  words' gradient exactly 0 at padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from _torch_parity import cnn_encoder_key, flax_tree_from_port, import_transformers
from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.losses.damsm import words_loss as jax_words_loss
from sba_gan_tpu.models.text_bert import BertEncoder as JaxBertEncoder
from sba_gan_tpu.models.text_bert import bert_trainable_mask as jax_trainable_mask
from sba_gan_tpu.models.text_bert import port_bert
from sba_gan_tpu.train.damsm import DAMSMTrainer as JaxDAMSMTrainer
from sba_gan_tpu.train.damsm import build_damsm_models as jax_build_damsm
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.losses.damsm import words_loss
from sba_gan_tpu_torch.models import text_bert as tb
from sba_gan_tpu_torch.train.damsm import LOG_KEYS, DAMSMTrainer, build_damsm_models
from sba_gan_tpu_torch.utils import torch_port
from sba_gan_tpu_torch.utils import weights as W

TINY = dict(vocab_size=50, hidden_size=16, num_layers=2, num_heads=2,
            intermediate_size=32, max_position=24, type_vocab_size=2,
            layer_norm_eps=1e-12)
NEF, T, N_WORDS = 8, 6, 50
LENS = np.array([6, 4, 3, 1], np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs six
    test processes on the CPU, and the many small ops of these steps slow
    down by an order of magnitude when every process spins eight threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pad(rng, lens):
    """Random ids < N_WORDS, zero-padded after each length."""
    caps = np.zeros((len(lens), T), np.int32)
    for i, n in enumerate(lens):
        caps[i, :n] = rng.integers(1, N_WORDS, n)
    return caps


def _captions():
    return _pad(np.random.default_rng(2), LENS)


@pytest.fixture(scope="module")
def jax_params():
    enc = JaxBertEncoder(nef=NEF, bert_cfg=TINY)
    return enc.init(jax.random.PRNGKey(0), jnp.asarray(_captions()), jnp.asarray(LENS),
                    train=False)["params"]


def _port(params, dtype=torch.float32):
    enc = tb.BertEncoder(NEF, bert_cfg=TINY, dtype=dtype)
    enc.load_state_dict(W.bert_encoder_state_dict(jax.tree.map(np.asarray, params)))
    return enc.eval()


def _run_port(enc):
    with torch.no_grad():
        words, sent = enc(torch.from_numpy(_captions()).long(), torch.from_numpy(LENS).long())
    return words.numpy(), sent.numpy()


def _run_jax(params, dtype=jnp.float32):
    enc = JaxBertEncoder(nef=NEF, bert_cfg=TINY, dtype=dtype)
    words, sent = enc.apply({"params": params}, jnp.asarray(_captions()),
                            jnp.asarray(LENS), train=False)
    return np.asarray(words), np.asarray(sent)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bert_encoder_matches_jax_float32(jax_params):
    words, sent = _run_port(_port(jax_params))
    jw, js = _run_jax(jax_params)
    assert words.dtype == sent.dtype == np.float32
    assert words.shape == (len(LENS), T, NEF) and sent.shape == (len(LENS), NEF)
    np.testing.assert_allclose(words, jw, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sent, js, rtol=1e-5, atol=1e-6)
    for i, n in enumerate(LENS):
        assert np.all(words[i, n:] == 0.0) and np.all(words[i, :n] != 0.0)


def test_bert_encoder_matches_jax_bfloat16(jax_params):
    got = _run_port(_port(jax_params, torch.bfloat16))
    got32 = _run_port(_port(jax_params))
    want = _run_jax(jax_params, jnp.bfloat16)
    for name, g, g32, w in zip(("words", "sent"), got, got32, want):
        assert g.dtype == np.float32  # the outputs come back float32, as JAX's
        assert _rel(g, w) <= 2 * _rel(g32, w), (name, _rel(g, w), _rel(g32, w))
        assert _rel(g, g32) > 1e-4, name
    for i, n in enumerate(LENS):
        assert np.all(got[0][i, n:] == 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_flax(jax_params, dtype):
    """The embeddings' sum, the LayerNorm input of BERT, through the port's
    LayerNorm and flax's (fast variance), eps 1e-12."""
    rng = np.random.default_rng(4)
    x = (rng.normal(0.0, 1.0, (4, T, 16)) + rng.normal(0.0, 0.5, (1, 1, 16))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(0.0, 0.1, 16).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    want = fnn.LayerNorm(epsilon=1e-12, dtype=jdt).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x).astype(jdt))
    ln = tb.LayerNorm(16, eps=1e-12)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and want.dtype == jdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-5 if dtype == "float32" else 2 ** -8, atol=1e-5)


def test_trainable_mask_matches_jax(jax_params):
    want = {W.bert_encoder_key(tuple(k.split("/"))): bool(v) for k, v in
            W.flatten_tree(jax.tree.map(np.asarray, jax_trainable_mask(jax_params))).items()}
    got = tb.bert_trainable_mask(_port(jax_params))
    assert got == want
    assert sorted(k for k, v in got.items() if v) == [
        "bert.pooler.dense.bias", "bert.pooler.dense.weight", "emb_sent.bias",
        "emb_sent.weight", "emb_words.bias", "emb_words.weight"]


def test_weight_map_round_trips(jax_params):
    enc = _port(jax_params)
    back = flax_tree_from_port(jax_params, enc.state_dict(), W.bert_encoder_key)
    flat, flat_back = W.flatten_tree(jax.tree.map(np.asarray, jax_params)), W.flatten_tree(back)
    assert sorted(flat) == sorted(flat_back)
    for k in flat:
        np.testing.assert_array_equal(flat[k], flat_back[k], err_msg=k)
    with pytest.raises(KeyError, match="no port key"):
        W.bert_encoder_key(("bert", "layer_0", "nothing", "kernel"))


def _hf_model():
    transformers = import_transformers()
    cfg = transformers.BertConfig(
        vocab_size=TINY["vocab_size"], hidden_size=16, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=32, max_position_embeddings=24,
        type_vocab_size=2, hidden_act="gelu", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    return transformers, cfg, transformers.BertModel(cfg).eval()


def test_load_bert_matches_port_bert_and_transformers():
    transformers, cfg, hf = _hf_model()
    enc = tb.BertEncoder(NEF, bert_cfg=TINY)
    tb.init_weights(enc, torch.Generator().manual_seed(1))
    heads = {k: v.clone() for k, v in enc.state_dict().items() if k.startswith("emb_")}
    # a pretraining checkpoint: 'bert.' keys, the MLM and NSP heads
    full = transformers.BertForPreTraining(cfg).eval()
    full.bert.load_state_dict(hf.state_dict())
    torch_port.load_bert(enc, full.state_dict())
    sd = enc.state_dict()
    for k, v in heads.items():
        assert torch.equal(sd[k], v), k
    # the JAX package's port_bert of the same state dict, carried by the port's map
    want = W.bert_encoder_state_dict(port_bert({k: v.numpy() for k, v in
                                                hf.state_dict().items()}))
    assert sorted(want) == sorted(k for k in sd if not k.startswith("emb_"))
    for k, v in want.items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0, msg=k)
    # the bare BertModel dict gives the same; and the transformer's outputs are HF's
    bare = tb.BertEncoder(NEF, bert_cfg=TINY)
    torch_port.load_bert(bare, hf.state_dict())
    for k, v in bare.bert.state_dict().items():
        assert torch.equal(v, enc.bert.state_dict()[k]), k
    caps = torch.from_numpy(_captions()).long()
    mask = torch.arange(T)[None, :] < torch.from_numpy(LENS)[:, None]
    with torch.no_grad():
        hidden, pooled = enc.bert(caps, mask, torch.float32)
        out = hf(input_ids=caps, attention_mask=mask.long())
    valid = mask[:, :, None].expand_as(hidden)
    torch.testing.assert_close(hidden[valid], out.last_hidden_state[valid], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(pooled, out.pooler_output, rtol=1e-5, atol=1e-5)
    with pytest.raises(KeyError, match="missing"):
        torch_port.load_bert(bare, {k: v for k, v in hf.state_dict().items()
                                    if "pooler" not in k})


def test_random_init_has_flax_scale():
    enc = tb.BertEncoder(NEF, bert_cfg=TINY)
    tb.init_weights(enc, torch.Generator().manual_seed(0))
    big = tb.BertEncoder(256, bert_cfg={**TINY, "hidden_size": 64, "num_heads": 4,
                                        "intermediate_size": 256, "vocab_size": 1000})
    tb.init_weights(big, torch.Generator().manual_seed(0))
    for name, p in big.named_parameters():
        if name.endswith("LayerNorm.weight"):
            assert torch.all(p == 1.0), name
        elif name.endswith("bias"):
            assert torch.all(p == 0.0), name
        elif "embeddings" in name:
            assert abs(p.std().item() * 64 ** 0.5 - 1.0) < 0.1, name
        else:  # lecun-normal: std 1/sqrt(fan_in), truncated at 2 / 0.8796 of it
            fan_in = p.shape[1]
            assert abs(p.std().item() * fan_in ** 0.5 - 1.0) < 0.1, name
            assert p.abs().max().item() * fan_in ** 0.5 <= 2 / 0.87962566103423978 + 1e-6
    a = tb.BertEncoder(NEF, bert_cfg=TINY)
    tb.init_weights(a, torch.Generator().manual_seed(0))
    assert all(torch.equal(v, enc.state_dict()[k]) for k, v in a.state_dict().items())


PB, PLR = 8, 2e-3
PRETRAIN = {"TREE": {"BRANCH_NUM": 1}, "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": T},
            "MODEL": {"INCEPTION_INPUT": 75, "TEXT_ENCODER": "bert"},
            "TRAIN": {"ENCODER_LR": PLR}}
JAX_INTERPRET = {"DTYPE": "float64", "DAMSM_SIM_IMPL": "interpret", "DAMSM_SIM_TILE": 4}


def _pretrain_batch():
    rng = np.random.default_rng(11)
    img = rng.uniform(-1, 1, (PB, 75, 75, 3))
    cap_lens = rng.integers(1, T + 1, (PB,)).astype(np.int32)
    cap_lens[0], cap_lens[1] = 1, T
    return (img, _pad(rng, cap_lens), cap_lens,
            np.array([0, 1, 0, 2, 3, 1, 4, 5], np.int32))


def _adam_mu(opt_state):
    """The first moment of the one Adam in an optax state."""
    found = []
    jax.tree.map(lambda s: found.append(s.mu) if hasattr(s, "nu") else None, opt_state,
                 is_leaf=lambda s: hasattr(s, "mu") and hasattr(s, "nu"))
    (mu,) = found
    return mu


@pytest.fixture(scope="module")
def pretrain_case():
    """One BERT DAMSM train step of JAX and of the port (float64) from the
    port's random weights: logs, gradients after the clip (JAX's 2 mu), the
    parameters before and after, the running statistics."""
    img, captions, cap_lens, class_ids = _pretrain_batch()
    with pytest.MonkeyPatch.context() as mp:  # both packages build bert-base
        mp.setattr(tb, "BERT_BASE", TINY)
        models = build_damsm_models(cfg_from_dict(PRETRAIN), N_WORDS, seed=0)
    text_sd, image_sd = models.text_encoder.state_dict(), models.image_encoder.state_dict()
    with jax.enable_x64(True):
        jcfg = jax_cfg_from_dict({**PRETRAIN, "JAX": JAX_INTERPRET})
        jmodels = jax_build_damsm(jcfg, N_WORDS)._replace(
            text_encoder=JaxBertEncoder(nef=32, bert_cfg=TINY, dtype=jnp.float64))
        trainer = JaxDAMSMTrainer(jcfg, jmodels, N_WORDS)
        abstract = jax.eval_shape(trainer.init_state, jax.random.PRNGKey(0))
        state = trainer.reset_optimizer(abstract.replace(
            step=jnp.zeros((), jnp.int32),
            text_params=flax_tree_from_port(abstract.text_params, text_sd,
                                            W.bert_encoder_key),
            image_params=flax_tree_from_port(abstract.image_params, image_sd,
                                             cnn_encoder_key),
            image_batch_stats=flax_tree_from_port(abstract.image_batch_stats, image_sd,
                                                  cnn_encoder_key)), 0)
        args = tuple(jnp.asarray(a) for a in (img, captions, cap_lens, class_ids))
        new, logs = trainer.train_step(state, *args, jax.random.PRNGKey(1))
        new = jax.tree.map(np.asarray, new)
    text_mu, image_mu = (_adam_mu(s) for s in new.opt_state)
    want = {"logs": {k: float(v) for k, v in logs.items()},
            "text_grads": {k: 2 * v.double().numpy() for k, v in
                           W.bert_encoder_state_dict(text_mu).items()},
            "image_grads": {k: 2 * v.double().numpy() for k, v in
                            W.cnn_encoder_state_dict(image_mu, {}).items()},
            "text": W.bert_encoder_state_dict(new.text_params),
            "image": W.cnn_encoder_state_dict(new.image_params, new.image_batch_stats)}
    models.text_encoder.double()
    models.image_encoder.double()
    tr = DAMSMTrainer(cfg_from_dict(PRETRAIN), models, device="cpu")
    before = {"text": {k: v.clone() for k, v in tr.text_encoder.state_dict().items()},
              "image": {k: v.clone() for k, v in tr.image_encoder.state_dict().items()}}
    logs = tr.train_step(torch.from_numpy(img), torch.from_numpy(captions).long(),
                         torch.from_numpy(cap_lens).long(), torch.from_numpy(class_ids).long())
    return want, tr, {k: float(v) for k, v in logs.items()}, before


def _hold_group(params, want_grads, want_new, before):
    """Gradients rtol 1e-4, atol 1e-5 of the group's largest entry (the key
    biases' gradients are 0 but for rounding: softmax ignores a constant
    added to every score of a query).  Parameters after the update: Adam's
    first update is lr g / (|g| + 1e-8), so it moves them at most 1e-3 lr
    apart where the gradients agree to 1e-3 (over 99% of the group's
    entries), and 2 lr where they do not (near-zero gradients)."""
    scale = max(np.abs(w).max() for w in want_grads.values())
    agreeing = total = 0
    for name, p in params.items():
        g, w = p.grad.numpy(), want_grads[name]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale, err_msg=name)
        diff = np.abs((p.detach() - before[name]).numpy()
                      - (want_new[name].double() - before[name]).numpy())
        agree = np.abs(g - w) <= 1e-3 * np.abs(w)
        assert diff[agree].max(initial=0.0) <= 1e-3 * PLR, name
        assert diff[~agree].max(initial=0.0) <= 2 * PLR + 1e-6, name
        agreeing, total = agreeing + int(agree.sum()), total + agree.size
    assert agreeing / total > 0.99


def test_pretrain_step_matches_jax(pretrain_case):
    """Both sides start from the port's weights (``before``)."""
    want, tr, logs, before = pretrain_case
    assert sorted(logs) == sorted(want["logs"]) == sorted(LOG_KEYS)
    for k, v in want["logs"].items():
        np.testing.assert_allclose(logs[k], v, rtol=2e-5, err_msg=k)
    text = dict(tr.text_encoder.named_parameters())
    assert sorted(text) == sorted(want["text_grads"])  # every BERT parameter trains
    assert all(torch.isfinite(p.grad).all() for p in text.values())
    _hold_group(text, want["text_grads"], want["text"], before["text"])
    image = dict(tr.image_encoder.named_parameters())
    trained = {n: p for n, p in image.items() if p.requires_grad}
    assert {n.split(".")[0] for n in trained} == {"Mixed_7a", "Mixed_7b", "Mixed_7c",
                                                  "emb_features", "emb_cnn_code"}
    _hold_group(trained, {n: want["image_grads"][n] for n in trained}, want["image"],
                before["image"])
    for name, p in image.items():
        if name not in trained:
            assert p.grad is None and torch.equal(p.detach(), before["image"][name]), name
    got = tr.image_encoder.state_dict()
    for name, w in want["image"].items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=2e-5,
                                       err_msg=name)


def test_bert_gradients_finite_and_zero_at_padding():
    """The port's words loss (the plain version of K1-K3) through BERT with
    padded captions: every BERT gradient finite, the words' gradient exactly
    0 at padding.  The JAX package's dense formulation (``DAMSM_SIM_IMPL:
    xla``, its default) gives NaN there, which the port does not copy."""
    rng = np.random.default_rng(3)
    lens = np.array([6, 4, 3, 2], np.int32)
    captions = _pad(rng, lens)
    region = rng.normal(0, 1, (4, 17, NEF)).astype(np.float32)
    enc = tb.BertEncoder(NEF, bert_cfg=TINY)
    tb.init_weights(enc, torch.Generator().manual_seed(2))
    labels = torch.arange(4)
    words, sent = enc(torch.from_numpy(captions).long(), torch.from_numpy(lens).long())
    words.retain_grad()
    w0, w1 = words_loss(torch.from_numpy(region), words, labels, torch.from_numpy(lens),
                        None)
    (w0 + w1).backward()
    for name, p in enc.named_parameters():
        if name.startswith("emb_sent") or name.startswith("bert.pooler"):
            continue  # the sentence code is not in the words loss
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    pad = torch.arange(T)[None, :] >= torch.from_numpy(lens)[:, None]
    assert torch.all(words.grad[pad] == 0) and torch.all(words.grad[~pad].abs().sum(-1) > 0)

    params = flax_tree_from_port(
        jax.eval_shape(lambda: JaxBertEncoder(nef=NEF, bert_cfg=TINY).init(
            jax.random.PRNGKey(0), jnp.asarray(captions), jnp.asarray(lens))["params"]),
        enc.state_dict(), W.bert_encoder_key)

    def loss(p):
        w, _ = JaxBertEncoder(nef=NEF, bert_cfg=TINY).apply({"params": p}, jnp.asarray(captions),
                                           jnp.asarray(lens))
        a, b = jax_words_loss(jnp.asarray(region), w, jnp.arange(4), jnp.asarray(lens),
                              None)  # impl "xla"
        return a + b
    nan = [bool(np.isnan(np.asarray(g)).any()) for g in
           jax.tree.leaves(jax.jit(jax.grad(loss))(params))]
    assert sum(nan) > len(nan) // 2  # the JAX package's fault (its interpret
    # formulation: test_pretrain_step_matches_jax)
