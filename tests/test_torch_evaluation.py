"""The port's evaluation against the JAX package's: the Inception Score
from probabilities, FID's statistics and distance, R-precision and the
batched application with a ragged tail on the same numpy inputs (rtol
1e-6); the classifier's probabilities and pooled activations against JAX's
``InceptionV3Classifier`` / ``make_activation_fn`` at input 75 on weights
carried from the port (random running statistics; float32 through some
ninety convolutions and norms, atol/rtol 1e-4 as tests/test_torch_inception.py,
probabilities atol 1e-6); reference checkpoints read into the port's
modules; the ``evaluate`` and ``reproduce`` CLIs on the CPU, whose JSON has
the JAX package's keys."""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_parity import cnn_encoder_key, flax_tree_from_port
from sba_gan_tpu.evaluation.r_precision import r_precision_from_codes as jax_r_precision
from sba_gan_tpu_torch import evaluate, reproduce
from sba_gan_tpu_torch.evaluation import (activation_stats, batched_apply, build_classifier,
                                          fid, frechet_distance, inception_score,
                                          inception_score_from_probs, load_images_from_dir,
                                          make_activation_fn, make_predict_fn,
                                          r_precision_from_codes)
from sba_gan_tpu_torch.models.text_rnn import RNNEncoder
from sba_gan_tpu_torch.utils import torch_port
from sba_gan_tpu_torch.utils import weights as W
from sba_gan_tpu_torch.utils.image import save_image

# the package's __init__ shadows the module names with its functions
jax_fid = importlib.import_module("sba_gan_tpu.evaluation.fid")
jax_is = importlib.import_module("sba_gan_tpu.evaluation.inception_score")
SIZE = 75
RTOL = 1e-6
TOL = dict(rtol=1e-4, atol=1e-4)
# the keys of the JAX package's reproduce summary (sba_gan_tpu/reproduce.py)
JAX_REPRODUCE_KEYS = {"samples_dir", "inception_score", "inception_score_std", "n_images",
                      "pretrained_is_model", "r_precision", "r_precision_std"}


def _probs(rng, n, c=10):
    logits = rng.normal(0, 3, (n, c))
    p = np.exp(logits - logits.max(1, keepdims=True))
    return p / p.sum(1, keepdims=True)


@pytest.mark.parametrize("n, splits", [(50, 10), (23, 10), (7, 3)])
def test_inception_score_from_probs_equals_jax(n, splits):
    p = _probs(np.random.default_rng(n), n)
    np.testing.assert_allclose(inception_score_from_probs(p, splits),
                               jax_is.inception_score_from_probs(p, splits), rtol=RTOL)


def test_batched_apply_pads_the_tail_as_jax():
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(-1, 1, (4, 4, 3)).astype(np.float32) for _ in range(11)]
    seen = []

    def fn(batch):
        seen.append(batch.shape[0])
        return batch.reshape(len(batch), -1).sum(1, keepdims=True) + np.arange(len(batch))[:, None]

    got = batched_apply(imgs, fn, 4)
    np.testing.assert_array_equal(got, jax_is.batched_apply(imgs, fn, 4))
    assert got.shape == (11, 1) and seen == [4, 4, 4] * 2  # the tail padded to 4


def test_fid_equals_jax():
    rng = np.random.default_rng(1)
    a, b = rng.normal(0, 1, (200, 16)), rng.normal(0.3, 1.2, (150, 16)) @ rng.normal(0, 1, (16, 16))
    (mu1, c1), (mu2, c2) = activation_stats(a), activation_stats(b)
    want_stats = jax_fid.activation_stats(a) + jax_fid.activation_stats(b)
    for got, want in zip((mu1, c1, mu2, c2), want_stats):
        np.testing.assert_allclose(got, want, rtol=RTOL)
    d = frechet_distance(mu1, c1, mu2, c2)
    np.testing.assert_allclose(d, jax_fid.frechet_distance(mu1, c1, mu2, c2), rtol=RTOL)
    assert d > 1.0 and abs(frechet_distance(mu1, c1, mu1, c1)) < 1e-4
    act = lambda x: x.reshape(len(x), -1)[:, :16].astype(np.float64)  # noqa: E731
    imgs1 = [rng.uniform(-1, 1, (4, 4, 3)) for _ in range(30)]
    imgs2 = [rng.uniform(-1, 1, (4, 4, 3)) * 0.5 for _ in range(25)]
    np.testing.assert_allclose(fid(imgs1, imgs2, act, 8), jax_fid.fid(imgs1, imgs2, act, 8),
                               rtol=RTOL)


@pytest.mark.parametrize("classes", [False, True])
def test_r_precision_equals_jax(classes):
    rng = np.random.default_rng(2)
    n, d = 60, 12
    sent = rng.normal(0, 1, (n, d)).astype(np.float32)
    img = (sent + rng.normal(0, 1.5, (n, d))).astype(np.float32)
    cls = rng.integers(0, 6, n) if classes else None
    got = r_precision_from_codes(img, sent, np.random.default_rng(7), num_candidates=20,
                                 trials=4, class_ids=cls)
    want = jax_r_precision(img, sent, np.random.default_rng(7), num_candidates=20, trials=4,
                           class_ids=cls)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert 0.0 < got[0] < 1.0
    with pytest.raises(ValueError, match="more pairs"):
        r_precision_from_codes(img[:10], sent[:10], np.random.default_rng(0), num_candidates=20)


def _classifier_key(path):
    return f"fc.{'weight' if path[1] == 'kernel' else 'bias'}" if path[0] == "fc" \
        else cnn_encoder_key(path)


@pytest.fixture(scope="module")
def classifiers():
    """(JAX classifier, its variables, port classifier): the port's random
    weights with random running statistics, carried into Flax."""
    clf = build_classifier(SIZE)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in clf.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.5 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=gen)
    jclf = jax_is.InceptionV3Classifier(input_size=SIZE)
    abstract = jax.eval_shape(lambda: jclf.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, SIZE, SIZE, 3)), False))
    sd = clf.state_dict()
    variables = {c: flax_tree_from_port(abstract[c], sd, _classifier_key) for c in abstract}
    return jclf, variables, clf


@pytest.mark.parametrize("size", [SIZE, 64])
def test_classifier_and_activations_match_jax(classifiers, size):
    jclf, variables, clf = classifiers
    imgs = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    probs = make_predict_fn(clf, "cpu")(imgs)
    probs_j = np.asarray(jax_is.make_predict_fn(jclf, variables)(jnp.asarray(imgs)))
    assert probs.shape == (2, 1000) and np.allclose(probs.sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(probs, probs_j, rtol=1e-4, atol=1e-6)
    backbone = {c: variables[c]["backbone"] for c in variables}
    pooled = make_activation_fn(clf, "cpu")(imgs)
    pooled_j = np.asarray(jax_fid.make_activation_fn(backbone, input_size=SIZE)(jnp.asarray(imgs)))
    assert pooled.shape == (2, 2048)
    assert np.abs(pooled[0] - pooled[1]).max() > 10 * TOL["atol"]  # the images matter
    np.testing.assert_allclose(pooled, pooled_j, **TOL)


def test_classifier_weight_map_and_torchvision_file(classifiers, tmp_path):
    """``weights.cnn_encoder_state_dict`` maps the JAX classifier (with
    ``fc``) onto the port's; a torchvision-layout file (``AuxLogits`` and
    ``num_batches_tracked`` present) loads; a missing key raises."""
    _, variables, clf = classifiers
    mapped = W.cnn_encoder_state_dict(variables["params"], variables["batch_stats"])
    own = clf.state_dict()
    assert set(mapped) == set(own)
    for k, v in own.items():
        torch.testing.assert_close(mapped[k], v, rtol=0, atol=0)
    sd = dict(own, **{"AuxLogits.fc.weight": torch.zeros(1000, 768),
                      "AuxLogits.conv0.bn.num_batches_tracked": torch.tensor(0)})
    torch.save(sd, tmp_path / "inception_v3.pth")
    other = build_classifier(SIZE, weights=str(tmp_path / "inception_v3.pth"))
    assert all(torch.equal(other.state_dict()[k], v) for k, v in own.items())
    del sd["fc.bias"]
    with pytest.raises(KeyError, match="fc.bias"):
        torch_port.load_reference(other, sd, "inception_v3 without fc.bias")


def test_encoder_of_another_vocabulary_is_refused(tmp_path):
    enc = RNNEncoder(ntoken=30, nhidden=16)
    torch.save(enc.state_dict(), tmp_path / "text_encoder.pth")
    torch_port.load_rnn_encoder(RNNEncoder(ntoken=30, nhidden=16),
                                str(tmp_path / "text_encoder.pth"))
    with pytest.raises(ValueError, match="30 words.* 31"):
        torch_port.load_rnn_encoder(RNNEncoder(ntoken=31, nhidden=16),
                                    str(tmp_path / "text_encoder.pth"))
    assert torch_port.image_encoder_path(str(tmp_path / "text_encoder.pth")) is None
    torch.save({}, tmp_path / "image_encoder.pth")
    assert torch_port.image_encoder_path(str(tmp_path / "text_encoder.pth")) == str(
        tmp_path / "image_encoder.pth")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_reproduce_and_evaluate_cli(tmp_path, capsys):
    """``reproduce --synthetic`` on the CPU: samples, IS, R-precision, the
    JAX package's summary keys; ``evaluate`` on the samples gives its IS."""
    cfg = {"TREE": {"BRANCH_NUM": 1, "BASE_SIZE": 64}, "WORKERS": 2,
           "GAN": {"GF_DIM": 8, "Z_DIM": 8, "W_DIM": 16, "CONDITION_DIM": 8, "R_NUM": 1},
           "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 6}, "MODEL": {"INCEPTION_INPUT": SIZE},
           "TRAIN": {"BATCH_SIZE": 8, "FLAG": False}}
    yml = tmp_path / "tiny.yml"
    yml.write_text(yaml.safe_dump(cfg))
    result = reproduce.main(["--cfg", str(yml), "--synthetic", "--device", "cpu",
                             "--output_dir", str(tmp_path / "out"), "--is_size", str(SIZE),
                             "--r_precision", "--rp_candidates", "16"])
    assert _last_json(capsys) == result and set(result) == JAX_REPRODUCE_KEYS
    names = sorted(os.listdir(result["samples_dir"]))
    assert result["n_images"] == len(names) == 32  # the synthetic set's least size
    assert names[0] == "synthetic_00000_s-1.png"
    assert np.isfinite(result["inception_score"]) and 0.0 <= result["r_precision"] <= 1.0
    again = evaluate.main(["--dir", result["samples_dir"], "--size", str(SIZE),
                           "--device", "cpu"])
    assert _last_json(capsys) == again and set(again) == {"inception_score", "std", "weights"}
    assert round(again["inception_score"], 4) == result["inception_score"]


def test_inception_score_over_a_folder(classifiers, tmp_path):
    _, _, clf = classifiers
    rng = np.random.default_rng(4)
    imgs = [rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32) for _ in range(5)]
    for i, img in enumerate(imgs):
        save_image(img, str(tmp_path / f"{4 - i}.png"))
    loaded = list(load_images_from_dir(str(tmp_path)))
    assert len(loaded) == 5 and loaded[0].shape == (32, 32, 3)  # sorted by name
    np.testing.assert_allclose(loaded[4], imgs[0], atol=1 / 127.5)
    predict = make_predict_fn(clf, "cpu")
    mean, std = inception_score(loaded, predict, batch_size=2, splits=2)
    want = jax_is.inception_score_from_probs(jax_is.batched_apply(loaded, predict, 2), 2)
    np.testing.assert_allclose((mean, std), want, rtol=RTOL)


def test_eval_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        reproduce.main(["--synthetic", "--output_dir", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--dir", str(tmp_path), "--size", str(SIZE)])
