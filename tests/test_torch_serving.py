"""The port's serving path: its sampler against the JAX package's
``make_sample_fn(...).with_noise`` on the same weights and captions, the
WSGI routes over it, the import boundary, and the device default.

Weights: Flax initializes the text encoder and the generator (random
BatchNorm statistics), they are written to an ``.npz`` in the layout the
port's server reads, and the port loads that file.  Tolerance atol 1e-4,
rtol 1e-4, as for the generator alone (tests/test_torch_generator.py).
"""

import io
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import jax_generator_and_vars, tiny_cfgs
from sba_gan_tpu.models.text_rnn import RNNEncoder as JaxRNNEncoder
from sba_gan_tpu.train.gan import GANModels, make_sample_fn
from sba_gan_tpu_torch import pretrain
from sba_gan_tpu_torch.data.vocab import synthetic_vocab
from sba_gan_tpu_torch.serving.app import build_service, make_wsgi_app, main
from sba_gan_tpu_torch.train.sample import Sampler
from sba_gan_tpu_torch.utils import weights as W

N_WORDS, T = 30, 6
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX sample_with_noise, JAX state, port Sampler on the CPU, cfg)."""
    rng = np.random.default_rng(4)
    jcfg, cfg = tiny_cfgs()
    text = JaxRNNEncoder(ntoken=N_WORDS, nhidden=32)
    key = jax.random.PRNGKey(9)
    text_vars = text.init({"params": key, "dropout": key},
                          jnp.ones((2, T), jnp.int32),
                          jnp.full((2,), T, jnp.int32), train=False)
    g, g_vars = jax_generator_and_vars(
        jcfg, rng, np.zeros((2, 8), np.float32), np.zeros((2, 32), np.float32),
        np.zeros((2, T, 32), np.float32), np.zeros((2, T), bool),
        jax.random.PRNGKey(1))
    state = SimpleNamespace(
        text=text_vars, g_ema=g_vars["params"],
        g=SimpleNamespace(params=g_vars["params"],
                          batch_stats=g_vars["batch_stats"]))
    jax_models = GANModels(text_encoder=text, image_encoder=None, generator=g,
                           discriminators=())
    path = tmp_path_factory.mktemp("weights") / "serve.npz"
    np.savez(path, **W.flatten_tree({
        "g_ema": state.g_ema, "g": {"batch_stats": state.g.batch_stats},
        "text": state.text}))
    sampler = Sampler.from_config(cfg, N_WORDS, weights=str(path), device="cpu")
    return make_sample_fn(jcfg, jax_models).with_noise, state, sampler, cfg


def test_sampler_matches_make_sample_fn(models):
    with_noise, state, sampler, _ = models
    rng = np.random.default_rng(5)
    lens = np.array([6, 2, 1], np.int32)
    captions = np.zeros((3, T), np.int32)
    for i, n in enumerate(lens):
        captions[i, :n] = rng.integers(1, N_WORDS, n)
    captions[2, 0] = 0  # a caption with no known word: all padding, length 1
    z = rng.standard_normal((3, 8)).astype(np.float32)
    rng_ca = jax.random.PRNGKey(11)
    eps = np.array(jax.random.normal(rng_ca, (3, 8), jnp.float32))

    fakes_j, atts_j = with_noise(state, jnp.asarray(captions),
                                 jnp.asarray(lens), jnp.asarray(z), rng_ca)
    fakes, atts = sampler.with_noise(captions, lens, z, eps)
    assert all(isinstance(a, np.ndarray) for a in fakes + atts)
    assert [f.shape for f in fakes] == [(3, s, s, 3) for s in (64, 128, 256)]
    for got, want in zip(fakes + atts, list(fakes_j) + list(atts_j)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # the seeded entry point: same seed, same images
    a, _ = sampler(captions, lens, seed=3)
    b, _ = sampler(captions, lens, seed=3)
    np.testing.assert_array_equal(a[2], b[2])


@pytest.fixture(scope="module")
def client(models, tmp_path_factory):
    _, _, sampler, cfg = models
    wordtoix, ixtoword = synthetic_vocab(N_WORDS)
    service = build_service(cfg, sampler, wordtoix, ixtoword,
                            str(tmp_path_factory.mktemp("blobs")),
                            telemetry=lambda event: None)
    app = make_wsgi_app(service)

    def call(method, path, body=None):
        data = body if isinstance(body, bytes) else (
            json.dumps(body).encode() if body is not None else b"")
        out = {}

        def start_response(status, headers):
            out["status"] = status

        environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
                   "CONTENT_LENGTH": str(len(data)),
                   "wsgi.input": io.BytesIO(data)}
        chunks = app(environ, start_response)
        return out["status"], b"".join(chunks)

    return call


def test_routes(client):
    status, body = client("GET", "/")
    assert status == "200 OK"
    assert json.loads(body)["name"] == "sba_gan_tpu_torch"

    status, body = client("POST", "/api/v1.0/bird", {"caption": "w1 w2 w7"})
    assert status == "201 Created"
    bird = json.loads(body)["bird"]
    assert {"small", "medium", "large", "map1", "map2", "caption",
            "elapsed"} <= set(bird)
    status, img = client("GET", bird["large"])
    assert status == "200 OK" and img[:8] == b"\x89PNG\r\n\x1a\n"

    status, body = client("POST", "/api/v1.0/birds", {"caption": "w3 w4"})
    assert status == "201 Created"
    bird = json.loads(body)["bird"]
    assert {f"bird{j}" for j in range(1, 7)} | {"caption", "elapsed"} <= set(bird)
    assert {"small", "medium", "large", "map1", "map2"} <= set(bird["bird6"])

    for bad in (b"not json", {"nope": 1}, {"caption": 3}, {"caption": "w1",
                                                           "map_scale": 0}):
        status, _ = client("POST", "/api/v1.0/bird", bad)
        assert status == "400 Bad Request", bad


def test_port_imports_no_jax():
    """Every module of the port, found by walking the package, imports
    nothing of JAX, flax or the JAX package (nor does chip_smoke.py)."""
    code = ("import importlib, pkgutil, sys\n"
            "import sba_gan_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
            "pkg.__name__ + '.')]\n"
            "for m in names: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'sba_gan_tpu'))\n"
            "print(len(names), bad); sys.exit(1 if bad or len(names) < 20 else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default runs there")
    _, cfg = tiny_cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        Sampler.from_config(cfg, N_WORDS)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--synthetic", "--n_words", str(N_WORDS), "--store",
              str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        pretrain.main(["--synthetic", "--output_dir", str(tmp_path / "pretrain")])
