"""The port's BERT wordpieces (sba_gan_tpu_torch.data.vocab) against
HuggingFace's ``BertTokenizerFast`` and the JAX package's functions, on a
made-up ``vocab.txt`` placed as the ``bert-base-uncased`` snapshot of a
temporary HuggingFace hub cache (the released vocabulary is not in the
repository, and nothing is fetched):

* the tokenizer gives ``BertTokenizerFast``'s ids, with and without
  ``[CLS]``/``[SEP]``, with and without truncation, on captions with
  punctuation, accents, unknown words, CJK ideographs, control characters
  and over-long words;
* ``bert_vocab_encode`` (gen_example's captions) and
  ``load_or_build_captions_bert`` (the caption cache) equal the JAX
  package's, which find the same cache through ``transformers``;
* CUB items read with ``vocab='bert'`` are bit-identical to the JAX
  reader's;
* without the cached vocabulary every entry raises ``RuntimeError``;
* the pretrain and GAN CLIs on ``--device cpu`` with tiny YAMLs and a tiny
  BERT (``models.text_bert.BERT_BASE`` patched to 2 layers, because both
  packages always build bert-base): resume, ``TRAIN.NET_E`` from the BERT
  pretrain checkpoint, gen_example's wordpiece captions with the mixing
  sets; sampling and R-precision.
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch
import yaml

from _torch_parity import import_transformers, write_bert_hub
from sba_gan_tpu.data import vocab as jax_vocab
from sba_gan_tpu.data.cub import TextImageDataset as JaxTextImageDataset
from sba_gan_tpu_torch import main as gan_main
from sba_gan_tpu_torch import pretrain
from sba_gan_tpu_torch.config import cfg_from_dict, cfg_from_file
from sba_gan_tpu_torch.data import vocab
from sba_gan_tpu_torch.data.cub import TextImageDataset
from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset
from sba_gan_tpu_torch.models import text_bert as tb
from sba_gan_tpu_torch.train.damsm import DAMSMTrainer, build_damsm_models
from sba_gan_tpu_torch.utils.checkpoint import Checkpointer
from test_torch_cub_data import _assert_items_equal, _write_tree

transformers = import_transformers()

# special tokens at their own ids, whole words, and pieces of others
# ("wing" + "##s", "be" + "##ak", "perch" + "##ed"); "with", "and",
# "belly" of the mini CUB captions are in no piece: [UNK]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "bird", "small", "red",
         "wing", "##s", "short", "be", "##ak", "grey", "black", "crown", "white", "thr",
         "##oat", "long", "tail", "yellow", "eye", "perch", "##ed", "on", "branch", ",",
         ".", "!", "'", "-", "cafe", "the", "is", "un", "##known", "鸟", "##ing",
         "fly", "e", "##e", "naive"]
KW = dict(base_size=32, branch_num=2, words_num=6, seed=3)
CASES = [
    "A small RED bird, with wings!",
    "Café naïve   bird\tthe BIRD-wing's",
    "unknowns flying 鸟鸟bird zzz",
    "x" * 101 + " bird",
    "\x00bad� char​ here\x07 ok",
    "",
    "the bird is red. " * 6,
    "Ée éé",
]


@pytest.fixture()
def hub(tmp_path, monkeypatch):
    """A hub cache holding the made-up vocabulary as bert-base-uncased, named
    by ``HF_HUB_CACHE`` (the port) and handed to ``transformers`` (the JAX
    package's ``get_bert_tokenizer``; its cache path is fixed at import)."""
    root = write_bert_hub(tmp_path / "hub", VOCAB)
    monkeypatch.setenv("HF_HUB_CACHE", str(root))
    monkeypatch.setattr(jax_vocab, "get_bert_tokenizer",
                        lambda: transformers.BertTokenizerFast.from_pretrained(
                            "bert-base-uncased", local_files_only=True, cache_dir=str(root)))
    return root


@pytest.mark.parametrize("text", CASES)
def test_tokenizer_gives_bert_tokenizer_fast_ids(hub, text):
    fast = jax_vocab.get_bert_tokenizer()
    tok = vocab.get_bert_tokenizer()
    assert tok.vocab == fast.get_vocab()
    assert tok.encode(text) == fast(text)["input_ids"]
    assert tok.encode(text, add_special_tokens=False) == fast(
        text, add_special_tokens=False)["input_ids"]
    for n in (2, 5):
        assert tok.encode(text, max_length=n) == fast(
            text, truncation=True, max_length=n)["input_ids"]


def test_pieces_unknowns_and_long_words(hub):
    tok = vocab.get_bert_tokenizer()
    assert tok.tokenize("Wings beak, un-known!") == ["wing", "##s", "be", "##ak", ",",
                                                     "un", "-", "[UNK]", "!"]
    assert tok.tokenize("with " + "e" * 101 + " " + "e" * 100) == ["[UNK]", "[UNK]", "e"] + [
        "##e"] * 99


def test_bert_vocab_encode_equals_jax(hub):
    for words_num in (4, 8):
        ids, lens = vocab.bert_vocab_encode(CASES, words_num)
        want_ids, want_lens = jax_vocab.bert_vocab_encode(CASES, words_num)
        assert ids.dtype == want_ids.dtype and lens.dtype == want_lens.dtype
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(lens, want_lens)
    assert lens.min() == 2  # the empty caption: [CLS] [SEP]


@pytest.fixture(scope="module")
def mini_cub(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("birds"), np.random.default_rng(0))


def test_caption_cache_equals_jax(hub, mini_cub, tmp_path):
    """Each package builds captions_bert.pickle from the caption files: the
    same contents, which the other package reads back."""
    caches = {}
    for name, fn in (("port", vocab.load_or_build_captions_bert),
                     ("jax", jax_vocab.load_or_build_captions_bert)):
        root = str(tmp_path / name)
        shutil.copytree(mini_cub, root)
        with open(os.path.join(mini_cub, "train", "filenames.pickle"), "rb") as f:
            train = pickle.load(f)
        with open(os.path.join(mini_cub, "test", "filenames.pickle"), "rb") as f:
            test = pickle.load(f)
        out = fn(root, train, test, 10)
        with open(os.path.join(root, "captions_bert.pickle"), "rb") as f:
            caches[name] = (out, pickle.load(f), root)
    (port, port_file, port_root), (jax_, jax_file, jax_root) = caches["port"], caches["jax"]
    assert port == tuple(jax_) and port_file == jax_file
    unk = VOCAB.index("[UNK]")
    assert any(unk in c for c in port[0]) and any(VOCAB.index("##s") in c for c in port[0])
    assert not any(VOCAB.index("[CLS]") in c for c in port[0] + port[1])
    assert vocab.load_or_build_captions_bert(jax_root, [], [], 10) == port
    assert tuple(jax_vocab.load_or_build_captions_bert(port_root, [], [], 10)) == port


@pytest.mark.parametrize("split", ["train", "test"])
def test_cub_items_with_bert_vocab_equal_jax(hub, mini_cub, tmp_path, split):
    roots = {}
    for name in ("port", "jax"):
        roots[name] = str(tmp_path / name / "birds")
        shutil.copytree(mini_cub, roots[name])
    ds = TextImageDataset(roots["port"], split=split, vocab="bert", **KW)
    jds = JaxTextImageDataset(roots["jax"], split=split, vocab="bert", **KW)
    assert ds.ixtoword == jds.ixtoword and ds.n_words == jds.n_words == len(VOCAB)
    assert max(len(c) for c in ds.captions) > KW["words_num"]  # the subsample draws
    for epoch in ((0, 1) if split == "train" else (0,)):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        _assert_items_equal(ds, jds, range(len(ds)))
    cfg = cfg_from_dict({"DATA_DIR": roots["port"], "MODEL": {"TEXT_ENCODER": "bert"},
                         "TREE": {"BRANCH_NUM": 2, "BASE_SIZE": 32},
                         "TEXT": {"WORDS_NUM": 6}, "JAX": {"SEED": 3}})
    built = build_dataset(cfg, False, split)
    assert built.wordtoix == ds.wordtoix
    jds.set_epoch(0)
    _assert_items_equal(built, jds, range(2))


def test_missing_vocabulary_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="tokenizer"):
        vocab.bert_vocab_encode(["a bird"], 6)
    with pytest.raises(RuntimeError, match="tokenizer"):
        vocab.load_or_build_captions_bert(str(tmp_path), [], [], 10)
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "home"))
    with pytest.raises(RuntimeError, match="home"):
        vocab.get_bert_tokenizer()
    monkeypatch.delenv("HF_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "user"))
    with pytest.raises(RuntimeError, match="user"):
        vocab.get_bert_tokenizer()


# The CLIs: a tiny BERT (ids of the synthetic set, below 300), one torch
# thread (the suite runs six test processes on the CPU, and the steps' many
# small ops slow down by an order of magnitude when every process spins
# eight threads).
TINY_BERT = dict(vocab_size=300, hidden_size=16, num_layers=2, num_heads=2,
                 intermediate_size=32, max_position=24, type_vocab_size=2,
                 layer_norm_eps=1e-12)


@pytest.fixture()
def tiny_cli(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(tb, "BERT_BASE", TINY_BERT)
    yield
    torch.set_num_threads(threads)


GAN_YML = {"TREE": {"BRANCH_NUM": 2}, "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 6},
           "GAN": {"GF_DIM": 8, "DF_DIM": 8, "Z_DIM": 8, "W_DIM": 16, "CONDITION_DIM": 8,
                   "R_NUM": 1},
           "MODEL": {"INCEPTION_INPUT": 75}, "TRAIN": {"BATCH_SIZE": 8}}
DAMSM_YML = {"TREE": {"BRANCH_NUM": 1, "BASE_SIZE": 64},
             "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 6},
             "MODEL": {"INCEPTION_INPUT": 75}, "TRAIN": {"BATCH_SIZE": 8}, "WORKERS": 0}
HUB_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "small", "bird",
              "red", "wing", "##s", ","]


def _yaml(tmp_path, name, preset_name, *overrides):
    """The port's preset ``preset_name`` with the overrides (dicts of groups
    merged in order), as a file."""
    with open(os.path.join(os.path.dirname(tb.__file__), "..", "configs",
                           f"{preset_name}.yml")) as f:
        raw = yaml.safe_load(f)
    for over in overrides:
        for group, values in over.items():
            if isinstance(values, dict):
                raw.setdefault(group, {}).update(values)
            else:
                raw[group] = values
    path = tmp_path / f"{name}.yml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_clis_train_resume_and_generate_with_bert(tiny_cli, tmp_path, monkeypatch):
    """pretrain.main (DAMSM/bird_bert) for one epoch and a resumed second;
    main.main (bird_bert) from that checkpoint, one epoch and a resumed
    second; then gen_example of bird_mixing over wordpiece captions, with
    the mixing sets."""
    damsm_out = str(tmp_path / "damsm")
    yml = _yaml(tmp_path, "damsm", "DAMSM/bird_bert", DAMSM_YML)
    for max_epoch, resumed in ((1, None), (2, 0)):
        summary = pretrain.main(["--cfg", yml, "--synthetic", "--max_epoch", str(max_epoch),
                                 "--device", "cpu", "--output_dir", damsm_out])
        assert summary["resumed_from"] == resumed
        assert all(np.isfinite(v) for e in summary["epochs"] for step in e["logs"]
                   for v in step.values())
    saved = Checkpointer(os.path.join(damsm_out, "Model")).restore()
    assert any(k.startswith("bert.encoder.layer.1.") for k in saved["text_encoder"])
    cfg = cfg_from_file(yml)  # the checkpoint restores; the CLI's attention grid
    ds = build_dataset(cfg, True, "train")
    tr = DAMSMTrainer(cfg, build_damsm_models(cfg, ds.n_words), device="cpu")
    tr.load_state_dict(saved)
    batch = next(iter(DataLoader(ds, 8, shuffle=False)))
    png = pretrain.dump_attention(tr, batch, str(tmp_path / "attn"), ds.ixtoword, "bert")
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"

    gan_out = str(tmp_path / "gan")
    net_e = {"TRAIN": {"NET_E": os.path.join(damsm_out, "Model")}}
    yml = _yaml(tmp_path, "gan", "bird_bert", GAN_YML, net_e)
    for max_epoch, resumed in ((1, None), (2, 0)):
        summary = gan_main.main(["--cfg", yml, "--synthetic", "--max_epoch", str(max_epoch),
                                 "--device", "cpu", "--output_dir", gan_out])
        assert summary["resumed_from"] == resumed
        assert all(np.isfinite(v) for e in summary["epochs"] for v in e["logs"].values())
    state = Checkpointer(os.path.join(gan_out, "Model")).restore()
    for k, v in saved["text_encoder"].items():  # the frozen encoder as NET_E gave it
        assert torch.equal(state["text_encoder"][k], v), k

    data = tmp_path / "examples"
    data.mkdir()
    (data / "example_filenames.txt").write_text("birds/one\n")
    (data / "birds").mkdir()
    (data / "birds" / "one.txt").write_text("A small red bird, wings\nred bird\n")
    monkeypatch.setenv("HF_HUB_CACHE", str(write_bert_hub(tmp_path / "hub", HUB_TOKENS)))
    yml = _yaml(tmp_path, "mix", "bird_mixing", GAN_YML, net_e,
                {"DATA_DIR": str(data), "TRAIN": {"FLAG": False}})
    summary = gan_main.main(["--cfg", yml, "--synthetic", "--device", "cpu",
                             "--output_dir", str(tmp_path / "mix")])
    out = os.path.join(summary["gen_example_dir"], "one")
    assert sorted(os.listdir(out)) == sorted(
        ["attention_maps.png"] + [f"{j}_s_g{k}.png" for j in range(2) for k in range(2)]
        + [f"{j}_mix_{m}.png" for j in range(2) for m in ("AB", "BA", "A", "B")])


def test_sampling_and_r_precision_with_bert(tiny_cli, tmp_path):
    """The trainer's test-split sampling and R-precision with BERT."""
    from sba_gan_tpu_torch.train.loop import GANTrainer

    cfg = cfg_from_dict({**GAN_YML, "MODEL": {"INCEPTION_INPUT": 75, "TEXT_ENCODER": "bert"},
                         "TRAIN": {"FLAG": False, "BATCH_SIZE": 8}})
    ds = build_dataset(cfg, True, "test")
    trainer = GANTrainer(cfg, str(tmp_path), ds, ds.n_words, ds.ixtoword, device="cpu")
    out = trainer.sampling("valid")
    assert len(os.listdir(out)) == len(ds)
    mean, std = trainer.r_precision_eval(num_candidates=4, trials=2)
    assert 0.0 <= mean <= 1.0 and std >= 0.0
