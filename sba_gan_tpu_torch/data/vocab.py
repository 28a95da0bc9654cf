"""Captions and the word-id vocabulary (the port's copy of the JAX
package's ``data/vocab.py``, without its BERT half): ``\\w+`` tokens of the
lowercased caption, ascii only; the vocabulary over train + test captions in
first-seen order, index 0 = ``<end>`` pad; the caption cache
``captions.pickle`` in the reference layout ``[train_caps, test_caps,
ixtoword, wordtoix]`` (protocol 2), so one cache is read by both packages;
and the padding of a caption to ``WORDS_NUM``."""

from __future__ import annotations

import os
import pickle
import re
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

_WORD_RE = re.compile(r"\w+")


def tokenize_caption(cap: str) -> List[str]:
    """Lowercase, split on word characters, drop non-ascii residue."""
    cap = cap.replace("��", " ")
    tokens = _WORD_RE.findall(cap.lower())
    out = []
    for t in tokens:
        t = t.encode("ascii", "ignore").decode("ascii")
        if t:
            out.append(t)
    return out


def build_dictionary(
    train_captions: Sequence[List[str]], test_captions: Sequence[List[str]]
) -> Tuple[List[List[int]], List[List[int]], Dict[int, str], Dict[str, int]]:
    """Word ids over train + test in first-seen order, 0 = ``<end>``; returns
    the encoded train and test captions, ixtoword and wordtoix."""
    word_counts: Dict[str, float] = defaultdict(float)
    for sent in list(train_captions) + list(test_captions):
        for w in sent:
            word_counts[w] += 1

    ixtoword = {0: "<end>"}
    wordtoix = {"<end>": 0}
    for ix, w in enumerate(word_counts, start=1):
        wordtoix[w] = ix
        ixtoword[ix] = w

    def encode(caps):
        return [[wordtoix[w] for w in sent if w in wordtoix] for sent in caps]

    return encode(train_captions), encode(test_captions), ixtoword, wordtoix


def load_caption_files(data_dir: str, filenames: Sequence[str],
                       captions_per_image: int) -> List[List[str]]:
    """Tokens of the first ``captions_per_image`` non-empty captions of each
    ``text/{name}.txt``."""
    all_captions = []
    for name in filenames:
        with open(os.path.join(data_dir, "text", f"{name}.txt"), "r") as f:
            cnt = 0
            for cap in f.read().split("\n"):
                if len(cap) == 0:
                    continue
                tokens = tokenize_caption(cap)
                if not tokens:
                    continue
                all_captions.append(tokens)
                cnt += 1
                if cnt == captions_per_image:
                    break
            if cnt < captions_per_image:
                print(f"ERROR: the captions for {name} less than {cnt}")
    return all_captions


def load_or_build_captions(data_dir: str, train_names: Sequence[str],
                           test_names: Sequence[str], captions_per_image: int,
                           cache_name: str = "captions.pickle"):
    """(train_caps, test_caps, ixtoword, wordtoix) from ``data_dir``'s cache,
    or built from the caption files and written there."""
    filepath = os.path.join(data_dir, cache_name)
    if os.path.isfile(filepath):
        with open(filepath, "rb") as f:
            train_captions, test_captions, ixtoword, wordtoix = pickle.load(f)[:4]
        return train_captions, test_captions, ixtoword, wordtoix

    train_raw = load_caption_files(data_dir, train_names, captions_per_image)
    test_raw = load_caption_files(data_dir, test_names, captions_per_image)
    train_captions, test_captions, ixtoword, wordtoix = build_dictionary(train_raw, test_raw)
    with open(filepath, "wb") as f:
        pickle.dump([train_captions, test_captions, ixtoword, wordtoix], f, protocol=2)
    return train_captions, test_captions, ixtoword, wordtoix


def pad_caption(sent: Sequence[int], words_num: int, rng: np.random.Generator
                ) -> Tuple[np.ndarray, int]:
    """Zero-pad to ``words_num``; a longer caption keeps a sorted random
    subsample of ``words_num`` words (one ``rng.permutation``).  Returns
    (ids (words_num,) int64, length)."""
    sent = np.asarray(sent, dtype=np.int64)
    x = np.zeros((words_num,), dtype=np.int64)
    n = len(sent)
    if n <= words_num:
        x[:n] = sent
        return x, n
    ix = rng.permutation(n)[:words_num]
    ix.sort()
    x[:] = sent[ix]
    return x, words_num


def encode_free_text(
    sentences: Sequence[str], wordtoix: Dict[str, int], words_num: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize sentences to zero-padded (N, words_num) ids and (N,) lengths.
    Unknown words are dropped; a caption with no known word gives an
    all-padding row of length 1."""
    ids, lens = [], []
    for sent in sentences:
        rev = [wordtoix[t] for t in tokenize_caption(sent) if t in wordtoix]
        rev = rev[:words_num]
        row = np.zeros((words_num,), dtype=np.int64)
        row[: len(rev)] = rev
        ids.append(row)
        lens.append(max(len(rev), 1))
    return np.stack(ids), np.asarray(lens, dtype=np.int64)


def synthetic_vocab(n_words: int) -> Tuple[Dict[str, int], Dict[int, str]]:
    """The synthetic dataset's vocabulary: ``w1 .. w{n_words-1}``, 0 = pad."""
    ixtoword = {i: f"w{i}" for i in range(1, n_words)}
    ixtoword[0] = "<end>"
    return {w: i for i, w in ixtoword.items()}, ixtoword
