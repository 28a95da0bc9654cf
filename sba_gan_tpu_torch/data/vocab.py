"""Caption tokenization for free text (the port's copy of the JAX package's
``data/vocab.py`` ingest): ``\\w+`` tokens of the lowercased caption, ascii
only, mapped through the word-id vocabulary (index 0 = ``<end>`` pad)."""

from __future__ import annotations

import re
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
