"""Captions and their vocabularies (the port's copy of the JAX package's
``data/vocab.py``): ``\\w+`` tokens of the lowercased caption, ascii only;
the vocabulary over train + test captions in first-seen order, index 0 =
``<end>`` pad; the caption cache ``captions.pickle`` in the reference
layout ``[train_caps, test_caps, ixtoword, wordtoix]`` (protocol 2), so one
cache is read by both packages; and the padding of a caption to
``WORDS_NUM``.

The BERT half: :class:`WordPieceTokenizer`, the ``bert-base-uncased``
tokenizer written out (HuggingFace's ``BertTokenizerFast`` gives the same
ids; the port does not import ``transformers``), over the ``vocab.txt`` of
the ``models--bert-base-uncased`` snapshot in the local HuggingFace hub
cache, where the JAX package's ``from_pretrained(..., local_files_only=True)``
finds it; :func:`bert_vocab_encode` for free text (``[CLS] ... [SEP]``) and
:func:`load_or_build_captions_bert` for the caption cache
``captions_bert.pickle`` (no special tokens), in the same layout.  Without
the cached vocabulary both raise ``RuntimeError``; nothing falls back to the
word vocabulary.
"""

from __future__ import annotations

import os
import pickle
import re
import unicodedata
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# BERT wordpieces
# ---------------------------------------------------------------------------

BERT_REPO = "models--bert-base-uncased"
UNK, CLS, SEP = "[UNK]", "[CLS]", "[SEP]"
SPECIAL_TOKENS = (UNK, SEP, "[PAD]", CLS, "[MASK]")
MAX_WORD_CHARS = 100  # a longer word is [UNK]
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_control(c: str) -> bool:
    return c not in "\t\n\r" and unicodedata.category(c).startswith("C")


def _is_punctuation(c: str) -> bool:
    """ASCII non-alphanumerics, and Unicode's P* categories."""
    cp = ord(c)
    return (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126
            or unicodedata.category(c).startswith("P"))


def _is_cjk(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _CJK)


def bert_normalize(text: str) -> str:
    """The uncased model's normalizer, in its order: drop NUL, U+FFFD and
    control characters and make every other whitespace a space; put spaces
    around CJK ideographs; strip accents (NFD, then no nonspacing marks);
    lowercase each character (no context rules, as the fast tokenizer)."""
    out = []
    for c in text:
        if c in ("\0", "\ufffd") or _is_control(c):
            continue
        if c in "\t\n\r" or c.isspace():
            out.append(" ")
        elif _is_cjk(c):
            out.append(f" {c} ")
        else:
            out.append(c)
    text = unicodedata.normalize("NFD", "".join(out))
    return "".join(c.lower() for c in text if unicodedata.category(c) != "Mn")


def bert_pre_tokenize(text: str) -> List[str]:
    """Words split on whitespace, each punctuation character a word of its own."""
    words: List[str] = []
    for chunk in text.split():
        cur = ""
        for c in chunk:
            if _is_punctuation(c):
                if cur:
                    words.append(cur)
                words.append(c)
                cur = ""
            else:
                cur += c
        if cur:
            words.append(cur)
    return words


class WordPieceTokenizer:
    """``bert-base-uncased``'s tokenizer over a ``vocab.txt`` (one token a
    line, its id the line number): :func:`bert_normalize`,
    :func:`bert_pre_tokenize`, then greedy longest-match-first wordpieces
    (``##`` before a piece inside a word; a word with a part in no piece,
    or longer than ``MAX_WORD_CHARS`` characters, is ``[UNK]``)."""

    def __init__(self, vocab: Dict[str, int]):
        for tok in (UNK, CLS, SEP):
            if tok not in vocab:
                raise ValueError(f"the BERT vocabulary has no {tok}")
        self.vocab = vocab
        specials = [t for t in SPECIAL_TOKENS if t in vocab]
        self._special = re.compile("(" + "|".join(map(re.escape, specials)) + ")")

    @classmethod
    def from_file(cls, path: str) -> "WordPieceTokenizer":
        with open(path, "r", encoding="utf-8") as f:
            return cls({line.rstrip("\n"): i for i, line in enumerate(f)})

    def _pieces(self, word: str) -> List[str]:
        if len(word) > MAX_WORD_CHARS:
            return [UNK]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    break
                end -= 1
            if end == start:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        """Pieces of ``text``; a special token written in it (``[CLS]``,
        ``[SEP]``, ``[PAD]``, ``[UNK]``, ``[MASK]``, as they are spelled and
        where the vocabulary holds them) is one piece, wherever it stands,
        as in HuggingFace's tokenizer."""
        out: List[str] = []
        for i, part in enumerate(self._special.split(text)):
            if i % 2:
                out.append(part)
            else:
                out += [p for w in bert_pre_tokenize(bert_normalize(part))
                        for p in self._pieces(w)]
        return out

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None) -> List[int]:
        """Ids of ``text``; with ``add_special_tokens`` between ``[CLS]`` and
        ``[SEP]``; with ``max_length`` the pieces cut at the end so that the
        whole fits (HuggingFace's ``truncation=True``)."""
        ids = [self.vocab[p] for p in self.tokenize(text)]
        if max_length is not None:
            ids = ids[:max(max_length - (2 if add_special_tokens else 0), 0)]
        if add_special_tokens:
            ids = [self.vocab[CLS], *ids, self.vocab[SEP]]
        return ids


def bert_vocab_path() -> str:
    """``vocab.txt`` of the cached ``bert-base-uncased`` snapshot: the hub
    cache is ``HF_HUB_CACHE``, else ``HF_HOME/hub``, else
    ``~/.cache/huggingface/hub``; the snapshot is the commit ``refs/main``
    names.  ``RuntimeError`` when it is not there."""
    cache = os.environ.get("HF_HUB_CACHE") or (
        os.path.join(os.environ["HF_HOME"], "hub") if os.environ.get("HF_HOME")
        else os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub"))
    repo = os.path.join(cache, BERT_REPO)
    ref = os.path.join(repo, "refs", "main")
    commit = "main"
    if os.path.isfile(ref):
        with open(ref) as f:
            commit = f.read().strip()
    path = os.path.join(repo, "snapshots", commit, "vocab.txt")
    if not os.path.isfile(path):
        raise RuntimeError(
            f"bert-base-uncased tokenizer is not available locally (no {path}); "
            "put the model's files in the HuggingFace hub cache, or use the "
            "word-id vocabulary (MODEL.TEXT_ENCODER: rnn)")
    return path


def get_bert_tokenizer() -> WordPieceTokenizer:
    """The cached ``bert-base-uncased`` tokenizer, or ``RuntimeError``."""
    return WordPieceTokenizer.from_file(bert_vocab_path())


def bert_vocab_encode(sentences: Sequence[str], words_num: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Sentences as ``[CLS] pieces [SEP]``, at most ``words_num`` ids each,
    zero-padded to (N, words_num), and their (N,) lengths."""
    tok = get_bert_tokenizer()
    ids, lens = [], []
    for sent in sentences:
        enc = tok.encode(sent, max_length=words_num)
        row = np.zeros((words_num,), dtype=np.int64)
        row[: len(enc)] = enc
        ids.append(row)
        lens.append(len(enc))
    return np.stack(ids), np.asarray(lens, dtype=np.int64)


def load_or_build_captions_bert(data_dir: str, train_names: Sequence[str],
                                test_names: Sequence[str], captions_per_image: int,
                                cache_name: str = "captions_bert.pickle"):
    """(train_caps, test_caps, ixtoword, wordtoix) of the wordpiece
    vocabulary: from ``data_dir``'s cache, or each caption's ``\\w+`` tokens,
    joined by spaces, as pieces without special tokens, with the BERT
    vocabulary as ``wordtoix``, written there."""
    filepath = os.path.join(data_dir, cache_name)
    if os.path.isfile(filepath):
        with open(filepath, "rb") as f:
            train_captions, test_captions, ixtoword, wordtoix = pickle.load(f)[:4]
        return train_captions, test_captions, ixtoword, wordtoix

    tok = get_bert_tokenizer()
    wordtoix = dict(tok.vocab)
    ixtoword = {i: w for w, i in wordtoix.items()}

    def encode(names):
        return [tok.encode(" ".join(sent), add_special_tokens=False)
                for sent in load_caption_files(data_dir, names, captions_per_image)]

    train_captions, test_captions = encode(train_names), encode(test_names)
    with open(filepath, "wb") as f:
        pickle.dump([train_captions, test_captions, ixtoword, wordtoix], f, protocol=2)
    return train_captions, test_captions, ixtoword, wordtoix
