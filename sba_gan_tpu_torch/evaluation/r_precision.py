"""R-precision over DAMSM codes (the port's copy of the JAX package's
``evaluation/r_precision.py``, numpy on the host).

For each generated image, its true caption is ranked against
``num_candidates - 1`` mismatched captions by the cosine similarity of the
DAMSM global codes (the image encoder's code of the generated image, the
text encoder's sentence code); the score is the share of images whose true
caption ranks within the top ``r``.  With ``class_ids``, candidates of the
query's own class are drawn again (on CUB a same-class caption is no true
negative).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _cosine(a: np.ndarray, b: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Row-wise cosine similarity between (N, D) and (N, K, D) -> (N, K)."""
    a = a / np.clip(np.linalg.norm(a, axis=-1, keepdims=True), eps, None)
    b = b / np.clip(np.linalg.norm(b, axis=-1, keepdims=True), eps, None)
    return np.einsum("nd,nkd->nk", a, b)


def r_precision_from_codes(
    img_codes: np.ndarray,
    sent_codes: np.ndarray,
    rng: np.random.Generator,
    num_candidates: int = 100,
    r: int = 1,
    trials: int = 3,
    class_ids: Optional[np.ndarray] = None,
) -> Tuple[float, float]:
    """(mean, std) over ``trials`` candidate draws of the R-precision of
    matched (N, D) image and sentence codes; row i of ``sent_codes`` is the
    caption image i was generated from.  Needs N > ``num_candidates``."""
    img_codes = np.asarray(img_codes, np.float32)
    sent_codes = np.asarray(sent_codes, np.float32)
    n = img_codes.shape[0]
    k = num_candidates - 1
    if img_codes.shape[0] != sent_codes.shape[0]:
        raise ValueError(f"matched pairs required: {img_codes.shape} vs {sent_codes.shape}")
    if n <= num_candidates:
        raise ValueError(f"need more pairs ({n}) than candidates ({num_candidates})")

    scores = []
    for _ in range(trials):
        # k mismatched captions per image: draw from n - 1 and skip the query
        draws = rng.integers(0, n - 1, size=(n, k))
        draws = draws + (draws >= np.arange(n)[:, None])
        if class_ids is not None:
            cid = np.asarray(class_ids)
            bad = cid[draws] == cid[:, None]
            while bad.any():
                redraw = rng.integers(0, n - 1, size=int(bad.sum()))
                rows = np.nonzero(bad)[0]
                redraw = redraw + (redraw >= rows)
                draws[bad] = redraw
                bad = cid[draws] == cid[:, None]
        cand = np.concatenate([sent_codes[:, None, :], sent_codes[draws]], axis=1)
        sims = _cosine(img_codes, cand)  # (N, num_candidates); true caption first
        rank = (sims[:, 1:] > sims[:, :1]).sum(axis=1)
        scores.append(float((rank < r).mean()))
    return float(np.mean(scores)), float(np.std(scores))
