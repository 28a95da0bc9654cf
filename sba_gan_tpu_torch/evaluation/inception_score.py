"""Inception Score (the port's counterpart of the JAX package's
``evaluation/inception_score.py``): the classifier's softmax over images in
[-1, 1] (resized to its input size with the align-corners bilinear map),
then per split exp(mean KL(p(y|x) || p(y))), mean and std over splits.

Without torchvision's weights (``evaluate --weights``) the classifier is
random, and the score is only comparable between runs of the port.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from sba_gan_tpu_torch.models.inception import InceptionV3Classifier, init_classifier_weights
from sba_gan_tpu_torch.utils.platform import resolve_device


def build_classifier(input_size: int = 299, weights: Optional[str] = None,
                     seed: int = 0) -> InceptionV3Classifier:
    """The classifier on the CPU: torchvision's ``inception_v3`` weights from
    the ``.pth`` file ``weights``, else random weights from ``seed``."""
    classifier = InceptionV3Classifier(input_size=input_size)
    if weights:
        from sba_gan_tpu_torch.utils.torch_port import load_cnn_encoder

        load_cnn_encoder(classifier, weights)
    else:
        init_classifier_weights(classifier, torch.Generator().manual_seed(seed))
    return classifier


def make_predict_fn(classifier: InceptionV3Classifier, device="cuda") -> Callable:
    """images (B, H, W, 3) numpy in [-1, 1] -> softmax probabilities (B, C)
    numpy, the classifier in eval mode on ``device``, no gradient."""
    dev = resolve_device(device)
    classifier = classifier.to(dev).eval()

    @torch.no_grad()
    def predict(imgs: np.ndarray) -> np.ndarray:
        logits = classifier(torch.from_numpy(np.asarray(imgs, np.float32)).to(dev))
        return torch.softmax(logits, dim=-1).cpu().numpy()

    return predict


def inception_score_from_probs(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """exp(mean KL) per split, (mean, std) over the non-empty splits."""
    n = probs.shape[0]
    scores = []
    for k in range(splits):
        part = probs[k * n // splits: (k + 1) * n // splits]
        if part.shape[0] == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(float(np.exp(kl.sum(axis=1).mean())))
    return float(np.mean(scores)), float(np.std(scores))


def batched_apply(images: Iterable[np.ndarray], fn: Callable, batch_size: int) -> np.ndarray:
    """``fn`` over batches of ``batch_size`` images; the ragged tail is
    padded by repeating its last image and the padding's rows cut off."""
    outs = []
    batch = []
    for img in images:
        batch.append(np.asarray(img, np.float32))
        if len(batch) == batch_size:
            outs.append(np.asarray(fn(np.stack(batch))))
            batch = []
    if batch:
        tail = len(batch)
        batch += [batch[-1]] * (batch_size - tail)
        outs.append(np.asarray(fn(np.stack(batch)))[:tail])
    return np.concatenate(outs, axis=0)


def inception_score(images: Iterable[np.ndarray], predict_fn: Callable,
                    batch_size: int = 32, splits: int = 10) -> Tuple[float, float]:
    """IS over an iterable of (H, W, 3) images in [-1, 1]."""
    return inception_score_from_probs(batched_apply(images, predict_fn, batch_size), splits)


def load_images_from_dir(path: str, size: Optional[int] = None):
    """[-1, 1] float32 images of the PNGs and JPEGs of ``path``, by sorted
    name, optionally resized (bilinear) to ``size``."""
    from PIL import Image

    for name in sorted(os.listdir(path)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        with Image.open(os.path.join(path, name)) as f:
            im = f.convert("RGB")
        if size is not None:
            im = im.resize((size, size), Image.BILINEAR)
        yield np.asarray(im, np.float32) / 127.5 - 1.0
