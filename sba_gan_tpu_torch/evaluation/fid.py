"""Frechet Inception Distance (the port's counterpart of the JAX package's
``evaluation/fid.py``) over the classifier's 2048-d pooled activations:
FID = ||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)), in float64 numpy."""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np
import torch

from sba_gan_tpu_torch.evaluation.inception_score import batched_apply
from sba_gan_tpu_torch.models.inception import InceptionV3Classifier
from sba_gan_tpu_torch.utils.platform import resolve_device


def make_activation_fn(classifier: InceptionV3Classifier, device="cuda") -> Callable:
    """images (B, H, W, 3) numpy in [-1, 1] -> pooled activations (B, 2048)
    numpy, the classifier in eval mode on ``device``, no gradient."""
    dev = resolve_device(device)
    classifier = classifier.to(dev).eval()

    @torch.no_grad()
    def activations(imgs: np.ndarray) -> np.ndarray:
        return classifier.pooled(torch.from_numpy(np.asarray(imgs, np.float32)).to(dev)
                                 ).cpu().numpy()

    return activations


def activation_stats(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    acts = np.asarray(acts, np.float64)
    mu = acts.mean(axis=0)
    cov = np.cov(acts, rowvar=False)
    return mu, np.atleast_2d(cov)


def _sqrtm_psd_product(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """sqrt(C1 C2) through S = sqrt(C1): sqrt(S C2 S) has the same trace and
    is symmetric PSD, so an eigendecomposition is safe."""
    w1, v1 = np.linalg.eigh(c1)
    w1 = np.clip(w1, 0.0, None)
    s = (v1 * np.sqrt(w1)) @ v1.T
    m = s @ c2 @ s
    w, v = np.linalg.eigh((m + m.T) / 2.0)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)) @ v.T


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    diff = mu1 - mu2
    covmean = _sqrtm_psd_product(cov1 + eps * np.eye(cov1.shape[0]),
                                 cov2 + eps * np.eye(cov2.shape[0]))
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(covmean))


def fid(images1: Iterable[np.ndarray], images2: Iterable[np.ndarray],
        activation_fn: Callable, batch_size: int = 32) -> float:
    """FID between two iterables of (H, W, 3) images in [-1, 1]."""
    mu1, c1 = activation_stats(batched_apply(images1, activation_fn, batch_size))
    mu2, c2 = activation_stats(batched_apply(images2, activation_fn, batch_size))
    return frechet_distance(mu1, c1, mu2, c2)
