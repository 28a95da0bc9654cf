"""Evaluation: Inception Score, FID and R-precision."""

from sba_gan_tpu_torch.evaluation.fid import (
    activation_stats,
    fid,
    frechet_distance,
    make_activation_fn,
)
from sba_gan_tpu_torch.evaluation.inception_score import (
    batched_apply,
    build_classifier,
    inception_score,
    inception_score_from_probs,
    load_images_from_dir,
    make_predict_fn,
)
from sba_gan_tpu_torch.evaluation.r_precision import r_precision_from_codes

__all__ = [
    "activation_stats",
    "batched_apply",
    "build_classifier",
    "fid",
    "frechet_distance",
    "inception_score",
    "inception_score_from_probs",
    "load_images_from_dir",
    "make_activation_fn",
    "make_predict_fn",
    "r_precision_from_codes",
]
