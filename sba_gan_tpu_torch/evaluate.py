"""Inception Score over a folder of images (the JAX package's
``evaluate.py``): the classifier's softmax over every PNG/JPEG of ``--dir``
(sorted by name), exp(mean KL) per split, mean and std over ``--splits``.

Usage (on the card; ``--device cpu`` runs on the CPU):

    python -m sba_gan_tpu_torch.evaluate --dir output/.../valid/single \\
        [--weights inception_v3.pth] [--splits 10] [--batch 32]

Without ``--weights`` (torchvision's ``inception_v3`` state dict) the
classifier has random weights from seed 0: a smoke test whose score is
comparable only between runs of the port.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description="Inception Score over a folder")
    p.add_argument("--dir", required=True, help="folder of generated images")
    p.add_argument("--weights", default=None,
                   help="torchvision inception_v3 .pth state dict")
    p.add_argument("--splits", type=int, default=10)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=299)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from sba_gan_tpu_torch.evaluation.inception_score import (
        build_classifier,
        inception_score,
        load_images_from_dir,
        make_predict_fn,
    )

    predict = make_predict_fn(build_classifier(args.size, args.weights), args.device)
    mean, std = inception_score(load_images_from_dir(args.dir), predict,
                                batch_size=args.batch, splits=args.splits)
    result = {"inception_score": mean, "std": std, "weights": bool(args.weights)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
