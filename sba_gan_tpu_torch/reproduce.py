"""One command from reference checkpoints to scores (the JAX package's
``reproduce.py``): the reference ``netG`` and ``text_encoder`` files (the
image encoder beside the latter by the ``text_encoder`` ->
``image_encoder`` name rule) into the port's models, one sample per test
item (``{key}_s-1.png``, ``--rounds`` times over), then the Inception Score
of the samples and, with ``--r_precision``, the DAMSM R-precision; the
summary is one JSON line with the JAX package's keys.

    python -m sba_gan_tpu_torch.reproduce \\
        --net_e .../text_encoder200.pth --net_g .../netG_epoch_600.pth \\
        --data_dir .../birds [--inception_weights inception_v3.pth] \\
        [--output_dir out] [--splits 10] [--rounds 1] [--device cpu]

With no checkpoints the models keep random weights, and without
``--inception_weights`` the classifier too: the pipeline runs, the scores
mean nothing.  deviation: a named checkpoint that does not exist raises
(the JAX package skips it).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Reproduce reference checkpoints: samples + IS")
    p.add_argument("--cfg", dest="cfg_file", default=None,
                   help="preset YAML (default: configs/eval_bird.yml)")
    p.add_argument("--net_e", default="",
                   help="reference text_encoder .pth (the image encoder is found by "
                        "the text_encoder->image_encoder name rule)")
    p.add_argument("--net_g", default="", help="reference netG .pth (EMA)")
    p.add_argument("--data_dir", default="")
    p.add_argument("--synthetic", action="store_true",
                   help="the synthetic data set in place of --data_dir")
    p.add_argument("--output_dir", default="output/reproduce")
    p.add_argument("--inception_weights", default=None,
                   help="torchvision inception_v3 .pth for the IS classifier "
                        "(random weights otherwise: relative IS only)")
    p.add_argument("--splits", type=int, default=10)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--r_precision", action="store_true",
                   help="also the DAMSM R-precision over the test split (needs more "
                        "items than --rp_candidates)")
    p.add_argument("--rp_candidates", type=int, default=100,
                   help="R-precision candidates per image (1 true + K-1 mismatched)")
    p.add_argument("--skip_is", action="store_true", help="samples only, no IS")
    p.add_argument("--is_size", type=int, default=299,
                   help="IS classifier input size (299 as the reference)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    from sba_gan_tpu_torch.config import cfg_from_file, preset
    from sba_gan_tpu_torch.data.pipeline import build_dataset
    from sba_gan_tpu_torch.train.loop import GANTrainer
    from sba_gan_tpu_torch.utils.platform import resolve_device
    from sba_gan_tpu_torch.utils.torch_port import image_encoder_path

    device = resolve_device(args.device)
    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else preset("eval_bird")
    cfg.TRAIN.FLAG = False
    cfg.B_VALIDATION = True
    if args.data_dir:
        cfg.DATA_DIR = args.data_dir
    if args.batch:
        cfg.TRAIN.BATCH_SIZE = args.batch
    for path in (args.net_e, args.net_g):
        if path and not os.path.isfile(path):
            raise FileNotFoundError(f"checkpoint {path} does not exist")

    dataset = build_dataset(cfg, args.synthetic, "test")
    trainer = GANTrainer(cfg, args.output_dir, dataset, dataset.n_words,
                         dataset.ixtoword, device=device)
    net_e_image = image_encoder_path(args.net_e) if args.net_e else None
    trainer.load_torch_weights(net_g=args.net_g or None, net_e_text=args.net_e or None,
                               net_e_image=net_e_image)
    loaded = [name for name, path in (("netG", args.net_g), ("text_encoder", args.net_e),
                                      ("image_encoder", net_e_image)) if path]
    print(f"loaded reference checkpoints: {loaded or 'none (random init)'}", flush=True)

    sample_dir = trainer.sampling("valid", rounds=args.rounds)
    result = {"samples_dir": sample_dir}
    if not args.skip_is:
        from sba_gan_tpu_torch.evaluation.inception_score import (
            build_classifier,
            inception_score,
            load_images_from_dir,
            make_predict_fn,
        )

        predict = make_predict_fn(build_classifier(args.is_size, args.inception_weights),
                                  device)
        imgs = list(load_images_from_dir(sample_dir))
        mean, std = inception_score(imgs, predict, batch_size=min(32, len(imgs)),
                                    splits=args.splits)
        result.update(inception_score=round(float(mean), 4),
                      inception_score_std=round(float(std), 4), n_images=len(imgs),
                      pretrained_is_model=bool(args.inception_weights))
        print(f"Inception Score: {mean:.4f} +- {std:.4f} ({len(imgs)} images, "
              f"{args.splits} splits)", flush=True)
    if args.r_precision:
        rp_mean, rp_std = trainer.r_precision_eval(num_candidates=args.rp_candidates)
        result.update(r_precision=round(float(rp_mean), 4),
                      r_precision_std=round(float(rp_std), 4))
        print(f"R-precision (top-1 of {args.rp_candidates}): {rp_mean:.4f} +- "
              f"{rp_std:.4f}", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
