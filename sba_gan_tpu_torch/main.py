"""GAN training CLI (the JAX package's ``main.py``): a YAML preset, the
synthetic data set, the DAMSM encoders of ``TRAIN.NET_E`` (a checkpoint of
the port's own pretraining, :mod:`sba_gan_tpu_torch.pretrain`: an
``epoch_N.pt`` file or its ``Model`` directory, whose latest checkpoint is
taken; random encoders when the path is empty), then training from the
latest checkpoint of the output directory, if any.

``TRAIN.FLAG`` false (sampling, ``gen_example``), ``TRAIN.NET_G`` and the
CUB reader are not ported yet and raise.

Usage (on the card; ``--device cpu`` runs on the CPU):

    python -m sba_gan_tpu_torch.main \\
        --cfg sba_gan_tpu_torch/configs/bird_style.yml --synthetic --max_epoch 1
"""

from __future__ import annotations

import argparse
import datetime
import os
import pprint
import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sba_gan_tpu_torch.config import cfg_from_file, default_config
from sba_gan_tpu_torch.data.pipeline import build_dataset
from sba_gan_tpu_torch.utils.checkpoint import Checkpointer
from sba_gan_tpu_torch.utils.platform import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Train the SBA-GAN generator")
    p.add_argument("--cfg", dest="cfg_file", type=str, default=None)
    p.add_argument("--manualSeed", type=int, default=100)
    p.add_argument("--output_dir", type=str, default="")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic data set (the CUB reader is not ported yet)")
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_net_e(path: str) -> Tuple[Optional[Dict], Optional[Dict]]:
    """(text encoder, image encoder) state dicts of a pretrain checkpoint:
    a ``.pt`` file or a checkpoint directory (its latest).  (None, None) for
    an empty path; a path that does not exist raises."""
    if not path:
        return None, None
    if os.path.isdir(path):
        state = Checkpointer(path).restore()
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    return state["text_encoder"], state["image_encoder"]


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Runs the CLI; returns a summary: the output directory, the epoch
    resumed from and per epoch its step count, last logs and seconds."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else default_config()
    if not cfg.TRAIN.FLAG:
        raise NotImplementedError("TRAIN.FLAG false (sampling, gen_example) is not ported "
                                  "yet (ROADMAP.md, queue 1, item 3)")
    if cfg.TRAIN.NET_G:
        raise NotImplementedError("TRAIN.NET_G (a reference G checkpoint to start from) is "
                                  "not read yet (ROADMAP.md, queue 1, item 3)")
    cfg.JAX.SEED = args.manualSeed
    random.seed(args.manualSeed)
    np.random.seed(args.manualSeed)
    torch.manual_seed(args.manualSeed)
    print("Using config:")
    pprint.pprint(cfg)

    now = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    output_dir = args.output_dir or os.path.join(
        "output", f"{cfg.DATASET_NAME}_{cfg.CONFIG_NAME}_{now}")
    dataset = build_dataset(cfg, args.synthetic, "train")
    text_state, image_state = load_net_e(cfg.TRAIN.NET_E)

    from sba_gan_tpu_torch.train.loop import GANTrainer

    trainer = GANTrainer(cfg, output_dir, dataset, dataset.n_words, dataset.ixtoword,
                         text_state=text_state, image_state=image_state, device=device)
    resumed = trainer.ckpt.latest_step() if trainer.resume() else None
    epochs = trainer.train(max_epoch=args.max_epoch)
    return {"output_dir": output_dir, "resumed_from": resumed, "epochs": epochs}


if __name__ == "__main__":
    main()
