"""Gen-2 conditional StyleGAN training CLI (the JAX package's
``gen2_main.py``): RMSprop, WGAN-GP (or BCE) losses, a G update after every
``TRAIN.CRITIC_ITER``-th D update, a sample grid of the EMA generator per
epoch (``Image/epoch_N.png``) and checkpoints (``Model/epoch_N.pt``, N the
D step count: the weights, the EMA and the RMSprop moments) every
``TRAIN.SNAPSHOT_INTERVAL`` epochs and at the end.  A run resumes from the
latest checkpoint of its output directory and then runs ``MAX_EPOCH``
epochs, each epoch's data and shuffle seeded by its index (as the JAX CLI).

Data: a multi-resolution pack (``python -m sba_gan_tpu_torch.prepare_data``)
read at ``GEN2.RESOLUTION``, its wordpiece ids folded into
``GEN2.BERT_VOCAB`` (ids of a smaller test tower), or ``--synthetic``.
``--bert_weights`` names a local HuggingFace ``BertModel`` state dict for the
frozen text tower; else the tower stays at random init.

Usage (on the card; ``--device cpu`` runs on the CPU):

    python -m sba_gan_tpu_torch.gen2_main \\
        --cfg sba_gan_tpu_torch/configs/gen2_birds.yml --data_dir data/pack \\
        --max_epoch 500
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from sba_gan_tpu_torch.config import cfg_from_file, default_config
from sba_gan_tpu_torch.train.gen2 import Gen2Trainer
from sba_gan_tpu_torch.utils.checkpoint import Checkpointer
from sba_gan_tpu_torch.utils.image import make_grid


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Gen-2 conditional StyleGAN")
    p.add_argument("--cfg", default=None)
    p.add_argument("--data_dir", default="")
    p.add_argument("--output_dir", default="output/gen2")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--manualSeed", type=int, default=100)
    p.add_argument("--device", default="cuda")
    p.add_argument("--bert_weights", default=None,
                   help="a local HuggingFace BertModel state dict for the frozen text tower")
    return p.parse_args(argv)


def synthetic_batches(batch: int, resolution: int, max_length: int, n_batches: int,
                      seed: int, vocab: int):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        imgs = rng.uniform(-1, 1, (batch, resolution, resolution, 3))
        toks = rng.integers(1, vocab, (batch, max_length))
        toks[:, max_length // 2:] = 0  # padded tail
        yield imgs.astype(np.float32), toks.astype(np.int32)


def fold_ids(toks: np.ndarray, vocab: int) -> np.ndarray:
    """Wordpiece ids folded into a vocabulary of ``vocab`` (0 stays 0)."""
    return np.where(toks == 0, 0, 1 + (toks - 1) % (vocab - 1))


def main(argv: Optional[Sequence[str]] = None) -> Gen2Trainer:
    args = parse_args(argv)
    cfg = cfg_from_file(args.cfg) if args.cfg else default_config()
    if args.max_epoch is not None:
        cfg.TRAIN.MAX_EPOCH = args.max_epoch
    if args.batch is not None:
        cfg.TRAIN.BATCH_SIZE = args.batch
    os.makedirs(os.path.join(args.output_dir, "Image"), exist_ok=True)

    trainer = Gen2Trainer(cfg, device=args.device, seed=args.manualSeed)
    if args.bert_weights:
        from sba_gan_tpu_torch.utils.torch_port import load_bert, load_state_dict_file

        sd = load_state_dict_file(args.bert_weights)
        for net in (trainer.generator, trainer.g_ema):
            load_bert(net.bert_embedding, sd)
        print("loaded BERT weights into the text tower")

    ckpt = Checkpointer(os.path.join(args.output_dir, "Model"))
    if ckpt.latest_step() is not None:
        trainer.load_state_dict(ckpt.restore())
        print(f"resumed at step {trainer.step}")

    g2 = cfg.GEN2

    def epoch_batches(epoch: int):
        if args.synthetic:
            return synthetic_batches(cfg.TRAIN.BATCH_SIZE, g2.RESOLUTION, g2.MAX_LENGTH,
                                     n_batches=8, seed=epoch, vocab=g2.BERT_VOCAB)
        from sba_gan_tpu_torch.data.multires import MultiResolutionDataset, batch_iterator

        ds = MultiResolutionDataset(args.data_dir, resolution=g2.RESOLUTION,
                                    max_length=g2.MAX_LENGTH, seed=epoch)
        return ((imgs, fold_ids(toks, g2.BERT_VOCAB))
                for imgs, toks in batch_iterator(ds, cfg.TRAIN.BATCH_SIZE, seed=epoch))

    fixed_tokens = None
    for epoch in range(cfg.TRAIN.MAX_EPOCH):
        t0 = time.time()
        d_loss, g_loss = trainer.train_epoch(epoch_batches(epoch))
        print(f"[{epoch}/{cfg.TRAIN.MAX_EPOCH}] Loss_D: {d_loss:.4f} Loss_G: {g_loss:.4f} "
              f"Time: {time.time() - t0:.2f}s", flush=True)
        if fixed_tokens is None:
            fixed_tokens = next(iter(epoch_batches(0)))[1][:8]
        imgs = trainer.sample(fixed_tokens, seed=epoch)
        Image.fromarray(make_grid(list(imgs.numpy()), nrow=4)).save(
            os.path.join(args.output_dir, "Image", f"epoch_{epoch}.png"))
        if epoch % cfg.TRAIN.SNAPSHOT_INTERVAL == 0 and epoch != 0:
            ckpt.save(trainer.step, trainer.state_dict())
    ckpt.save(trainer.step, trainer.state_dict())
    print("done")
    return trainer


if __name__ == "__main__":
    main()
