"""Gen-1 progressive StyleGAN training CLI (the JAX package's
``progressive_main.py``): the resolution schedule with its alpha fade-in
(``--init_size`` to ``--max_size``, ``--phase`` samples a rung), WGAN-GP or
R1 (``--loss``), a G update after every ``--n_critic``-th D update, style
mixing, the EMA, sample grids of the EMA generator every
``--sample_every`` steps (``Image/sample_N.png``), an Inception Score every
``--eval_is_every`` steps, and checkpoints (``Model/epoch_N.pt``, N the D
step count: the weights, the EMA, both Adams' counts, rates and moments)
every ``--ckpt_every`` steps and at the end, with ``Model/used_samples.txt``
beside them so that a resumed run keeps the pacing exact.

The pacing follows the samples consumed (each rung's batch under
``--sched``, which also sets both learning rates from ``SCHED_LR``: D then
trains at G's rate, as the JAX CLI does).  Reals larger than the rung are
shrunk by the antialiased bilinear resize (``jax.image.resize``'s
'bilinear').  ``--conditional`` feeds the sentence embedding of the bi-LSTM
text encoder at random init (its vocabulary the data set's, or BERT's
30,522 wordpiece ids with ``--pack``).

Data: ``--synthetic``, a CUB tree (``--data_dir``), or a multi-resolution
pack (``--pack``, from ``python -m sba_gan_tpu_torch.prepare_data``) read at
each rung's resolution.

Usage (on the card; ``--device cpu`` runs on the CPU):

    python -m sba_gan_tpu_torch.progressive_main --synthetic --steps 200 \\
        --max_size 64 --batch 16 --loss wgan-gp
"""

from __future__ import annotations

import argparse
import os
import time
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from sba_gan_tpu_torch.models.legacy_style import progressive_schedule_samples
from sba_gan_tpu_torch.train.progressive import ProgressiveTrainer
from sba_gan_tpu_torch.utils.checkpoint import Checkpointer
from sba_gan_tpu_torch.utils.image import make_grid

# per-resolution schedules (the reference's train.py:450-456)
SCHED_LR = {4: 1e-3, 8: 1e-3, 16: 5e-4, 32: 1e-4, 64: 1e-4, 128: 1e-4, 256: 1e-4}
SCHED_BATCH = {4: 64, 8: 64, 16: 64, 32: 32, 64: 32, 128: 16, 256: 16}
SCHED_BATCH_DEFAULT = 32
PACK_N_WORDS = 30522  # BERT's wordpiece ids, the pack's captions


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Progressive StyleGAN trainer")
    p.add_argument("--data_dir", default="")
    p.add_argument("--pack", default="", help="multi-resolution pack dir, read per rung")
    p.add_argument("--output_dir", default="output/progressive")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--loss", choices=["wgan-gp", "r1"], default="wgan-gp")
    p.add_argument("--init_size", type=int, default=8)
    p.add_argument("--max_size", type=int, default=256)
    p.add_argument("--phase", type=int, default=600_000, help="samples per resolution phase")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--d_lr_mult", type=float, default=4.0, help="D lr multiplier")
    p.add_argument("--sched", action="store_true", help="per-resolution lr/batch schedule")
    p.add_argument("--n_critic", type=int, default=1)
    p.add_argument("--mixing", type=float, default=0.9)
    p.add_argument("--z_dim", type=int, default=128)
    p.add_argument("--w_dim", type=int, default=512)
    p.add_argument("--fmap_max", type=int, default=512)
    p.add_argument("--batch_cap", type=int, default=0,
                   help="cap scheduled batch sizes (0 = no cap); for smoke-scale runs of --sched")
    p.add_argument("--conditional", action="store_true")
    p.add_argument("--embed_dim", type=int, default=256)
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--sample_every", type=int, default=1000)
    p.add_argument("--ckpt_every", type=int, default=10_000)
    p.add_argument("--eval_is_every", type=int, default=0,
                   help="Inception Score every N steps (0: off); a random-init classifier "
                        "unless --inception_weights names torchvision's .pth")
    p.add_argument("--inception_weights", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def scheduled_batch(args, res: int) -> int:
    batch = SCHED_BATCH.get(res, SCHED_BATCH_DEFAULT)
    return min(batch, args.batch_cap) if args.batch_cap else batch


def build_data(args):
    if args.pack:
        return None  # pack mode reads each rung's images
    if args.synthetic:
        from sba_gan_tpu_torch.data.cub import SyntheticDataset

        return SyntheticDataset(num_examples=max(4 * args.batch, 64), base_size=args.max_size,
                                branch_num=1, words_num=16, seed=args.seed)
    from sba_gan_tpu_torch.data.cub import TextImageDataset

    return TextImageDataset(args.data_dir, split="train", base_size=args.max_size,
                            branch_num=1)


def make_loader(args, dataset, batch_size: int, res: int):
    """Batches with ``imgs`` (a tuple ending in the NHWC reals), ``captions``
    and ``cap_lens``, without end."""
    if not args.pack:
        from sba_gan_tpu_torch.data.pipeline import DataLoader

        loader = DataLoader(dataset, batch_size, shuffle=True, drop_last=True, seed=args.seed)
        while True:
            yield from loader
    from sba_gan_tpu_torch.data.multires import MultiResolutionDataset, batch_iterator

    ds = MultiResolutionDataset(args.pack, resolution=res, max_length=24, seed=args.seed)
    epoch = 0
    while True:
        for imgs, toks in batch_iterator(ds, batch_size, seed=args.seed + epoch):
            lens = np.maximum((toks != 0).sum(axis=1), 1)
            yield SimpleNamespace(imgs=(imgs,), captions=torch.from_numpy(toks).long(),
                                  cap_lens=torch.from_numpy(lens).long())
        epoch += 1


def resize_reals(real: torch.Tensor, res: int) -> torch.Tensor:
    """(B, S, S, 3) -> (B, res, res, 3) by the bilinear resize that
    antialiases when it shrinks (``jax.image.resize(..., 'bilinear')``)."""
    x = F.interpolate(real.permute(0, 3, 1, 2), size=(res, res), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def _write_used_samples(path: str, used: int) -> None:
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(str(used))
    except OSError:
        pass


def main(argv: Optional[Sequence[str]] = None) -> ProgressiveTrainer:
    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    trainer = ProgressiveTrainer(
        z_dim=args.z_dim, w_dim=args.w_dim, max_resolution=args.max_size,
        fmap_max=args.fmap_max, loss_mode=args.loss, lr=args.lr, d_lr_mult=args.d_lr_mult,
        mixing_prob=args.mixing,
        embed_dim=args.embed_dim if args.conditional else None, device=args.device,
        seed=args.seed)
    dev = trainer.device
    ckpt = Checkpointer(os.path.join(args.output_dir, "Model"))
    if ckpt.latest_step() is not None:
        trainer.load_state_dict(ckpt.restore())
        print(f"resumed at step {trainer.step}")

    dataset = build_data(args)
    text_encoder = None
    if args.conditional:
        from sba_gan_tpu_torch.config import cfg_from_dict
        from sba_gan_tpu_torch.train.sample import build_text_encoder, init_text_weights

        n_words = PACK_N_WORDS if args.pack else getattr(dataset, "n_words",
                                                         len(dataset.ixtoword))
        text_encoder = build_text_encoder(
            cfg_from_dict({"TEXT": {"EMBEDDING_DIM": args.embed_dim}}), n_words)
        init_text_weights(text_encoder, torch.Generator().manual_seed(args.seed))
        text_encoder = text_encoder.to(dev).eval()

    is_predict = None
    if args.eval_is_every:
        from sba_gan_tpu_torch.evaluation.inception_score import (
            build_classifier,
            inception_score,
            make_predict_fn,
        )

        is_predict = make_predict_fn(build_classifier(299, args.inception_weights), dev)

    gstep = trainer.step
    used_path = os.path.join(args.output_dir, "Model", "used_samples.txt")
    used_samples = gstep * args.batch
    if gstep and os.path.isfile(used_path):
        try:
            with open(used_path) as f:
                used_samples = int(f.read().strip())
        except (ValueError, OSError):
            pass
    cur_res, _ = progressive_schedule_samples(used_samples, args.phase, args.init_size,
                                              args.max_size)
    cur_batch = args.batch
    if args.sched:
        trainer.with_lr(SCHED_LR.get(cur_res, 1e-4), SCHED_LR.get(cur_res, 4e-4))
        cur_batch = scheduled_batch(args, cur_res)
    data_iter = make_loader(args, dataset, cur_batch, cur_res)

    t0 = time.time()
    g_loss = float("nan")  # no G update yet (n_critic schedule)
    n_blocks = trainer.n_blocks()
    while gstep < args.steps:
        res, alpha = progressive_schedule_samples(used_samples, args.phase, args.init_size,
                                                  args.max_size)
        res_step = min(int(np.log2(res // 4)), n_blocks - 1)
        if res != cur_res:  # phase switch: retune the rates and the batch
            new_batch = cur_batch
            if args.sched:
                trainer.with_lr(SCHED_LR.get(res, 1e-4), SCHED_LR.get(res, 4e-4))
                new_batch = scheduled_batch(args, res)
            if args.pack or new_batch != cur_batch:
                cur_batch = new_batch
                data_iter = make_loader(args, dataset, cur_batch, res)
            if args.sched:
                print(f"phase switch -> res {res}, batch {cur_batch}, "
                      f"g_lr {SCHED_LR.get(res, 1e-4)}", flush=True)
        cur_res = res
        batch = next(data_iter)
        real = torch.as_tensor(batch.imgs[-1]).to(dev)
        if real.shape[1] != res:
            real = resize_reals(real, res)
        sent = None
        if text_encoder is not None:
            with torch.no_grad():
                _, sent = text_encoder(batch.captions.to(dev), batch.cap_lens)
        d_loss = trainer.d_step(real, sent, alpha, res_step)
        gstep = trainer.step
        used_samples += int(real.shape[0])
        if gstep % args.n_critic == 0:
            g_loss = trainer.g_step(real.shape[0], sent, alpha, res_step)
        if gstep % 100 == 0:
            print(f"step {gstep} res {res} alpha {alpha:.2f} d {float(d_loss):.3f} "
                  f"g {float(g_loss):.3f} ({(time.time() - t0):.0f}s)", flush=True)
        if gstep % args.sample_every == 0:
            nb = min(8, cur_batch) if sent is not None else 8
            imgs = trainer.sample(nb, res_step, None if sent is None else sent[:nb],
                                  alpha=alpha, seed=gstep)
            os.makedirs(os.path.join(args.output_dir, "Image"), exist_ok=True)
            Image.fromarray(make_grid(list(imgs.numpy()), nrow=4)).save(
                os.path.join(args.output_dir, "Image", f"sample_{gstep}.png"))
        if is_predict is not None and gstep % args.eval_is_every == 0:
            nb = min(16, args.batch, len(sent) if sent is not None else 16)
            imgs = [im for i in range(4) for im in trainer.sample(
                nb, res_step, None if sent is None else sent[:nb], alpha=alpha,
                seed=gstep + i).numpy()]
            mean, std = inception_score(imgs, is_predict, batch_size=16, splits=4)
            print(f"step {gstep} inception score {mean:.3f} +- {std:.3f}", flush=True)
        if gstep % args.ckpt_every == 0:
            ckpt.save(gstep, trainer.state_dict())
            _write_used_samples(used_path, used_samples)
    ckpt.save(gstep, trainer.state_dict())
    _write_used_samples(used_path, used_samples)
    print("done")
    return trainer


if __name__ == "__main__":
    main()
