"""DAMSM pretraining CLI (the JAX package's ``pretrain.py``): trains the text
encoder and the image projections on the words and sentence losses, with
an evaluation of at most 50 batches each epoch, the x0.98 learning-rate
decay, attention-map dumps every 50 steps, a checkpoint each
epoch, resume from the latest one, and a save on Ctrl-C.

Usage (on the card; ``--device cpu`` runs on the CPU):

    python -m sba_gan_tpu_torch.pretrain \\
        --cfg sba_gan_tpu_torch/configs/DAMSM/bird.yml --synthetic --max_epoch 1
"""

from __future__ import annotations

import argparse
import os
import pprint
import random
import statistics
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sba_gan_tpu_torch.config import cfg_from_file, default_config
from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset
from sba_gan_tpu_torch.losses.damsm import own_image_attention
from sba_gan_tpu_torch.train.damsm import DAMSMTrainer, build_damsm_models
from sba_gan_tpu_torch.utils.checkpoint import Checkpointer
from sba_gan_tpu_torch.utils.platform import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Pretrain the DAMSM encoders")
    p.add_argument("--cfg", dest="cfg_file", type=str, default=None)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--manualSeed", type=int, default=100)
    p.add_argument("--output_dir", type=str, default="")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def run_epoch(trainer, loader, log_every=50, image_dir=None, ixtoword=None,
              epoch=0):
    """One pass over ``loader``.  Returns (logs of each step as floats, host
    ms of each step, each ended by fetching its losses)."""
    logs_seen: List[Dict[str, float]] = []
    step_ms: List[float] = []
    for batch in loader:
        t0 = time.perf_counter()
        logs = trainer.train_step(batch.imgs[-1], batch.captions, batch.cap_lens,
                                  batch.class_ids)
        logs = {k: float(v) for k, v in logs.items()}
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logs_seen.append(logs)
        count = len(logs_seen)
        if count % log_every == 0:
            print(f"  step {count} | w {logs['w_loss0']:.2f} {logs['w_loss1']:.2f} "
                  f"| s {logs['s_loss0']:.2f} {logs['s_loss1']:.2f} "
                  f"| {statistics.mean(step_ms):.0f} ms/batch", flush=True)
            if image_dir is not None:
                dump_attention(trainer, batch, image_dir, ixtoword, f"{epoch}_{count}")
    return logs_seen, step_ms


@torch.no_grad()
def dump_attention(trainer, batch, image_dir, ixtoword, tag) -> str:
    """The word -> region attention of each caption over its own image, as
    an attention grid PNG (eval mode)."""
    from PIL import Image

    from sba_gan_tpu_torch.utils.viz import build_super_images

    trainer.image_encoder.eval()
    trainer.text_encoder.eval()
    region, _ = trainer.image_encoder(batch.imgs[-1])
    words_emb, _ = trainer.text_encoder(batch.captions, batch.cap_lens)
    attn = own_image_attention(region, words_emb, batch.cap_lens,
                               trainer.gammas[0]).cpu().numpy()  # (B, T, R)
    side = int(np.sqrt(attn.shape[2]))
    maps = attn[:, :, : side * side].transpose(0, 2, 1).reshape(
        attn.shape[0], side, side, attn.shape[1])
    grid = build_super_images(batch.imgs[-1].cpu().numpy(),
                              batch.captions.cpu().numpy(), ixtoword or {}, maps)
    os.makedirs(image_dir, exist_ok=True)
    path = os.path.join(image_dir, f"attn_{tag}.png")
    Image.fromarray(grid).save(path)
    return path


def evaluate(trainer, loader, max_batches=50) -> float:
    """Mean total loss over at most ``max_batches`` batches, eval mode."""
    totals = []
    for batch in loader:
        logs = trainer.eval_step(batch.imgs[-1], batch.captions, batch.cap_lens,
                                 batch.class_ids)
        totals.append(float(logs["total"]))
        if len(totals) >= max_batches:
            break
    return float(np.mean(totals)) if totals else float("nan")


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Runs the CLI; returns a summary: per epoch its step logs, step ms and
    validation loss, and the checkpoint directory."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else default_config()
    if args.data_dir:
        cfg.DATA_DIR = args.data_dir
    cfg.JAX.SEED = args.manualSeed
    random.seed(args.manualSeed)
    np.random.seed(args.manualSeed)
    torch.manual_seed(args.manualSeed)
    print("Using config:")
    pprint.pprint(cfg)

    output_dir = args.output_dir or os.path.join(
        "output", f"DAMSM_{cfg.DATASET_NAME}_{cfg.CONFIG_NAME}")
    train_ds = build_dataset(cfg, args.synthetic, "train")
    val_ds = build_dataset(cfg, args.synthetic, "test")

    models = build_damsm_models(cfg, train_ds.n_words, seed=cfg.JAX.SEED)
    trainer = DAMSMTrainer(cfg, models, device=device)
    ckpt = Checkpointer(os.path.join(output_dir, "Model"))
    latest = ckpt.latest_step()
    if latest is not None:
        trainer.load_state_dict(ckpt.restore())
        print(f"resumed from epoch {latest}")

    bs = cfg.TRAIN.BATCH_SIZE
    train_loader = DataLoader(train_ds, bs, shuffle=True, drop_last=True,
                              seed=cfg.JAX.SEED, device=device, num_workers=cfg.WORKERS)
    val_loader = DataLoader(val_ds, bs, shuffle=False, drop_last=True, device=device)

    max_epoch = args.max_epoch or cfg.TRAIN.MAX_EPOCH
    start = latest + 1 if latest is not None else 0
    summary = {"output_dir": output_dir, "resumed_from": latest, "epochs": []}
    epoch = start
    try:
        for epoch in range(start, max_epoch):
            lr = trainer.reset_optimizer(epoch)
            t0 = time.time()
            logs, step_ms = run_epoch(
                trainer, train_loader, image_dir=os.path.join(output_dir, "Image"),
                ixtoword=train_ds.ixtoword, epoch=epoch)
            val = evaluate(trainer, val_loader)
            later = step_ms[1:] or step_ms
            print(f"[{epoch}/{max_epoch}] lr {lr:.3g} | {len(logs)} steps | "
                  f"median step {statistics.median(later):.1f} ms after the first "
                  f"| last {logs[-1] if logs else {}} | val loss {val:.3f} "
                  f"| {time.time() - t0:.1f}s", flush=True)
            ckpt.save(epoch, trainer.state_dict())
            summary["epochs"].append({"epoch": epoch, "lr": lr, "logs": logs,
                                      "step_ms": step_ms, "val": val})
    except KeyboardInterrupt:
        # save under the epoch reached, so a resume goes on from the next one
        print("Ctrl-C: saving and exiting")
        ckpt.save(epoch, trainer.state_dict())
    return summary


if __name__ == "__main__":
    main()
