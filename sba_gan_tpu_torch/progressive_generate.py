"""Gen-1 progressive StyleGAN sampling CLI (the JAX package's
``progressive_generate.py``): the mean style over 10 x 1024 z draws (the
style MLP alone, ``return_w`` at rung 0), a sample grid truncated toward it
at psi ``--style_weight`` (0.7), and style-mixing grids of (n_target + 1) x
(n_source + 1) tiles: a blank (-1) and the sources in the first row, then
each target and its mixes, the target's style on blocks 0-1 (crossover 2)
and the source's after.  It reads the EMA generator of the latest
checkpoint of ``progressive_main`` (``Model/``), or samples from the init
with a warning, and writes ``sample.png`` and ``sample_mixing_{j}.png``.

The draws come from a CPU ``torch.Generator`` seeded by ``--seed``; as in
the JAX sampler, the calls of one mixing grid share one noise seed, so two
calls of one batch size see the same noise maps.

Usage (on the card; ``--device cpu`` runs on the CPU):

    python -m sba_gan_tpu_torch.progressive_generate output/progressive/Model \\
        --size 256 --n_row 3 --n_col 5 --out_dir samples/
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from sba_gan_tpu_torch.models.legacy_style import mean_style as mean_style_of
from sba_gan_tpu_torch.models.progressive import StyledGenerator
from sba_gan_tpu_torch.train.progressive import ProgressiveTrainer
from sba_gan_tpu_torch.utils.checkpoint import Checkpointer
from sba_gan_tpu_torch.utils.image import make_grid


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Progressive StyleGAN sampler")
    p.add_argument("path", help="checkpoint dir (progressive_main Model/)")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--n_row", type=int, default=3)
    p.add_argument("--n_col", type=int, default=5)
    p.add_argument("--n_mixing", type=int, default=20, help="number of style-mixing grids")
    p.add_argument("--style_weight", type=float, default=0.7)
    p.add_argument("--out_dir", default=".")
    p.add_argument("--z_dim", type=int, default=128)
    p.add_argument("--w_dim", type=int, default=512)
    p.add_argument("--fmap_max", type=int, default=512)
    p.add_argument("--max_size", type=int, default=256)
    p.add_argument("--embed_dim", type=int, default=0,
                   help="text conditioning dim (0 = unconditional, as the reference sampler)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _rows(sent_emb: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    return None if sent_emb is None else sent_emb[:1].expand(n, -1)


@torch.no_grad()
def mean_style(net: StyledGenerator, zs: Sequence[torch.Tensor],
               sent_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean of the row means of w over the draws ``zs`` (each (N, Z)),
    with the first row of ``sent_emb`` for every z; (1, W)."""
    acc = None
    for z in zs:
        z = torch.as_tensor(z).to(net.mlp_0.weight)
        w = mean_style_of(net(z, _rows(sent_emb, z.shape[0]), 0, 1.0, None, return_w=True))
        acc = w if acc is None else acc + w
    return acc / len(zs)


@torch.no_grad()
def generate(net: StyledGenerator, z: torch.Tensor, step: int, w_mean: torch.Tensor,
             style_weight: float, noise: List[torch.Tensor],
             sent_emb: Optional[torch.Tensor] = None,
             crossover: Optional[int] = None) -> np.ndarray:
    """Images (B, R, R, 3) float32 numpy at alpha 1, truncated toward
    ``w_mean``."""
    ref = net.mlp_0.weight
    z = torch.as_tensor(z).to(ref)
    b = z.shape[-2]
    img = net(z, _rows(None if sent_emb is None else sent_emb.to(ref), b), step, 1.0, noise,
              crossover=crossover, w_mean=w_mean, style_weight=style_weight)
    return img.permute(0, 2, 3, 1).float().cpu().numpy()


def style_mixing_grid(net: StyledGenerator, step: int, w_mean: torch.Tensor,
                      style_weight: float, source: torch.Tensor, target: torch.Tensor,
                      draw_noise: Callable[[int], List[torch.Tensor]],
                      sent_emb: Optional[torch.Tensor] = None) -> np.ndarray:
    """(n_target + 1) (n_source + 1) images: [blank, sources], then per
    target [target, its mixes]; ``draw_noise(batch)`` gives each call's
    noise maps."""
    def gen(z, crossover=None):
        return generate(net, z, step, w_mean, style_weight, draw_noise(z.shape[-2]), sent_emb,
                        crossover)
    shape = 4 * 2 ** step
    rows = [np.full((1, shape, shape, 3), -1.0, np.float32), gen(source)]
    target_imgs = gen(target)
    for i in range(target.shape[0]):
        z_pair = torch.stack([target[i].expand_as(source), source])
        rows.append(target_imgs[i:i + 1])
        rows.append(gen(z_pair, crossover=2))  # blocks 0-1 take the target's style
    return np.concatenate(rows, axis=0)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    ckpt = Checkpointer(args.path)
    found = ckpt.latest_step() is not None
    trainer = ProgressiveTrainer(z_dim=args.z_dim, w_dim=args.w_dim,
                                 max_resolution=args.max_size, fmap_max=args.fmap_max,
                                 embed_dim=args.embed_dim or None, device=args.device,
                                 seed=args.seed, init=not found)
    if found:
        trainer.load_state_dict(ckpt.restore())
        print(f"loaded step {trainer.step}")
    else:
        print("warning: no checkpoint found, sampling from init")
    net = trainer.g_ema  # the reference's g_running
    gen = torch.Generator().manual_seed(args.seed)
    sent = (torch.zeros((1, args.embed_dim), device=trainer.device, dtype=trainer.dtype)
            if args.embed_dim else None)
    w_mean = mean_style(net, [torch.randn((1024, args.z_dim), generator=gen)
                              for _ in range(10)], sent)
    step = int(math.log2(args.size)) - 2

    n = args.n_row * args.n_col
    img = generate(net, torch.randn((n, args.z_dim), generator=gen), step, w_mean,
                   args.style_weight, net.draw_noise(n, step, gen), sent)
    Image.fromarray(make_grid(list(img), nrow=args.n_col)).save(
        os.path.join(args.out_dir, "sample.png"))

    for j in range(args.n_mixing):
        source = torch.randn((args.n_col, args.z_dim), generator=gen)
        target = torch.randn((args.n_row, args.z_dim), generator=gen)
        noise_seed = int(torch.randint(2 ** 62, (), generator=gen))
        imgs = style_mixing_grid(
            net, step, w_mean, args.style_weight, source, target,
            lambda b: net.draw_noise(b, step, torch.Generator().manual_seed(noise_seed)), sent)
        Image.fromarray(make_grid(list(imgs), nrow=args.n_col + 1)).save(
            os.path.join(args.out_dir, f"sample_mixing_{j}.png"))
    print("done")


if __name__ == "__main__":
    main()
