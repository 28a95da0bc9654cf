"""How far bfloat16 compute moves the image gradient through Inception-v3.

    python3 scripts/torch_bf16_grad_noise.py [--device cpu|cuda]

The port's ``CNNEncoder`` at full width (299 x 299, random weights and
running statistics from a seed, eval mode) takes a batch of two images; a
fixed random cotangent on the output of the first k trunk blocks (k = 1, 2,
3, 5, 8, 13: the stem to Mixed_6e) is pulled back to the images in
float32 and in bfloat16 compute, each against float64.  Prints one JSON
line per depth: |out - out64| / |out64| of the block's output and of the
image gradient.  The rounding moves the forward output by a fraction of a
percent, but flips ReLU kinks whose cotangents then drop in or out, so the
image gradient drifts much further with depth; this is the reading behind
the DAMSM image-gradient bound of ``chip_smoke.py``'s bfloat16 GAN step.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sba_gan_tpu_torch.models.inception import (  # noqa: E402
    TRUNK,
    CNNEncoder,
    init_weights,
    max_pool_3x3_s2,
)
from sba_gan_tpu_torch.models.layers import set_compute_dtype  # noqa: E402

DEPTHS = (1, 2, 3, 5, 8, 13)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    gen = torch.Generator().manual_seed(0)
    enc = CNNEncoder(256, 299)
    init_weights(enc, gen)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(0.5 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    images = torch.rand((2, 3, 299, 299), generator=gen) * 2 - 1

    def run(depth, kind):
        e = copy.deepcopy(enc).eval()
        dtype = torch.float64 if kind == "float64" else torch.float32
        e = e.to(dev, dtype)
        if kind == "bfloat16":
            set_compute_dtype(e, torch.bfloat16)
        x = images.to(dev, dtype).detach().requires_grad_(True)
        h = x
        for name in TRUNK[:depth]:
            h = getattr(e, name)(h)
            if name in ("Conv2d_2b_3x3", "Conv2d_4a_3x3"):
                h = max_pool_3x3_s2(h)
        cot = torch.randn(h.shape, generator=torch.Generator().manual_seed(depth))
        (h * cot.to(dev, h.dtype)).sum().backward()
        return h.detach().cpu(), x.grad.cpu()

    with torch.backends.cudnn.flags(allow_tf32=False):
        for depth in DEPTHS:
            out64, g64 = run(depth, "float64")
            row = {"device": str(dev), "depth": depth, "block": TRUNK[depth - 1]}
            for kind in ("float32", "bfloat16"):
                out, g = run(depth, kind)
                row[kind] = {"output": _rel(out, out64), "image_grad": _rel(g, g64)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
