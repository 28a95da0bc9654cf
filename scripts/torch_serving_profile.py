"""Where the card's time goes in one text->image generation of the PyTorch port.

    python3 scripts/torch_serving_profile.py [--batch 1] [--iters 5]

Builds the full-width ``eval_bird`` models of ``sba_gan_tpu_torch``
(vocabulary 5450, random weights from seed 0), warms up, then traces
``--iters`` generations (text encoder + generator + the ``.cpu()`` fetch)
with ``torch.profiler``.  Prints one JSON line with the wall time per
generation, the summed device time of the kernels, the device's idle share
over the traced window, and the kernels that took the most device time.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sba_gan_tpu_torch.config import preset
    from sba_gan_tpu_torch.data.vocab import encode_free_text, synthetic_vocab
    from sba_gan_tpu_torch.ops import word_attention as wa
    from sba_gan_tpu_torch.train.sample import Sampler

    cfg = preset("eval_bird")
    wordtoix, _ = synthetic_vocab(5450)
    sampler = Sampler.from_config(cfg, 5450, seed=0, device="cuda")
    ids, lens = encode_free_text(
        ["w17 w4031 w9 w250 w77 w3 w1200 w88 w5 w13 w402 w6"] * args.batch,
        wordtoix, cfg.TEXT.WORDS_NUM)
    for _ in range(3):
        sampler(ids, lens, 0)
    torch.cuda.synchronize()

    wa.word_attention.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.iters):
            sampler(ids, lens, i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = wa.word_attention.launches

    # device-side events only (kernels and copies); a CPU op's device time
    # is already counted in the kernels it launched
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[: args.top]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "batch": args.batch,
        "iters": args.iters,
        "wall_ms_per_generation": wall_ms / args.iters,
        "device_ms_per_generation": device_ms / args.iters,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "word_attention_launches": launches,
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "device_ms": _device_us(e) / 1e3 / args.iters}
                        for e in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
