"""Where the card's time goes in one DAMSM pretraining step of the PyTorch port.

    python3 scripts/torch_pretrain_profile.py [--iters 50] [--batch 32] [--n_words 5450]

Builds the full-width ``configs/DAMSM/bird.yml`` models of
``sba_gan_tpu_torch`` (Inception-v3 at 299^2, EMBEDDING_DIM 256, WORDS_NUM
20, vocabulary ``--n_words``: 5450 is CUB's, 300 the CLI's synthetic set's;
random weights from seed 0) and one synthetic batch on the card, warms up,
times ``--iters`` train steps without the profiler (each ended by fetching
its loss), then traces as many with ``torch.profiler``.  Prints one JSON
line: wall ms per step untraced (mean, median, min, max and each step's)
and traced, the summed device time of the kernels per step, the device's idle
share over the traced window, kernel launches per step, the time of the
three DAMSM-similarity kernels, and the kernels that took the most device
time.  TF32 stays at PyTorch's defaults, as the CLI runs.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_WORDS = 5450


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--n_words", type=int, default=N_WORDS)
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sba_gan_tpu_torch.config import preset
    from sba_gan_tpu_torch.data.cub import SyntheticDataset
    from sba_gan_tpu_torch.data.pipeline import collate
    from sba_gan_tpu_torch.ops import damsm_sim as dsim
    from sba_gan_tpu_torch.train.damsm import DAMSMTrainer, build_damsm_models

    cfg = preset("DAMSM/bird")
    cfg.TRAIN.BATCH_SIZE = args.batch
    trainer = DAMSMTrainer(cfg, build_damsm_models(cfg, args.n_words, seed=0), device="cuda")
    ds = SyntheticDataset(num_examples=args.batch, base_size=cfg.TREE.BASE_SIZE,
                          branch_num=cfg.TREE.BRANCH_NUM, words_num=cfg.TEXT.WORDS_NUM,
                          n_words=args.n_words, seed=0)
    batch = collate([ds[i] for i in range(args.batch)], "cuda")

    def step():
        logs = trainer.train_step(batch.imgs[-1], batch.captions, batch.cap_lens,
                                  batch.class_ids)
        return float(logs["total"])

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    untraced_ms = statistics.mean(step_ms)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device-side events only (kernels and copies)
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels) / args.iters
    top = sorted(kernels, key=_device_us, reverse=True)[: args.top]
    damsm = {e.key: _device_us(e) / 1e3 / args.iters for e in kernels
             if "damsm_" in e.key or "sum_splits" in e.key}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "batch": args.batch,
        "n_words": args.n_words,
        "iters": args.iters,
        "wall_ms_per_step_untraced": untraced_ms,
        "wall_ms_untraced_median": statistics.median(step_ms),
        "wall_ms_untraced_min": min(step_ms),
        "wall_ms_untraced_max": max(step_ms),
        "wall_ms_untraced_steps": step_ms,
        "wall_ms_per_step_traced": wall_ms / args.iters,
        "device_ms_per_step": device_ms / args.iters,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "device_launches_per_step": launches,
        "images_per_s_untraced": args.batch * 1e3 / untraced_ms,
        "images_per_s_untraced_median": args.batch * 1e3 / statistics.median(step_ms),
        "damsm_kernels_ms_per_step": damsm,
        "damsm_launch_counts": {"fwd": dsim.damsm_sim_fwd.launches,
                                "dimg": dsim.damsm_sim_dimg.launches,
                                "dwords": dsim.damsm_sim_dwords.launches},
        "top_kernels": [{"name": e.key[:90], "calls": e.count / args.iters,
                         "device_ms": _device_us(e) / 1e3 / args.iters}
                        for e in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
