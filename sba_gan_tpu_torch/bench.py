"""Bench of the port's flagship GAN train step on one card.

    python -m sba_gan_tpu_torch.bench [--device cuda] [--dtype float32|bfloat16]
        [--batch B] [--grad_accum K --accum_mode window|dfresh]
        [--steps S --profiled P]
    torchrun --standalone --nproc_per_node N -m sba_gan_tpu_torch.bench

The workload of the JAX package's ``bench.py``: bird_style at BRANCH_NUM 3
(64/128/256 images), GF_DIM 32, DF_DIM 64, Z_DIM 100, R_NUM 2,
EMBEDDING_DIM 256, WORDS_NUM 18, gammas 4/5/10, lambda 5, Inception at
299, the CUB vocabulary of 5450 words, batch 128; random weights from
``SEED``, one fixed batch made on the card.  ``--dtype`` sets ``JAX.DTYPE``
and ``JAX.LOSS_DTYPE`` together: float32 (the default; TF32 at PyTorch's
defaults, stated in the line) or bfloat16, the JAX package's accelerator
setting (its ``bench.py`` on the TPU), in which the convolutions, linears
and K4 compute in bfloat16 and K1/K2 round their products' operands to
bfloat16, with float32 parameters, statistics and losses.  The line names
the dtype and what precision each part ran at.  It warms up for ``WARMUP`` steps, then
times one window of ``STEPS`` steps queued back to back and closed by one
host read of the last step's ``errG`` (which depends on all of the step's
work): images/s is ``STEPS * batch`` over that window.  CUDA events between
the steps give each step's device-timeline ms (median and spread) without
fencing it.  Then it traces ``PROFILE_STEPS`` steps with ``torch.profiler``
(device time, launches, idle share, time by kernel), times the phases of as
many steps with CUDA events and the G and Inception passes alone, and
counts one step's matmul and convolution
FLOPs with ``FlopCounterMode``, plus those of the hand-written kernels,
which it cannot see.  A batch that does not fit is reported with the peak
memory it reached, and the next smaller one is timed.

``--grad_accum K`` runs ``TRAIN.GRAD_ACCUM`` K in ``--accum_mode`` (a step
is a micro-step; K micro-steps of B make one update of K B).  Under
``torchrun`` each rank runs its rows of the global batch B
(:mod:`parallel.dist`); rank 0 prints the line, with images/s over the
global batch, the rank count and the collectives' device ms a step (the
NCCL kernels in the profile).

Prints one JSON line, ``{"metric": "gan_train_step_images_per_sec_256px_h100",
"value": ..., "unit": "images/sec", ...}``.  Without CUDA it raises;
``--device cpu`` runs a tiny-width smoke of the same code on the CPU, whose
line carries no device metric.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import statistics
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.parallel import dist
from sba_gan_tpu_torch.train.gan import GANModels, GANStep, build_models, init_gan_state

FLAGSHIP = {
    "TREE": {"BRANCH_NUM": 3, "BASE_SIZE": 64},
    "GAN": {"GF_DIM": 32, "DF_DIM": 64, "Z_DIM": 100, "R_NUM": 2},
    "TEXT": {"EMBEDDING_DIM": 256, "WORDS_NUM": 18},
    "TRAIN": {"BATCH_SIZE": 128,
              "SMOOTH": {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0, "LAMBDA": 5.0}},
}
TINY = {  # the --device cpu smoke
    "TREE": {"BRANCH_NUM": 2, "BASE_SIZE": 64},
    "GAN": {"GF_DIM": 8, "DF_DIM": 8, "Z_DIM": 8, "W_DIM": 16, "CONDITION_DIM": 8,
            "R_NUM": 1},
    "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 6},
    "MODEL": {"INCEPTION_INPUT": 75},
    "TRAIN": {"BATCH_SIZE": 4,
              "SMOOTH": {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0, "LAMBDA": 5.0}},
}
N_WORDS = 5450  # the CUB vocabulary
REGIONS = 289  # 17 x 17 Inception regions
TF32_FLOPS_PER_S = 495e12  # H100 SXM, dense
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense
FP32_FLOPS_PER_S = 67e12
FALLBACK_BATCHES = (96, 64, 32)
STEPS = 20  # the timed window
WARMUP = 3
PROFILE_STEPS = 3
SEED = 0


def make_batch(cfg, batch: int, device, seed: int):
    """Images in [-1, 1] per branch, captions of 4..WORDS_NUM words, 20
    classes; all on ``device`` except the lengths (the CPU, as the data
    pipeline keeps them).  Across ranks, this rank's rows of the global
    batch ``batch``."""
    t = cfg.TEXT.WORDS_NUM
    gen = torch.Generator().manual_seed(seed)
    cap_lens = torch.randint(4, t + 1, (batch,), generator=gen)
    words = torch.randint(1, N_WORDS, (batch, t), generator=gen)
    captions = torch.where(torch.arange(t)[None, :] < cap_lens[:, None], words, 0)
    class_ids = torch.randint(0, 20, (batch,), generator=gen)
    dev_gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [cfg.TREE.BASE_SIZE * 2 ** i for i in range(cfg.TREE.BRANCH_NUM)]
    imgs = tuple(torch.rand((batch, s, s, 3), generator=dev_gen, device=device) * 2 - 1
                 for s in sizes)
    mine = dist.rows(dist.local_batch_size(batch, dist.world_size()))
    return (tuple(i[mine] for i in imgs), captions[mine].to(device), cap_lens[mine],
            class_ids[mine].to(device))


def custom_kernel_flops(cfg, batch: int, cap_lens: torch.Tensor) -> Dict[str, float]:
    """FLOPs of the hand-written kernels in one step, which FlopCounterMode
    does not see: K4 forward at both refinement stages (4 QL T D a text),
    K1 (4 L R D a pair over the real words) and K2 (10 L R D)."""
    d_attn, t, nef = cfg.GAN.GF_DIM, cfg.TEXT.WORDS_NUM, cfg.TEXT.EMBEDDING_DIM
    base = cfg.TREE.BASE_SIZE
    k4 = sum(4 * batch * (base * 2 ** i) ** 2 * t * d_attn
             for i in range(cfg.TREE.BRANCH_NUM - 1))
    pairs = batch * int(cap_lens.sum()) * REGIONS * nef
    return {"word_attention": float(k4), "damsm_sim_fwd": 4.0 * pairs,
            "damsm_sim_dimg": 10.0 * pairs}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_events(events) -> Tuple[list, list]:
    """The device-side entries of a profile's ``key_averages()``: (kernels
    and copies, user-annotation ranges).  The ranges (``record_function``;
    each optimizer's ``Optimizer.step#Adam.step``) lie on the device's
    timeline over the kernels they enclose, so device time and launches sum
    the first list only."""
    from torch.autograd import DeviceType

    device = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    ranges = [e for e in device if getattr(e, "is_user_annotation", False)]
    return [e for e in device if e not in ranges], ranges


# a part of each kernel's name on the device's timeline; "word_attention_fwd"
# begins the name of every K4 instance (word_attention_fwd_kernel for D 32
# and the generic one, word_attention_fwd_wide_kernel for D 48)
KERNEL_NAMES = {"word_attention": "word_attention_fwd",
                "damsm_sim_fwd": "damsm_sim_fwd_kernel",
                "damsm_sim_dimg": "damsm_sim_dimg_kernel",
                "damsm_sim_dwords": "damsm_dwords_kernel"}


def profile_steps(step, args_, steps: int) -> Dict:
    """Device time, launches, idle share and the kernels by time over
    ``steps`` traced steps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logs = step(*args_)
        float(logs["errG"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, ranges = device_events(prof.key_averages())
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    named = {}
    for short, kname in KERNEL_NAMES.items():
        hits = [e for e in kernels if kname in e.key]
        named[short] = {"device_ms_per_step": sum(_device_us(e) for e in hits) / 1e3 / steps,
                        "launches_per_step": sum(e.count for e in hits) / steps}
    top = sorted(kernels, key=_device_us, reverse=True)[:25]
    return {
        "traced_steps": steps,
        "wall_ms_per_step_traced": wall_ms / steps,
        "device_ms_per_step": device_ms / steps,
        "annotated_ranges_ms_per_step": {e.key: _device_us(e) / 1e3 / steps for e in ranges},
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "launches_per_step": sum(e.count for e in kernels) / steps,
        "collective_device_ms_per_step": sum(_device_us(e) for e in nccl) / 1e3 / steps,
        "collective_launches_per_step": sum(e.count for e in nccl) / steps,
        "hand_written_kernels": named,
        "top_kernels": [{"name": e.key[:100], "calls_per_step": e.count / steps,
                         "device_ms_per_step": _device_us(e) / 1e3 / steps} for e in top],
    }


def phase_ms(step, args_, steps: int) -> Dict[str, float]:
    """Device-timeline ms of each phase of the step (CUDA events at the
    step's marks), averaged over ``steps`` steps."""
    totals: Dict[str, float] = {}
    for _ in range(steps):
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        step(*args_, mark=mark)
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(marks, marks[1:]):
            totals[name] = totals.get(name, 0.0) + a.elapsed_time(b) / steps
    return totals


def _device_ms(fn, repeats: int) -> float:
    """Device ms of one call of ``fn`` (CUDA events over ``repeats`` calls
    after one more to warm up)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def component_ms(step, args_, repeats: int) -> Dict[str, float]:
    """Device ms of the step's largest parts alone, on its batch, which the
    phase marks cannot split out of the G backward: G's forward (train
    mode, running statistics frozen) and its backward from unit-normal
    cotangents on the three images; the frozen Inception encoder's forward
    on the final images and its backward to them."""
    from sba_gan_tpu_torch.models.norms import frozen_running_stats

    s = step.state
    imgs, captions, cap_lens, _ = args_
    z, eps = step.draw_noise(captions.shape[0])
    with torch.no_grad():
        words, sent = s.text_encoder(captions, cap_lens)
    pad = captions == 0
    params = list(s.generator.parameters())
    out: Dict[str, float] = {}
    with frozen_running_stats(s.generator):
        out["g_forward"] = _device_ms(
            lambda: s.generator.forward_nchw(z, sent, words, pad, eps), repeats)
        fakes = s.generator.forward_nchw(z, sent, words, pad, eps)[0]
        cots = [torch.randn_like(f) for f in fakes]
        out["g_backward"] = _device_ms(lambda: torch.autograd.grad(
            fakes, params, cots, retain_graph=True), repeats)
        del fakes
    x = imgs[-1].clone().requires_grad_(True)
    out["inception_forward"] = _device_ms(lambda: s.image_encoder(x), repeats)
    region, code = s.image_encoder(x)
    cots = (torch.randn_like(region), torch.randn_like(code))
    out["inception_backward"] = _device_ms(lambda: torch.autograd.grad(
        (region, code), x, cots, retain_graph=True), repeats)
    return out


def run(cfg, batch: int, device, detail: bool = True, steps: int = STEPS,
        profiled: int = PROFILE_STEPS, models: Optional[GANModels] = None) -> Dict:
    """The step at global batch ``batch``: the timed window of ``steps``
    steps and the profile of ``profiled``; with ``detail`` also the phases,
    the G and Inception passes alone and the FLOP count (and mfu).  The
    networks are a copy of ``models``, else drawn from ``SEED``."""
    cfg = copy.deepcopy(cfg)
    cfg.TRAIN.BATCH_SIZE = batch
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    models = build_models(cfg, N_WORDS, seed=SEED) if models is None else copy.deepcopy(models)
    state = init_gan_state(cfg, models, device)
    step = GANStep(cfg, state, seed=SEED)
    args_ = make_batch(cfg, batch, device, SEED)
    t0 = time.perf_counter()
    for _ in range(WARMUP):
        logs = step(*args_)
    float(logs["errG"])
    warmup_s = time.perf_counter() - t0
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)] if cuda else []
    t0 = time.perf_counter()
    for i in range(steps):
        if cuda:
            marks[i].record()
        logs = step(*args_)
    if cuda:
        marks[-1].record()
    float(logs["errG"])  # closes the window: errG depends on all of the step's work
    window_s = time.perf_counter() - t0
    out = {"batch": batch, "ranks": dist.world_size(), "grad_accum": cfg.TRAIN.GRAD_ACCUM,
           "accum_mode": cfg.TRAIN.GRAD_ACCUM_MODE, "steps": steps, "warmup": WARMUP,
           "warmup_s": warmup_s, "window_s": window_s, "ms_per_step": window_s * 1e3 / steps,
           "images_per_sec": steps * batch / window_s}
    if cuda:  # each step's span on the device's timeline, between its events
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        out.update(step_ms_median=statistics.median(step_ms), step_ms_min=min(step_ms),
                   step_ms_max=max(step_ms), step_ms_stdev=statistics.stdev(step_ms),
                   step_ms=step_ms)
    values = {k: float(v) for k, v in logs.items()}
    out.update(last_logs=values,
               finite=all(v == v and abs(v) != float("inf") for v in values.values()))
    if cuda:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        out["profile"] = profile_steps(step, args_, profiled)
    if not detail:
        return out
    if cuda:
        out["phase_device_ms"] = phase_ms(step, args_, profiled)
        out["component_device_ms"] = component_ms(step, args_, profiled)
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        float(step(*args_)["errG"])
    custom = custom_kernel_flops(cfg, args_[1].shape[0], args_[2])
    flops = counter.get_total_flops() + sum(custom.values())
    out.update(flops_per_step=flops, flop_counter_flops=counter.get_total_flops(),
               hand_written_kernel_flops=custom)
    if cuda:
        seconds = window_s / steps
        if cfg.JAX.DTYPE == "bfloat16":
            peak, name = BF16_FLOPS_PER_S, "bf16 (H100 SXM dense peak)"
        else:
            peak, name = TF32_FLOPS_PER_S, ("tf32 (H100 SXM dense peak; convolutions run "
                                            "TF32 when cudnn.allow_tf32)")
        out.update(mfu=flops / seconds / peak, mfu_peak_flops_per_s=peak,
                   mfu_precision=name,
                   share_of_fp32_peak=flops / seconds / FP32_FLOPS_PER_S)
    return out


def precision(cfg) -> Dict[str, str]:
    """What precision each part of the step runs at under ``cfg``."""
    if cfg.JAX.DTYPE == "bfloat16":
        layers = "bfloat16 (float32 parameters cast at the call)"
        k4 = "bfloat16 q and s, float32 scores and softmax, P rounded to bfloat16"
    else:
        layers = ("float32; convolutions TF32 when cudnn.allow_tf32, linears TF32 when "
                  "cuda.matmul.allow_tf32")
        k4 = "float32"
    sim = ("bfloat16 operands, float32 accumulation" if cfg.JAX.LOSS_DTYPE == "bfloat16"
           else "float32 (3xTF32)")
    return {"convolutions_and_linears": layers,
            "batchnorm_instance_norm": "float32 statistics and normalization",
            "word_attention_k4": k4, "damsm_products_k1_k2": sim,
            "losses": "float32", "parameters_adam_ema": "float32"}


def measure(cfg, batch: int, device, detail: bool = True, steps: int = STEPS,
            profiled: int = PROFILE_STEPS, models: Optional[GANModels] = None) -> Dict:
    """:func:`run` at ``batch`` (``steps`` timed, ``profiled`` traced, on a
    copy of ``models`` if given); on running out of card memory, the peak it
    reached is recorded and the next smaller batch of FALLBACK_BATCHES
    runs."""
    oom = []
    for b in (batch,) + tuple(x for x in FALLBACK_BATCHES if x < batch):
        try:
            result = run(cfg, b, device, detail, steps, profiled, models)
        except torch.cuda.OutOfMemoryError as e:
            oom.append({"batch": b, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                        "error": str(e).splitlines()[0]})
        else:
            result["out_of_memory"] = oom
            return result
        gc.collect()  # the failed run's frames are gone once the handler has ended
        torch.cuda.empty_cache()
    raise RuntimeError(f"no batch fits: {oom}")


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="JAX.DTYPE and JAX.LOSS_DTYPE")
    p.add_argument("--batch", type=int, default=None,
                   help="the global batch (default 128; 4 with --device cpu)")
    p.add_argument("--grad_accum", type=int, default=1, help="TRAIN.GRAD_ACCUM")
    p.add_argument("--accum_mode", choices=("window", "dfresh"), default="window",
                   help="TRAIN.GRAD_ACCUM_MODE")
    p.add_argument("--steps", type=int, default=STEPS, help="the timed window's steps")
    p.add_argument("--profiled", type=int, default=PROFILE_STEPS,
                   help="the steps traced by the profiler")
    args = p.parse_args(argv)
    cuda = args.device.startswith("cuda")
    cfg = cfg_from_dict(copy.deepcopy(FLAGSHIP if cuda else TINY))
    cfg.JAX.DTYPE = cfg.JAX.LOSS_DTYPE = args.dtype
    cfg.TRAIN.GRAD_ACCUM, cfg.TRAIN.GRAD_ACCUM_MODE = args.grad_accum, args.accum_mode
    batch = args.batch or cfg.TRAIN.BATCH_SIZE
    with dist.distributed(cfg, args.device) as device:
        result = measure(cfg, batch, device, steps=args.steps, profiled=args.profiled)
        if dist.is_main():
            return _line(args, cfg, batch, result)
        return {}


def _line(args, cfg, batch: int, result: Dict) -> Dict:
    cuda = args.device.startswith("cuda")
    if cuda:
        line = {"metric": "gan_train_step_images_per_sec_256px_h100",
                "value": result["images_per_sec"], "unit": "images/sec",
                "device": torch.cuda.get_device_name(0)}
    else:
        line = {"metric": "gan_train_step_images_per_sec_cpu_smoke",
                "value": result["images_per_sec"], "unit": "images/sec", "device": "cpu"}
    line.update(batch_asked=batch, dtype=args.dtype, precision=precision(cfg), **result,
                tf32={"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                      "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32},
                torch=torch.__version__)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
