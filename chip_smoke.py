"""Quickest proof that the PyTorch port runs on the GPU: ``python3 chip_smoke.py``.

Run from the root of a checkout, on a machine with one CUDA card (an H100
for the numbers in PERF.md).  It imports the port (``sba_gan_tpu_torch``)
and nothing of JAX.  Phases, each printing one line or more:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles every CUDA kernel of the port from ``ops/csrc`` (nvcc,
   all sources at once) and loads it; prints each kernel function's
   registers and spills as ptxas reports them;
3. kernel checks: each kernel against its plain PyTorch version on the card
   at the serving shapes (word attention: B 1 and 6, QL 64^2, 128^2 and a
   ragged QL, T 25, D 32; ragged captions and an all-padding row) and at
   the GAN step's (B 128, QL 64^2 and 128^2, T 18, captions of 4 to 18
   words), with
   the kernel's, the plain version's and one library call's device times
   (calls captured in a CUDA graph) and times as called from Python, and
   the least time the card could take;
4. DAMSM kernels: the similarity kernels K1-K3 (forward, image gradient,
   word gradient) against their plain versions in the same way, at B 32
   T 20 (pretrain), B 128 T 18 (the GAN step's shape) and a ragged B 30,
   R 289, D 256, captions of 1 to T words, with a random cotangent; no
   single library call computes them (``library_ms`` null).  All three run
   their products on the tensor cores in 3xTF32: each row also gives the
   bound of those products at the TF32 rate (``bound_tc_ms``);
5. slice: the full-width ``eval_bird`` generator (vocabulary 5450, random
   weights from a seed, random BatchNorm statistics) on the card against
   the same models on the CPU, same captions and noise, TF32 off;
6. serve: the WSGI app on the card answers ``GET /``, a few
   ``POST /api/v1.0/bird`` and one ``POST /api/v1.0/birds``; the kernel
   launch counts are set to 0 just before and read just after, and every
   generation must launch the word-attention kernel exactly twice;
7. pretrain step: one full-width DAMSM train step (``configs/DAMSM/bird.yml``:
   batch 32, 299^2 images, Inception-v3, EMBEDDING_DIM 256, WORDS_NUM 20,
   vocabulary 5450) on the card against the CPU from the same weights,
   batch and dropout mask, TF32 off: losses, gradients of the heads and
   the text encoder, BatchNorm running statistics;
8. pretrain CLI: ``pretrain.main`` runs one epoch of synthetic data on the
   card (4 steps of 32, evaluation, a checkpoint), with the K1-K3 counts
   set to 0 just before: K1 must launch once per train step and eval
   batch, K2 and K3 once per train step; the trunk must stay as it was and
   the heads, the text encoder and the running statistics must move; the
   checkpoint then restores into a trainer on the card, which renders the
   CLI's attention grid for one batch;
9. GAN step: one full-width GAN train step (``configs/bird_style.yml``,
   WORDS_NUM 18, batch 8, vocabulary 5450) on the card against the same step
   on the CPU from the same weights, batch and noise, TF32 off: every log,
   the G and D BatchNorm running statistics, the D and G gradients, the
   parameters entry by entry against Adam's first update of both
   gradients, the EMA, and the gradient of the G loss's DAMSM terms to the
   images (Inception, K1, K2); the card's gradients also against the CPU's
   float64 step, by the same bounds; and the card's step at the bench's
   precision (TF32 convolutions) against the float64 step, within its own
   bounds (the bounds' readings: ``scripts/torch_gan_step_readings.py``).
   The kernel counts set to 0 just before each card step: K4 must launch
   twice, K1 and K2 once, K3 never (K1 and K2 once in the DAMSM terms
   alone);
10. GAN bench: ``python -m sba_gan_tpu_torch.bench`` in this process, at
   batch 128 (or the largest that fits, stated), its JSON line printed on
   its own line; it must run at the precision step 9 checked;
11. GAN CLI: ``main.main`` trains one epoch of synthetic data at batch 32
   with the encoders of the pretrain CLI's checkpoint (``TRAIN.NET_E``),
   saves the full GAN state, and a second call resumes for another epoch
   (kernel counts checked per step); the checkpoint restores into a trainer
   on the card, which renders the EMA sample and the attention grid;
12. the ``kernels`` JSON line (with each kernel's launches in the GAN step),
   then the device JSON line last.

Any failure raises, and the script exits non-zero.  Without CUDA it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM, TF32 on the tensor cores, dense
SEED = 0
N_WORDS = 5450  # the CUB vocabulary
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# card against CPU, both float32 with TF32 off: sums in another order
# through some twenty-five convolutions and norms
SLICE_ATOL = 2e-4


@contextlib.contextmanager
def tf32(cudnn: bool, matmul: bool):
    """TF32 for cudnn's convolutions and for matmuls as given, then as before."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _events_ms(run, count: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def eager_ms(fn, iters: int = 100) -> float:
    """Time of one call of ``fn`` as the caller sees it: ``iters`` calls back
    to back from Python between two CUDA events, host overhead included."""
    for _ in range(min(iters, 5)):
        fn()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run, iters)


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph, replayed ``replays`` times, so no host work sits between the
    kernels.  The inputs stay in L2 from one call to the next."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()

    def run():
        for _ in range(replays):
            graph.replay()
    ms = _events_ms(run, calls * replays)
    del graph
    return ms


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    say("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


def ptxas_by_function(log: str) -> dict:
    """``{kernel function: [its ptxas lines]}`` from an ``nvcc -Xptxas -v``
    log: the spill line and the registers line after each entry function."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif name is not None and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


def phase_build():
    from sba_gan_tpu_torch.ops import _build

    t0 = time.time()
    logs = _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    seconds = time.time() - t0
    for name, log in logs.items():
        say("build", kernel=name, ptxas=ptxas_by_function(log))
    say("build", seconds=round(seconds, 3), kernels=sorted(logs))


def word_attention_case(b, ql, t, d, lens, seed, reps=None):
    from sba_gan_tpu_torch.ops import word_attention as wa

    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, ql, d), generator=gen).cuda()
    s = torch.randn((b, t, d), generator=gen).cuda()
    pad = (torch.arange(t)[None, :] >= torch.tensor(lens)[:, None]).cuda()
    bias = wa.pad_bias(pad, s)

    ctx, att = wa.word_attention(q, s, pad)
    torch.cuda.synchronize()
    ctx_p, att_p = wa.word_attention_plain(q, s, bias)
    torch.testing.assert_close(ctx, ctx_p, **KERNEL_TOL)
    torch.testing.assert_close(att, att_p, **KERNEL_TOL)
    if min(lens) == 0:  # a fully padded row is uniform over all T words
        row = lens.index(0)
        torch.testing.assert_close(att[row], torch.full_like(att[row], 1.0 / t),
                                   **KERNEL_TOL)
    err = max((ctx - ctx_p).abs().max().item(), (att - att_p).abs().max().item())

    def library():  # three calls: no single PyTorch call returns both ctx and P
        p = torch.softmax(torch.baddbmm(bias[:, None, :], q, s.transpose(1, 2)), -1)
        return torch.bmm(p, s)

    nbytes = 4 * (2 * b * ql * d + b * t * d + b * t + b * ql * t)
    flops = 4 * b * ql * t * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    kernel = lambda: wa.word_attention(q, s, pad)  # noqa: E731
    plain = lambda: wa.word_attention_plain(q, s, bias)  # noqa: E731
    reps = reps or {}
    return {
        "shape": f"B{b} QL{ql} T{t} D{d}",
        "max_abs_err": err,
        "kernel_ms": device_ms(kernel, **reps),
        "plain_ms": device_ms(plain, **reps),
        "library_ms": device_ms(library, **reps),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "eager_ms": eager_ms(kernel),
        "plain_eager_ms": eager_ms(plain),
        "library_eager_ms": eager_ms(library),
    }


def phase_kernels():
    """K4 at the serving shapes, then at the GAN step's: batch 128, the
    two refinement stages' queries (64^2 and 128^2), T 18, captions of 4 to
    18 words as the bench's batch."""
    t, d = 25, 32
    rows = []
    for b, lens in ((1, [11]), (6, [25, 18, 9, 3, 1, 0])):
        for ql in (64 * 64, 128 * 128, 4133):
            row = word_attention_case(b, ql, t, d, lens, seed=len(rows))
            say("kernel", name="word_attention", **row)
            rows.append(row)
    gen = torch.Generator().manual_seed(SEED + 5)
    lens = torch.randint(4, 19, (128,), generator=gen).tolist()
    lens[0], lens[-1] = 4, 18
    gan_rows = []
    for ql in (64 * 64, 128 * 128):
        row = word_attention_case(128, ql, 18, d, lens, seed=len(rows) + len(gan_rows),
                                  reps=dict(calls=5, replays=4))
        say("kernel", name="word_attention", case="gan_step", **row)
        gan_rows.append(row)
    return rows, gan_rows


# K1-K3 against their plain versions: float32 on both sides, sums over D 256
# and R 289 in another order, amplified by three softmaxes; the gradients
# are compared against their own largest entry
DAMSM_FWD_TOL = dict(rtol=1e-4, atol=1e-4)
DAMSM_GRAD_RTOL = 1e-3
DAMSM_R, DAMSM_D = 289, 256  # 17 x 17 regions, EMBEDDING_DIM
# card against CPU, one full-width DAMSM train step, float32, TF32 off:
# relative to the largest entry of each tensor (sums in another order
# through the Inception trunk, three softmaxes and a bi-LSTM)
PRETRAIN_TOL = {"logs": 1e-4, "grads": 1e-3, "stats": 1e-4}
DAMSM_SHAPES = (  # (B, T, name): pretrain, the GAN step's, ragged B
    (32, 20, "pretrain"), (128, 18, "gan_step"), (30, 20, "ragged"))


def damsm_case(b, t, seed, gamma1=4.0, gamma2=5.0):
    """K1-K3 at B texts and images, T words, R 289, D 256: each kernel
    against its plain version, with device and eager times and the bound."""
    from sba_gan_tpu_torch.ops import damsm_sim as ds

    gen = torch.Generator().manual_seed(seed)
    r, d = DAMSM_R, DAMSM_D
    words = torch.randn((b, t, d), generator=gen).cuda()
    img = torch.randn((b, r, d), generator=gen).cuda()
    g = torch.randn((b, b), generator=gen).cuda()
    lens = torch.randint(1, t + 1, (b,), generator=gen)
    lens[0], lens[-1] = 1, t  # the shortest and the longest caption
    lens_dev = lens.to(torch.int32).cuda()
    n_words = int(lens.sum())

    # flops per real word, region and channel of each pair: K1 the forward's
    # two products (S = W X^T, C = A2 X); K2 recomputes them and adds dA2 =
    # dC X^T, A2^T dC and dS^T W; K3 recomputes them and adds dA2 and dS X
    kernels = {
        "damsm_sim_fwd": (lambda: ds.launch_fwd(words, img, lens_dev, gamma1, gamma2),
                          lambda: ds.damsm_sim_plain(words, img, lens_dev, gamma1, gamma2),
                          4, 4 * (b * t * d + b * r * d + b + b * b)),
        "damsm_sim_dimg": (lambda: ds.launch_dimg(words, img, lens_dev, g, gamma1, gamma2),
                           lambda: ds.damsm_sim_dimg_plain(words, img, lens_dev, g,
                                                           gamma1, gamma2),
                           10, 4 * (b * t * d + 2 * b * r * d + b + b * b)),
        "damsm_sim_dwords": (lambda: ds.launch_dwords(words, img, lens_dev, g,
                                                      gamma1, gamma2),
                             lambda: ds.damsm_sim_dwords_plain(words, img, lens_dev, g,
                                                               gamma1, gamma2),
                             8, 4 * (2 * b * t * d + b * r * d + b + b * b)),
    }
    rows = {}
    for name, (kernel, plain, flops_per, nbytes) in kernels.items():
        # the public wrapper (host checks, lens from the CPU) on the card
        public = getattr(ds, name)
        got = (public(words, img, lens, gamma1, gamma2) if name == "damsm_sim_fwd"
               else public(words, img, lens, g, gamma1, gamma2))
        torch.cuda.synchronize()
        want = plain()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if name == "damsm_sim_fwd":
            torch.testing.assert_close(got, want, **DAMSM_FWD_TOL)
            tol = DAMSM_FWD_TOL
        else:
            tol = dict(rtol=DAMSM_GRAD_RTOL, atol=DAMSM_GRAD_RTOL * scale)
            torch.testing.assert_close(got, want, **tol)
        if name == "damsm_sim_dwords":  # padding words get exactly zero
            pad = torch.arange(t)[None, :] >= lens[:, None]
            if got[pad.cuda()].abs().max().item() != 0.0:
                raise AssertionError("d_words is not zero at padding")
        flops = flops_per * b * n_words * r * d  # the real words of this batch
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_FLOPS_PER_S * 1e3
        reps = dict(calls=3, replays=3) if b >= 128 else dict(calls=5, replays=4)
        rows[name] = {
            "shape": f"B{b} T{t} R{r} D{d}", "words": n_words,
            "max_abs_err": err, "ref_max_abs": scale, "tol": tol,
            "kernel_ms": device_ms(kernel, **reps),
            "plain_ms": device_ms(plain, **reps),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "eager_ms": eager_ms(kernel, iters=5),
            "plain_eager_ms": eager_ms(plain, iters=5),
        }
        # 3xTF32 on the tensor cores: each product three times
        rows[name]["bound_tc_ms"] = max(bytes_ms, 3 * flops / TF32_FLOPS_PER_S * 1e3)
    return rows


def phase_damsm_kernels():
    out = []
    for k, (b, t, label) in enumerate(DAMSM_SHAPES):
        rows = damsm_case(b, t, seed=100 + k)
        for name, row in rows.items():
            say("kernel", name=name, case=label, **row)
        out.append((label, rows))
    return dict(out)


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (0 when both are all zero)."""
    scale = want.abs().max().item()
    return (got.cpu() - want.cpu()).abs().max().item() / (scale or 1.0)


def phase_pretrain_step(cfg, batch_size):
    """One full-width DAMSM train step on the card against the same step on
    the CPU: same weights, batch and dropout mask, TF32 off."""
    from sba_gan_tpu_torch.data.pipeline import collate
    from sba_gan_tpu_torch.data.cub import SyntheticDataset
    from sba_gan_tpu_torch.train.damsm import LOG_KEYS, DAMSMTrainer, build_damsm_models

    cfg = copy.deepcopy(cfg)
    cfg.TRAIN.BATCH_SIZE = batch_size
    models = build_damsm_models(cfg, N_WORDS, seed=SEED)
    ds = SyntheticDataset(num_examples=batch_size, base_size=cfg.TREE.BASE_SIZE,
                          branch_num=cfg.TREE.BRANCH_NUM, words_num=cfg.TEXT.WORDS_NUM,
                          n_words=N_WORDS, seed=SEED)
    batch = collate([ds[i] for i in range(batch_size)])
    keep = models.text_encoder.dropout_mask(batch.captions,
                                            torch.Generator().manual_seed(SEED + 2))
    runs = {}
    with tf32(cudnn=False, matmul=False):
        for device in ("cuda", "cpu"):
            trainer = DAMSMTrainer(cfg, copy.deepcopy(models), device=device)
            t0 = time.perf_counter()
            logs = trainer.train_step(
                batch.imgs[-1].to(device), batch.captions.to(device), batch.cap_lens,
                batch.class_ids.to(device), keep_mask=keep.to(device))
            logs = {k: float(v) for k, v in logs.items()}
            seconds = time.perf_counter() - t0
            grads = {f"text.{n}": p.grad for n, p in trainer.text_encoder.named_parameters()}
            grads.update({f"image.{n}": p.grad for n, p in
                          trainer.image_encoder.named_parameters() if p.grad is not None})
            stats = {n: b for n, b in trainer.image_encoder.state_dict().items()
                     if n.endswith(("running_mean", "running_var"))}
            runs[device] = dict(logs=logs, grads=grads, stats=stats, seconds=seconds)
    gpu, cpu = runs["cuda"], runs["cpu"]
    errs = {
        "logs": max(abs(gpu["logs"][k] - cpu["logs"][k]) / abs(cpu["logs"][k])
                    for k in LOG_KEYS),
        "grads": {n: _rel_err(g, cpu["grads"][n]) for n, g in gpu["grads"].items()},
        "stats": max(_rel_err(s, cpu["stats"][n]) for n, s in gpu["stats"].items()),
    }
    worst_grad = max(errs["grads"].values())
    say("pretrain_step", batch=batch_size, logs_cuda=gpu["logs"], logs_cpu=cpu["logs"],
        rel_err_logs=errs["logs"], rel_err_grads_max=worst_grad,
        rel_err_grads={n: e for n, e in errs["grads"].items() if "emb_" in n or
                       n.startswith("text.")},
        rel_err_running_stats=errs["stats"], tol=PRETRAIN_TOL,
        grads_compared=sorted(gpu["grads"]), step_s_cuda=gpu["seconds"],
        step_s_cpu=cpu["seconds"])
    image_grads = sorted(n for n in gpu["grads"] if n.startswith("image."))
    if image_grads != ["image.emb_cnn_code.bias", "image.emb_cnn_code.weight",
                       "image.emb_features.weight"]:
        raise AssertionError(f"unexpected trainable image parameters: {image_grads}")
    if not (errs["logs"] <= PRETRAIN_TOL["logs"] and worst_grad <= PRETRAIN_TOL["grads"]
            and errs["stats"] <= PRETRAIN_TOL["stats"]):
        raise AssertionError(f"pretrain step: card and CPU disagree beyond {PRETRAIN_TOL}")


def phase_pretrain_cli(cfg_path, out):
    """``pretrain.main`` on the card: one epoch of synthetic data at full
    width, evaluation, a checkpoint under ``out``; counts of K1-K3 set to 0
    just before.  Then the checkpoint is restored into a trainer on the card,
    as a resume does, and the CLI's attention dump runs on one batch."""
    from sba_gan_tpu_torch import pretrain
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.pipeline import build_dataset
    from sba_gan_tpu_torch.ops import damsm_sim as dsim
    from sba_gan_tpu_torch.data.pipeline import DataLoader
    from sba_gan_tpu_torch.train.damsm import (DAMSMTrainer, build_damsm_models,
                                               image_trainable_mask)
    from sba_gan_tpu_torch.utils.checkpoint import Checkpointer

    wrappers = {"damsm_sim_fwd": dsim.damsm_sim_fwd, "damsm_sim_dimg": dsim.damsm_sim_dimg,
                "damsm_sim_dwords": dsim.damsm_sim_dwords}
    for fn in wrappers.values():
        fn.launches = 0
    summary = pretrain.main(["--cfg", cfg_path, "--synthetic", "--max_epoch", "1",
                             "--output_dir", out])
    launches = {name: fn.launches for name, fn in wrappers.items()}
    epoch = summary["epochs"][0]
    saved = Checkpointer(os.path.join(out, "Model")).restore()

    cfg = cfg_from_file(cfg_path)
    cfg.JAX.SEED = 100  # the CLI's --manualSeed default
    train_ds = build_dataset(cfg, True, "train")  # the synthetic vocabulary: 300
    resumed = DAMSMTrainer(cfg, build_damsm_models(cfg, train_ds.n_words),
                           device="cuda")
    resumed.load_state_dict(saved)
    batch = next(iter(DataLoader(train_ds, cfg.TRAIN.BATCH_SIZE, shuffle=False,
                                 device="cuda")))
    dump = pretrain.dump_attention(resumed, batch, os.path.join(out, "Image"),
                                   train_ds.ixtoword, "smoke")
    images = sorted(os.listdir(os.path.join(out, "Image")))
    start = build_damsm_models(cfg, train_ds.n_words, seed=cfg.JAX.SEED)
    steps = len(epoch["logs"])
    evals = min(50, len(build_dataset(cfg, True, "test")) // cfg.TRAIN.BATCH_SIZE)
    image_start = start.image_encoder.state_dict()
    image_end = saved["image_encoder"]
    trains = image_trainable_mask(start.image_encoder)
    frozen_same = all(torch.equal(image_end[n], image_start[n])
                      for n, t in trains.items() if not t)
    heads_moved = all(not torch.equal(image_end[n], image_start[n])
                      for n, t in trains.items() if t)
    text_moved = all(not torch.equal(saved["text_encoder"][n], v)
                     for n, v in start.text_encoder.state_dict().items())
    stats_moved = any(not torch.equal(image_end[n], image_start[n])
                      for n in image_end if n.endswith("running_mean"))
    finite = all(np.isfinite(v) for logs in epoch["logs"] for v in logs.values())
    later = epoch["step_ms"][1:]
    same = all(torch.equal(v.cpu(), saved["image_encoder"][n])
               for n, v in resumed.image_encoder.state_dict().items())
    say("pretrain_cli", steps=steps, eval_batches=evals, launches=launches,
        logs_first=epoch["logs"][0], logs_last=epoch["logs"][-1], val_loss=epoch["val"],
        step_ms=epoch["step_ms"], step_ms_median_after_first=statistics.median(later),
        images_per_s=cfg.TRAIN.BATCH_SIZE * 1e3 / statistics.median(later),
        attention_dumps=images, trunk_unchanged=frozen_same, heads_moved=heads_moved,
        text_moved=text_moved, running_stats_moved=stats_moved,
        resumed_on_card=same)
    want = {"damsm_sim_fwd": steps + evals, "damsm_sim_dimg": steps,
            "damsm_sim_dwords": steps}
    if not (finite and np.isfinite(epoch["val"]) and frozen_same and heads_moved
            and text_moved and stats_moved and launches == want and same
            and images == [os.path.basename(dump)]):
        raise AssertionError(f"pretrain CLI: launches {launches} (want {want}), "
                             f"finite {finite}, trunk unchanged {frozen_same}, heads "
                             f"moved {heads_moved}, text moved {text_moved}, "
                             f"stats moved {stats_moved}, resumed {same}, "
                             f"dumps {images}")
    return launches


def random_bn_stats(module, gen):
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(0.5 * torch.randn(m.running_mean.shape,
                                                       generator=gen))
                m.running_var.uniform_(0.5, 2.0, generator=gen)


def phase_slice(cfg, wordtoix):
    from sba_gan_tpu_torch.data.vocab import encode_free_text
    from sba_gan_tpu_torch.train.sample import Sampler

    cpu = Sampler.from_config(cfg, N_WORDS, seed=SEED, device="cpu")
    random_bn_stats(cpu.generator, torch.Generator().manual_seed(SEED + 1))
    gpu = Sampler(cfg, copy.deepcopy(cpu.generator),
                  copy.deepcopy(cpu.text_encoder), device="cuda")
    captions = ["w17 w4031 w9 w250 w77 w3 w1200 w88 w5 w13 w402 w6",
                "w2 w5449 w31"]
    ids, lens = encode_free_text(captions, wordtoix, cfg.TEXT.WORDS_NUM)
    z, eps = cpu.draw_noise(len(captions), SEED)

    with tf32(cudnn=False, matmul=False):
        fakes_g, atts_g = gpu.with_noise(ids, lens, z, eps)
    fakes_c, atts_c = cpu.with_noise(ids, lens, z, eps)
    errs = {}
    for name, g, c in zip(("img64", "img128", "img256", "map64", "map128"),
                          fakes_g + atts_g, fakes_c + atts_c):
        if g.shape != c.shape or not np.isfinite(g).all():
            raise AssertionError(f"{name}: shape {g.shape} vs {c.shape}, "
                                 f"finite {np.isfinite(g).all()}")
        errs[name] = float(np.abs(g - c).max())
    say("slice", max_abs_err=errs, atol=SLICE_ATOL,
        image_shapes=[list(f.shape) for f in fakes_g],
        map_shapes=[list(a.shape) for a in atts_g])
    bad = {k: v for k, v in errs.items() if not v <= SLICE_ATOL}
    if bad:
        raise AssertionError(f"card and CPU disagree beyond {SLICE_ATOL}: {bad}")

    # one generation at B=1 as the server runs it (TF32 at PyTorch's defaults)
    one = lambda: gpu(ids[:1], lens[:1], SEED)  # noqa: E731
    one()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        one()
        times.append((time.perf_counter() - t0) * 1e3)
    say("slice", generate_b1_ms_median=statistics.median(times),
        generate_b1_ms=times)
    return gpu


def phase_serve(cfg, sampler, wordtoix, ixtoword):
    from PIL import Image

    from sba_gan_tpu_torch.ops import word_attention as wa
    from sba_gan_tpu_torch.serving.app import build_service, make_wsgi_app

    events = []
    with tempfile.TemporaryDirectory() as blobs:
        app = make_wsgi_app(build_service(cfg, sampler, wordtoix, ixtoword,
                                          blobs, telemetry=events.append))

        def call(method, path, body=None):
            data = json.dumps(body).encode() if body is not None else b""
            out = {}

            def start_response(status, headers):
                out["status"] = status

            environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
                       "CONTENT_LENGTH": str(len(data)),
                       "wsgi.input": io.BytesIO(data)}
            t0 = time.perf_counter()
            body = b"".join(app(environ, start_response))
            return out["status"], body, (time.perf_counter() - t0) * 1e3

        requests = [("GET", "/", None, 0)]
        requests += [("POST", "/api/v1.0/bird",
                      {"caption": f"w{12 + i} w40{i} w7 w1999 w63", "seed": i}, 2)
                     for i in range(4)]
        requests += [("POST", "/api/v1.0/birds",
                      {"caption": "w5 w818 w3210 w44", "seed": 9}, 2)]

        wa.word_attention.launches = 0
        latency = {}
        for method, path, body, want_launches in requests:
            before = wa.word_attention.launches
            status, payload, ms = call(method, path, body)
            grew = wa.word_attention.launches - before
            want_status = "201 Created" if method == "POST" else "200 OK"
            if status != want_status or grew != want_launches:
                raise AssertionError(f"{method} {path}: {status}, kernel "
                                     f"launches {grew} (want {want_launches})")
            latency.setdefault(f"{method} {path}", []).append(ms)
            if method == "POST":
                bird = json.loads(payload)["bird"]
                entries = [bird] if path.endswith("bird") else [
                    bird[f"bird{j}"] for j in range(1, 7)]
                for entry in entries:
                    for label, size in (("small", 64), ("medium", 128),
                                        ("large", 256)):
                        st, img, _ = call("GET", entry[label])
                        im = Image.open(io.BytesIO(img))
                        if st != "200 OK" or im.size != (size, size):
                            raise AssertionError(f"{entry[label]}: {st} {im.size}")
                    for label in ("map1", "map2"):
                        st, img, _ = call("GET", entry[label])
                        if st != "200 OK" or img[:8] != b"\x89PNG\r\n\x1a\n":
                            raise AssertionError(f"{entry[label]}: {st}")
        launches = {"word_attention": wa.word_attention.launches}
    if launches["word_attention"] == 0:
        raise AssertionError("the main path never launched word_attention")
    phases = [e["phases"] for e in events if e.get("event") == "generate"]
    say("serve", latency_ms_median={k: statistics.median(v)
                                    for k, v in latency.items()},
        latency_ms=latency, phases=phases, launches=launches)
    return launches


# One full-width GAN train step at batch 8 on the card against the CPU, from
# the same weights, batch and noise (``gan_step_readings``).  Logs relative;
# running statistics relative to each tensor's largest entry; gradients per
# tensor as |g_card - g_cpu| / |g_cpu| over the whole tensor, the Ds' from
# the step, G's from a step whose Ds do not move (D lr 0: Adam's first
# update, lr * g / (|g| + 1e-8), flips sign where a D gradient is rounding
# noise, and G's loss meets the updated Ds).  The gradients of batch 8 pass
# LeakyReLU and ReLU kinks on the Ds' 4 x 4 codes, where float32 rounding
# alone moves them by up to ~1% (the CPU's float32 step against its float64
# step), and only 43-85% of the entries agree to 1e-3; so the card is also
# held to the CPU's float64 step by the same bounds.  Parameters entry by
# entry: where the two gradients agree to 1e-3 within 1e-3 lr, and wherever
# they share a sign within what Adam's first updates of the two gradients
# differ by (float64) plus 1e-3 lr, past one float32 rounding of the
# parameter; entries that share a sign must be nearly all.  The EMA within
# 1e-3 of the parameters' difference past two roundings.  The G loss's
# DAMSM part alone (Inception, K1, K2: the gradient of its two terms to the
# batch's final-scale images), since the whole gradients cannot see it:
# with K2's output dropped G's gradients read 1.14e-2 against 1.04e-2.
# The bench's precision (cudnn convolutions in TF32, PyTorch's default) is
# held to the float64 step by GAN_TF32_TOL.  Readings over seeds 0-4 and
# with faults put in (scripts/torch_gan_step_readings.py, H100; PERF.md):
# largest sound logs 1.7e-4, stats 2.0e-6, D 9.3e-3, G 1.04e-2, DAMSM image
# gradient 6.2e-3 (against float64 9.3e-3, 1.03e-2, 5.1e-3), sign share
# at least 0.9991; K4's context x 1.01 reads G 2.5e-2, K2's output x 1.1
# reads DAMSM 0.10; TF32 at most logs 1.0e-3, stats 7.8e-4, D 8.7e-2,
# G 0.143, DAMSM 0.159.
GAN_STEP_TOL = {"logs": 1e-3, "stats": 1e-4, "d_grads": 2e-2, "g_grads": 2e-2,
                "damsm_img_grad": 1.5e-2, "params_agreeing_excess": 1e-3,
                "params_adam_excess": 1e-3, "ema_excess": 0.0}
GAN_SIGN_SHARE = 0.99  # least share of parameter entries whose gradients share a sign
GAN_TF32_TOL = {"logs": 1e-2, "stats": 1e-2, "d_grads": 0.2, "g_grads": 0.3,
                "damsm_img_grad": 0.3}
GAN_TF32 = dict(cudnn=True, matmul=False)  # PyTorch's defaults, as the bench runs
GAN_KERNELS = ("word_attention", "damsm_sim_fwd", "damsm_sim_dimg", "damsm_sim_dwords")
GAN_STEP_LAUNCHES = {"word_attention": 2, "damsm_sim_fwd": 1, "damsm_sim_dimg": 1,
                     "damsm_sim_dwords": 0}
GAN_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "sba_gan_tpu_torch", "configs", "bird_style.yml")


def _kernel_wrappers():
    from sba_gan_tpu_torch.ops import damsm_sim as dsim
    from sba_gan_tpu_torch.ops import word_attention as wa

    return {"word_attention": wa.word_attention, "damsm_sim_fwd": dsim.damsm_sim_fwd,
            "damsm_sim_dimg": dsim.damsm_sim_dimg, "damsm_sim_dwords": dsim.damsm_sim_dwords}


def gan_step_inputs(seed=SEED, batch_size=8):
    """bird_style at WORDS_NUM 18: the config, random models from ``seed``
    (random running statistics in the eval-mode Inception), one synthetic
    batch and the noise of one step, all on the CPU."""
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.cub import SyntheticDataset
    from sba_gan_tpu_torch.data.pipeline import collate
    from sba_gan_tpu_torch.train.gan import build_models
    from sba_gan_tpu_torch.train.sample import noise_shape

    cfg = cfg_from_file(GAN_CFG)
    cfg.TEXT.WORDS_NUM = 18
    cfg.TRAIN.BATCH_SIZE = batch_size
    models = build_models(cfg, N_WORDS, seed=seed)
    random_bn_stats(models.image_encoder, torch.Generator().manual_seed(seed + 3))
    ds = SyntheticDataset(num_examples=batch_size, base_size=cfg.TREE.BASE_SIZE,
                          branch_num=cfg.TREE.BRANCH_NUM, words_num=cfg.TEXT.WORDS_NUM,
                          n_words=N_WORDS, seed=seed)
    batch = collate([ds[i] for i in range(batch_size)])
    gen = torch.Generator().manual_seed(seed + 4)
    z = torch.randn(noise_shape(cfg, batch_size), generator=gen)
    eps = torch.randn((batch_size, cfg.GAN.CONDITION_DIM), generator=gen)
    return cfg, models, batch, z, eps


def still_ds(cfg):
    """``cfg`` with the Ds held still (D lr 0)."""
    cfg = copy.deepcopy(cfg)
    cfg.TRAIN.DISCRIMINATOR_LR = 0.0
    return cfg


def gan_step_run(cfg, models, batch, z, eps, device, dtype=torch.float32):
    """One step from a copy of ``models`` on ``device`` in ``dtype``: its
    logs, gradients, parameters, running statistics, EMA and launch counts
    (set to 0 just before the step, read just after); all on the CPU."""
    from sba_gan_tpu_torch.train.gan import GANStep, init_gan_state

    wrappers = _kernel_wrappers()
    models = copy.deepcopy(models)
    for m in (models.text_encoder, models.image_encoder, models.generator,
              *models.discriminators):
        m.to(dtype)
    state = init_gan_state(cfg, models, device=device)
    step = GANStep(cfg, state)
    args = ([i.to(device, dtype) for i in batch.imgs], batch.captions.to(device),
            batch.cap_lens, batch.class_ids.to(device))
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logs = step(*args, z=z.to(device, dtype), eps=eps.to(device, dtype))
    logs = {k: float(v) for k, v in logs.items()}
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    nets = {"G": state.generator, **{f"D{i}": d for i, d in enumerate(state.discriminators)}}
    grads = {f"{k}.{n}": p.grad.cpu().double() for k, m in nets.items()
             for n, p in m.named_parameters()}
    sd = state.state_dict()
    tensors = {f"G.{n}": v.cpu() for n, v in sd["generator"].items()}
    tensors.update({f"D{i}.{n}": v.cpu() for i, d in enumerate(sd["discriminators"])
                    for n, v in d.items()})
    return dict(logs=logs, grads=grads, tensors=tensors,
                ema={n: v.cpu() for n, v in sd["g_ema"].items()},
                launches=launches, seconds=seconds)


def _norm_rel(got, want) -> float:
    return ((got - want).norm() / (want.norm() or 1.0)).item()


def _worst(d: dict, n: int = 5):
    return sorted(d.items(), key=lambda kv: -kv[1])[:n]


def grad_errs(got, want) -> dict:
    """Per tensor |g_got - g_want| / |g_want|, the largest of the Ds and of
    G, and the five worst tensors."""
    errs = {n: _norm_rel(g, want["grads"][n]) for n, g in got["grads"].items()}
    return {"d_grads": max(e for n, e in errs.items() if n.startswith("D")),
            "g_grads": max(e for n, e in errs.items() if n.startswith("G.")),
            "worst": _worst(errs)}


def agreeing(got, want, names):
    """{parameter: entries whose gradients agree to 1e-3}."""
    return {n: (got["grads"][n] - want["grads"][n]).abs()
            <= 1e-3 * want["grads"][n].abs() for n in names}


def param_readings(moving, still, lr) -> dict:
    """Parameters after the step, card against CPU: the Ds from the step
    (``moving``: card, CPU), G and its EMA from the still-D step (``still``).
    Each difference less one float32 rounding of the parameter, over lr, at
    most: over the entries whose gradients agree to 1e-3; over those whose
    gradients share a sign, past the difference of Adam's first updates
    lr * g / (|g| + 1e-8) of the two gradients.  The shares of both kinds
    of entry, and the largest difference of any entry over lr (at most 2 by
    Adam's first update).  The EMA: its largest difference past 1e-3 of the
    parameters' difference and two roundings."""
    ulp = torch.finfo(torch.float32).eps
    adam = lambda g: lr * g / (g.abs() + 1e-8)  # noqa: E731
    excess = {"agreeing": 0.0, "adam": 0.0}
    counts = {"agreeing": 0, "sign": 0, "all": 0}
    largest = 0.0
    for (card, cpu), prefix in ((moving, "D"), (still, "G.")):
        for n in (n for n in cpu["grads"] if n.startswith(prefix)):
            g_card, g_cpu = card["grads"][n], cpu["grads"][n]
            diff = (card["tensors"][n].double() - cpu["tensors"][n].double()).abs()
            past = diff - ulp * cpu["tensors"][n].double().abs()
            agree = (g_card - g_cpu).abs() <= 1e-3 * g_cpu.abs()
            sign = torch.sign(g_card) == torch.sign(g_cpu)
            for key, mask, vals in (("agreeing", agree, past),
                                    ("adam", sign, past - (adam(g_card) - adam(g_cpu)).abs())):
                if mask.any():
                    excess[key] = max(excess[key], vals[mask].max().item() / lr)
            counts["agreeing"] += int(agree.sum())
            counts["sign"] += int(sign.sum())
            counts["all"] += sign.numel()
            largest = max(largest, (diff.max() / lr).item())
    card, cpu = still
    ema_excess = 0.0
    for n, want in cpu["ema"].items():
        dp = (card["tensors"][f"G.{n}"].double() - cpu["tensors"][f"G.{n}"].double()).abs()
        diff = (card["ema"][n].double() - want.double()).abs()
        slack = 1e-3 * dp + 2 * ulp * want.double().abs()
        ema_excess = max(ema_excess, (diff - slack).max().item())
    return {"params_agreeing_excess": excess["agreeing"],
            "params_adam_excess": excess["adam"],
            "params_agree_share": counts["agreeing"] / counts["all"],
            "params_sign_share": counts["sign"] / counts["all"],
            "params_max_over_lr": largest, "ema_excess": ema_excess}


def damsm_grad_run(cfg, models, batch, device, dtype=torch.float32):
    """The G loss's DAMSM terms alone (``GANStep.damsm_loss``) on the batch's
    final-scale images, and their gradient to those images, on ``device``
    in ``dtype``; the kernel counts set to 0 just before, read just after."""
    from sba_gan_tpu_torch.train.gan import GANStep, init_gan_state

    wrappers = _kernel_wrappers()
    models = copy.deepcopy(models)
    for m in (models.text_encoder, models.image_encoder):
        m.to(dtype)
    step = GANStep(cfg, init_gan_state(cfg, models, device=device))
    captions = batch.captions.to(device)
    with torch.no_grad():
        words, sent = step.state.text_encoder(captions, batch.cap_lens)
    img = batch.imgs[-1].to(device, dtype).requires_grad_(True)
    for fn in wrappers.values():
        fn.launches = 0
    w_loss, s_loss = step.damsm_loss(img, words, sent, batch.cap_lens,
                                     batch.class_ids.to(device))
    (grad,) = torch.autograd.grad(w_loss + s_loss, img)
    return dict(logs={"w_loss": float(w_loss.detach()), "s_loss": float(s_loss.detach())},
                grad=grad.cpu().double(),
                launches={k: fn.launches for k, fn in wrappers.items()})


def gan_step_readings(cfg, runs) -> dict:
    """Card against CPU from the runs of :func:`gan_step_runs`."""
    from sba_gan_tpu_torch.train.gan import log_keys

    keys = log_keys(cfg.TREE.BRANCH_NUM)
    gpu, cpu = runs["cuda"], runs["cpu"]
    stats = [n for n in cpu["tensors"] if n.endswith(("running_mean", "running_var"))]
    lr = max(cfg.TRAIN.GENERATOR_LR, cfg.TRAIN.DISCRIMINATOR_LR)
    dm = runs["damsm"]

    def logs(a, b):
        return max(abs(a["logs"][k] - b["logs"][k]) / abs(b["logs"][k]) for k in keys)

    def against(got, want):  # the step's gradients and the DAMSM gradient
        e = grad_errs(got, want)
        return e, {"d_grads": e["d_grads"], "g_grads": e["g_grads"]}
    grads, card = against(runs["cuda_still"], runs["cpu_still"])
    card64, card64_r = against(runs["cuda_still"], runs["cpu64_still"])
    cpu64, cpu64_r = against(runs["cpu_still"], runs["cpu64_still"])
    tf32_e, tf32_r = against(runs["cuda_tf32_still"], runs["cpu64_still"])
    return {
        "logs": logs(gpu, cpu),
        "stats": max(_rel_err(gpu["tensors"][n], cpu["tensors"][n]) for n in stats),
        **card,
        "damsm_img_grad": _norm_rel(dm["cuda"]["grad"], dm["cpu"]["grad"]),
        **param_readings((gpu, cpu), (runs["cuda_still"], runs["cpu_still"]), lr),
        # card and CPU float32 against the CPU's float64 step
        "float64": {"card_f32": {**card64_r, "damsm_img_grad": _norm_rel(
                        dm["cuda"]["grad"], dm["cpu64"]["grad"])},
                    "cpu_f32": {**cpu64_r, "damsm_img_grad": _norm_rel(
                        dm["cpu"]["grad"], dm["cpu64"]["grad"])}},
        "tf32": {"logs": logs(runs["cuda_tf32_still"], runs["cpu64_still"]),
                 "stats": max(_rel_err(runs["cuda_tf32_still"]["tensors"][n],
                                       runs["cpu64_still"]["tensors"][n].float())
                              for n in stats),
                 **tf32_r,
                 "damsm_img_grad": _norm_rel(dm["cuda_tf32"]["grad"], dm["cpu64"]["grad"])},
        "worst_grads": grads["worst"], "worst_card_f32_vs_f64": card64["worst"],
        "worst_cpu_f32_vs_f64": cpu64["worst"], "worst_tf32": tf32_e["worst"],
    }


def gan_step_failures(r) -> list:
    """The readings of :func:`gan_step_readings` outside their bounds."""
    bad = [k for k, tol in GAN_STEP_TOL.items() if not r[k] <= tol]
    if not r["params_sign_share"] > GAN_SIGN_SHARE:
        bad.append("params_sign_share")
    bad += [f"float64.{k}" for k, v in r["float64"]["card_f32"].items()
            if not v <= GAN_STEP_TOL[k]]
    bad += [f"tf32.{k}" for k, tol in GAN_TF32_TOL.items() if not r["tf32"][k] <= tol]
    return bad


def gan_step_runs(seed=SEED, batch_size=8):
    """From one set of inputs: the step on the card and on the CPU (float32,
    TF32 off), the same with the Ds held still, the CPU's still step in
    float64, and the card's still step at the bench's precision (GAN_TF32);
    the DAMSM terms' image gradient (``damsm``) the same four ways."""
    cfg, models, batch, z, eps = gan_step_inputs(seed, batch_size)
    still = still_ds(cfg)

    def run(c, device, dtype=torch.float32):
        return gan_step_run(c, models, batch, z, eps, device, dtype)

    def damsm(device, dtype=torch.float32):
        return damsm_grad_run(cfg, models, batch, device, dtype)
    with tf32(cudnn=False, matmul=False):
        runs = {"cuda": run(cfg, "cuda"), "cpu": run(cfg, "cpu"),
                "cuda_still": run(still, "cuda"), "cpu_still": run(still, "cpu"),
                "cpu64_still": run(still, "cpu", torch.float64)}
        dm = {"cuda": damsm("cuda"), "cpu": damsm("cpu"), "cpu64": damsm("cpu", torch.float64)}
    with tf32(**GAN_TF32):
        runs["cuda_tf32_still"] = run(still, "cuda")
        dm["cuda_tf32"] = damsm("cuda")
    runs["damsm"] = dm
    return cfg, runs


def phase_gan_step(batch_size=8):
    """One full-width GAN train step on the card against the CPU
    (:func:`gan_step_runs`), held to the bounds above; the card's launches
    in each of its steps: K4 twice, K1 and K2 once, K3 never; K1 and K2
    once in the DAMSM terms alone."""
    cfg, runs = gan_step_runs(SEED, batch_size)
    r = gan_step_readings(cfg, runs)
    dm = runs.pop("damsm")
    say("gan_step", batch=batch_size, words_num=cfg.TEXT.WORDS_NUM,
        logs_cuda=runs["cuda"]["logs"], logs_cpu=runs["cpu"]["logs"],
        damsm_logs={k: v["logs"] for k, v in dm.items()}, readings=r,
        tol={**GAN_STEP_TOL, "params_sign_share_above": GAN_SIGN_SHARE,
             "tf32": GAN_TF32_TOL},
        tf32_run=GAN_TF32,
        launches={k: v["launches"] for k, v in runs.items()},
        damsm_launches={k: v["launches"] for k, v in dm.items()},
        step_s={k: v["seconds"] for k, v in runs.items()})
    bad = gan_step_failures(r)
    if bad or not all(np.isfinite(v) for v in runs["cuda"]["logs"].values()):
        raise AssertionError(f"GAN step: card and CPU disagree in {bad}")
    none = dict.fromkeys(GAN_KERNELS, 0)
    damsm_only = {**none, "damsm_sim_fwd": 1, "damsm_sim_dimg": 1}
    for k, run in list(runs.items()) + [(f"damsm_{k}", v) for k, v in dm.items()]:
        want = ((damsm_only if k.startswith("damsm") else GAN_STEP_LAUNCHES)
                if "cuda" in k else none)
        if run["launches"] != want:
            raise AssertionError(f"GAN step {k}: launches {run['launches']} (want {want})")
    return runs["cuda"]["launches"]


def phase_gan_bench():
    """The port bench at its default, batch 128 (or the largest that fits,
    stated in its line), in this process: its line, then a summary.  It
    must run at the precision whose step ``gan_step`` checked (GAN_TF32)."""
    from sba_gan_tpu_torch import bench

    line = bench.main([])
    named = line["profile"]["hand_written_kernels"]
    per_step = {k: named[k]["launches_per_step"] for k in GAN_KERNELS}
    precision = {"cudnn.allow_tf32": GAN_TF32["cudnn"],
                 "cuda.matmul.allow_tf32": GAN_TF32["matmul"]}
    say("gan_bench", batch=line["batch"], out_of_memory=line["out_of_memory"],
        ms_per_step=line["ms_per_step"], images_per_sec=line["value"],
        step_ms_median=line["step_ms_median"], step_ms_stdev=line["step_ms_stdev"],
        device_ms_per_step=line["profile"]["device_ms_per_step"],
        launches_per_step=line["profile"]["launches_per_step"],
        device_idle_share=line["profile"]["device_idle_share"],
        peak_memory_bytes=line["peak_memory_bytes"], mfu=line["mfu"], tf32=line["tf32"],
        kernel_launches_per_step=per_step,
        kernel_ms_per_step={k: named[k]["device_ms_per_step"] for k in GAN_KERNELS})
    if not line["finite"] or per_step != GAN_STEP_LAUNCHES or line["tf32"] != precision:
        raise AssertionError(f"GAN bench: finite {line['finite']}, kernel launches per "
                             f"step {per_step} (want {GAN_STEP_LAUNCHES}), TF32 "
                             f"{line['tf32']} (gan_step checked {precision})")
    return line


def phase_gan_cli(damsm_model_dir, out, batch_size=32):
    """``main.main`` on the card: one epoch of synthetic data at full width
    with the pretrain CLI's encoders, a checkpoint, then a second call that
    resumes for one more epoch; the kernel counts of each call checked per
    step.  The checkpoint then restores into a trainer on the card, which
    renders the EMA sample and the attention grid of one batch."""
    import yaml

    from sba_gan_tpu_torch import main as gan_main
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset
    from sba_gan_tpu_torch.train.loop import GANTrainer
    from sba_gan_tpu_torch.utils.checkpoint import Checkpointer

    with open(GAN_CFG) as f:
        raw = yaml.safe_load(f)
    raw["TRAIN"].update(BATCH_SIZE=batch_size, NET_E=damsm_model_dir)
    yml = os.path.join(out, "gan.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(raw, f)
    argv = ["--cfg", yml, "--synthetic", "--output_dir", os.path.join(out, "gan")]
    wrappers = _kernel_wrappers()
    calls = []
    for max_epoch in (1, 2):
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        summary = gan_main.main(argv + ["--max_epoch", str(max_epoch)])
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        steps = sum(e["steps"] for e in summary["epochs"])
        calls.append(dict(resumed_from=summary["resumed_from"], steps=steps,
                          launches=launches, seconds=seconds,
                          epochs=summary["epochs"]))
    ckpt = Checkpointer(os.path.join(out, "gan", "Model"))
    saved = ckpt.restore()
    damsm = Checkpointer(damsm_model_dir).restore()
    encoders_kept = all(torch.equal(saved[k][n], v) for k in ("text_encoder", "image_encoder")
                        for n, v in damsm[k].items())
    cfg = cfg_from_file(yml)
    cfg.JAX.SEED = 100  # the CLI's --manualSeed default
    ds = build_dataset(cfg, True, "train")
    trainer = GANTrainer(cfg, os.path.join(out, "gan"), ds, ds.n_words, ds.ixtoword,
                         device="cuda")
    resumed = trainer.resume()
    batch = next(iter(DataLoader(ds, batch_size, shuffle=False, device="cuda")))
    paths = trainer.save_img_results(batch, trainer.state.step)
    pngs = [os.path.basename(p) for p in paths
            if open(p, "rb").read(8) == b"\x89PNG\r\n\x1a\n"]
    finite = all(np.isfinite(v) for c in calls for e in c["epochs"] for v in e["logs"].values())
    say("gan_cli", batch=batch_size, calls=[{k: v for k, v in c.items()} for c in calls],
        checkpoints=ckpt.steps(), checkpoint_step=saved["step"],
        encoders_from_net_e=encoders_kept, resumed_on_card=resumed, images=pngs)
    want_steps = len(ds) // batch_size
    ok = (finite and encoders_kept and resumed and ckpt.steps() == [0, 1]
          and saved["step"] == 2 * want_steps
          and [c["resumed_from"] for c in calls] == [None, 0]
          and all(c["steps"] == want_steps and c["launches"] == {
              k: n * want_steps for k, n in GAN_STEP_LAUNCHES.items()} for c in calls)
          and pngs == [f"G_avg_{2 * want_steps}_0.png", f"attn_{2 * want_steps}.png"])
    if not ok:
        raise AssertionError(f"GAN CLI: {calls}, checkpoints {ckpt.steps()}, step "
                             f"{saved['step']}, encoders kept {encoders_kept}, images {pngs}")
    return calls


DAMSM_KERNELS = {  # wrapper name -> (CUDA source, the TPU kernel it replaces)
    "damsm_sim_fwd": ("sba_gan_tpu_torch/ops/csrc/damsm_sim.cu",
                      "sba_gan_tpu/ops/damsm_sim.py:157"),
    "damsm_sim_dimg": ("sba_gan_tpu_torch/ops/csrc/damsm_sim.cu",
                       "sba_gan_tpu/ops/damsm_sim.py:188"),
    "damsm_sim_dwords": ("sba_gan_tpu_torch/ops/csrc/damsm_dwords.cu",
                         "sba_gan_tpu/ops/damsm_sim.py:214"),
}
PRETRAIN_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "sba_gan_tpu_torch", "configs", "DAMSM", "bird.yml")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from sba_gan_tpu_torch.config import preset
    from sba_gan_tpu_torch.data.vocab import synthetic_vocab

    name, _ = phase_device()
    phase_build()
    rows, gan_rows = phase_kernels()
    damsm_rows = phase_damsm_kernels()
    cfg = preset("eval_bird")
    wordtoix, ixtoword = synthetic_vocab(N_WORDS)
    sampler = phase_slice(cfg, wordtoix)
    launches = phase_serve(cfg, sampler, wordtoix, ixtoword)
    phase_pretrain_step(preset("DAMSM/bird"), batch_size=32)
    with tempfile.TemporaryDirectory() as out:
        launches.update(phase_pretrain_cli(PRETRAIN_CFG, os.path.join(out, "damsm")))
        gan_launches = phase_gan_step()
        phase_gan_bench()
        phase_gan_cli(os.path.join(out, "damsm", "Model"), out)

    # the kernels line: K4 at the largest serving shape of one request,
    # K1-K3 at the pretrain shape, with the GAN step's shapes beside
    main_row = next(r for r in rows if r["shape"] == "B1 QL16384 T25 D32")
    kernels = [{
        "name": "word_attention",
        "route": "cuda",
        "source": "sba_gan_tpu_torch/ops/csrc/word_attention.cu",
        "replaces": "sba_gan_tpu/ops/word_attention.py:65",
        "launches": launches["word_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in rows + gan_rows),
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "eager_ms": main_row["eager_ms"],
        "gan_step_launches": gan_launches["word_attention"],
        "gan_step": [{k: r[k] for k in ("shape", "kernel_ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by", "eager_ms", "max_abs_err")}
                     for r in gan_rows],
    }]
    for kname, (source, replaces) in DAMSM_KERNELS.items():
        row, gan = damsm_rows["pretrain"][kname], damsm_rows["gan_step"][kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": max(r[kname]["max_abs_err"] for r in damsm_rows.values()),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": row["shape"], "eager_ms": row["eager_ms"],
            "bound_tc_ms": row["bound_tc_ms"],
            "gan_step_launches": gan_launches[kname],
            "gan_step": {k: gan[k] for k in ("shape", "kernel_ms", "plain_ms",
                                             "bound_ms", "bound_by", "eager_ms",
                                             "bound_tc_ms")},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
