"""Quickest proof that the PyTorch port runs on the GPU: ``python3 chip_smoke.py``.

Run from the root of a checkout, on a machine with one CUDA card (an H100
for the numbers in PERF.md).  It imports the port (``sba_gan_tpu_torch``)
and nothing of JAX.  Phases, each printing one line or more:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles every CUDA kernel of the port from ``ops/csrc`` (nvcc,
   all sources at once) and loads it;
3. kernel checks: each kernel against its plain PyTorch version on the card
   at the serving shapes (word attention: B 1 and 6, QL 64^2, 128^2 and a
   ragged QL, T 25, D 32; ragged captions and an all-padding row), with
   the kernel's, the plain version's and one library call's device times
   (calls captured in a CUDA graph) and times as called from Python, and
   the least time the card could take;
4. DAMSM kernels: the similarity kernels K1-K3 (forward, image gradient,
   word gradient) against their plain versions in the same way, at B 32 T 20 (pretrain), B 128 T 18 (the GAN step's shape) and
   a ragged B 30, R 289, D 256, captions of 1 to T words, with a random
   cotangent; no single library call computes them (``library_ms`` null).
   K3 runs its products on the tensor cores in 3xTF32: its row also gives
   the bound of those products at the TF32 rate (``bound_tc_ms``);
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
9. the ``kernels`` JSON line, then the device JSON line last.

Any failure raises, and the script exits non-zero.  Without CUDA it exits
non-zero and prints no result.
"""

from __future__ import annotations

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


def phase_build():
    from sba_gan_tpu_torch.ops import _build

    t0 = time.time()
    logs = _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    seconds = time.time() - t0
    for name, log in logs.items():
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        say("build", kernel=name, ptxas=ptxas)
    say("build", seconds=round(seconds, 3), kernels=sorted(logs))


def word_attention_case(b, ql, t, d, lens, seed):
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
    return {
        "shape": f"B{b} QL{ql} T{t} D{d}",
        "max_abs_err": err,
        "kernel_ms": device_ms(kernel),
        "plain_ms": device_ms(plain),
        "library_ms": device_ms(library),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "eager_ms": eager_ms(kernel),
        "plain_eager_ms": eager_ms(plain),
        "library_eager_ms": eager_ms(library),
    }


def phase_kernels():
    t, d = 25, 32
    rows = []
    for b, lens in ((1, [11]), (6, [25, 18, 9, 3, 1, 0])):
        for ql in (64 * 64, 128 * 128, 4133):
            row = word_attention_case(b, ql, t, d, lens, seed=len(rows))
            say("kernel", name="word_attention", **row)
            rows.append(row)
    return rows


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
        if name == "damsm_sim_dwords":  # 3xTF32: each product three times
            rows[name]["bound_tc_ms"] = max(bytes_ms,
                                            3 * flops / TF32_FLOPS_PER_S * 1e3)
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
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
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
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
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


def phase_pretrain_cli(cfg_path):
    """``pretrain.main`` on the card: one epoch of synthetic data at full
    width, evaluation, a checkpoint; counts of K1-K3 set to 0 just before.
    Then the checkpoint is restored into a trainer on the card, as a resume
    does, and the CLI's attention dump runs on one batch."""
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
    with tempfile.TemporaryDirectory() as out:
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

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fakes_g, atts_g = gpu.with_noise(ids, lens, z, eps)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
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
    rows = phase_kernels()
    damsm_rows = phase_damsm_kernels()
    cfg = preset("eval_bird")
    wordtoix, ixtoword = synthetic_vocab(N_WORDS)
    sampler = phase_slice(cfg, wordtoix)
    launches = phase_serve(cfg, sampler, wordtoix, ixtoword)
    phase_pretrain_step(preset("DAMSM/bird"), batch_size=32)
    launches.update(phase_pretrain_cli(PRETRAIN_CFG))

    # the kernels line: K4 at the largest serving shape of one request,
    # K1-K3 at the pretrain shape, with the GAN step's shape beside
    main_row = next(r for r in rows if r["shape"] == "B1 QL16384 T25 D32")
    kernels = [{
        "name": "word_attention",
        "route": "cuda",
        "source": "sba_gan_tpu_torch/ops/csrc/word_attention.cu",
        "replaces": "sba_gan_tpu/ops/word_attention.py:65",
        "launches": launches["word_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "eager_ms": main_row["eager_ms"],
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
            "gan_step": {k: gan[k] for k in ("shape", "kernel_ms", "plain_ms",
                                             "bound_ms", "bound_by", "eager_ms",
                                             "bound_tc_ms") if k in gan},
        })
        if "bound_tc_ms" in row:
            kernels[-1]["bound_tc_ms"] = row["bound_tc_ms"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
