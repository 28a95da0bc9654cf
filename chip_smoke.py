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
   batch 128 (or the largest that fits, stated), a window of 10 steps and
   one traced (``SHORT_BENCH``), its JSON line printed on its own line; it
   must run at the precision step 9 checked;
11. GAN CLI: ``main.main`` trains one epoch of synthetic data at batch 32
   with the encoders of the pretrain CLI's checkpoint (``TRAIN.NET_E``),
   saves the full GAN state, and a second call resumes for another epoch
   (kernel counts checked per step); the checkpoint restores into a trainer
   on the card, which renders the EMA sample and the attention grid;
12. CUB tree: a CUB-200-2011 layout written to a temporary directory at
   CUB's scale per image (JPEGs of 500 x 375, bounding boxes, 10 captions
   each over 300 made-up words, two example caption files of 8 lines), 17
   classes, 170 test items (10 batches of 16 and a ragged tail of 10) and
   32 train items; every item read with 0 and with 4 reader threads must be
   equal exactly, items/s of both printed;
13. CUB training: ``main.main`` with bird_style on that tree (batch 16, 4
   reader threads, one epoch = 2 steps), finite logs, the GAN step's kernel
   counts per step;
14. evaluation sampling: reference-layout ``netG.pth`` (the GAN CLI's EMA
   generator), ``text_encoder.pth`` (seeded, at the tree's vocabulary) and
   ``image_encoder.pth`` (the pretrain CLI's); ``main.main`` with eval_bird
   and ``B_VALIDATION`` writes 170 PNGs with K4 launched twice per batch
   (22); the first batch from the same files and noise gives those PNGs
   again, and with TF32 off the card matches the CPU within SLICE_ATOL;
   sampled images/s;
15. gen_example: the same with ``B_VALIDATION`` false and ``TRAIN.MIXING``:
   per example file, each caption's three stages, ``attention_maps.png``
   and the four mixing sets (K4 20 launches);
16. reproduce: ``reproduce.main`` with R-precision over 100 candidates on
   the 170 test items (K4 44 launches: sampling and R-precision), FID
   between its samples and the 170 real test images, ``evaluate.main`` on
   the samples giving the same IS, the Inception classifier card against
   CPU on one batch (TF32 off, ``CLASSIFIER_TOL``) and its images/s; the
   scores are of random weights and mean nothing;
17. BERT (bert-base: 12 layers, hidden 768, 12 heads, random weights from
   a seed), after the evaluation phases: ``bert_encoder``, the encoder at
   batch 8 and T 20 (captions of 2 to 20 wordpieces) on the card against
   the CPU (TF32 off, BERT_TOL); ``gan_step_bert``, step 9 with
   ``configs/bird_bert.yml`` (M_NUM 8, INIT_Z_CONCAT False; the same
   readings and bounds against the CPU's float64 step; K4 2, K1 1, K2 1,
   K3 0), then ``gan_step_mixing``, one ``bird_mixing.yml`` step ((2, B, Z)
   noise) card against CPU, logs within GAN_STEP_TOL's, the same launches;
   ``pretrain_step_bert``, one ``configs/DAMSM/bird_bert.yml`` train step
   (batch 32, Inception at 299, T 20; every BERT parameter and Mixed_7a/b/c
   train) card against CPU (PRETRAIN_BERT_TOL), K1, K2 and K3 once each,
   the words' gradient finite and exactly 0 at padding and the text clip
   applied; ``gan_bench_bert``, ``bench.measure`` on the flagship dims
   with the bird_bert keys in float32 and bfloat16, beside step 10's
   bird_style lines; ``bert_cli``, steps 8 and 11 with the BERT presets
   (``pretrain.main``, then ``main.main`` with its checkpoint as
   TRAIN.NET_E: train, save, resume, render);
18. data parallelism and gradient accumulation (``parallel/dist.py``,
   ``TRAIN.GRAD_ACCUM``), after the BERT phases, each line with its
   seconds: ``grad_accum``, two full-width micro-steps (bird_style, batch 8,
   the Ds held still) on the card in 'window' and in 'dfresh' against the
   CPU's float64 window, the gan_step bounds, G and its EMA still after
   micro-step 1 and moved after 2, the Ds' Adam cadence, K4 2, K1 1, K2 1,
   K3 0 a micro-step; ``dist_nccl1``, the flagship step (batch 128) for
   three steps and one bfloat16 step as the one rank of a world over NCCL
   against no group (bit-identical, or within DIST1_SPREAD of the card's
   own run-to-run spread); ``dist_gloo2``, two ranks on the one card over
   gloo (spawned processes, 4 rows each) against one process at 8: the GAN
   step in the gan_step bounds, the DAMSM/bird pretrain step in
   PRETRAIN_TOL, both ranks identical, each rank's launches (K4 2, K1 1,
   K2 1 a GAN step; K1, K2, K3 1 a pretrain step); ``gan_bench_dist``,
   ``bench.measure`` of GRAD_ACCUM 2 at 64 in both modes (an update of 128)
   and of the world of one over NCCL at 128, beside step 10's plain step at
   128 (images/s, device ms, launches, collectives' device ms and host
   microseconds a call, peak memory);
   ``dist_cli``, ``torchrun --standalone --nproc_per_node 1`` of ``main``
   (GRAD_ACCUM 3, batch 8, small widths: a save in the middle of a window,
   a resume that finishes it) and of ``pretrain`` (one epoch);
19. ``GAN.B_DCGAN`` (``configs/bird_attnDCGAN2.yml``: GDCGAN, K4 in both
   refinement stages, one DNet256 without an unconditional head; R_NUM 0,
   lambda 1), after the data-parallel phases, each line with its seconds;
   the CPU's runs of its step start in a thread beside the first three:
   ``dcgan_cli``, step 11 with that preset at batch 16 (train, save,
   resume, render) and 2 steps on the CUB tree (``dcgan_cub_train``, one
   256 image an item); ``serve_dcgan``, the WSGI app with
   ``eval_bird_attnDCGAN2.yml`` and an ``.npz`` of seeded weights (the
   JAX trees' layout, restored exactly; one generation card against CPU),
   one ``POST /api/v1.0/bird``: one stage, two maps, K4 twice;
   ``gan_step_dcgan``, step 9 with that preset (the same readings and
   bounds against the CPU's float32 and float64 steps; K4 2, K1 1, K2 1, K3
   0; one D; the mapping net's gradient finite and nonzero on both
   devices); ``gan_bench_dcgan``, ``bench.measure`` with the preset's keys
   at batch 30 in float32 and bfloat16 and at 128 in float32, beside step
   10's bird_style lines;
20. ``JAX.DAMSM_CHUNKS`` in pretraining, the native JPEG loader and the
   profiling hooks: ``pretrain_step_chunks`` (after step 7), step 7's step
   with DAMSM_CHUNKS 2 (the train-mode Inception over two sequential
   sub-batches, each with its own BatchNorm statistics) card against CPU
   under PRETRAIN_TOL, running statistics included, K1, K2 and K3 once
   each, its logs and running statistics far from step 7's one-pass ones;
   ``profiling`` (after step 8), three pretrain steps under
   ``utils.profiling.trace`` with each batch under ``annotate("data")``: the
   trace holds three ``data`` ranges and K1-K3 by name; ``pretrain_chunks_memory``
   (after step 9), ms a step and peak memory at batch 128 and 512 with
   chunks 1 and 4; ``native_loader`` (after step 12), ``MODEL.IMAGE_LOADER:
   native`` on the CUB tree: where g++ or libjpeg is missing, the build's
   error line and the reader raising without a PIL read; where it builds,
   items against PIL's and 0 against 4 threads, items/s;
21. AttnGAN2 on COCO at its published widths (``configs/coco_attn2.yml``:
   GF_DIM 48, DF_DIM 96, R_NUM 3, WORDS_NUM 12, lambda 50; ``eval_coco.yml``,
   WORDS_NUM 20, batch 100; ``DAMSM/coco.yml``, WORDS_NUM 15, batch 48; the
   COCO vocabulary of 27,297 words), after the DCGAN phases; their CPU
   references start in the thread beside the DCGAN and COCO CLI phases:
   ``coco_tree``, a COCO-layout tree (flat ``images/`` of 640 x 480 JPEGs,
   no boxes, 5 captions an image, 100 test and 96 train items); ``coco_cli``,
   ``pretrain.main`` with DAMSM/coco on it (``coco_pretrain_cli``: two steps,
   two evaluation batches), ``main.main`` with coco_attn2 and that
   checkpoint as TRAIN.NET_E (``coco_gan_cli``: an epoch of 6 steps of 14,
   save, resume), its EMA G as a reference-layout ``netG.pth`` and
   ``main.main`` with eval_coco and ``B_VALIDATION`` (``coco_sampling``: 100
   PNGs in one batch, K4 twice, the first 4 images card against CPU within
   SLICE_ATOL); ``pretrain_step_coco``, step 7 at DAMSM/coco's batch 48 and
   T 15 (PRETRAIN_TOL; K1, K2, K3 once each); ``gan_step_coco``, step 9
   with coco_attn2 at batch 8 and WORDS_NUM 12 (the gan_step bounds); K4's
   D 48 instance in kernel rows (B 14 and 128, QL 64^2 and 128^2, T 12,
   float32 and bfloat16; B 100 QL 64^2 T 20; B 1 QL 128^2 T 20; each with
   an all-padding row, and failing unless the launch took the D 48
   instance) and K1-K3 at B 48 T 15; ``gan_bench_coco``,
   ``bench.measure`` with the coco_attn2 keys at batch 14 and 128 (or the
   largest that fits) in float32 and bfloat16, beside step 10's
   bird_style lines;
22. the ``kernels`` JSON line (with each kernel's launches in the GAN step,
   K4's also in the evaluation phases, each kernel's on the BERT paths
   under ``bert_paths``, on the data-parallel paths under ``dist_paths``,
   on the GAN.B_DCGAN paths under ``dcgan_paths``, K1-K3's on the
   chunked pretraining and profiling paths under ``chunks_paths``, each
   kernel's on the COCO paths under ``coco_paths`` with its COCO rows, and
   each entry's on the gen-2 paths under ``gen2_paths``, all 0), then
   the device JSON line last;
23. the gen-2 conditional StyleGAN at ``configs/gen2_birds.yml``'s widths
   (128^2 from a 4^2 constant, FMAP_BASE 4096 / FMAP_MAX 256, bert-base at
   random init, E/C/Z 128, W and A 256, 8 mapping layers, WGAN-GP at
   lambda 10, CRITIC_ITER 5, RMSprop), after the COCO phases; no kernel is
   on its path, and each phase requires K1-K4's counts, set to 0 just
   before, to read 0 just after; its CPU references start in the thread
   beside the COCO phases: ``gen2_step``, one D step and one G step at
   batch 8 on the card (TF32 off) against the CPU's float64 run of the
   same weights (G's constant drawn too), batch and draws, for the preset,
   for BCE mode (Inception at 299) and for a G with every toggle on
   (attention style, noise, pixel norm, truncation): the losses, each
   net's whole gradient and the parameters after RMSprop's first update
   within the gan_step bounds, the EMA, the frozen BERT tower's largest
   change 0.0 on both devices, the CPU's own float32 run's readings beside;
   the preset's step at the bench's precision (TF32 convolutions) within
   GAN_TF32_TOL's; ``gen2_cli``, ``prepare_data`` over a birds-layout tree
   it writes (16 JPEGs of CUB's size, 6 captions each of made-up words;
   sizes 4 to 128, 4 workers), then ``gen2_main`` with the preset: one
   epoch of the pack at batch 2, a second call that resumes from its
   checkpoint, one epoch of synthetic data at batch 8 (grids, checkpoints,
   finite losses); ``gen2_bench``, the training loop at batch 8 and 64 (3
   D steps of warm-up, a window of 20 D steps and 4 G steps closed by one
   host read; then the D step, the G step and a loop of 5 D steps and a G
   step traced apart: device ms, launches, idle share, the kernels by
   time; peak memory), beside step 10's bird_style lines.

The phases run in the order of ``main``, which differs from the numbers
above: one thread computes the CPU's reference runs of the GAN steps (step
9, the BERT steps of 17, the accumulation window of 18, the DCGAN step of
19, the COCO steps of 21, the gen-2 steps of 23) beside phases whose host
time is no metric (the
pretraining phases, the CLIs, the ranks); each line carries ``at_s``, its
seconds since the start.  Every bench line times a window of 10 steps and
traces one (``SHORT_BENCH``); the bench lines after step 10 run on copies
of one seeded draw of weights per architecture (``seeded_models``).

Under ``JAX.DTYPE`` and ``LOSS_DTYPE`` bfloat16 (the JAX package's
accelerator setting), beside the float32 phases: each kernel's bfloat16
instantiation against its plain bfloat16 version at the float32 rows'
shapes and inputs (K4 at B 1 QL 128^2 T 25 and B 128 QL 64^2 and 128^2 T
18; K1-K3 at B 32 T 20 and B 128 T 18), the plain float32 result printed
beside, each at least ten times closer to plain bfloat16 than that is to
float32 (after step 4); one bfloat16 generation, card against CPU (after
step 6); one full-width bfloat16 DAMSM train step, card against CPU, K1-K3
launched in bfloat16 (after step 7); one full-width bfloat16 GAN step
(batch 8) against the CPU's float64 step of step 9, with K4 2, K1 1, K2 1,
K3 0 bfloat16 launches (after step 9); and ``bench --dtype bfloat16`` at
batch 128 (after step 10).  The kernels line lists every kernel twice,
its float32 entry and its ``_bf16`` entry, whose launches are those of
the bfloat16 GAN step (K3: the bfloat16 pretrain step).

Any failure raises, and the script exits non-zero.  Without CUDA it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import io
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM, TF32 on the tensor cores, dense
BF16_FLOPS_PER_S = 989e12  # H100 SXM, bf16 on the tensor cores, dense
BF16 = torch.bfloat16
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


T_START = time.perf_counter()


def say(phase: str, **fields) -> None:
    """One JSON line of ``phase``, stamped with the seconds since the script
    started (``at_s``)."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": round(time.perf_counter() - T_START, 1)}), flush=True)


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


def padding_row_err(q, s, pad) -> float:
    """K4 at a row's shape and inputs with caption 0 made all padding and its
    queries scaled by D^-0.5: every score of that row then stays within 32
    of 0, where the pad bias -1e9's float32 neighbours lie 64 apart, so its
    P must be uniform over all T words (KERNEL_TOL), and the rest match
    plain.  Returns that row's largest distance from 1/T."""
    from sba_gan_tpu_torch.ops import word_attention as wa

    t = s.shape[1]
    q1, pad1 = q.clone(), pad.clone()
    q1[0] *= q.shape[2] ** -0.5
    pad1[0] = True
    _, att = wa.word_attention(q1, s, pad1)
    torch.cuda.synchronize()
    _, att_p = wa.word_attention_plain(q1, s, wa.pad_bias(pad1, s))
    torch.testing.assert_close(att, att_p, **KERNEL_TOL)
    torch.testing.assert_close(att[0], torch.full_like(att[0], 1.0 / t), **KERNEL_TOL)
    return (att[0] - 1.0 / t).abs().max().item()


def word_attention_case(b, ql, t, d, lens, seed, reps=None, padding_row=False):
    """K4 against its plain version at one shape, timed beside the plain
    version and the library's three calls; ``instance``: the kernel
    instance the launch took (:func:`padding_row_err` too, with
    ``padding_row``)."""
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
    extra = {"padding_row_err": padding_row_err(q, s, pad)} if padding_row else {}
    return {
        "shape": f"B{b} QL{ql} T{t} D{d}",
        "instance": wa.instance(d, q.data_ptr() % 16 == 0),
        **extra,
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


def pretrain_step_inputs(cfg, batch_size, chunks=1, n_words=N_WORDS):
    """A full-width DAMSM train step's config (``JAX.DAMSM_CHUNKS``
    ``chunks``), random models from SEED over a vocabulary of ``n_words``,
    one synthetic batch and its dropout mask, all on the CPU."""
    from sba_gan_tpu_torch.data.pipeline import collate
    from sba_gan_tpu_torch.data.cub import SyntheticDataset
    from sba_gan_tpu_torch.train.damsm import build_damsm_models

    cfg = copy.deepcopy(cfg)
    cfg.TRAIN.BATCH_SIZE = batch_size
    cfg.JAX.DAMSM_CHUNKS = chunks
    models = build_damsm_models(cfg, n_words, seed=SEED)
    ds = SyntheticDataset(num_examples=batch_size, base_size=cfg.TREE.BASE_SIZE,
                          branch_num=cfg.TREE.BRANCH_NUM, words_num=cfg.TEXT.WORDS_NUM,
                          n_words=n_words, seed=SEED)
    batch = collate([ds[i] for i in range(batch_size)])
    keep = models.text_encoder.dropout_mask(batch.captions,
                                            torch.Generator().manual_seed(SEED + 2))
    return cfg, models, batch, keep


def pretrain_step_run(inputs, device, count=True):
    """One step of :func:`pretrain_step_inputs` on ``device`` from a copy of
    its models (TF32 as the caller set it): logs, gradients, running
    statistics, seconds and the launches (counts set to 0 just before; None
    without ``count``, for a CPU run beside phases that count)."""
    from sba_gan_tpu_torch.train.damsm import DAMSMTrainer

    cfg, models, batch, keep = inputs
    wrappers = _kernel_wrappers()
    trainer = DAMSMTrainer(cfg, copy.deepcopy(models), device=device)
    if count:
        reset_launches(wrappers)
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
    return dict(logs=logs, grads=grads, stats=stats, seconds=seconds,
                launches=read_launches(wrappers) if count else None)


def pretrain_step_runs(cfg, batch_size, chunks=1, inputs=None, cpu=None):
    """One full-width DAMSM train step of ``cfg`` (``JAX.DAMSM_CHUNKS``
    ``chunks``; or of ``inputs``) on the card and on the CPU (``cpu``: its
    run, made already) from the same weights, batch and dropout mask, TF32
    off (:func:`pretrain_step_run`)."""
    inputs = inputs or pretrain_step_inputs(cfg, batch_size, chunks)
    with tf32(cudnn=False, matmul=False):
        runs = {"cuda": pretrain_step_run(inputs, "cuda")}
        runs["cpu"] = cpu or pretrain_step_run(inputs, "cpu")
    return runs


def pretrain_step_readings(runs):
    """The card's step against the CPU's, as PRETRAIN_TOL reads them."""
    from sba_gan_tpu_torch.train.damsm import LOG_KEYS

    gpu, cpu = runs["cuda"], runs["cpu"]
    return {
        "logs": max(abs(gpu["logs"][k] - cpu["logs"][k]) / abs(cpu["logs"][k])
                    for k in LOG_KEYS),
        "grads": {n: _rel_err(g, cpu["grads"][n]) for n, g in gpu["grads"].items()},
        "stats": max(_rel_err(s, cpu["stats"][n]) for n, s in gpu["stats"].items()),
    }


def phase_pretrain_step(cfg, batch_size, phase="pretrain_step", inputs=None, cpu=None):
    """One full-width DAMSM train step on the card against the same step on
    the CPU (``cpu``: its run of ``inputs``, made already): same weights,
    batch and dropout mask, TF32 off; K1, K2 and K3 once each on the
    card."""
    runs = pretrain_step_runs(cfg, batch_size, inputs=inputs, cpu=cpu)
    gpu, cpu = runs["cuda"], runs["cpu"]
    errs = pretrain_step_readings(runs)
    worst_grad = max(errs["grads"].values())
    say(phase, batch=batch_size, words_num=cfg.TEXT.WORDS_NUM, logs_cuda=gpu["logs"],
        logs_cpu=cpu["logs"],
        rel_err_logs=errs["logs"], rel_err_grads_max=worst_grad,
        rel_err_grads={n: e for n, e in errs["grads"].items() if "emb_" in n or
                       n.startswith("text.")},
        rel_err_running_stats=errs["stats"], tol=PRETRAIN_TOL,
        grads_compared=sorted(gpu["grads"]), step_s_cuda=gpu["seconds"],
        step_s_cpu=cpu["seconds"], launches=gpu["launches"], cpu_launches=cpu["launches"])
    if gpu["launches"] != PRETRAIN_STEP_LAUNCHES or any((cpu["launches"] or {}).values()):
        raise AssertionError(f"{phase}: launches {gpu['launches']} (want "
                             f"{PRETRAIN_STEP_LAUNCHES}), on the CPU {cpu['launches']}")
    image_grads = sorted(n for n in gpu["grads"] if n.startswith("image."))
    if image_grads != ["image.emb_cnn_code.bias", "image.emb_cnn_code.weight",
                       "image.emb_features.weight"]:
        raise AssertionError(f"unexpected trainable image parameters: {image_grads}")
    if not (errs["logs"] <= PRETRAIN_TOL["logs"] and worst_grad <= PRETRAIN_TOL["grads"]
            and errs["stats"] <= PRETRAIN_TOL["stats"]):
        raise AssertionError(f"{phase}: card and CPU disagree beyond {PRETRAIN_TOL}")
    return runs


PRETRAIN_CHUNKS = 2  # JAX.DAMSM_CHUNKS of the pretrain_step_chunks phase
PRETRAIN_STEP_LAUNCHES = {"word_attention": 0, "damsm_sim_fwd": 1, "damsm_sim_dimg": 1,
                          "damsm_sim_dwords": 1}


def phase_pretrain_step_chunks(cfg, batch_size, one_pass):
    """The pretrain_step phase's step with ``JAX.DAMSM_CHUNKS``
    PRETRAIN_CHUNKS (the train-mode Inception over sequential sub-batches of
    batch / chunks rows, each with its own BatchNorm statistics, the running
    statistics moved once per sub-batch), on the card against the CPU under
    PRETRAIN_TOL (logs, gradients, running statistics); K1, K2 and K3 once
    each on the card (the losses run once on the whole batch); the card's
    logs and running statistics other than those of the one-pass step of
    ``one_pass`` (:func:`phase_pretrain_step`'s runs: the same weights,
    batch and dropout mask) by a hundred times the card-vs-CPU readings of
    either step, so the key took effect."""
    t0 = time.perf_counter()
    runs = pretrain_step_runs(cfg, batch_size, PRETRAIN_CHUNKS)
    gpu, cpu = runs["cuda"], runs["cpu"]
    errs = pretrain_step_readings(runs)
    worst_grad = max(errs["grads"].values())
    base = one_pass["cuda"]
    moved = {"logs": max(abs(gpu["logs"][k] - base["logs"][k]) / abs(base["logs"][k])
                         for k in gpu["logs"]),
             "stats": max(_rel_err(v, base["stats"][n]) for n, v in gpu["stats"].items())}
    say("pretrain_step_chunks", batch=batch_size, chunks=PRETRAIN_CHUNKS,
        logs_cuda=gpu["logs"], logs_cpu=cpu["logs"], logs_cuda_one_pass=base["logs"],
        rel_err_logs=errs["logs"], rel_err_grads_max=worst_grad,
        rel_err_running_stats=errs["stats"], tol=PRETRAIN_TOL,
        card_against_one_pass=moved, launches=gpu["launches"],
        cpu_launches=cpu["launches"], step_s_cuda=gpu["seconds"],
        step_s_cpu=cpu["seconds"], seconds=time.perf_counter() - t0)
    bad = [k for k, v in (("logs", errs["logs"]), ("grads", worst_grad),
                          ("stats", errs["stats"])) if not v <= PRETRAIN_TOL[k]]
    if gpu["launches"] != PRETRAIN_STEP_LAUNCHES or any(cpu["launches"].values()):
        bad.append(f"launches {gpu['launches']} (want {PRETRAIN_STEP_LAUNCHES})")
    # per-sub-batch statistics are other values: a hundred times beyond the
    # card-vs-CPU agreement of either step
    agree = pretrain_step_readings(one_pass)
    if not (moved["logs"] > 100 * max(errs["logs"], agree["logs"])
            and moved["stats"] > 100 * max(errs["stats"], agree["stats"])):
        bad.append(f"the chunked step equals the one-pass step ({moved})")
    if bad:
        raise AssertionError(f"pretrain_step_chunks: {bad}")
    return gpu["launches"]


# (batch, JAX.DAMSM_CHUNKS) of the pretrain_chunks_memory phase
CHUNKS_MEMORY = ((128, 1), (128, 4), (512, 1), (512, 4))


def phase_pretrain_chunks_memory(cfg, steps=3):
    """Whether ``JAX.DAMSM_CHUNKS`` (built to cut the train-mode Inception's
    peak in TPU HBM) buys anything on the card: the full-width DAMSM/bird
    train step at the batches and chunk counts of CHUNKS_MEMORY (random
    weights and a random batch on the card, PyTorch's default precision):
    ms a step (the median of ``steps`` steps after one of warm-up, each
    between CUDA events), the peak of allocated memory from a reset just
    before, and each kernel's launches a step.  Torch keeps no activations
    of the frozen trunk for the backward, so only the forward's peak can
    shrink."""
    from sba_gan_tpu_torch.train.damsm import DAMSMTrainer, build_damsm_models

    t0 = time.perf_counter()
    models = build_damsm_models(cfg, N_WORDS, seed=SEED)
    wrappers = _kernel_wrappers()
    lines = {}
    for batch, chunks in CHUNKS_MEMORY:
        c = copy.deepcopy(cfg)
        c.TRAIN.BATCH_SIZE, c.JAX.DAMSM_CHUNKS = batch, chunks
        gen = torch.Generator().manual_seed(SEED + batch)
        size, t = c.MODEL.INCEPTION_INPUT, c.TEXT.WORDS_NUM
        cap_lens = torch.randint(1, t + 1, (batch,), generator=gen)
        captions = torch.randint(1, N_WORDS, (batch, t), generator=gen)
        captions[torch.arange(t)[None, :] >= cap_lens[:, None]] = 0
        args = (torch.rand((batch, size, size, 3), generator=gen).mul(2).sub(1).cuda(),
                captions.cuda(), cap_lens,
                torch.randint(0, 200, (batch,), generator=gen).cuda())
        trainer = DAMSMTrainer(c, copy.deepcopy(models), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        float(trainer.train_step(*args)["total"])
        reset_launches(wrappers)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        marks[0].record()
        for i in range(steps):
            logs = trainer.train_step(*args)
            marks[i + 1].record()
        finite = bool(torch.isfinite(logs["total"]))
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        lines[f"b{batch}_chunks{chunks}"] = dict(
            batch=batch, chunks=chunks, step_ms=ms, step_ms_median=statistics.median(ms),
            images_per_s=batch * 1e3 / statistics.median(ms),
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, finite=finite,
            launches_per_step={k: v / steps for k, v in read_launches(wrappers).items()})
        del trainer, args, logs
        gc.collect()
        torch.cuda.empty_cache()
    say("pretrain_chunks_memory", lines=lines, tf32={
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32},
        seconds=time.perf_counter() - t0)
    bad = [k for k, v in lines.items() if not v["finite"]
           or v["launches_per_step"] != PRETRAIN_STEP_LAUNCHES]
    if bad:
        raise AssertionError(f"pretrain_chunks_memory: {bad}: "
                             f"{ {k: lines[k]['launches_per_step'] for k in bad} }")
    return {k: v["launches_per_step"] for k, v in lines.items()}


def phase_pretrain_cli(cfg_path, out, data_dir=None, name="pretrain_cli"):
    """``pretrain.main`` on the card: one epoch of synthetic data (or of the
    tree ``data_dir``) at full width, evaluation, a checkpoint under
    ``out``; the counts of K1-K4 set to 0 just before (K4 runs on no
    pretrain path).  Then the checkpoint is restored into a trainer on the
    card, as a resume does, and the CLI's attention dump runs on one
    batch."""
    from sba_gan_tpu_torch import pretrain
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.pipeline import build_dataset
    from sba_gan_tpu_torch.data.pipeline import DataLoader
    from sba_gan_tpu_torch.train.damsm import (DAMSMTrainer, build_damsm_models,
                                               image_trainable_mask)
    from sba_gan_tpu_torch.utils.checkpoint import Checkpointer

    wrappers = _kernel_wrappers()
    reset_launches(wrappers)
    data = ["--data_dir", data_dir] if data_dir else ["--synthetic"]
    summary = pretrain.main(["--cfg", cfg_path, *data, "--max_epoch", "1",
                             "--output_dir", out])
    launches = read_launches(wrappers)
    epoch = summary["epochs"][0]
    saved = Checkpointer(os.path.join(out, "Model")).restore()

    cfg = cfg_from_file(cfg_path)
    cfg.JAX.SEED = 100  # the CLI's --manualSeed default
    cfg.DATA_DIR = data_dir or cfg.DATA_DIR
    train_ds = build_dataset(cfg, not data_dir, "train")  # synthetic: 300 words
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
    evals = min(50, len(build_dataset(cfg, not data_dir, "test")) // cfg.TRAIN.BATCH_SIZE)
    image_start = start.image_encoder.state_dict()
    image_end = saved["image_encoder"]
    trains = image_trainable_mask(start.image_encoder, cfg.MODEL.TEXT_ENCODER == "bert")
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
    say(name, text_encoder=cfg.MODEL.TEXT_ENCODER, steps=steps,
        eval_batches=evals, launches=launches,
        logs_first=epoch["logs"][0], logs_last=epoch["logs"][-1], val_loss=epoch["val"],
        step_ms=epoch["step_ms"], step_ms_median_after_first=statistics.median(later),
        images_per_s=cfg.TRAIN.BATCH_SIZE * 1e3 / statistics.median(later),
        attention_dumps=images, trunk_unchanged=frozen_same, heads_moved=heads_moved,
        text_moved=text_moved, running_stats_moved=stats_moved,
        resumed_on_card=same)
    want = {"word_attention": 0, "damsm_sim_fwd": steps + evals,
            "damsm_sim_dimg": steps, "damsm_sim_dwords": steps}
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
# The EMA against the CPU's is held past its bound (1e-3 of the parameters'
# difference and two float32 roundings) by EMA_EXCESS, in every phase that
# checks an EMA: the bound is a float64 subtraction, whose own rounding the
# reading may carry (H100: 4.4e-15 in grad_accum, 7.9e-15 once in
# gan_step_bert, 0.0 in other runs).  1e-12 is at least 100 times below one
# float32 rounding of any parameter larger than 1e-3, so it hides no float32
# error.
EMA_EXCESS = 1e-12
GAN_STEP_TOL = {"logs": 1e-3, "stats": 1e-4, "d_grads": 2e-2, "g_grads": 2e-2,
                "damsm_img_grad": 1.5e-2, "params_agreeing_excess": 1e-3,
                "params_adam_excess": 1e-3, "ema_excess": EMA_EXCESS}
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


def reset_launches(wrappers) -> None:
    """Every count of the wrappers to 0: all launches and the bfloat16 ones."""
    for fn in wrappers.values():
        fn.launches = fn.bf16_launches = 0


def read_launches(wrappers, bf16: bool = False) -> dict:
    """{wrapper: launches}, of the bfloat16 instantiations with ``bf16``."""
    return {k: fn.bf16_launches if bf16 else fn.launches for k, fn in wrappers.items()}


_SEEDED = {}  # (seed, the networks' names and shapes) -> their seeded state dicts
_SEEDED_LOCK = threading.Lock()  # the main thread and the CPU pool's thread share it


def seeded_models(cfg, n_words=N_WORDS, seed=SEED):
    """``train.gan.build_models(cfg, n_words, seed)``, its weights drawn once
    per architecture and seed in this process and copied after (the
    orthogonal draws of full-width Ds take seconds on the host each time)."""
    from sba_gan_tpu_torch.train.gan import build_models, init_models

    models = build_models(cfg, n_words)
    nets = (models.text_encoder, models.image_encoder, models.generator,
            *models.discriminators)
    key = (seed, tuple((n, tuple(v.shape)) for m in nets for n, v in m.state_dict().items()))
    with _SEEDED_LOCK:
        cached = _SEEDED.get(key)
    if cached is None:
        init_models(models, seed)
        with _SEEDED_LOCK:
            _SEEDED.setdefault(key, [copy.deepcopy(m.state_dict()) for m in nets])
        return models
    for m, sd in zip(nets, cached):
        m.load_state_dict(sd)
    return models


def gan_step_inputs(seed=SEED, batch_size=8, cfg_path=None, words_num=18, n_words=N_WORDS):
    """bird_style (or the preset ``cfg_path``) at WORDS_NUM ``words_num``
    (None: the preset's) over a vocabulary of ``n_words``: the config,
    random models from ``seed`` (random running statistics in the eval-mode
    Inception), one synthetic batch and the noise of one step, all on the
    CPU."""
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.cub import SyntheticDataset
    from sba_gan_tpu_torch.data.pipeline import collate
    from sba_gan_tpu_torch.train.sample import noise_shape

    cfg = cfg_from_file(cfg_path or GAN_CFG)
    cfg.TEXT.WORDS_NUM = words_num or cfg.TEXT.WORDS_NUM
    cfg.TRAIN.BATCH_SIZE = batch_size
    models = seeded_models(cfg, n_words, seed)
    random_bn_stats(models.image_encoder, torch.Generator().manual_seed(seed + 3))
    ds = SyntheticDataset(num_examples=batch_size, base_size=cfg.TREE.BASE_SIZE,
                          branch_num=cfg.TREE.BRANCH_NUM, words_num=cfg.TEXT.WORDS_NUM,
                          n_words=n_words, b_dcgan=cfg.GAN.B_DCGAN, seed=seed)
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


def gan_step_run(cfg, models, batch, z, eps, device, dtype=torch.float32, count=True):
    """One step from a copy of ``models`` on ``device`` in ``dtype``: its
    logs, gradients, parameters, running statistics, EMA and launch counts
    (set to 0 just before the step, read just after; None without ``count``,
    for a CPU step that runs beside phases that count); all on the CPU."""
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
    if count:
        reset_launches(wrappers)
    t0 = time.perf_counter()
    logs = step(*args, z=z.to(device, dtype), eps=eps.to(device, dtype))
    logs = {k: float(v) for k, v in logs.items()}
    seconds = time.perf_counter() - t0
    launches = read_launches(wrappers) if count else None
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


# the step comparisons' arithmetic (float64 over every parameter of G and
# the Ds: 16 s a comparison on the host at COCO's widths) runs on the card
READINGS_DEVICE = torch.device("cuda")


def _norm_rel(got, want) -> float:
    got, want = got.to(READINGS_DEVICE), want.to(READINGS_DEVICE)
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
            g_card, g_cpu = (r["grads"][n].to(READINGS_DEVICE) for r in (card, cpu))
            p_card, p_cpu = (r["tensors"][n].to(READINGS_DEVICE, torch.float64)
                             for r in (card, cpu))
            diff = (p_card - p_cpu).abs()
            past = diff - ulp * p_cpu.abs()
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
        p_card, p_cpu, e_card, want = (t.to(READINGS_DEVICE, torch.float64) for t in (
            card["tensors"][f"G.{n}"], cpu["tensors"][f"G.{n}"], card["ema"][n], want))
        dp = (p_card - p_cpu).abs()
        diff = (e_card - want).abs()
        slack = 1e-3 * dp + 2 * ulp * want.abs()
        ema_excess = max(ema_excess, (diff - slack).max().item())
    return {"params_agreeing_excess": excess["agreeing"],
            "params_adam_excess": excess["adam"],
            "params_agree_share": counts["agreeing"] / counts["all"],
            "params_sign_share": counts["sign"] / counts["all"],
            "params_max_over_lr": largest, "ema_excess": ema_excess}


def damsm_grad_run(cfg, models, batch, device, dtype=torch.float32, count=True):
    """The G loss's DAMSM terms alone (``GANStep.damsm_loss``) on the batch's
    final-scale images, and their gradient to those images, on ``device``
    in ``dtype``; the kernel counts set to 0 just before, read just after
    (with ``count``)."""
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
    if count:
        reset_launches(wrappers)
    w_loss, s_loss = step.damsm_loss(img, words, sent, batch.cap_lens,
                                     batch.class_ids.to(device))
    (grad,) = torch.autograd.grad(w_loss + s_loss, img)
    return dict(logs={"w_loss": float(w_loss.detach()), "s_loss": float(s_loss.detach())},
                grad=grad.cpu().double(), launches=read_launches(wrappers) if count else None)


def gan_step_readings(cfg, runs) -> dict:
    """Card against CPU from the runs of :func:`gan_step_runs`."""
    from sba_gan_tpu_torch.train.gan import log_keys

    keys = log_keys(sum(k.startswith("errD") for k in runs["cpu"]["logs"]))
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


def gan_step_cpu_runs(inputs, count=True):
    """The CPU's runs of :func:`gan_step_runs` from ``inputs`` (those of
    :func:`gan_step_inputs`): the step in float32, the still-D step in
    float32 and float64, and the DAMSM terms' image gradient in float32 and
    float64; (runs, damsm runs).  Without ``count`` the launches are not
    counted, so that they can run in a thread beside phases that count."""
    cfg, models, batch, z, eps = inputs
    still = still_ds(cfg)

    def run(c, dtype=torch.float32):
        return gan_step_run(c, models, batch, z, eps, "cpu", dtype, count)
    runs = {"cpu": run(cfg), "cpu_still": run(still), "cpu64_still": run(still, torch.float64)}
    dm = {"cpu": damsm_grad_run(cfg, models, batch, "cpu", count=count),
          "cpu64": damsm_grad_run(cfg, models, batch, "cpu", torch.float64, count)}
    return runs, dm


def gan_step_cpu_refs(cfg_path=None, **inputs_kw):
    """A GAN step phase's inputs (:func:`gan_step_inputs` of the preset
    ``cfg_path`` at batch 8) and the CPU's runs of them, the launches not
    counted, so that both are made in a thread beside phases that count."""
    inputs = gan_step_inputs(SEED, 8, cfg_path, **inputs_kw)
    return inputs, gan_step_cpu_runs(inputs, False)


def gan_step_runs(seed=SEED, batch_size=8, cfg_path=None, inputs=None, cpu=None):
    """From one set of inputs (``inputs``, else made from ``seed``): the step
    on the card and on the CPU (float32, TF32 off), the same with the Ds held
    still, the CPU's still step in float64, and the card's still step at the
    bench's precision (GAN_TF32); the DAMSM terms' image gradient
    (``damsm``) the same four ways.  ``cpu``: the CPU's runs, made already
    (:func:`gan_step_cpu_runs` of these inputs)."""
    inputs = inputs or gan_step_inputs(seed, batch_size, cfg_path)
    cfg, models, batch, z, eps = inputs
    still = still_ds(cfg)

    def run(c, device, dtype=torch.float32):
        return gan_step_run(c, models, batch, z, eps, device, dtype)

    def damsm(device, dtype=torch.float32):
        return damsm_grad_run(cfg, models, batch, device, dtype)
    with tf32(cudnn=False, matmul=False):
        runs = {"cuda": run(cfg, "cuda"), "cuda_still": run(still, "cuda")}
        dm = {"cuda": damsm("cuda")}
    cpu_runs, cpu_dm = cpu or gan_step_cpu_runs(inputs)
    runs.update(cpu_runs)
    dm.update(cpu_dm)
    with tf32(**GAN_TF32):
        runs["cuda_tf32_still"] = run(still, "cuda")
        dm["cuda_tf32"] = damsm("cuda")
    runs["damsm"] = dm
    return cfg, runs


def gan_step_f64_runs(seed=SEED, batch_size=8):
    """The CPU's still-D float64 step and DAMSM terms' image gradient alone,
    as :func:`gan_step_runs` makes them."""
    cfg, models, batch, z, eps = gan_step_inputs(seed, batch_size)
    return {"cpu64_still": gan_step_run(still_ds(cfg), models, batch, z, eps, "cpu",
                                        torch.float64),
            "damsm": {"cpu64": damsm_grad_run(cfg, models, batch, "cpu", torch.float64)}}


def phase_gan_step(batch_size=8, cfg_path=None, phase="gan_step", inputs=None, cpu=None):
    """One full-width GAN train step (bird_style, or the preset
    ``cfg_path``) on the card against the CPU (:func:`gan_step_runs`, with
    its ``inputs`` and ``cpu``), held to the bounds above; the card's
    launches in each of its steps: K4 twice, K1 and K2 once, K3 never; K1
    and K2 once in the DAMSM terms alone (a CPU run counted, none)."""
    t0 = time.perf_counter()
    cfg, runs = gan_step_runs(SEED, batch_size, cfg_path, inputs, cpu)
    r = gan_step_readings(cfg, runs)
    dm = runs.pop("damsm")
    say(phase, batch=batch_size, words_num=cfg.TEXT.WORDS_NUM,
        text_encoder=cfg.MODEL.TEXT_ENCODER, m_num=cfg.GAN.M_NUM,
        init_z_concat=cfg.GAN.INIT_Z_CONCAT, b_dcgan=cfg.GAN.B_DCGAN, r_num=cfg.GAN.R_NUM,
        smooth_lambda=cfg.TRAIN.SMOOTH.LAMBDA, seconds=time.perf_counter() - t0,
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
        raise AssertionError(f"{phase}: card and CPU disagree in {bad}")
    none = dict.fromkeys(GAN_KERNELS, 0)
    damsm_only = {**none, "damsm_sim_fwd": 1, "damsm_sim_dimg": 1}
    for k, run in list(runs.items()) + [(f"damsm_{k}", v) for k, v in dm.items()]:
        want = ((damsm_only if k.startswith("damsm") else GAN_STEP_LAUNCHES)
                if "cuda" in k else none)
        if run["launches"] is not None and run["launches"] != want:
            raise AssertionError(f"{phase} {k}: launches {run['launches']} (want {want})")
    return runs["cuda"]["launches"], {**runs, "damsm": dm}


def phase_gan_bench():
    """The port bench at its default, batch 128 (or the largest that fits,
    stated in its line), in this process, with the window and trace of
    :data:`SHORT_BENCH`: its line, then a summary.  It must run at the
    precision whose step ``gan_step`` checked (GAN_TF32)."""
    from sba_gan_tpu_torch import bench

    line = bench.main(SHORT_BENCH_ARGV)
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


def phase_gan_cli(damsm_model_dir, out, batch_size=32, cfg_path=None, name="gan",
                  data_dir=None, render=True):
    """``main.main`` on the card: one epoch of synthetic data (or of the tree
    ``data_dir``) at full width (bird_style, or the preset ``cfg_path``)
    with the pretrain CLI's encoders, a checkpoint under ``out/name``, then
    a second call that resumes for one more epoch; the kernel counts of each
    call checked per step.  With ``render``, the checkpoint then restores
    into a trainer on the card, which renders the EMA sample and the
    attention grid of one batch."""
    import yaml

    from sba_gan_tpu_torch import main as gan_main
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset
    from sba_gan_tpu_torch.train.loop import GANTrainer
    from sba_gan_tpu_torch.utils.checkpoint import Checkpointer

    with open(cfg_path or GAN_CFG) as f:
        raw = yaml.safe_load(f)
    raw["TRAIN"].update(BATCH_SIZE=batch_size, NET_E=damsm_model_dir)
    yml = os.path.join(out, f"{name}.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(raw, f)
    data = ["--data_dir", data_dir] if data_dir else ["--synthetic"]
    argv = ["--cfg", yml, *data, "--output_dir", os.path.join(out, name)]
    wrappers = _kernel_wrappers()
    calls = []
    t_phase = time.perf_counter()
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
    ckpt = Checkpointer(os.path.join(out, name, "Model"))
    saved = ckpt.restore()
    damsm = Checkpointer(damsm_model_dir).restore()
    encoders_kept = all(torch.equal(saved[k][n], v) for k in ("text_encoder", "image_encoder")
                        for n, v in damsm[k].items())
    cfg = cfg_from_file(yml)
    cfg.JAX.SEED = 100  # the CLI's --manualSeed default
    cfg.DATA_DIR = data_dir or cfg.DATA_DIR
    ds = build_dataset(cfg, not data_dir, "train")
    want_steps = len(ds) // batch_size
    resumed, pngs = None, None
    if render:
        trainer = GANTrainer(cfg, os.path.join(out, name), ds, ds.n_words, ds.ixtoword,
                             device="cuda")
        resumed = trainer.resume()
        batch = next(iter(DataLoader(ds, batch_size, shuffle=False, device="cuda")))
        paths = trainer.save_img_results(batch, trainer.state.step)
        pngs = [os.path.basename(p) for p in paths
                if open(p, "rb").read(8) == b"\x89PNG\r\n\x1a\n"]
    finite = all(np.isfinite(v) for c in calls for e in c["epochs"] for v in e["logs"].values())
    say(f"{name}_cli", text_encoder=cfg.MODEL.TEXT_ENCODER, batch=batch_size,
        calls=[{k: v for k, v in c.items()} for c in calls],
        checkpoints=ckpt.steps(), checkpoint_step=saved["step"],
        encoders_from_net_e=encoders_kept, resumed_on_card=resumed, images=pngs,
        seconds=time.perf_counter() - t_phase)
    ok = (finite and encoders_kept and ckpt.steps() == [0, 1]
          and saved["step"] == 2 * want_steps
          and [c["resumed_from"] for c in calls] == [None, 0]
          and all(c["steps"] == want_steps and c["launches"] == {
              k: n * want_steps for k, n in GAN_STEP_LAUNCHES.items()} for c in calls)
          and (not render or (resumed and pngs == [f"G_avg_{2 * want_steps}_0.png",
                                                   f"attn_{2 * want_steps}.png"])))
    if not ok:
        raise AssertionError(f"GAN CLI: {calls}, checkpoints {ckpt.steps()}, step "
                             f"{saved['step']}, encoders kept {encoders_kept}, images {pngs}")
    return calls


# ---------------------------------------------------------------------------
# Evaluation on CUB-layout data: the reader, training on it, sampling the
# test split, gen_example with style mixing, IS / FID / R-precision
# ---------------------------------------------------------------------------

CUB_CLASSES = 17
CUB_TEST = 170  # at batch 16: 10 full batches and a ragged tail of 10
CUB_TRAIN = 32
CUB_IMAGE = (500, 375)  # CUB's typical width x height
CUB_VOCAB = 300
EVAL_BATCH = 16
RP_CANDIDATES = 100  # R-precision: 1 true caption + 99 of other classes
EVAL_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "sba_gan_tpu_torch", "configs", "eval_bird.yml")
# the Inception classifier, card against CPU (TF32 off): the largest
# difference of one batch's softmax, and of its pooled activations over
# their largest magnitude
CLASSIFIER_TOL = {"probs": 1e-5, "pooled_rel": 1e-4}


def made_up_words(rng, n=CUB_VOCAB):
    """``n`` distinct made-up lower-case words of 3 to 8 letters."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return sorted({"".join(rng.choice(letters, int(rng.integers(3, 9))))
                   for _ in range(n * 2)})[:n]


def write_smooth_jpeg(rng, size, path):
    """A smooth random image of ``size`` (width, height) with a little
    noise, as a JPEG at ``path``."""
    from PIL import Image

    w, h = size
    low = rng.uniform(0, 255, (12, 16, 3)).astype(np.uint8)
    arr = np.asarray(Image.fromarray(low).resize((w, h), Image.BICUBIC), np.int16)
    arr = np.clip(arr + rng.integers(-12, 13, arr.shape), 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path, quality=90)


def write_cub_tree(root, seed=SEED):
    """A CUB-200-2011 layout under ``root`` (whose name holds ``birds``, so
    the reader crops to the boxes): ``CUB_TEST`` test and ``CUB_TRAIN``
    train items over ``CUB_CLASSES`` classes, smooth random JPEGs of
    ``CUB_IMAGE``, their bounding boxes, 10 captions each over ``CUB_VOCAB``
    made-up words,
    ``train``/``test`` filename and class pickles (test items spread evenly
    over the classes), and ``example_filenames.txt`` naming two files of 8
    captions.  Returns ``root``."""
    import pickle

    rng = np.random.default_rng(seed)
    words = made_up_words(rng)
    base = os.path.join(root, "CUB_200_2011", "CUB_200_2011")
    w, h = CUB_IMAGE
    items = {"test": [], "train": []}
    lines_img, lines_box = [], []
    for split, n in (("test", CUB_TEST), ("train", CUB_TRAIN)):
        for i in range(n):
            cls = i % CUB_CLASSES + 1
            key = f"{cls:03d}.Species_{cls}/{split}_{i:04d}"
            items[split].append((key, cls))
            os.makedirs(os.path.join(base, "images", os.path.dirname(key)), exist_ok=True)
            os.makedirs(os.path.join(root, "text", os.path.dirname(key)), exist_ok=True)
            write_smooth_jpeg(rng, CUB_IMAGE, os.path.join(base, "images", key + ".jpg"))
            lines_img.append(f"{len(lines_img) + 1} {key}.jpg")
            bw, bh = int(rng.integers(w // 5, w * 3 // 5)), int(rng.integers(h // 5, h * 3 // 5))
            bx, by = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            lines_box.append(f"{len(lines_box) + 1} {bx}.0 {by}.0 {bw}.0 {bh}.0")
            with open(os.path.join(root, "text", key + ".txt"), "w") as f:
                for _ in range(10):
                    f.write(" ".join(rng.choice(words, int(rng.integers(6, 31)))) + "\n")
    with open(os.path.join(base, "images.txt"), "w") as f:
        f.write("\n".join(lines_img) + "\n")
    with open(os.path.join(base, "bounding_boxes.txt"), "w") as f:
        f.write("\n".join(lines_box) + "\n")
    for split, entries in items.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        with open(os.path.join(root, split, "filenames.pickle"), "wb") as f:
            pickle.dump([k for k, _ in entries], f)
        with open(os.path.join(root, split, "class_info.pickle"), "wb") as f:
            pickle.dump([c for _, c in entries], f)
    os.makedirs(os.path.join(root, "example_captions"), exist_ok=True)
    names = ["example_captions/first", "example_captions/second"]
    for name in names:
        with open(os.path.join(root, name + ".txt"), "w") as f:
            for _ in range(8):
                f.write(" ".join(rng.choice(words, int(rng.integers(4, 20)))) + "\n")
    with open(os.path.join(root, "example_filenames.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return root


def phase_cub_tree(root):
    """The CUB-layout tree, then every test item read with 0 and with 4
    reader threads (test split: center crops; train split, epoch 0: random
    crops, flips and captions), which must be equal exactly."""
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset

    t0 = time.perf_counter()
    write_cub_tree(root)
    written = time.perf_counter() - t0
    cfg = cfg_from_file(EVAL_CFG)
    cfg.DATA_DIR = root
    rates, equal = {}, {}
    for split in ("test", "train"):
        runs = {}
        for workers in (0, 4):
            ds = build_dataset(cfg, False, split)
            loader = DataLoader(ds, EVAL_BATCH, shuffle=split == "train", drop_last=False,
                                seed=SEED, num_workers=workers)
            t1 = time.perf_counter()
            runs[workers] = list(loader)
            rates[f"{split}_workers{workers}"] = len(ds) / (time.perf_counter() - t1)
        equal[split] = len(runs[0]) == len(runs[4]) and all(
            a.keys == b.keys and torch.equal(a.captions, b.captions)
            and torch.equal(a.cap_lens, b.cap_lens) and torch.equal(a.class_ids, b.class_ids)
            and all(torch.equal(x, y) for x, y in zip(a.imgs, b.imgs))
            for a, b in zip(runs[0], runs[4]))
    test = build_dataset(cfg, False, "test")
    sizes = [len(b.keys) for b in DataLoader(test, EVAL_BATCH, shuffle=False,
                                               drop_last=False)]
    print(f"cub_tree: items/s {rates}", flush=True)
    say("cub_tree", items_per_s=rates, write_s=written, n_words=test.n_words,
        test_items=len(test), classes=len(set(test.class_id.tolist())),
        test_batch_sizes=sizes, workers_equal_serial=equal)
    if not (all(equal.values()) and len(test) == CUB_TEST
            and sizes == [EVAL_BATCH] * (CUB_TEST // EVAL_BATCH) + [CUB_TEST % EVAL_BATCH]):
        raise AssertionError(f"CUB reader: workers equal serial {equal}, test items "
                             f"{len(test)}, batch sizes {sizes}")
    return test.n_words, rates


NATIVE_DECODE_ATOL = 0.02  # tests/test_native_loader.py: the decode and crop against PIL
NATIVE_RESIZE_MEAN = 0.05  # and the mean gap of a bilinear resize (another resampler)


def phase_native_loader(root, pil_rates):
    """``MODEL.IMAGE_LOADER: native`` on the CUB tree.  Where its library
    cannot be built (no g++ or libjpeg), the build's error line is printed
    and the reader must raise ``RuntimeError`` without reading anything
    with PIL.  Where it builds: a square crop of a test image decoded at its
    own size against PIL's decode (NATIVE_DECODE_ATOL); every test item and
    the first train batch's items against the PIL reader's (the same
    geometry, other resamplers: each image's mean gap under
    NATIVE_RESIZE_MEAN); 0 and 4 reader threads equal exactly; items/s
    beside the PIL rates of the cub_tree phase (``pil_rates``)."""
    from PIL import Image

    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data import native_loader
    from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset

    t0 = time.perf_counter()
    cfg = cfg_from_file(EVAL_CFG)
    cfg.DATA_DIR = root
    native = copy.deepcopy(cfg)
    native.MODEL.IMAGE_LOADER = "native"
    try:
        loader = native_loader.NativeImageLoader()
    except RuntimeError as e:
        lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
        opened = []
        real_open = Image.open
        Image.open = lambda *a, **k: opened.append(a[0]) or real_open(*a, **k)
        try:
            build_dataset(native, False, "test")
            raised = None
        except RuntimeError as err:
            raised = str(err).splitlines()[0]
        finally:
            Image.open = real_open
        say("native_loader", available=False,
            build_error=next((ln for ln in lines if "cannot find" in ln or "error" in ln),
                             lines[-1]),
            reader_raised=raised, pil_reads=len(opened), seconds=time.perf_counter() - t0)
        if raised is None or opened:
            raise AssertionError(f"native_loader: the reader did not raise ({raised}) or "
                                 f"read {len(opened)} files with PIL")
        return {"available": False}
    pil = build_dataset(cfg, False, "test")
    path = pil._image_path(pil.filenames[0])
    side = min(Image.open(path).size) // 2
    (crop,) = loader.load(path, sizes=[side], bbox=(7, 5, side, side))
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB").crop((7, 5, 7 + side, 5 + side)),
                          np.float32) / 127.5 - 1.0
    decode = float(np.abs(crop - want).max())
    gaps, rates, equal = [], {}, {}
    for split in ("test", "train"):
        ds, ref = build_dataset(native, False, split), build_dataset(cfg, False, split)
        for i in range(len(ds) if split == "test" else EVAL_BATCH):
            gaps += [float(np.abs(a - b).mean()) for a, b in zip(ds[i][0], ref[i][0])]
        runs = {}
        for workers in (0, 4):
            loader_w = DataLoader(build_dataset(native, False, split), EVAL_BATCH,
                                  shuffle=split == "train", drop_last=False, seed=SEED,
                                  num_workers=workers)
            t1 = time.perf_counter()
            runs[workers] = list(loader_w)
            rates[f"{split}_workers{workers}"] = len(ds) / (time.perf_counter() - t1)
        equal[split] = len(runs[0]) == len(runs[4]) and all(
            a.keys == b.keys and all(torch.equal(x, y) for x, y in zip(a.imgs, b.imgs))
            for a, b in zip(runs[0], runs[4]))
    say("native_loader", available=True, library=str(native_loader.library_path()),
        decode_max_abs=decode, decode_atol=NATIVE_DECODE_ATOL,
        item_mean_gap_max=max(gaps), item_mean_gap_bound=NATIVE_RESIZE_MEAN,
        workers_equal_serial=equal, items_per_s=rates, pil_items_per_s=pil_rates,
        seconds=time.perf_counter() - t0)
    if not (decode <= NATIVE_DECODE_ATOL and max(gaps) <= NATIVE_RESIZE_MEAN
            and all(equal.values())):
        raise AssertionError(f"native_loader: decode {decode}, item gap {max(gaps)}, "
                             f"threads equal serial {equal}")
    return {"available": True, "items_per_s": rates}


def phase_profiling(cfg, out, batch_size=32, steps=3):
    """``utils.profiling`` on the card: ``steps`` full-width DAMSM/bird train
    steps under ``trace()``, each batch collated and moved to the card under
    ``annotate("data")``; the Chrome trace written must hold ``steps`` host
    ``data`` ranges (each also on the card's timeline, as it holds a copy)
    and the kernels K1, K2 and K3 by name (their launches counted
    beside)."""
    import glob

    from sba_gan_tpu_torch.bench import KERNEL_NAMES
    from sba_gan_tpu_torch.data.cub import SyntheticDataset
    from sba_gan_tpu_torch.data.pipeline import collate
    from sba_gan_tpu_torch.train.damsm import DAMSMTrainer, build_damsm_models
    from sba_gan_tpu_torch.utils.profiling import annotate, trace

    t0 = time.perf_counter()
    cfg = copy.deepcopy(cfg)
    cfg.TRAIN.BATCH_SIZE = batch_size
    trainer = DAMSMTrainer(cfg, build_damsm_models(cfg, N_WORDS, seed=SEED), device="cuda")
    ds = SyntheticDataset(num_examples=batch_size * steps, base_size=cfg.TREE.BASE_SIZE,
                          branch_num=cfg.TREE.BRANCH_NUM, words_num=cfg.TEXT.WORDS_NUM,
                          n_words=N_WORDS, seed=SEED)

    def step(i):
        with annotate("data"):
            b = collate([ds[j] for j in range(i * batch_size, (i + 1) * batch_size)],
                        device="cuda")
        return trainer.train_step(b.imgs[-1], b.captions, b.cap_lens, b.class_ids)
    float(step(0)["total"])  # warm-up, outside the trace
    wrappers = _kernel_wrappers()
    reset_launches(wrappers)
    log_dir = os.path.join(out, "trace")
    with trace(log_dir):
        for i in range(steps):
            logs = step(i)
        float(logs["total"])
    launches = read_launches(wrappers)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    # the host's ranges; the card's timeline repeats a range that holds
    # device work as a "gpu_user_annotation"
    data = sum(e.get("name") == "data" and e.get("cat") == "user_annotation"
               for e in events)
    data_on_card = sum(e.get("name") == "data" and e.get("cat") == "gpu_user_annotation"
                       for e in events)
    kernels = {k: sum(KERNEL_NAMES[k] in n for n in names)
               for k in ("damsm_sim_fwd", "damsm_sim_dimg", "damsm_sim_dwords")}
    say("profiling", steps=steps, batch=batch_size, trace_files=len(files),
        trace_mb=os.path.getsize(files[0]) / 1e6, events=len(events), data_ranges=data,
        data_ranges_on_card=data_on_card, kernel_events=kernels, launches=launches,
        seconds=time.perf_counter() - t0)
    if not (len(files) == 1 and data == steps
            and all(kernels[k] == launches[k] == steps for k in kernels)):
        raise AssertionError(f"profiling: {len(files)} trace files, {data} data ranges "
                             f"(want {steps}), kernel events {kernels}, launches {launches}")
    return launches


def _yaml_cfg(path, out, **top):
    """``path``'s YAML with top-level keys (and ``TRAIN``, merged) replaced,
    written to ``out``."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    train = top.pop("TRAIN", {})
    raw.update(top)
    raw["TRAIN"].update(train)
    with open(out, "w") as f:
        yaml.safe_dump(raw, f)
    return out


def phase_cub_train(root, out, cfg_path=GAN_CFG, name="cub_train"):
    """``main.main`` with bird_style (or the preset ``cfg_path``) on the
    CUB-layout tree (not synthetic): batch 16, 4 reader threads, one epoch =
    2 steps, the kernel counts set to 0 just before."""
    from sba_gan_tpu_torch import main as gan_main

    yml = _yaml_cfg(cfg_path, os.path.join(out, f"{name}.yml"), WORKERS=4,
                    TRAIN={"BATCH_SIZE": EVAL_BATCH})
    wrappers = _kernel_wrappers()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    summary = gan_main.main(["--cfg", yml, "--data_dir", root, "--max_epoch", "1",
                             "--output_dir", os.path.join(out, name)])
    seconds = time.perf_counter() - t0
    launches = read_launches(wrappers)
    (epoch,) = summary["epochs"]
    steps = CUB_TRAIN // EVAL_BATCH
    want = {k: n * steps for k, n in GAN_STEP_LAUNCHES.items()}
    finite = all(np.isfinite(v) for v in epoch["logs"].values())
    say(name, steps=epoch["steps"], logs=epoch["logs"], launches=launches,
        seconds=seconds)
    if not (finite and epoch["steps"] == steps and launches == want):
        raise AssertionError(f"GAN training on the CUB tree: steps {epoch['steps']}, "
                             f"finite {finite}, launches {launches} (want {want})")
    return launches


def write_reference_checkpoints(gan_model_dir, damsm_model_dir, n_words, out, prefix="",
                                own_text=False):
    """Reference-layout files ``{prefix}netG.pth`` from the GAN CLI's
    checkpoint (its EMA parameters and G's running statistics; the word
    projection as the reference's 1 x 1 conv), ``text_encoder.pth`` a seeded
    text encoder at the tree's vocabulary (the pretrain phase's, with
    ``own_text``, where it was trained on the tree: else it has the
    synthetic vocabulary, and an embedding of another size must not load),
    ``image_encoder.pth`` the pretrain phase's image encoder.  Returns
    (netG, text encoder)."""
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.models.text_rnn import init_weights as init_text_weights
    from sba_gan_tpu_torch.train.sample import build_text_encoder
    from sba_gan_tpu_torch.utils.checkpoint import Checkpointer

    gan = Checkpointer(gan_model_dir).restore()
    net_g = {k: v for k, v in gan["generator"].items()}
    net_g.update(gan["g_ema"])
    net_g = {k: v[:, :, None, None] if k.endswith("att.conv_context.weight") else v
             for k, v in net_g.items()}
    damsm = Checkpointer(damsm_model_dir).restore()
    if own_text:
        text = damsm["text_encoder"]
    else:
        encoder = build_text_encoder(cfg_from_file(EVAL_CFG), n_words)
        init_text_weights(encoder, torch.Generator().manual_seed(SEED + 3))
        text = encoder.state_dict()
    paths = {name: os.path.join(out, f"{prefix}{name}.pth")
             for name in ("netG", "text_encoder", "image_encoder")}
    torch.save(net_g, paths["netG"])
    torch.save(text, paths["text_encoder"])
    torch.save(damsm["image_encoder"], paths["image_encoder"])
    return paths["netG"], paths["text_encoder"]


def _eval_models(cfg, net_g, net_e, n_words, device):
    """The Sampler of the EMA generator and the text encoder read from the
    reference files, on ``device``."""
    from sba_gan_tpu_torch.models.generator import build_generator
    from sba_gan_tpu_torch.train.sample import Sampler, build_text_encoder
    from sba_gan_tpu_torch.utils import torch_port

    g, text = build_generator(cfg), build_text_encoder(cfg, n_words)
    torch_port.load_g_net(g, net_g)
    torch_port.load_rnn_encoder(text, net_e)
    return Sampler(cfg, g, text, device=device)


def phase_eval_sampling(root, net_g, net_e, n_words, out, cfg_path=EVAL_CFG, items=CUB_TEST,
                        batch_size=EVAL_BATCH, name="eval_sampling", cpu_rows=None,
                        timed=True):
    """``main.main`` with eval_bird (or the preset ``cfg_path`` at its batch
    ``batch_size``; ``B_VALIDATION``) on the tree's test split of ``items``:
    one PNG per item, K4 twice per batch (counts set to 0 just before).
    Then the first batch from the same files and noise: at PyTorch's
    defaults it must give the PNGs written, and with TF32 off the card must
    match the CPU within SLICE_ATOL (on its first ``cpu_rows`` rows, else
    all).  Sampled images/s: with ``timed``, a trainer's ``sampling`` of
    the split again; else over ``main.main``'s seconds (its model loading
    included)."""
    from PIL import Image

    from sba_gan_tpu_torch import main as gan_main
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset
    from sba_gan_tpu_torch.train.loop import GANTrainer
    from sba_gan_tpu_torch.utils.image import to_uint8

    yml = _yaml_cfg(cfg_path, os.path.join(out, f"{name}.yml"), B_VALIDATION=True,
                    TRAIN={"NET_G": net_g, "NET_E": net_e, "BATCH_SIZE": batch_size})
    wrappers = _kernel_wrappers()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    summary = gan_main.main(["--cfg", yml, "--data_dir", root, "--manualSeed", str(SEED),
                             "--output_dir", os.path.join(out, name)])
    seconds = time.perf_counter() - t0
    launches = read_launches(wrappers)
    samples = summary["samples_dir"]
    pngs = sorted(os.listdir(samples))
    batches = -(-items // batch_size)

    cfg = cfg_from_file(yml)
    cfg.DATA_DIR, cfg.JAX.SEED = root, SEED  # the items' captions follow the seed
    batch = next(iter(DataLoader(build_dataset(cfg, False, "test"), batch_size,
                                 shuffle=False, drop_last=False)))
    gpu = _eval_models(cfg, net_g, net_e, n_words, "cuda")
    z, eps = gpu.draw_noise(batch_size, 0)  # sampling's seed of its first batch
    written = np.stack([np.asarray(Image.open(os.path.join(
        samples, f"{k.replace('/', '_')}_s-1.png"))) for k in batch.keys])
    again = to_uint8(gpu.with_noise(batch.captions, batch.cap_lens, z, eps)[0][-1])
    png_gap = int(np.abs(again.astype(np.int16) - written).max())
    with tf32(cudnn=False, matmul=False):
        fakes_g, _ = gpu.with_noise(batch.captions, batch.cap_lens, z, eps)
    rows = slice(cpu_rows)
    cpu = _eval_models(cfg, net_g, net_e, n_words, "cpu")
    fakes_c, _ = cpu.with_noise(batch.captions[rows], batch.cap_lens[rows], z[rows], eps[rows])
    errs = [float(np.abs(g[rows] - c).max()) for g, c in zip(fakes_g, fakes_c)]

    # sampled images/s at batch 16: one batch's generation with its copy to
    # the host, the same queued back to back without the copy (CUDA events),
    # and the trainer's sampling of the whole split (reading, generation,
    # PNGs) as main.main runs it
    gen_s = []
    for _ in range(6):
        t1 = time.perf_counter()
        gpu.with_noise(batch.captions, batch.cap_lens, z, eps)
        gen_s.append(time.perf_counter() - t1)
    gen_rate = batch_size / statistics.median(gen_s[1:])
    queued_ms = eager_ms(lambda: gpu.launch_with_noise(batch.captions, batch.cap_lens, z, eps),
                         iters=20)
    sampling_rate = items / seconds
    if timed:
        test = build_dataset(cfg, False, "test")
        trainer = GANTrainer(cfg, os.path.join(out, f"{name}_timed"), test, test.n_words,
                             test.ixtoword, device="cuda")
        trainer.load_torch_weights(net_g=net_g, net_e_text=net_e)
        t1 = time.perf_counter()
        trainer.sampling("valid")
        sampling_rate = items / (time.perf_counter() - t1)
    print(f"{name}: {len(pngs)} PNGs in {seconds:.2f} s of main.main; sampling "
          f"{sampling_rate:.1f} images/s; generation {gen_rate:.1f} images/s at batch "
          f"{batch_size} ({queued_ms:.3f} ms a batch queued)", flush=True)
    say(name, preset=os.path.basename(cfg_path), batch=batch_size,
        words_num=cfg.TEXT.WORDS_NUM, pngs=len(pngs), launches=launches, batches=batches,
        main_s=seconds, sampling_images_per_s=sampling_rate, sampling_timed_apart=timed,
        generate_images_per_s=gen_rate, generate_batch_s=gen_s,
        generate_batch_queued_ms=queued_ms,
        png_vs_rerun_levels=png_gap, card_vs_cpu_max_abs_err=errs, atol=SLICE_ATOL,
        card_vs_cpu_rows=len(fakes_c[-1]), shapes=[list(f.shape) for f in fakes_g])
    want = {k: 0 for k in wrappers}
    want["word_attention"] = 2 * batches
    if not (len(pngs) == items and launches == want and png_gap <= 1
            and max(errs) <= SLICE_ATOL and fakes_g[-1].shape == (batch_size, 256, 256, 3)):
        raise AssertionError(f"{name}: {len(pngs)} PNGs, launches {launches} (want "
                             f"{want}), PNG gap {png_gap}, card vs CPU {errs}")
    return launches["word_attention"]


def phase_gen_example(root, net_g, net_e, out):
    """``main.main`` with eval_bird, ``B_VALIDATION`` false and
    ``TRAIN.MIXING`` true: per example file, each caption's three stages,
    the attention grid and the four mixing sets; K4 twice per generation
    (one generation and four mixing sets per file)."""
    from sba_gan_tpu_torch import main as gan_main

    yml = _yaml_cfg(EVAL_CFG, os.path.join(out, "gen_example.yml"), B_VALIDATION=False,
                    TRAIN={"NET_G": net_g, "NET_E": net_e, "MIXING": True})
    wrappers = _kernel_wrappers()
    reset_launches(wrappers)
    summary = gan_main.main(["--cfg", yml, "--data_dir", root, "--manualSeed", str(SEED),
                             "--output_dir", os.path.join(out, "gen")])
    launches = read_launches(wrappers)
    root_dir = summary["gen_example_dir"]
    want_files = sorted([f"{j}_s_g{k}.png" for j in range(8) for k in range(3)]
                        + [f"{j}_mix_{t}.png" for j in range(8) for t in ("AB", "BA", "A", "B")]
                        + ["attention_maps.png"])
    found = {key: sorted(os.listdir(os.path.join(root_dir, key)))
             for key in sorted(os.listdir(root_dir))}
    say("gen_example", files={k: len(v) for k, v in found.items()}, launches=launches)
    want = {k: 0 for k in wrappers}
    want["word_attention"] = 2 * 5 * 2
    if not (sorted(found) == ["first", "second"]
            and all(v == want_files for v in found.values()) and launches == want):
        raise AssertionError(f"gen_example: {found}, launches {launches}")
    return launches["word_attention"]


def phase_reproduce(root, net_g, net_e, out):
    """``reproduce.main`` on the tree's test split with R-precision over
    ``RP_CANDIDATES`` candidates; FID between its samples and the 170 real test images;
    ``evaluate.main`` on the samples must give the same IS; the classifier
    (random weights from seed 0, 299 x 299) card against CPU on one batch,
    TF32 off, and its images/s.  The scores are of random weights."""
    from sba_gan_tpu_torch import evaluate, reproduce
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.pipeline import build_dataset
    from sba_gan_tpu_torch.evaluation import (build_classifier, fid, load_images_from_dir,
                                              make_activation_fn, make_predict_fn)

    yml = _yaml_cfg(EVAL_CFG, os.path.join(out, "reproduce.yml"))
    wrappers = _kernel_wrappers()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    result = reproduce.main(["--cfg", yml, "--net_e", net_e, "--net_g", net_g,
                             "--data_dir", root, "--output_dir", os.path.join(out, "repro"),
                             "--r_precision", "--rp_candidates", str(RP_CANDIDATES)])
    seconds = time.perf_counter() - t0
    launches = read_launches(wrappers)
    samples = result["samples_dir"]
    again = evaluate.main(["--dir", samples])

    cfg = cfg_from_file(yml)
    cfg.DATA_DIR = root
    test = build_dataset(cfg, False, "test")
    real = [test[i][0][-1] for i in range(len(test))]
    fakes = list(load_images_from_dir(samples))
    classifier = build_classifier(299)
    t1 = time.perf_counter()
    fid_value = fid(fakes, real, make_activation_fn(copy.deepcopy(classifier), "cuda"))
    fid_s = time.perf_counter() - t1

    batch = np.stack(fakes[:EVAL_BATCH])
    predict_gpu = make_predict_fn(copy.deepcopy(classifier), "cuda")
    with tf32(cudnn=False, matmul=False):
        probs_g = predict_gpu(batch)
        pooled_g = make_activation_fn(copy.deepcopy(classifier), "cuda")(batch)
    probs_c = make_predict_fn(copy.deepcopy(classifier), "cpu")(batch)
    pooled_c = make_activation_fn(classifier, "cpu")(batch)
    errs = {"probs": float(np.abs(probs_g - probs_c).max()),
            "pooled_rel": float(np.abs(pooled_g - pooled_c).max() / np.abs(pooled_c).max())}
    big = np.stack(fakes[:32])
    predict_gpu(big)
    times = []
    for _ in range(5):
        t2 = time.perf_counter()
        predict_gpu(big)
        times.append(time.perf_counter() - t2)
    clf_rate = 32 / statistics.median(times)
    print(f"reproduce: {seconds:.2f} s for {result.get('n_images')} items; classifier "
          f"{clf_rate:.1f} images/s at 299 (random weights: IS "
          f"{result.get('inception_score')}, R-precision {result.get('r_precision')}, "
          f"FID {fid_value:.4f})", flush=True)
    say("reproduce", result=result, evaluate=again, fid=fid_value, fid_s=fid_s,
        reproduce_s=seconds, launches=launches, classifier_images_per_s=clf_rate,
        classifier_batch_s=times, classifier_card_vs_cpu=errs, tol=CLASSIFIER_TOL)
    same_is = round(again["inception_score"], 4) == result["inception_score"]
    batches = -(-CUB_TEST // EVAL_BATCH)  # K4 twice a batch: sampling, R-precision
    want = {k: 0 for k in wrappers}
    want["word_attention"] = 2 * 2 * batches
    if not (result["n_images"] == CUB_TEST and same_is and launches == want
            and np.isfinite(fid_value)
            and np.isfinite(result["r_precision"]) and np.isfinite(result["inception_score"])
            and all(errs[k] <= CLASSIFIER_TOL[k] for k in errs)):
        raise AssertionError(f"reproduce: {result}, evaluate {again}, FID {fid_value}, "
                             f"classifier card vs CPU {errs}")
    return launches["word_attention"]


# ---------------------------------------------------------------------------
# bfloat16: JAX.DTYPE and JAX.LOSS_DTYPE bfloat16, the JAX package's
# accelerator setting
# ---------------------------------------------------------------------------

def _gap(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def word_attention_bf16_case(b, ql, t, d, lens, seed, reps=None, case=None,
                             padding_row=False):
    """K4's bfloat16 instantiation (bfloat16 query and source) against its
    plain bfloat16 version on the same inputs, with the plain float32 result
    of the unrounded inputs beside it (the bfloat16 gap).  Both sides round
    each P to bfloat16 for the context product; a P computed in another
    order can round to the neighbouring value, which moves the context by
    one rounding of P (2^-8) times a source value: atol 2^-8 max|S| + 1e-5 on
    the context, KERNEL_TOL on P.  The kernel must also be at least ten
    times closer to the plain bfloat16 result than that is to float32."""
    from sba_gan_tpu_torch.ops import word_attention as wa

    gen = torch.Generator().manual_seed(seed)
    q32 = torch.randn((b, ql, d), generator=gen).cuda()
    s32 = torch.randn((b, t, d), generator=gen).cuda()
    q, s = q32.to(BF16), s32.to(BF16)
    pad = (torch.arange(t)[None, :] >= torch.tensor(lens)[:, None]).cuda()
    bias = wa.pad_bias(pad, s)
    ctx, att = wa.word_attention(q, s, pad)
    torch.cuda.synchronize()
    ctx_p, att_p = wa.word_attention_plain(q, s, bias)
    ctx_f, att_f = wa.word_attention_plain(q32, s32, bias)
    ctx_tol = dict(rtol=1e-5, atol=2.0 ** -8 * s.float().abs().max().item() + 1e-5)
    err = {"ctx": _gap(ctx, ctx_p), "att": _gap(att, att_p)}
    gap = {"ctx": _gap(ctx_p, ctx_f), "att": _gap(att_p, att_f)}
    row = {"shape": f"B{b} QL{ql} T{t} D{d}", "dtype": "bfloat16",
           "instance": wa.instance(d, q.data_ptr() % 16 == 0),
           "max_abs_err": max(err.values()), "max_abs_err_by_output": err,
           "plain_bf16_vs_plain_f32": gap, "ctx_tol": ctx_tol}
    if padding_row:
        row["padding_row_err"] = padding_row_err(q, s, pad)

    def check():
        torch.testing.assert_close(ctx, ctx_p, **ctx_tol)
        torch.testing.assert_close(att, att_p, **KERNEL_TOL)
        if not all(10 * err[k] <= gap[k] for k in err):
            raise AssertionError(f"word_attention bf16 {row['shape']}: kernel {err} is not "
                                 f"ten times closer to plain bf16 than plain bf16 to f32 "
                                 f"{gap}")

    bias16 = bias.to(BF16)[:, None, :]

    def library():  # three calls, as the float32 row's
        p = torch.softmax(torch.baddbmm(bias16, q, s.transpose(1, 2)).float(), -1)
        return torch.bmm(p.to(BF16), s)

    nbytes = 2 * (b * ql * d + b * t * d) + b * t + 4 * (b * ql * d + b * ql * t)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * b * ql * t * d / BF16_FLOPS_PER_S * 1e3
    kernel = lambda: wa.word_attention(q, s, pad)  # noqa: E731
    plain = lambda: wa.word_attention_plain(q, s, bias)  # noqa: E731
    reps = reps or {}
    row.update(kernel_ms=device_ms(kernel, **reps), plain_ms=device_ms(plain, **reps),
               library_ms=device_ms(library, **reps), bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               eager_ms=eager_ms(kernel))
    say("kernel", name="word_attention", **({"case": case} if case else {}), **row)
    check()
    return row


def phase_kernels_bf16():
    """K4 in bfloat16 at the serving shape (B 1, QL 128^2, T 25) and at the
    GAN step's (B 128, QL 64^2 and 128^2, T 18), from the seeds of the
    float32 rows of the same shapes (:func:`phase_kernels`)."""
    row = word_attention_bf16_case(1, 128 * 128, 25, 32, [11], seed=1)
    gen = torch.Generator().manual_seed(SEED + 5)
    lens = torch.randint(4, 19, (128,), generator=gen).tolist()
    lens[0], lens[-1] = 4, 18
    gan_rows = []
    for k, ql in enumerate((64 * 64, 128 * 128)):
        gan_rows.append(word_attention_bf16_case(128, ql, 18, 32, lens, seed=6 + k,
                                                 reps=dict(calls=5, replays=4),
                                                 case="gan_step"))
    return row, gan_rows


# K1-K3 with mm_dtype bfloat16 against their plain bfloat16 versions: the
# same rounding points, products of bfloat16 values exact in float32, sums
# in another order; an intermediate (A2, dC, dS) computed in another order
# can round to the neighbouring bfloat16 value, which moves one term of a
# sum by 2^-8 of itself.  Read on the H100 at B32 T20 and B128 T18 over two
# seeds: sim up to 9.2e-5, gradients up to 2.6e-3 of their largest entry
# (K2 at B32, where such a term dominates an entry), against the plain
# bfloat16-vs-float32 gap of 1.7e-3 to 1.9e-2 (the ten-times check below
# is the sharp one); the bounds are about four times the readings.
DAMSM_BF16_FWD_TOL = dict(rtol=1e-3, atol=1e-3)
DAMSM_BF16_GRAD_RTOL = 1e-2
DAMSM_BF16_SHAPES = ((32, 20, "pretrain"), (128, 18, "gan_step"))


def damsm_bf16_case(b, t, seed, label, gamma1=4.0, gamma2=5.0):
    """K1-K3's bfloat16 instantiations at B texts and images, T words, R 289,
    D 256 against their plain bfloat16 versions, the plain float32 result
    beside; each kernel must be at least ten times closer to plain bfloat16
    than that is to float32.  Bound: the inputs' bytes (float32 in memory)
    and the products' flops at the bf16 dense peak."""
    from sba_gan_tpu_torch.ops import damsm_sim as ds

    gen = torch.Generator().manual_seed(seed)
    r, d = DAMSM_R, DAMSM_D
    words = torch.randn((b, t, d), generator=gen).cuda()
    img = torch.randn((b, r, d), generator=gen).cuda()
    g = torch.randn((b, b), generator=gen).cuda()
    lens = torch.randint(1, t + 1, (b,), generator=gen)
    lens[0], lens[-1] = 1, t
    lens_dev = lens.to(torch.int32).cuda()
    n_words = int(lens.sum())
    mm = dict(mm_dtype=BF16)
    kernels = {
        "damsm_sim_fwd": (lambda: ds.launch_fwd(words, img, lens_dev, gamma1, gamma2, BF16),
                          lambda dt: ds.damsm_sim_plain(words, img, lens_dev, gamma1,
                                                        gamma2, dt),
                          lambda: ds.damsm_sim_fwd(words, img, lens, gamma1, gamma2, **mm),
                          4, 4 * (b * t * d + b * r * d + b + b * b)),
        "damsm_sim_dimg": (lambda: ds.launch_dimg(words, img, lens_dev, g, gamma1, gamma2,
                                                  BF16),
                           lambda dt: ds.damsm_sim_dimg_plain(words, img, lens_dev, g,
                                                              gamma1, gamma2, dt),
                           lambda: ds.damsm_sim_dimg(words, img, lens, g, gamma1, gamma2,
                                                     **mm),
                           10, 4 * (b * t * d + 2 * b * r * d + b + b * b)),
        "damsm_sim_dwords": (lambda: ds.launch_dwords(words, img, lens_dev, g, gamma1,
                                                      gamma2, BF16),
                             lambda dt: ds.damsm_sim_dwords_plain(words, img, lens_dev, g,
                                                                  gamma1, gamma2, dt),
                             lambda: ds.damsm_sim_dwords(words, img, lens, g, gamma1,
                                                         gamma2, **mm),
                             8, 4 * (2 * b * t * d + b * r * d + b + b * b)),
    }
    rows, failed = {}, []
    for name, (kernel, plain, public, flops_per, nbytes) in kernels.items():
        wrapper = getattr(ds, name)
        before = wrapper.bf16_launches
        got = public()
        torch.cuda.synchronize()
        if wrapper.bf16_launches != before + 1:
            raise AssertionError(f"{name}: the bfloat16 instantiation did not launch")
        want, want_f32 = plain(BF16), plain(torch.float32)
        err, gap = _gap(got, want), _gap(want, want_f32)
        scale = want.abs().max().item()
        tol = (DAMSM_BF16_FWD_TOL if name == "damsm_sim_fwd" else
               dict(rtol=DAMSM_BF16_GRAD_RTOL, atol=DAMSM_BF16_GRAD_RTOL * scale))
        flops = flops_per * b * n_words * r * d
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        rows[name] = {"shape": f"B{b} T{t} R{r} D{d}", "dtype": "bfloat16",
                      "words": n_words, "max_abs_err": err, "ref_max_abs": scale,
                      "plain_bf16_vs_plain_f32": gap, "tol": tol}
        try:
            torch.testing.assert_close(got, want, **tol)
        except AssertionError as e:
            failed.append(f"{name}: {e}")
        if not 10 * err <= gap:
            failed.append(f"{name}: kernel {err} is not ten times closer to plain bf16 "
                          f"than plain bf16 to f32 {gap}")
        if name == "damsm_sim_dwords":
            pad = torch.arange(t)[None, :] >= lens[:, None]
            if got[pad.cuda()].abs().max().item() != 0.0:
                failed.append("d_words is not zero at padding")
        reps = dict(calls=3, replays=3) if b >= 128 else dict(calls=5, replays=4)
        rows[name].update(
            kernel_ms=device_ms(kernel, **reps),
            plain_ms=device_ms(lambda: plain(BF16), **reps),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None, eager_ms=eager_ms(kernel, iters=5))
        say("kernel", name=name, case=label, **rows[name])
    if failed:
        raise AssertionError("DAMSM kernels in bf16: " + "; ".join(failed))
    return rows


def phase_damsm_kernels_bf16():
    """K1-K3 in bfloat16 on the inputs of their float32 rows
    (:func:`phase_damsm_kernels`, the same seeds)."""
    return {label: damsm_bf16_case(b, t, seed=100 + k, label=label)
            for k, (b, t, label) in enumerate(DAMSM_BF16_SHAPES)}


def bf16_models(cfg, models):
    """``cfg`` with JAX.DTYPE and LOSS_DTYPE bfloat16, and the models it
    builds (``train.gan.build_models``) holding the weights of ``models``."""
    from sba_gan_tpu_torch.train.gan import build_models

    cfg = copy.deepcopy(cfg)
    cfg.JAX.DTYPE = cfg.JAX.LOSS_DTYPE = "bfloat16"
    out = build_models(cfg, N_WORDS)
    for dst, src in zip((*out[:3], *out.discriminators), (*models[:3], *models.discriminators)):
        dst.load_state_dict(src.state_dict())
    return cfg, out


# The bfloat16 GAN step on the card (batch 8, Ds held still) against the
# CPU's float64 step from the same weights, batch and noise.  Gradients as
# |g - g64| / |g64| over all of a network's parameters at once (the largest
# of the Ds): per tensor, the biases of BatchNorms that follow a sum of
# cotangents are rounding noise in bfloat16 (up to 1.9 of their norm).
# Readings over seeds 0-2 (scripts/torch_gan_step_readings.py --dtype
# bfloat16, H100): the CPU's own bfloat16 step against float64 at most
# logs 1.01e-2, statistics 1.02e-2, D 0.205, G 0.316, DAMSM image gradient
# 0.557; the card's 7.8e-3, 1.09e-2, 0.206, 0.307, 0.559.  Bounds: about
# twice the CPU's.  ReLU kinks that bfloat16 rounding moves make the image
# gradient through Inception about half noise, on the CPU as on the card
# (scripts/torch_bf16_grad_noise.py: 3.3% through the first layer, 56%
# through Mixed_6e, outputs within 0.3%), so that reading cannot see K2,
# whose own bfloat16 rows hold it to 1e-2 of its largest entry.
GAN_BF16_TOL = {"logs": 2e-2, "stats": 2e-2, "d_grads": 0.4, "g_grads": 0.6,
                "damsm_img_grad": 1.1}


def net_grad_errs(got, want) -> dict:
    """|g_got - g_want| / |g_want| over all the parameters of each network:
    the largest of the Ds, and G."""
    def err(prefix):
        names = [n for n in want["grads"] if n.startswith(prefix)]
        a = torch.cat([got["grads"][n].flatten() for n in names])
        b = torch.cat([want["grads"][n].flatten() for n in names])
        return _norm_rel(a, b)
    n_ds = len({n.split(".")[0] for n in want["grads"] if n.startswith("D")})
    return {"d_grads": max(err(f"D{i}.") for i in range(n_ds)), "g_grads": err("G.")}


def gan_step_bf16_readings(runs, seed=SEED, batch_size=8, cpu=False):
    """The still-D bfloat16 step and the DAMSM terms' image gradient in
    bfloat16 on the card (and on the CPU with ``cpu``), each against the
    CPU's float64 runs of ``runs`` (:func:`gan_step_runs` of the same seed):
    logs, statistics, D and G gradients, DAMSM image gradient; launches."""
    from sba_gan_tpu_torch.train.gan import log_keys

    cfg, models, batch, z, eps = gan_step_inputs(seed, batch_size)
    cfg16, models16 = bf16_models(cfg, models)
    still16 = still_ds(cfg16)
    want, want_dm = runs["cpu64_still"], runs["damsm"]["cpu64"]
    keys = log_keys(cfg.TREE.BRANCH_NUM)
    stats = [n for n in want["tensors"] if n.endswith(("running_mean", "running_var"))]
    out = {}
    for device in ("cuda", "cpu") if cpu else ("cuda",):
        wrappers = _kernel_wrappers()
        got = gan_step_run(still16, models16, batch, z, eps, device)
        bf16_launches = read_launches(wrappers, bf16=True)
        dm = damsm_grad_run(cfg16, models16, batch, device)
        e = grad_errs(got, want)
        e.update(net_grad_errs(got, want))
        out[device] = {
            "logs": max(abs(got["logs"][k] - want["logs"][k]) / abs(want["logs"][k])
                        for k in keys),
            "stats": max(_rel_err(got["tensors"][n], want["tensors"][n].float())
                         for n in stats),
            "d_grads": e["d_grads"], "g_grads": e["g_grads"],
            "damsm_img_grad": _norm_rel(dm["grad"], want_dm["grad"]),
            "worst_grads": e["worst"], "launches": got["launches"],
            "bf16_launches": bf16_launches, "damsm_launches": dm["launches"],
            "logs_bf16": got["logs"], "seconds": got["seconds"]}
    return out


def phase_gan_step_bf16(runs, batch_size=8):
    """One full-width bfloat16 GAN step on the card against the CPU's float64
    step (``runs`` from :func:`phase_gan_step`): within GAN_BF16_TOL; K4 twice,
    K1 and K2 once, K3 never, all of them bfloat16 launches."""
    r = gan_step_bf16_readings(runs, SEED, batch_size)["cuda"]
    say("gan_step_bf16", batch=batch_size, readings=r, tol=GAN_BF16_TOL)
    bad = [k for k, tol in GAN_BF16_TOL.items() if not r[k] <= tol]
    if bad or not all(np.isfinite(v) for v in r["logs_bf16"].values()):
        raise AssertionError(f"bf16 GAN step: card and CPU float64 disagree in {bad}")
    if not r["launches"] == r["bf16_launches"] == GAN_STEP_LAUNCHES:
        raise AssertionError(f"bf16 GAN step: launches {r['launches']}, bfloat16 "
                             f"{r['bf16_launches']} (want {GAN_STEP_LAUNCHES})")
    return r["bf16_launches"]


# Card against CPU, both bfloat16, one full-width step or generation from
# the same weights and inputs: each reading (relative, as the float32
# phases') must lie within BF16_FACTOR times the same reading of the CPU's
# bfloat16 run against its float32 run, i.e. the card's bfloat16 result is
# no further from the CPU's than bfloat16 rounding itself moves the result.
BF16_FACTOR = 2.0


def _bf16_against(readings_card, readings_cpu, label):
    bad = {k: (v, readings_cpu[k]) for k, v in readings_card.items()
           if not v <= BF16_FACTOR * readings_cpu[k]}
    if bad:
        raise AssertionError(f"{label}: card bf16 against CPU bf16 beyond {BF16_FACTOR} "
                             f"times CPU bf16 against CPU f32: {bad}")


def phase_pretrain_step_bf16(cfg, batch_size, f32_runs):
    """One full-width bfloat16 DAMSM train step on the card and on the CPU,
    from the weights, batch and dropout mask of :func:`phase_pretrain_step`
    (whose CPU float32 run is ``f32_runs["cpu"]``); K1-K3 launched, in
    bfloat16."""
    from sba_gan_tpu_torch.data.cub import SyntheticDataset
    from sba_gan_tpu_torch.data.pipeline import collate
    from sba_gan_tpu_torch.train.damsm import LOG_KEYS, DAMSMTrainer, build_damsm_models

    cfg = copy.deepcopy(cfg)
    cfg.TRAIN.BATCH_SIZE = batch_size
    models = build_damsm_models(cfg, N_WORDS, seed=SEED)
    cfg.JAX.DTYPE = cfg.JAX.LOSS_DTYPE = "bfloat16"
    models16 = build_damsm_models(cfg, N_WORDS)
    models16.text_encoder.load_state_dict(models.text_encoder.state_dict())
    models16.image_encoder.load_state_dict(models.image_encoder.state_dict())
    ds = SyntheticDataset(num_examples=batch_size, base_size=cfg.TREE.BASE_SIZE,
                          branch_num=cfg.TREE.BRANCH_NUM, words_num=cfg.TEXT.WORDS_NUM,
                          n_words=N_WORDS, seed=SEED)
    batch = collate([ds[i] for i in range(batch_size)])
    keep = models.text_encoder.dropout_mask(batch.captions,
                                            torch.Generator().manual_seed(SEED + 2))
    wrappers = _kernel_wrappers()
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = DAMSMTrainer(cfg, copy.deepcopy(models16), device=device)
        reset_launches(wrappers)
        t0 = time.perf_counter()
        logs = trainer.train_step(
            batch.imgs[-1].to(device), batch.captions.to(device), batch.cap_lens,
            batch.class_ids.to(device), keep_mask=keep.to(device))
        logs = {k: float(v) for k, v in logs.items()}
        grads = {f"text.{n}": p.grad for n, p in trainer.text_encoder.named_parameters()}
        grads.update({f"image.{n}": p.grad for n, p in
                      trainer.image_encoder.named_parameters() if p.grad is not None})
        runs[device] = dict(logs=logs, grads=grads, seconds=time.perf_counter() - t0,
                            stats={n: b for n, b in trainer.image_encoder.state_dict().items()
                                   if n.endswith(("running_mean", "running_var"))},
                            launches=read_launches(wrappers),
                            bf16_launches=read_launches(wrappers, bf16=True))

    def readings(got, want):
        return {"logs": max(abs(got["logs"][k] - want["logs"][k]) / abs(want["logs"][k])
                            for k in LOG_KEYS),
                "grads": max(_norm_rel(g.cpu().double(), want["grads"][n].cpu().double())
                             for n, g in got["grads"].items()),
                "stats": max(_rel_err(v, want["stats"][n]) for n, v in got["stats"].items())}
    card, cpu = readings(runs["cuda"], runs["cpu"]), readings(runs["cpu"], f32_runs["cpu"])
    launches = runs["cuda"]["bf16_launches"]
    say("pretrain_step_bf16", batch=batch_size, card_bf16_vs_cpu_bf16=card,
        cpu_bf16_vs_cpu_f32=cpu, factor=BF16_FACTOR, logs_cuda=runs["cuda"]["logs"],
        logs_cpu=runs["cpu"]["logs"], launches=runs["cuda"]["launches"],
        bf16_launches=launches, step_s={k: v["seconds"] for k, v in runs.items()})
    want = {"damsm_sim_fwd": 1, "damsm_sim_dimg": 1, "damsm_sim_dwords": 1,
            "word_attention": 0}
    if not (launches == runs["cuda"]["launches"] == want
            and all(np.isfinite(v) for v in runs["cuda"]["logs"].values())):
        raise AssertionError(f"bf16 pretrain step: launches {runs['cuda']['launches']}, "
                             f"bfloat16 {launches} (want {want})")
    _bf16_against(card, cpu, "bf16 pretrain step")
    return launches


def phase_generation_bf16(cfg, wordtoix):
    """One bfloat16 generation (``eval_bird``, the slice's weights and
    captions) on the card against the CPU in bfloat16 and float32: images and
    maps; K4 launched twice, in bfloat16."""
    from sba_gan_tpu_torch.data.vocab import encode_free_text
    from sba_gan_tpu_torch.ops import word_attention as wa
    from sba_gan_tpu_torch.train.sample import Sampler

    cpu32 = Sampler.from_config(cfg, N_WORDS, seed=SEED, device="cpu")
    random_bn_stats(cpu32.generator, torch.Generator().manual_seed(SEED + 1))
    cfg16 = copy.deepcopy(cfg)
    cfg16.JAX.DTYPE = "bfloat16"
    samplers = {"cpu32": cpu32}
    for key, device in (("cuda", "cuda"), ("cpu", "cpu")):
        s = Sampler.from_config(cfg16, N_WORDS, device="cpu")
        s.generator.load_state_dict(cpu32.generator.state_dict())
        s.text_encoder.load_state_dict(cpu32.text_encoder.state_dict())
        samplers[key] = Sampler(cfg16, s.generator, s.text_encoder, device=device)
    captions = ["w17 w4031 w9 w250 w77 w3 w1200 w88 w5 w13 w402 w6", "w2 w5449 w31"]
    ids, lens = encode_free_text(captions, wordtoix, cfg.TEXT.WORDS_NUM)
    z, eps = cpu32.draw_noise(len(captions), SEED)
    outs = {}
    for key, sampler in samplers.items():
        wa.word_attention.launches = wa.word_attention.bf16_launches = 0
        outs[key] = sampler.with_noise(ids, lens, z, eps)
        if key == "cuda":
            launches = (wa.word_attention.launches, wa.word_attention.bf16_launches)

    def readings(got, want):
        names = ("img64", "img128", "img256", "map64", "map128")
        return {n: float(np.linalg.norm(g - w) / np.linalg.norm(w))
                for n, g, w in zip(names, got[0] + got[1], want[0] + want[1])}
    card, cpu = readings(outs["cuda"], outs["cpu"]), readings(outs["cpu"], outs["cpu32"])
    finite = all(np.isfinite(a).all() for a in outs["cuda"][0] + outs["cuda"][1])
    say("generation_bf16", card_bf16_vs_cpu_bf16=card, cpu_bf16_vs_cpu_f32=cpu,
        factor=BF16_FACTOR, launches=launches,
        image_shapes=[list(f.shape) for f in outs["cuda"][0]])
    if not (finite and launches == (2, 2)):
        raise AssertionError(f"bf16 generation: finite {finite}, launches {launches}")
    _bf16_against(card, cpu, "bf16 generation")
    return {"word_attention": launches[1]}


def phase_gan_bench_bf16():
    """``python -m sba_gan_tpu_torch.bench --dtype bfloat16`` in this process
    at batch 128 (:data:`SHORT_BENCH`): its line, then a summary; K4 2, K1
    1, K2 1 launches a step."""
    from sba_gan_tpu_torch import bench

    line = bench.main(["--dtype", "bfloat16", *SHORT_BENCH_ARGV])
    named = line["profile"]["hand_written_kernels"]
    per_step = {k: named[k]["launches_per_step"] for k in GAN_KERNELS}
    say("gan_bench_bf16", batch=line["batch"], dtype=line["dtype"],
        out_of_memory=line["out_of_memory"], ms_per_step=line["ms_per_step"],
        images_per_sec=line["value"], step_ms_median=line["step_ms_median"],
        device_ms_per_step=line["profile"]["device_ms_per_step"],
        launches_per_step=line["profile"]["launches_per_step"],
        device_idle_share=line["profile"]["device_idle_share"],
        peak_memory_bytes=line["peak_memory_bytes"], mfu=line["mfu"],
        mfu_precision=line["mfu_precision"], precision=line["precision"],
        kernel_launches_per_step=per_step,
        kernel_ms_per_step={k: named[k]["device_ms_per_step"] for k in GAN_KERNELS})
    if not line["finite"] or per_step != GAN_STEP_LAUNCHES or line["dtype"] != "bfloat16":
        raise AssertionError(f"bf16 GAN bench: finite {line['finite']}, kernel launches "
                             f"per step {per_step} (want {GAN_STEP_LAUNCHES})")
    return line


# ---------------------------------------------------------------------------
# The BERT text encoder: bert-base (12 layers, hidden 768, 12 heads,
# intermediate 3072) in the bird_bert and bird_mixing GAN steps and in the
# DAMSM/bird_bert pretraining, fed through K1-K4
# ---------------------------------------------------------------------------

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sba_gan_tpu_torch",
                       "configs")
BERT_CFG = os.path.join(CONFIGS, "bird_bert.yml")
MIXING_CFG = os.path.join(CONFIGS, "bird_mixing.yml")
BERT_PRETRAIN_CFG = os.path.join(CONFIGS, "DAMSM", "bird_bert.yml")
# card against CPU, both float32 with TF32 off: bert-base's twelve layers
# sum in another order; relative to each output's largest entry
BERT_TOL = 1e-4
# the BERT pretrain step, card against CPU (TF32 off): as PRETRAIN_TOL, the
# gradients relative to the largest entry of their side (text, image): the
# attention key biases' gradients are 0 but for rounding (softmax ignores a
# constant added to every score of a query); the clipped text gradient's
# norm against min(its norm before the clip, 0.25).  The image side's
# gradients (Mixed_7a/b/c through three train-mode BatchNorms on 8 x 8 maps,
# and the heads) read 6.8e-3 card against CPU (H100, first reading), so
# they are also held to the CPU's float64 step: the card's float32 no
# further from it than BF16_FACTOR (2) times the CPU's float32, and within
# the bound above or that.
PRETRAIN_BERT_TOL = {"logs": 1e-4, "grads": 1e-3, "stats": 1e-4, "clip": 1e-4}
BERT_PRETRAIN_LAUNCHES = PRETRAIN_STEP_LAUNCHES


def bert_captions(batch_size, t, vocab, seed):
    """(captions (B, t) ids in [1, vocab) zero after each length, lengths
    (B,) from 2 to t, the first t and the second 2), on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(2, t + 1, (batch_size,), generator=gen)
    lens[0], lens[1] = t, 2
    ids = torch.randint(1, vocab, (batch_size, t), generator=gen)
    return torch.where(torch.arange(t)[None, :] < lens[:, None], ids, 0), lens


def phase_bert_encoder(batch_size=8, t=20):
    """bert-base (random weights from SEED) on the card against the CPU,
    TF32 off: the words (zero at padding) and sentence codes of captions of
    2 to ``t`` wordpieces, and the card's forward time."""
    from sba_gan_tpu_torch.models.text_bert import BERT_BASE, BertEncoder, init_weights

    enc = BertEncoder(nef=256)
    init_weights(enc, torch.Generator().manual_seed(SEED))
    captions, lens = bert_captions(batch_size, t, BERT_BASE["vocab_size"], SEED + 5)
    out = {}
    with tf32(cudnn=False, matmul=False), torch.no_grad():
        for device in ("cuda", "cpu"):
            m = copy.deepcopy(enc).to(device).eval()
            out[device] = [x.cpu() for x in m(captions.to(device), lens)]
            if device == "cuda":
                caps = captions.to(device)
                ms = eager_ms(lambda: m(caps, lens), iters=20)
    errs = {k: _rel_err(a, b) for k, a, b in zip(("words", "sent"), out["cuda"], out["cpu"])}
    pad = torch.arange(t)[None, :] >= lens[:, None]
    pad_zero = bool(torch.all(out["cuda"][0][pad] == 0))
    say("bert_encoder", batch=batch_size, words_num=t, lens=lens.tolist(),
        params=sum(p.numel() for p in enc.parameters()), rel_err=errs, tol=BERT_TOL,
        padding_zero=pad_zero, forward_ms_eager=ms)
    if not (pad_zero and all(e <= BERT_TOL for e in errs.values())
            and all(torch.isfinite(x).all() for x in out["cuda"])):
        raise AssertionError(f"bert_encoder: card and CPU disagree {errs} (tol {BERT_TOL}), "
                             f"padding zero {pad_zero}")


def gan_step_bert_cpu_refs(batch_size=8):
    """The CPU's runs of the gan_step_bert phase: the bird_bert step's
    (:func:`gan_step_cpu_runs`) and the bird_mixing step's, with their
    inputs; launches not counted, so that they run in a thread beside
    phases that count."""
    bert_inputs = gan_step_inputs(SEED, batch_size, BERT_CFG)
    mixing_inputs = gan_step_inputs(SEED, batch_size, MIXING_CFG)
    return {"bert_inputs": bert_inputs, "bert_cpu": gan_step_cpu_runs(bert_inputs, False),
            "mixing_inputs": mixing_inputs,
            "mixing_cpu": gan_step_run(*mixing_inputs, "cpu", count=False)}


def phase_gan_step_bert(refs, batch_size=8):
    """The bird_bert step (:func:`phase_gan_step` with its preset: the same
    readings and bounds against the CPU's float64 step, K4 2, K1 1, K2 1, K3
    0); then one bird_mixing step ((2, B, Z) noise) on the card and on the
    CPU (TF32 off): finite logs within GAN_STEP_TOL's, the card's launches
    those of the step.  ``refs``: :func:`gan_step_bert_cpu_refs`, made
    beside earlier phases."""
    from sba_gan_tpu_torch.train.gan import log_keys

    launches, runs = phase_gan_step(batch_size, BERT_CFG, "gan_step_bert",
                                    refs["bert_inputs"], refs["bert_cpu"])
    del runs
    cfg, models, batch, z, eps = refs["mixing_inputs"]
    with tf32(cudnn=False, matmul=False):
        card = gan_step_run(cfg, models, batch, z, eps, "cuda")
    cpu = refs["mixing_cpu"]
    keys = log_keys(cfg.TREE.BRANCH_NUM)
    err = max(abs(card["logs"][k] - cpu["logs"][k]) / abs(cpu["logs"][k]) for k in keys)
    say("gan_step_mixing", batch=batch_size, noise=list(z.shape), logs_cuda=card["logs"],
        logs_cpu=cpu["logs"], rel_err_logs=err, tol=GAN_STEP_TOL["logs"],
        launches={"cuda": card["launches"], "cpu": cpu["launches"]},
        step_s={"cuda": card["seconds"], "cpu": cpu["seconds"]})
    if not (cfg.TRAIN.MIXING and z.dim() == 3 and err <= GAN_STEP_TOL["logs"]
            and all(np.isfinite(v) for v in card["logs"].values())
            and card["launches"] == GAN_STEP_LAUNCHES and cpu["launches"] is None):
        raise AssertionError(f"gan_step_mixing: logs {err}, launches {card['launches']}")
    return launches, card["launches"]


def _bert_raw_grads(trainer, batch, device):
    """The losses of the trainer's step on ``batch`` (train mode, the
    Inception running statistics not moved, nothing updated): the text
    side's gradient norm before the clip, and the gradient to the words."""
    from sba_gan_tpu_torch.losses.damsm import sent_loss, words_loss
    from sba_gan_tpu_torch.models.norms import frozen_running_stats

    g1, g2, g3 = trainer.gammas
    trainer.text_encoder.train()
    trainer.image_encoder.train()
    labels = torch.arange(batch.captions.shape[0], device=device)
    class_ids = batch.class_ids.to(device)
    with frozen_running_stats(trainer.image_encoder):
        region, code = trainer.image_encoder(batch.imgs[-1].to(device))
    words, sent = trainer.text_encoder(batch.captions.to(device), batch.cap_lens)
    w0, w1 = words_loss(region, words, labels, batch.cap_lens, class_ids, g1, g2, g3)
    s0, s1 = sent_loss(code, sent, labels, class_ids, g3)
    grads = torch.autograd.grad(w0 + w1 + s0 + s1, [words] + trainer.text_params)
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                 for g in grads[1:]])).item()
    return norm, grads[0].cpu()


def _group_rel_errs(got: dict, want: dict) -> dict:
    """|got - want| per tensor over the largest entry of all of ``want``."""
    scale = max(v.abs().max().item() for v in want.values()) or 1.0
    return {n: (g.cpu() - want[n].cpu()).abs().max().item() / scale for n, g in got.items()}


def pretrain_bert_inputs(batch_size=32):
    """The pretrain_step_bert phase's config, models (random weights from
    SEED), batch and padding mask, on the CPU."""
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.cub import SyntheticDataset
    from sba_gan_tpu_torch.data.pipeline import collate
    from sba_gan_tpu_torch.train.damsm import build_damsm_models

    cfg = cfg_from_file(BERT_PRETRAIN_CFG)
    cfg.TRAIN.BATCH_SIZE = batch_size
    models = build_damsm_models(cfg, N_WORDS, seed=SEED)
    ds = SyntheticDataset(num_examples=batch_size, base_size=cfg.TREE.BASE_SIZE,
                          branch_num=cfg.TREE.BRANCH_NUM, words_num=cfg.TEXT.WORDS_NUM,
                          n_words=N_WORDS, seed=SEED)
    batch = collate([ds[i] for i in range(batch_size)])
    pad = torch.arange(cfg.TEXT.WORDS_NUM)[None, :] >= batch.cap_lens[:, None]
    return cfg, models, batch, pad


def pretrain_bert_run(inputs, device, dtype=torch.float32, count=True):
    """One DAMSM/bird_bert train step of :func:`pretrain_bert_inputs` on
    ``device`` in ``dtype`` (TF32 as the caller set it): logs, gradients,
    statistics, the clip and the words' gradient at padding; the launches
    counted from 0 (None without ``count``, for a CPU run beside phases
    that count)."""
    from sba_gan_tpu_torch.train.damsm import DAMSMTrainer

    cfg, models, batch, pad = inputs
    wrappers = _kernel_wrappers()
    mine = copy.deepcopy(models)
    for m in mine:
        m.to(dtype)
    trainer = DAMSMTrainer(cfg, mine, device=device)
    img = batch.imgs[-1].to(device, dtype)
    raw_norm, words_grad = _bert_raw_grads(trainer, batch._replace(imgs=[img]), device)
    if count:
        reset_launches(wrappers)
    t0 = time.perf_counter()
    logs = trainer.train_step(img, batch.captions.to(device),
                              batch.cap_lens, batch.class_ids.to(device))
    logs = {k: float(v) for k, v in logs.items()}
    seconds = time.perf_counter() - t0
    launches = read_launches(wrappers) if count else None
    text = {n: p.grad for n, p in trainer.text_encoder.named_parameters()}
    image = {n: p.grad for n, p in trainer.image_encoder.named_parameters()
             if p.grad is not None}
    clipped = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in text.values()])).item()
    stats = {n: b for n, b in trainer.image_encoder.state_dict().items()
             if n.endswith(("running_mean", "running_var"))}
    return dict(
        logs=logs, text=text, image=image, stats=stats, launches=launches,
        seconds=seconds, raw_norm=raw_norm, clipped_norm=clipped,
        clip_err=abs(clipped - min(raw_norm, cfg.TRAIN.RNN_GRAD_CLIP))
        / min(raw_norm, cfg.TRAIN.RNN_GRAD_CLIP),
        finite=all(torch.isfinite(g).all().item() for g in text.values())
        and bool(torch.isfinite(words_grad).all()),
        pad_grad_zero=bool(torch.all(words_grad[pad] == 0)),
        real_grad_nonzero=bool(torch.all(words_grad[~pad].abs().sum(-1) > 0)))


def pretrain_bert_cpu_runs(inputs):
    """The CPU's float32 and float64 runs of :func:`pretrain_bert_run`,
    launches not counted, so that they run in a thread beside phases that
    count."""
    return {"cpu": pretrain_bert_run(inputs, "cpu", count=False),
            "cpu64": pretrain_bert_run(inputs, "cpu", torch.float64, False)}


def phase_pretrain_step_bert(inputs, cpu):
    """One full-width DAMSM/bird_bert train step (bert-base, Inception at
    299, T 20) on the card against the CPU from the same weights and batch,
    TF32 off: losses, every BERT parameter's gradient after the clip, the
    Mixed_7a/b/c and head gradients, running statistics; K1, K2 and K3 once
    each on the card.  Before the step, on both: the words' gradient (finite,
    exactly 0 at padding) and the text gradient's norm, against which the
    clip is checked.  ``inputs`` and ``cpu``: :func:`pretrain_bert_inputs`
    and its :func:`pretrain_bert_cpu_runs`, made beside earlier phases."""
    from sba_gan_tpu_torch.train.damsm import LOG_KEYS

    cfg = inputs[0]
    batch_size = cfg.TRAIN.BATCH_SIZE
    with tf32(cudnn=False, matmul=False):
        runs = {"cuda": pretrain_bert_run(inputs, "cuda"), **cpu}
    gpu, cpu, cpu64 = runs["cuda"], runs["cpu"], runs["cpu64"]
    image = {k: _group_rel_errs(runs[k]["image"], cpu64["image"]) for k in ("cuda", "cpu")}
    image_card = _group_rel_errs(gpu["image"], cpu["image"])
    errs = {
        "logs": max(abs(gpu["logs"][k] - cpu["logs"][k]) / abs(cpu["logs"][k])
                    for k in LOG_KEYS),
        "grads_text": max(_group_rel_errs(gpu["text"], cpu["text"]).values()),
        "stats": max(_rel_err(v, cpu["stats"][n]) for n, v in gpu["stats"].items()),
        "clip": max(gpu["clip_err"], cpu["clip_err"]),
    }
    image_f64 = {k: max(v.values()) for k, v in image.items()}
    image_bound = max(PRETRAIN_BERT_TOL["grads"], BF16_FACTOR * image_f64["cpu"])
    trained = sorted({n.split(".")[0] for n in gpu["image"]})
    say("pretrain_step_bert", batch=batch_size, words_num=cfg.TEXT.WORDS_NUM,
        logs_cuda=gpu["logs"], logs_cpu=cpu["logs"], rel_err=errs, tol=PRETRAIN_BERT_TOL,
        image_grads_card_vs_cpu=max(image_card.values()),
        image_grads_vs_cpu_float64=image_f64, image_grads_bound=image_bound,
        worst_image_card_vs_cpu=_worst(image_card),
        worst_image_card_vs_cpu64=_worst(image["cuda"]),
        worst_image_cpu_vs_cpu64=_worst(image["cpu"]),
        worst_text_card_vs_cpu=_worst(_group_rel_errs(gpu["text"], cpu["text"])),
        text_params=sum(g.numel() for g in gpu["text"].values()),
        image_modules_trained=trained,
        text_grad_norm_before_clip={k: r["raw_norm"] for k, r in runs.items()},
        text_grad_norm_after_clip={k: r["clipped_norm"] for k, r in runs.items()},
        words_grad_zero_at_padding={k: r["pad_grad_zero"] for k, r in runs.items()},
        finite={k: r["finite"] for k, r in runs.items()},
        launches={k: r["launches"] for k, r in runs.items()},
        step_s={k: r["seconds"] for k, r in runs.items()})
    bad = [k for k, v in errs.items()
           if not v <= PRETRAIN_BERT_TOL[k.split("_")[0]]]
    if not image_f64["cuda"] <= image_bound:
        bad.append("grads_image")
    if bad or trained != sorted(["Mixed_7a", "Mixed_7b", "Mixed_7c", "emb_cnn_code",
                                 "emb_features"]):
        raise AssertionError(f"pretrain_step_bert: card and CPU disagree in {bad} "
                             f"({errs}); trained image modules {trained}")
    if not all(r["finite"] and r["pad_grad_zero"] and r["real_grad_nonzero"]
               for r in runs.values()):
        raise AssertionError("pretrain_step_bert: BERT gradients not finite, or the "
                             "words' gradient not 0 at padding")
    if gpu["launches"] != BERT_PRETRAIN_LAUNCHES or any(
            r["launches"] is not None for r in (cpu, cpu64)):
        raise AssertionError(f"pretrain_step_bert: launches {gpu['launches']} "
                             f"(want {BERT_PRETRAIN_LAUNCHES})")
    return gpu["launches"]


# bench.measure's timed and traced steps for every bench line of this script
# (its defaults: 20 and 3; the short windows read as the full ones, PERF.md)
SHORT_BENCH = dict(steps=10, profiled=1)
SHORT_BENCH_ARGV = ["--steps", str(SHORT_BENCH["steps"]),
                    "--profiled", str(SHORT_BENCH["profiled"])]


def phase_gan_bench_bert(style_lines):
    """``bench.measure`` on the flagship dims with the bird_bert keys
    (MODEL.TEXT_ENCODER bert, M_NUM 8, INIT_Z_CONCAT False; batch 128,
    WORDS_NUM 18; :data:`SHORT_BENCH`), in each dtype of ``style_lines``
    (the bird_style bench lines of this call, printed beside): images/s,
    device ms, launches, peak memory, mfu and the text phase's device ms;
    K4 2, K1 1, K2 1 a step."""
    from sba_gan_tpu_torch import bench
    from sba_gan_tpu_torch.config import cfg_from_dict

    out = {}
    for dtype, style in style_lines.items():
        d = copy.deepcopy(bench.FLAGSHIP)
        d["MODEL"] = {"TEXT_ENCODER": "bert"}
        d["GAN"].update(M_NUM=8, INIT_Z_CONCAT=False)
        cfg = cfg_from_dict(d)
        cfg.JAX.DTYPE = cfg.JAX.LOSS_DTYPE = dtype
        line = bench.measure(cfg, cfg.TRAIN.BATCH_SIZE, torch.device("cuda"),
                             models=seeded_models(cfg, bench.N_WORDS, bench.SEED),
                             **SHORT_BENCH)
        named = line["profile"]["hand_written_kernels"]
        per_step = {k: named[k]["launches_per_step"] for k in GAN_KERNELS}

        def summary(ln):
            return {"batch": ln["batch"], "images_per_sec": ln["images_per_sec"],
                    "ms_per_step": ln["ms_per_step"], "step_ms_median": ln["step_ms_median"],
                    "device_ms_per_step": ln["profile"]["device_ms_per_step"],
                    "launches_per_step": ln["profile"]["launches_per_step"],
                    "device_idle_share": ln["profile"]["device_idle_share"],
                    "peak_memory_bytes": ln["peak_memory_bytes"], "mfu": ln["mfu"],
                    "flops_per_step": ln["flops_per_step"],
                    "text_device_ms": ln["phase_device_ms"]["text"]}
        mine = summary(line)
        say("gan_bench_bert", dtype=dtype, out_of_memory=line["out_of_memory"], **mine,
            phase_device_ms=line["phase_device_ms"],
            component_device_ms=line["component_device_ms"],
            kernel_launches_per_step=per_step,
            kernel_ms_per_step={k: named[k]["device_ms_per_step"] for k in GAN_KERNELS},
            tf32={"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                  "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32},
            bird_style=summary(style),
            images_per_sec_over_bird_style=mine["images_per_sec"] / style["value"])
        if not line["finite"] or per_step != GAN_STEP_LAUNCHES:
            raise AssertionError(f"gan_bench_bert {dtype}: finite {line['finite']}, kernel "
                                 f"launches per step {per_step} (want {GAN_STEP_LAUNCHES})")
        out[dtype] = per_step
    return out


def phase_bert_cli(out, batch_size=32):
    """``pretrain.main`` with DAMSM/bird_bert on synthetic data (one epoch of
    4 steps, evaluation, a checkpoint; K1-K3 counted, Mixed_7a/b/c and every
    BERT parameter moving), then ``main.main`` with bird_bert and that
    checkpoint as TRAIN.NET_E: train, save, resume and render
    (:func:`phase_pretrain_cli`, :func:`phase_gan_cli`)."""
    damsm = os.path.join(out, "bert_damsm")
    pretrain_launches = phase_pretrain_cli(BERT_PRETRAIN_CFG, damsm)
    calls = phase_gan_cli(os.path.join(damsm, "Model"), out, batch_size, BERT_CFG, "bert_gan")
    return pretrain_launches, [c["launches"] for c in calls]


# ---------------------------------------------------------------------------
# Data parallelism and gradient accumulation (parallel/dist.py,
# TRAIN.GRAD_ACCUM): two micro-steps against the CPU's float64 steps, a
# world of one rank over NCCL against no group, two ranks on the one card
# over gloo against one process, the bench lines, and the torchrun CLIs
# ---------------------------------------------------------------------------
PRETRAIN_DIST_BATCH = 8
ACCUM_MODES = ("window", "dfresh")
# a world of one over NCCL against no group: bit-identical unless the card's
# own run-to-run spread (the CONTROL run, no group again) is not 0; then
# within DIST1_SPREAD times that spread
DIST1_SPREAD = 10.0


@contextlib.contextmanager
def world_of(rank: int, world: int, port: int):
    """The environment ``torchrun`` gives a rank, then as before."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def nccl_world_of_one(cfg):
    """This process as the one rank of a world over NCCL, then no group."""
    from sba_gan_tpu_torch.parallel import dist

    with world_of(0, 1, free_port()), dist.distributed(cfg, "cuda") as device:
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError("the world of one is not on NCCL")
        yield device


def _opt_steps(opt) -> int:
    """The Adam step count of an optimizer (0 before its first step)."""
    states = list(opt.state.values())
    return int(states[0]["step"]) if states else 0


def _host(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` on the CPU (``cpu()`` of a CPU tensor is the tensor)."""
    return t.detach().to("cpu", copy=True)


def accum_run(cfg, models, batch, noises, device, dtype=torch.float32):
    """Micro-steps from a copy of ``models`` on ``device`` in ``dtype``, one a
    noise of ``noises``: after each, its logs, gradients, parameters and
    running statistics, EMA, Adam step counts, micro-step count and launch
    counts (set to 0 just before the micro-step); all on the CPU."""
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
    start = {f"G.{n}": p.detach().cpu().clone() for n, p in state.generator.named_parameters()}
    out = []
    for z, eps in noises:
        reset_launches(wrappers)
        logs = {k: float(v) for k, v in
                step(*args, z=z.to(device, dtype), eps=eps.to(device, dtype)).items()}
        nets = {"G": state.generator,
                **{f"D{i}": d for i, d in enumerate(state.discriminators)}}
        sd = state.state_dict()
        tensors = {f"G.{n}": _host(v) for n, v in sd["generator"].items()}
        tensors.update({f"D{i}.{n}": _host(v) for i, d in enumerate(sd["discriminators"])
                        for n, v in d.items()})
        out.append(dict(
            logs=logs, launches=read_launches(wrappers), tensors=tensors,
            grads={f"{k}.{n}": _host(p.grad).double() for k, m in nets.items()
                   for n, p in m.named_parameters()},
            ema={n: _host(v) for n, v in sd["g_ema"].items()},
            opt_steps={"G": _opt_steps(state.g_opt),
                       **{f"D{i}": _opt_steps(o) for i, o in enumerate(state.d_opts)}},
            micro=state.micro))
    return start, out


def _micro_grads(run, dfresh_from=None):
    """``run``'s gradients; with ``dfresh_from`` (the window's first
    micro-step) the Ds' second micro-gradient, 2 mean - first, in place of
    the window's mean (what a 'dfresh' D holds after micro-step 2)."""
    if dfresh_from is None:
        return run
    grads = {n: (2 * g - dfresh_from["grads"][n] if n.startswith("D") else g)
             for n, g in run["grads"].items()}
    return {**run, "grads": grads}


def accum_inputs(batch_size=8):
    """The grad_accum phase's config (bird_style at WORDS_NUM 18, the Ds held
    still, GRAD_ACCUM 2), models, batch and the noise of two micro-steps."""
    cfg, models, batch, z, eps = gan_step_inputs(SEED, batch_size)
    gen = torch.Generator().manual_seed(SEED + 5)
    noises = [(z, eps), (torch.randn(z.shape, generator=gen),
                         torch.randn(eps.shape, generator=gen))]
    still = still_ds(cfg)
    still.TRAIN.GRAD_ACCUM = 2
    return still, models, batch, noises


def accum_cpu_window(inputs):
    """The CPU's float64 window of :func:`accum_inputs` ('window'; with the
    Ds still, 'dfresh' computes the same numbers), TF32 off."""
    cfg, models, batch, noises = inputs
    return accum_run(cfg, models, batch, noises, "cpu", torch.float64)[1]


def phase_grad_accum(inputs, cpu):
    """GRAD_ACCUM 2 at full width (bird_style, WORDS_NUM 18, batch 8): two
    micro-steps on the card (TF32 off) in 'window' and in 'dfresh' against
    the CPU's float64 window ``cpu`` (:func:`accum_cpu_window`), all with
    the Ds held still (D lr 0, as the gan_step phase holds G's gradients),
    so both modes compute the same numbers and differ in the Ds' Adam
    cadence alone; the gan_step phase's bounds.  G, its EMA and its Adam
    hold still after micro-step 1 and move after 2 (G's parameters against
    Adam's first update of the window's mean); the Ds' Adam steps once a
    window ('window') or each micro-step ('dfresh'); K4 2, K1 1, K2 1, K3 0
    launches a micro-step."""
    t0 = time.perf_counter()
    still, models, batch, noises = inputs
    batch_size = batch.captions.shape[0]
    lr = still.TRAIN.GENERATOR_LR
    with tf32(cudnn=False, matmul=False):
        runs = {}
        for mode in ACCUM_MODES:
            c = copy.deepcopy(still)
            c.TRAIN.GRAD_ACCUM_MODE = mode
            runs[mode] = accum_run(c, models, batch, noises, "cuda")
    n_ds = still.TREE.BRANCH_NUM
    readings, launches, failures = {}, {}, []
    for mode, (start, card) in runs.items():
        keys = card[0]["logs"].keys()
        stats = [n for n in cpu[0]["tensors"] if n.endswith(("running_mean", "running_var"))]
        want2 = _micro_grads(cpu[1], cpu[0] if mode == "dfresh" else None)
        r = {"logs": max(abs(c["logs"][k] - w["logs"][k]) / abs(w["logs"][k])
                         for c, w in zip(card, cpu) for k in keys),
             "stats": max(_rel_err(c["tensors"][n], w["tensors"][n])
                          for c, w in zip(card, cpu) for n in stats)}
        g1, g2 = grad_errs(card[0], cpu[0]), grad_errs(card[1], want2)
        r.update(d_grads=max(g1["d_grads"], g2["d_grads"]),
                 g_grads=max(g1["g_grads"], g2["g_grads"]), worst_grads=g2["worst"])
        r.update(param_readings((card[1], want2), (card[1], want2), lr))
        g_still = all(torch.equal(card[0]["tensors"][n], v) for n, v in start.items())
        ema_still = all(torch.equal(card[0]["ema"][n], start[f"G.{n}"])
                        for n in card[0]["ema"])
        g_moved = any(not torch.equal(card[1]["tensors"][n], v) for n, v in start.items())
        d_steps = [1, 2] if mode == "dfresh" else [0, 1]
        cadence = [c["opt_steps"] for c in card] == [
            {"G": 0, **{f"D{i}": d_steps[0] for i in range(n_ds)}},
            {"G": 1, **{f"D{i}": d_steps[1] for i in range(n_ds)}}]
        r.update(g_and_ema_still_after_1=g_still and ema_still, g_moved_after_2=g_moved,
                 adam_cadence=[c["opt_steps"] for c in card],
                 micro=[c["micro"] for c in card])
        readings[mode] = r
        launches[mode] = [c["launches"] for c in card]
        bad = [k for k in ("logs", "stats", "d_grads", "g_grads", "params_agreeing_excess",
                           "params_adam_excess", "ema_excess") if not r[k] <= GAN_STEP_TOL[k]]
        if not r["params_sign_share"] > GAN_SIGN_SHARE:
            bad.append("params_sign_share")
        if not (g_still and ema_still and g_moved and cadence
                and r["micro"] == [1, 0]):
            bad.append("window cadence")
        if launches[mode] != [GAN_STEP_LAUNCHES] * 2:
            bad.append(f"launches {launches[mode]}")
        failures += [f"{mode}: {b}" for b in bad]
    say("grad_accum", batch=batch_size, grad_accum=2, logs_card={
        m: [c["logs"] for c in runs[m][1]] for m in ACCUM_MODES},
        logs_cpu64=[c["logs"] for c in cpu], readings=readings, launches=launches,
        tol={**GAN_STEP_TOL, "params_sign_share_above": GAN_SIGN_SHARE},
        seconds=time.perf_counter() - t0)
    if failures:
        raise AssertionError(f"grad_accum: {failures}")
    return launches


def _tensors_of(state) -> dict:
    """G's and the Ds' parameters and statistics and the EMA, on the CPU."""
    sd = state.state_dict()
    out = {f"G.{n}": v.cpu() for n, v in sd["generator"].items()}
    out.update({f"D{i}.{n}": v.cpu() for i, d in enumerate(sd["discriminators"])
                for n, v in d.items()})
    out.update({f"ema.{n}": v.cpu() for n, v in sd["g_ema"].items()})
    return out


def _largest_gap(a: dict, b: dict) -> dict:
    """The largest |a - b| over the logs of each step and over the tensors."""
    logs = max(abs(x[k] - y[k]) for x, y in zip(a["logs"], b["logs"]) for k in x)
    tensors = max(float((a["tensors"][n].double() - t.double()).abs().max())
                  for n, t in b["tensors"].items() if t.is_floating_point())
    return {"logs": logs, "tensors": tensors}


def phase_dist_nccl1(steps=3, batch=128):
    """The flagship step (bench dims, batch 128, PyTorch's TF32 defaults,
    cudnn deterministic) for ``steps`` steps from one state: with no group
    (A), as the one rank of a world over NCCL (B), and with no group again
    (C, the card's own run-to-run spread); then one bfloat16 step the same
    three ways.  B must equal A bit for bit when C does, else lie within
    DIST1_SPREAD times C's distance; K4 2, K1 1, K2 1 launches a step."""
    from sba_gan_tpu_torch import bench
    from sba_gan_tpu_torch.config import cfg_from_dict
    from sba_gan_tpu_torch.train.gan import GANStep, init_gan_state

    t0 = time.perf_counter()
    wrappers = _kernel_wrappers()
    out, failures = {}, []
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dtype, n in (("float32", steps), ("bfloat16", 1)):
            cfg = cfg_from_dict(copy.deepcopy(bench.FLAGSHIP))
            cfg.JAX.DTYPE = cfg.JAX.LOSS_DTYPE = dtype
            models = seeded_models(cfg, bench.N_WORDS, bench.SEED)
            args = bench.make_batch(cfg, batch, torch.device("cuda"), SEED)

            def run(world):
                with (nccl_world_of_one(cfg) if world else contextlib.nullcontext()):
                    state = init_gan_state(cfg, copy.deepcopy(models), "cuda")
                    step = GANStep(cfg, state, seed=SEED)
                    reset_launches(wrappers)
                    logs = [{k: float(v) for k, v in step(*args).items()} for _ in range(n)]
                    launches = read_launches(wrappers, bf16=dtype == "bfloat16")
                    result = dict(logs=logs, tensors=_tensors_of(state), launches=launches)
                del state, step
                torch.cuda.empty_cache()
                return result
            a, b, c = run(False), run(True), run(False)
            gap_b, gap_c = _largest_gap(b, a), _largest_gap(c, a)
            if all(v == 0 for v in gap_c.values()):
                ok = all(v == 0 for v in gap_b.values())
            else:
                ok = all(gap_b[k] <= DIST1_SPREAD * gap_c[k] for k in gap_b)
            want = {k: v * n for k, v in GAN_STEP_LAUNCHES.items()}
            if not ok:
                failures.append(f"{dtype}: NCCL {gap_b} against no group, control {gap_c}")
            if not (a["launches"] == b["launches"] == want):
                failures.append(f"{dtype}: launches {a['launches']} / {b['launches']}")
            if not all(np.isfinite(v) for x in b["logs"] for v in x.values()):
                failures.append(f"{dtype}: logs not finite")
            out[dtype] = dict(steps=n, logs_nccl=b["logs"], logs_no_group=a["logs"],
                              gap_nccl_vs_no_group=gap_b, gap_control=gap_c,
                              bit_identical=all(v == 0 for v in gap_b.values()),
                              launches_nccl=b["launches"])
            del models, args, a, b, c
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = saved
    say("dist_nccl1", batch=batch, runs=out, spread_factor=DIST1_SPREAD,
        seconds=time.perf_counter() - t0)
    if failures:
        raise AssertionError(f"dist_nccl1: {failures}")
    return {dtype: r["launches_nccl"] for dtype, r in out.items()}


def dist_cases(device, batch_size=8, gan_cfg=None, pretrain_cfg=None):
    """This rank's part of one GAN step (bird_style at WORDS_NUM 18, still
    Ds, the global noise injected) and one DAMSM/bird pretrain step (the
    global dropout mask sliced) at a global batch of ``batch_size`` (or
    the presets ``gan_cfg``, ``pretrain_cfg``), TF32 off: logs, gradients
    (summed over ranks), G's and the Ds' parameters and statistics, the EMA,
    the image encoder's statistics, and each step's launches.  One process:
    the whole batch."""
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.cub import SyntheticDataset
    from sba_gan_tpu_torch.data.pipeline import collate
    from sba_gan_tpu_torch.parallel import dist
    from sba_gan_tpu_torch.train.damsm import DAMSMTrainer, build_damsm_models
    from sba_gan_tpu_torch.train.gan import GANStep, init_gan_state

    wrappers = _kernel_wrappers()
    mine = dist.rows(batch_size // dist.world_size())
    cfg, models, batch, z, eps = gan_step_inputs(SEED, batch_size, gan_cfg)
    still = still_ds(cfg)
    out = {}
    with tf32(cudnn=False, matmul=False):
        state = init_gan_state(still, models, device=device)
        step = GANStep(still, state)
        reset_launches(wrappers)
        logs = step([i[mine].to(device) for i in batch.imgs], batch.captions[mine].to(device),
                    batch.cap_lens[mine], batch.class_ids[mine].to(device),
                    z=z.to(device), eps=eps.to(device))
        nets = {"G": state.generator, **{f"D{i}": d for i, d in enumerate(state.discriminators)}}
        sd = state.state_dict()
        tensors = {f"G.{n}": v.cpu() for n, v in sd["generator"].items()}
        tensors.update({f"D{i}.{n}": v.cpu() for i, d in enumerate(sd["discriminators"])
                        for n, v in d.items()})
        out["gan"] = dict(
            logs={k: float(v) for k, v in logs.items()}, launches=read_launches(wrappers),
            grads={f"{k}.{n}": p.grad.cpu().double() for k, m in nets.items()
                   for n, p in m.named_parameters()},
            tensors=tensors, ema={n: v.cpu() for n, v in sd["g_ema"].items()})
        del state, step, models

        pcfg = cfg_from_file(pretrain_cfg or PRETRAIN_CFG)
        pcfg.TRAIN.BATCH_SIZE = batch_size
        pmodels = build_damsm_models(pcfg, N_WORDS, seed=SEED)
        ds = SyntheticDataset(num_examples=batch_size, base_size=pcfg.TREE.BASE_SIZE,
                              branch_num=pcfg.TREE.BRANCH_NUM,
                              words_num=pcfg.TEXT.WORDS_NUM, n_words=N_WORDS, seed=SEED)
        pbatch = collate([ds[i] for i in range(batch_size)])
        emb = pmodels.text_encoder.encoder.embedding_dim
        keep = (torch.rand((batch_size, pcfg.TEXT.WORDS_NUM, emb),
                           generator=torch.Generator().manual_seed(SEED + 2)) >= 0.5)
        trainer = DAMSMTrainer(pcfg, pmodels, device=device)
        reset_launches(wrappers)
        plogs = trainer.train_step(pbatch.imgs[-1][mine].to(device),
                                   pbatch.captions[mine].to(device), pbatch.cap_lens[mine],
                                   pbatch.class_ids[mine].to(device),
                                   keep_mask=keep[mine].to(device))
        grads = {f"text.{n}": p.grad.cpu() for n, p in trainer.text_encoder.named_parameters()}
        grads.update({f"image.{n}": p.grad.cpu() for n, p in
                      trainer.image_encoder.named_parameters() if p.grad is not None})
        out["pretrain"] = dict(
            logs={k: float(v) for k, v in plogs.items()}, launches=read_launches(wrappers),
            grads=grads, stats={n: b.cpu() for n, b in trainer.image_encoder.state_dict().items()
                                if n.endswith(("running_mean", "running_var"))})
    return out


def _gloo2_worker(rank: int, port: int, out: str, device: str, cfgs) -> None:
    """One of two ranks on ``device`` (the one card) over gloo (spawned)."""
    from sba_gan_tpu_torch.parallel import dist

    try:
        with world_of(rank, 2, port), dist.distributed(None, device, backend="gloo") as dev:
            result = dist_cases(dev.type, 8, *cfgs)
        torch.save(result, os.path.join(out, f"{rank}.pt"))
    except BaseException:
        import traceback

        with open(os.path.join(out, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn_ranks(target, world: int, timeout: float, *args):
    """Each rank's saved result of ``target(rank, port, out, *args)`` run in
    ``world`` spawned processes; raises if one fails or outlives ``timeout``
    seconds (all are stopped)."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out:
        port = free_port()
        procs = [ctx.Process(target=target, args=(r, port, out, *args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join(30)
        errors = [open(os.path.join(out, n)).read() for n in sorted(os.listdir(out))
                  if n.endswith(".err")]
        if late or errors or any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"{world} ranks: {len(late)} past {timeout} s, exit codes "
                                 f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
        return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False)
                for r in range(world)]


def phase_dist_gloo2(batch_size=8, timeout=400.0, device="cuda", cfgs=(None, None)):
    """Two ranks on the one card over gloo (CUDA tensors; NCCL refuses two
    ranks on one device), each with 4 rows of a global batch of 8, against
    one process at 8 on the card (:func:`dist_cases`): the GAN step within
    the gan_step phase's bounds (card against card: the sums run in another
    order and cudnn picks kernels by batch), the pretrain step within
    PRETRAIN_TOL; both ranks end with the same logs and parameters; each
    rank launches K4 2, K1 1, K2 1 in the GAN step and K1, K2, K3 once in
    the pretrain step."""
    t0 = time.perf_counter()
    ranks = _spawn_ranks(_gloo2_worker, 2, timeout,
                         "cuda:0" if device == "cuda" else device, cfgs)
    one = dist_cases(device, batch_size, *cfgs)
    lr = 2e-4
    g2, g1 = ranks[0]["gan"], one["gan"]
    keys = g1["logs"].keys()
    stats = [n for n in g1["tensors"] if n.endswith(("running_mean", "running_var"))]
    ge = grad_errs(g2, g1)
    gan = {"logs": max(abs(g2["logs"][k] - g1["logs"][k]) / abs(g1["logs"][k]) for k in keys),
           "stats": max(_rel_err(g2["tensors"][n], g1["tensors"][n]) for n in stats),
           "d_grads": ge["d_grads"], "g_grads": ge["g_grads"], "worst_grads": ge["worst"],
           **param_readings((g2, g1), (g2, g1), lr)}
    p2, p1 = ranks[0]["pretrain"], one["pretrain"]
    pre = {"logs": max(abs(p2["logs"][k] - p1["logs"][k]) / abs(p1["logs"][k])
                       for k in p1["logs"]),
           "grads": max(_rel_err(g, p1["grads"][n]) for n, g in p2["grads"].items()),
           "stats": max(_rel_err(s, p1["stats"][n]) for n, s in p2["stats"].items())}
    same = all(torch.equal(ranks[0]["gan"]["tensors"][n], t)
               for n, t in ranks[1]["gan"]["tensors"].items()) and \
        ranks[0]["gan"]["logs"] == ranks[1]["gan"]["logs"] and \
        ranks[0]["pretrain"]["logs"] == ranks[1]["pretrain"]["logs"]
    pre_launches = {"word_attention": 0, "damsm_sim_fwd": 1, "damsm_sim_dimg": 1,
                    "damsm_sim_dwords": 1}
    launches = [{"gan_step": r["gan"]["launches"], "pretrain_step": r["pretrain"]["launches"]}
                for r in ranks]
    say("dist_gloo2", batch=batch_size, ranks=2, backend="gloo", logs_2ranks=g2["logs"],
        logs_1proc=g1["logs"], pretrain_logs_2ranks=p2["logs"],
        pretrain_logs_1proc=p1["logs"], gan_readings=gan, pretrain_readings=pre,
        ranks_identical=same, launches_per_rank=launches,
        tol={"gan": GAN_STEP_TOL, "pretrain": PRETRAIN_TOL},
        seconds=time.perf_counter() - t0)
    bad = [f"gan.{k}" for k in ("logs", "stats", "d_grads", "g_grads",
                                "params_agreeing_excess", "params_adam_excess", "ema_excess")
           if not gan[k] <= GAN_STEP_TOL[k]]
    bad += [f"pretrain.{k}" for k, v in pre.items() if not v <= PRETRAIN_TOL[k]]
    if not gan["params_sign_share"] > GAN_SIGN_SHARE:
        bad.append("gan.params_sign_share")
    if not same:
        bad.append("the ranks differ")
    if any(r != {"gan_step": GAN_STEP_LAUNCHES, "pretrain_step": pre_launches}
           for r in launches):
        bad.append(f"launches {launches}")
    if bad:
        raise AssertionError(f"dist_gloo2: {bad}")
    return launches


def _bench_summary(r: dict) -> dict:
    """The fields of a bench result that the data-parallel lines keep."""
    prof = r["profile"]
    return dict(
        batch=r["batch"], grad_accum=r["grad_accum"], accum_mode=r["accum_mode"],
        ranks=r["ranks"], images_per_sec=r["images_per_sec"], ms_per_step=r["ms_per_step"],
        step_ms_median=r["step_ms_median"], device_ms_per_step=prof["device_ms_per_step"],
        launches_per_step=prof["launches_per_step"],
        collective_device_ms_per_step=prof["collective_device_ms_per_step"],
        collective_launches_per_step=prof["collective_launches_per_step"],
        device_idle_share=prof["device_idle_share"], peak_memory_bytes=r["peak_memory_bytes"],
        out_of_memory=r["out_of_memory"], finite=r["finite"],
        kernel_launches_per_step={k: prof["hand_written_kernels"][k]["launches_per_step"]
                                  for k in GAN_KERNELS})


def collective_host_us(calls: int = 500) -> dict:
    """Host microseconds of one call of each collective the step makes, on
    a (2, 64) float32 tensor on the card, averaged over ``calls`` calls
    queued back to back and closed by one synchronize."""
    from sba_gan_tpu_torch.parallel import dist

    x = torch.randn(2, 64, device="cuda", requires_grad=True)
    out = {}
    for name, fn in (("reduce", lambda: dist.reduce(x)), ("gather", lambda: dist.gather(x)),
                     ("batch_moments", lambda: dist.batch_moments(x, 7)),
                     ("host_gather", lambda: dist.gather(torch.arange(4)))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e6 / calls
    return out


def phase_gan_bench_dist(plain_b128: dict):
    """``bench.measure`` (no phase split or FLOP count; :data:`SHORT_BENCH`)
    at the flagship dims, float32 at PyTorch's TF32 defaults, beside the
    gan_bench phase's line at batch 128 (``plain_b128``, this call's): the
    plain step at batch 64, GRAD_ACCUM 2 at batch 64 in 'window' and in
    'dfresh' (an update of 128, as the plain 128 line's), and the world of one
    over NCCL at 128 with the collectives' device ms and the host time of
    one call of each.  Each line: images/s, ms a step, device ms and
    launches a step, idle share, peak memory, the kernels' launches a step
    (K4 2, K1 1, K2 1)."""
    from sba_gan_tpu_torch import bench
    from sba_gan_tpu_torch.config import cfg_from_dict

    t0 = time.perf_counter()
    lines, bad = {"plain_b128": _bench_summary(plain_b128)}, []
    for label, batch, accum, mode, nccl in (
            ("plain_b64", 64, 1, "window", False),
            ("accum2_window_b64", 64, 2, "window", False),
            ("accum2_dfresh_b64", 64, 2, "dfresh", False),
            ("nccl1_b128", 128, 1, "window", True)):
        cfg = cfg_from_dict(copy.deepcopy(bench.FLAGSHIP))
        cfg.TRAIN.GRAD_ACCUM, cfg.TRAIN.GRAD_ACCUM_MODE = accum, mode
        with nccl_world_of_one(cfg) if nccl else contextlib.nullcontext():
            lines[label] = _bench_summary(bench.measure(
                cfg, batch, torch.device("cuda"), detail=False,
                models=seeded_models(cfg, bench.N_WORDS, bench.SEED), **SHORT_BENCH))
            if nccl:
                lines[label]["collective_host_us"] = collective_host_us()
        gc.collect()
        torch.cuda.empty_cache()
    for label, line in lines.items():
        if not line["finite"] or line["kernel_launches_per_step"] != GAN_STEP_LAUNCHES:
            bad.append(f"{label}: finite {line['finite']}, "
                       f"launches {line['kernel_launches_per_step']}")
    say("gan_bench_dist", lines=lines, seconds=time.perf_counter() - t0)
    if bad:
        raise AssertionError(f"gan_bench_dist: {bad}")
    return {k: v["kernel_launches_per_step"] for k, v in lines.items()}


def _torchrun(module: str, argv) -> subprocess.Popen:
    """``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    module argv`` from the repository's root, started."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", module, *argv]
    return subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)


def _kill(proc: subprocess.Popen) -> str:
    """Stops a :func:`_torchrun` process and its workers: SIGTERM, which
    torchrun passes on to the workers it started in sessions of their own,
    then SIGKILL to its process group if it has not ended within 30 s; its
    output."""
    proc.terminate()
    try:
        return proc.communicate(timeout=30)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        return proc.communicate()[0]


def _finish(proc: subprocess.Popen, t0: float, timeout: float = 300.0) -> float:
    """Waits for a :func:`_torchrun` process (killed past ``timeout``
    seconds); its seconds since ``t0``.  Raises on a non-zero exit, with
    the end of its output."""
    try:
        output, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        output = _kill(proc)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(proc.args)}: exit {proc.returncode}\n"
                             f"{output[-4000:]}")
    return time.perf_counter() - t0


# the torchrun CLIs at small widths: their full-width paths run in process
# (pretrain_cli, gan_cli); here the ranks' plumbing is under test
DIST_CLI_WIDTHS = {"GAN": {"GF_DIM": 8, "DF_DIM": 8, "Z_DIM": 8, "W_DIM": 16,
                           "CONDITION_DIM": 8, "R_NUM": 1},
                   "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 6},
                   "MODEL": {"INCEPTION_INPUT": 75}}


def _cli_yaml(preset_path, out, name, **train):
    """``preset_path`` at DIST_CLI_WIDTHS with ``train`` keys, written to
    ``out/name.yml``."""
    import yaml

    with open(preset_path) as f:
        raw = yaml.safe_load(f)
    for group, keys in DIST_CLI_WIDTHS.items():
        raw.setdefault(group, {}).update(keys)
    raw.setdefault("TRAIN", {}).update(train)
    path = os.path.join(out, f"{name}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def phase_dist_cli(out, batch_size=8, accum=3, device="cuda"):
    """``torchrun --standalone --nproc_per_node 1`` runs ``main`` (bird_style
    at DIST_CLI_WIDTHS) on synthetic data with GRAD_ACCUM ``accum``: an
    epoch of 4 steps saves in the middle of a window (micro-step 1 of 3),
    and a second call resumes and finishes it (step 8 at micro-step 2);
    ``pretrain`` (DAMSM/bird at those widths) runs one epoch the same way,
    beside the first call.  A generator, so that the processes run beside
    the caller's phases: the first ``next`` starts the first call and the
    pretraining, the second waits for them and starts the resume, the last
    waits for it and checks; closing it kills any process still running."""
    from sba_gan_tpu_torch.utils.checkpoint import Checkpointer

    t0 = time.perf_counter()
    yml = _cli_yaml(GAN_CFG, out, "dist_gan", BATCH_SIZE=batch_size, GRAD_ACCUM=accum)
    pyml = _cli_yaml(PRETRAIN_CFG, out, "dist_damsm", BATCH_SIZE=batch_size)
    gan_dir, damsm_dir = os.path.join(out, "dist_gan"), os.path.join(out, "dist_damsm")
    argv = ["--cfg", yml, "--synthetic", "--output_dir", gan_dir, "--device", device]
    procs = [_torchrun("sba_gan_tpu_torch.main", argv + ["--max_epoch", "1"]),
             _torchrun("sba_gan_tpu_torch.pretrain",
                       ["--cfg", pyml, "--synthetic", "--max_epoch", "1",
                        "--output_dir", damsm_dir, "--device", device])]
    try:
        yield
        seconds = {"gan_epoch_0": _finish(procs[0], t0),
                   "pretrain_epoch_0": _finish(procs[1], t0)}
        t1 = time.perf_counter()
        procs.append(_torchrun("sba_gan_tpu_torch.main", argv + ["--max_epoch", "2"]))
        yield
        seconds["gan_resume_epoch_1"] = _finish(procs[2], t1)
    finally:
        for proc in procs:
            if proc.poll() is None:
                _kill(proc)
    ckpt = Checkpointer(os.path.join(gan_dir, "Model"))
    first, second = ckpt.restore(0), ckpt.restore(1)
    damsm = Checkpointer(os.path.join(damsm_dir, "Model"))
    found = dict(gan_checkpoints=ckpt.steps(), steps=[first["step"], second["step"]],
                 micro=[first["accum"]["micro"], second["accum"]["micro"]],
                 damsm_checkpoints=damsm.steps(), damsm_steps=damsm.restore()["step"])
    say("dist_cli", batch=batch_size, grad_accum=accum, widths=DIST_CLI_WIDTHS, **found,
        call_seconds=seconds, seconds=time.perf_counter() - t0)
    want = dict(gan_checkpoints=[0, 1], steps=[4, 8], micro=[4 % accum, 8 % accum],
                damsm_checkpoints=[0], damsm_steps=4)
    if found != want:
        raise AssertionError(f"dist_cli: {found} (want {want})")


# ---------------------------------------------------------------------------
# GAN.B_DCGAN (configs/bird_attnDCGAN2.yml): GDCGAN, with K4 in both
# refinement stages, and its one discriminator at the final scale; the step
# against the CPU, the bench lines, the CLI and the service
# ---------------------------------------------------------------------------
DCGAN_CFG = os.path.join(CONFIGS, "bird_attnDCGAN2.yml")
DCGAN_EVAL_CFG = os.path.join(CONFIGS, "eval_bird_attnDCGAN2.yml")
DCGAN_BENCH = (("float32", 30), ("bfloat16", 30), ("float32", 128))  # (dtype, batch)
_FLAX_BN = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
_FLAX_DENSE = {"weight": "kernel", "bias": "bias"}
_FLAX_CONV = ("Conv_0", "kernel")
_FLAX_RNN = {"weight_ih": "w_ih", "weight_hh": "w_hh", "bias_ih": "b_ih", "bias_hh": "b_hh"}


def flax_g_path(key: str) -> tuple:
    """The Flax GDCGAN path of one port key (the inverse of
    ``utils.weights.g_net_key(path, dcgan=True)``)."""
    p = key.split(".")
    bn = ("BatchNorm_0", _FLAX_BN.get(p[-1]))
    dense = _FLAX_DENSE.get(p[-1])
    if p[0] == "ca_net":
        return ("CANet_0", "Dense_0", dense)
    if p[0] == "mapping_net":
        return ("MappingNet_0", f"Dense_{p[2]}", "kernel")
    if p[0] == "img_net":
        return ("GetImageG_0", "Conv3x3_0") + _FLAX_CONV

    def up(prefix, idx):  # an up block's conv (1) or BatchNorm (2)
        return prefix + (("Conv3x3_0",) + _FLAX_CONV if idx == "1" else ("BatchNorm_0",) + bn)
    if p[0] == "h_net1":
        if p[1] == "fc":
            return (("InitStageG_0", "Dense_0", "kernel") if p[2] == "0"
                    else ("InitStageG_0", "BatchNorm_0") + bn)
        return up(("InitStageG_0", f"UpBlock_{int(p[1][len('upsample'):]) - 1}"), p[2])
    stage = (f"NextStageG_{int(p[0][len('h_net'):]) - 2}",)
    if p[1] == "att":
        return stage + ("WordAttention_0", "Dense_0", "kernel")
    if p[1] == "adain":
        return stage + ("AdaINNorm_0", "Dense_0", dense)
    if p[1] == "residual":
        sub = {"0": "Conv3x3_0", "1": "BatchNorm_0", "3": "Conv3x3_1", "4": "BatchNorm_1"}[p[4]]
        return stage + (f"ResBlock_{p[2]}", sub) + (_FLAX_CONV if sub[0] == "C" else bn)
    return up(stage + ("UpBlock_0",), p[2])


def flax_text_path(key: str) -> tuple:
    """The Flax RNNEncoder path of one port key."""
    if key == "encoder.weight":
        return ("embedding",)
    name, suffix = key[len("rnn."):].split("_l0")
    return ("bwd" if suffix == "_reverse" else "fwd", _FLAX_RNN[name])


def write_dcgan_npz(cfg, path):
    """A serving weights file (``utils/weights.py``: ``g_ema/...``,
    ``g/batch_stats/...``, ``text/params/...``, the JAX trees' layout) of
    ``cfg``'s seeded GDCGAN (random running statistics) and text encoder,
    written through the inverse of the port's key map: conv kernels OIHW ->
    HWIO, dense (out, in) -> (in, out).  Returns the seeded CPU sampler."""
    from sba_gan_tpu_torch.train.sample import Sampler

    cpu = Sampler.from_config(cfg, N_WORDS, seed=SEED, device="cpu")
    random_bn_stats(cpu.generator, torch.Generator().manual_seed(SEED + 1))
    arrays = {}
    for n, t in cpu.generator.state_dict().items():
        if n.endswith("num_batches_tracked"):
            continue
        fpath = flax_g_path(n)
        v = t.numpy()
        if fpath[-1] == "kernel":
            v = np.transpose(v, (2, 3, 1, 0)) if v.ndim == 4 else v.T
        coll = "g/batch_stats" if n.endswith(("running_mean", "running_var")) else "g_ema"
        arrays["/".join((coll,) + fpath)] = np.ascontiguousarray(v)
    for n, t in cpu.text_encoder.state_dict().items():
        arrays["/".join(("text", "params") + flax_text_path(n))] = t.numpy()
    np.savez(path, **arrays)
    return cpu


def phase_serve_dcgan(wordtoix, ixtoword, out):
    """The WSGI app with ``eval_bird_attnDCGAN2.yml`` and an ``.npz`` of
    seeded weights (:func:`write_dcgan_npz`), as ``serving/app.py --cfg
    ... --weights`` builds it on the card: the file restores the seeded
    weights exactly; one generation card against CPU from it (TF32 off,
    SLICE_ATOL); then, with K4's count set to 0 just before, one ``POST
    /api/v1.0/bird`` gives one stage (``small``, 256 x 256) and two maps,
    and launches K4 exactly twice."""
    from PIL import Image

    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.vocab import encode_free_text
    from sba_gan_tpu_torch.ops import word_attention as wa
    from sba_gan_tpu_torch.serving.app import build_service, make_wsgi_app
    from sba_gan_tpu_torch.train.sample import Sampler

    t0 = time.perf_counter()
    cfg = cfg_from_file(DCGAN_EVAL_CFG)
    npz = os.path.join(out, "dcgan_weights.npz")
    seeded = write_dcgan_npz(cfg, npz)
    cpu = Sampler.from_config(cfg, N_WORDS, weights=npz, device="cpu")
    restored = all(torch.equal(a, b) for m, n in (("generator", "generator"),
                                                  ("text_encoder", "text_encoder"))
                   for a, b in zip(getattr(seeded, m).state_dict().values(),
                                   getattr(cpu, n).state_dict().values()))
    gpu = Sampler.from_config(cfg, N_WORDS, weights=npz, device="cuda")
    caption = "w17 w4031 w9 w250 w77 w3 w1200 w88"
    ids, lens = encode_free_text([caption], wordtoix, cfg.TEXT.WORDS_NUM)
    z, eps = cpu.draw_noise(1, SEED)
    with tf32(cudnn=False, matmul=False):
        got = gpu.with_noise(ids, lens, z, eps)
    want = cpu.with_noise(ids, lens, z, eps)
    errs = [float(np.abs(g - c).max()) for g, c in zip(sum(got, []), sum(want, []))]
    shapes = [list(a.shape) for a in sum(got, [])]

    events = []
    with tempfile.TemporaryDirectory() as blobs:
        app = make_wsgi_app(build_service(cfg, gpu, wordtoix, ixtoword, blobs,
                                          telemetry=events.append))

        def call(method, path, body=b""):
            status = {}
            environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
                       "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
            payload = b"".join(app(environ, lambda st, h: status.setdefault("s", st)))
            return status["s"], payload
        wa.word_attention.launches = 0
        t1 = time.perf_counter()
        status, payload = call("POST", "/api/v1.0/bird",
                               json.dumps({"caption": caption, "seed": 3}).encode())
        ms = (time.perf_counter() - t1) * 1e3
        launches = wa.word_attention.launches
        bird = json.loads(payload)["bird"]
        labels = sorted(k for k in bird if k not in ("caption", "elapsed"))
        images = {}
        for label in labels:
            st, img = call("GET", bird[label])
            images[label] = [st, list(Image.open(io.BytesIO(img)).size)]
    say("serve_dcgan", cfg="eval_bird_attnDCGAN2.yml", weights_restored=restored,
        card_vs_cpu_max_abs_err=errs, atol=SLICE_ATOL, shapes=shapes, status=status,
        labels=labels, images=images, launches={"word_attention": launches},
        latency_ms=ms, phases=[e["phases"] for e in events if e.get("event") == "generate"],
        seconds=time.perf_counter() - t0)
    ok = (restored and all(e <= SLICE_ATOL for e in errs) and status == "201 Created"
          and labels == ["map1", "map2", "small"] and images["small"] == ["200 OK", [256, 256]]
          and all(v[0] == "200 OK" for v in images.values()) and launches == 2)
    if not ok:
        raise AssertionError(f"serve_dcgan: restored {restored}, errors {errs}, {status}, "
                             f"labels {labels}, images {images}, K4 launches {launches}")
    return {"word_attention": launches}


def phase_dcgan_cli(damsm_model_dir, out, cub_root):
    """``main.main`` with bird_attnDCGAN2 at batch 16 on synthetic data with
    the pretrain CLI's encoders (train, save, resume, render, kernel counts
    per step: :func:`phase_gan_cli`), and 2 steps on the CUB tree
    (:func:`phase_cub_train`), whose items the ``b_dcgan`` reader gives as
    one 256 image."""
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.pipeline import build_dataset

    calls = phase_gan_cli(damsm_model_dir, out, EVAL_BATCH, DCGAN_CFG, "dcgan")
    cfg = cfg_from_file(DCGAN_CFG)
    cfg.DATA_DIR = cub_root
    shapes = [list(i.shape) for i in build_dataset(cfg, False, "train")[0][0]]
    if shapes != [[256, 256, 3]]:
        raise AssertionError(f"dcgan_cli: the b_dcgan reader gave images {shapes}")
    cub = phase_cub_train(cub_root, out, DCGAN_CFG, "dcgan_cub_train")
    return [c["launches"] for c in calls], cub


def phase_gan_step_dcgan(inputs, cpu, batch_size=8):
    """:func:`phase_gan_step` on bird_attnDCGAN2 (R_NUM 0, lambda 1;
    WORDS_NUM 18, batch 8), the same bounds, with the CPU's runs ``cpu`` of
    ``inputs`` (:func:`gan_step_cpu_refs`, made beside earlier phases); one
    D, DNet256 without ``UNCOND_DNET``; the
    mapping net's gradient finite and nonzero on the card and on the CPU
    (its w code styles both refinement stages through AdaIN)."""
    t0 = time.perf_counter()
    ds = inputs[1].discriminators
    launches, runs = phase_gan_step(batch_size, DCGAN_CFG, "gan_step_dcgan", inputs, cpu)
    mapping = {k: float(torch.sqrt(sum((g ** 2).sum() for n, g in runs[k]["grads"].items()
                                       if n.startswith("G.mapping_net."))))
               for k in ("cuda", "cpu", "cuda_still", "cpu_still", "cpu64_still")}
    heads = [[type(d).__name__, d.UNCOND_DNET is not None] for d in ds]
    say("gan_step_dcgan", discriminators_and_uncond_head=heads,
        mapping_net_grad_norm=mapping, seconds=time.perf_counter() - t0)
    if heads != [["DNet256", False]] or not all(np.isfinite(v) and v > 0
                                                for v in mapping.values()):
        raise AssertionError(f"gan_step_dcgan: discriminators {heads}, mapping net "
                             f"gradient norms {mapping}")
    return launches


def phase_gan_bench_dcgan(style_lines):
    """``bench.measure`` (no phase split or FLOP count; :data:`SHORT_BENCH`)
    with the bird_attnDCGAN2 keys (R_NUM 0, lambda 1, one D; WORDS_NUM 18) at batch
    30 in float32 and bfloat16 and at batch 128 in float32, beside the
    bird_style lines of this call (``style_lines``): images/s, ms a step,
    device ms and launches a step, idle share, peak memory; K4 2, K1 1, K2 1
    a step."""
    from sba_gan_tpu_torch import bench
    from sba_gan_tpu_torch.config import cfg_from_file

    t0 = time.perf_counter()
    lines, bad = {}, []
    for dtype, batch in DCGAN_BENCH:
        cfg = cfg_from_file(DCGAN_CFG)
        cfg.TEXT.WORDS_NUM = bench.FLAGSHIP["TEXT"]["WORDS_NUM"]
        cfg.JAX.DTYPE = cfg.JAX.LOSS_DTYPE = dtype
        label = f"{dtype}_b{batch}"
        lines[label] = _bench_summary(bench.measure(
            cfg, batch, torch.device("cuda"), detail=False,
            models=seeded_models(cfg, bench.N_WORDS, bench.SEED), **SHORT_BENCH))
        gc.collect()
        torch.cuda.empty_cache()
        line = lines[label]
        if not line["finite"] or line["kernel_launches_per_step"] != GAN_STEP_LAUNCHES:
            bad.append(f"{label}: finite {line['finite']}, "
                       f"launches {line['kernel_launches_per_step']}")
    style = {dtype: {"batch": ln["batch"], "images_per_sec": ln["value"],
                     "device_ms_per_step": ln["profile"]["device_ms_per_step"],
                     "launches_per_step": ln["profile"]["launches_per_step"],
                     "device_idle_share": ln["profile"]["device_idle_share"],
                     "peak_memory_bytes": ln["peak_memory_bytes"]}
             for dtype, ln in style_lines.items()}
    say("gan_bench_dcgan", lines=lines, bird_style=style,
        tf32={"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
              "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32},
        seconds=time.perf_counter() - t0)
    if bad:
        raise AssertionError(f"gan_bench_dcgan: {bad}")
    return {k: v["kernel_launches_per_step"] for k, v in lines.items()}


# ---------------------------------------------------------------------------
# AttnGAN2 on COCO (configs/coco_attn2.yml, eval_coco.yml, DAMSM/coco.yml) at
# its published widths: GF_DIM 48 (K4's D 48 instance), DF_DIM
# 96, R_NUM 3, WORDS_NUM 12 / 20 / 15, lambda 50, 5 captions an image
# ---------------------------------------------------------------------------
COCO_CFG = os.path.join(CONFIGS, "coco_attn2.yml")
COCO_EVAL_CFG = os.path.join(CONFIGS, "eval_coco.yml")
COCO_PRETRAIN_CFG = os.path.join(CONFIGS, "DAMSM", "coco.yml")
COCO_N_WORDS = 27297  # the vocabulary of AttnGAN's COCO caption pickle
COCO_D = 48  # GF_DIM: the width of the generator's word attention
COCO_PRETRAIN_BATCH = 48  # DAMSM/coco's
COCO_BENCH = (("float32", 14), ("float32", 128), ("bfloat16", 14), ("bfloat16", 128))
COCO_TEST = 100  # eval_coco's batch: one batch of the test split
COCO_TRAIN = 96  # two DAMSM/coco steps of 48; six coco_attn2 steps of 14
COCO_IMAGE = (640, 480)  # COCO's typical width x height
COCO_CPU_ROWS = 4  # the sampling batch's rows held to the CPU


def _caption_lens(b, t, seed, shortest=2):
    """``b`` caption lengths in [shortest, t], both ends present."""
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(shortest, t + 1, (b,), generator=gen).tolist()
    lens[0], lens[-1] = shortest, t
    return lens


def phase_kernels_coco():
    """K4's D 48 instance at COCO's D 48 against its plain version: at the
    coco_attn2 step's shapes (B 14, the preset's batch, and B 128, the
    bench's; QL 64^2 and 128^2, T 12, captions of 2 to 12 words) in float32
    and bfloat16, at eval_coco's batch (B 100, QL 64^2, T 20) and at one
    generation (B 1, QL 128^2, T 20) in float32, with the library's three
    calls beside, each with an all-padding row (:func:`padding_row_err`)
    and the instance it took, which must be the D 48 one; then K1-K3 at
    DAMSM/coco's pretrain shape (B 48, T 15, R 289, D 256).  The tolerances
    of the D 32 and B 32 rows."""
    reps = dict(calls=5, replays=4)
    rows = {}
    for b, seed, prefix in ((14, 150, "coco_step"), (128, 170, "coco_step_b128")):
        lens = _caption_lens(b, 12, SEED + b)
        for k, ql in enumerate((64 * 64, 128 * 128)):
            row = word_attention_case(b, ql, 12, COCO_D, lens, seed=seed + k, reps=reps,
                                      padding_row=True)
            say("kernel", name="word_attention", case="coco_step", **row)
            rows[f"{prefix}_ql{ql}"] = row
            rows[f"{prefix}_ql{ql}_bf16"] = word_attention_bf16_case(
                b, ql, 12, COCO_D, lens, seed=seed + k, reps=reps, case="coco_step",
                padding_row=True)
    for label, b, ql, lens in (("coco_sampling", 100, 64 * 64, _caption_lens(100, 20, SEED)),
                               ("coco_generation", 1, 128 * 128, [13])):
        row = word_attention_case(b, ql, 20, COCO_D, lens, seed=152 + b, reps=reps,
                                  padding_row=True)
        say("kernel", name="word_attention", case=label, **row)
        rows[label] = row
    others = {label: r["instance"] for label, r in rows.items() if r["instance"] != COCO_D}
    if others:
        raise AssertionError(f"K4 at D 48 took another instance than its D 48 one: {others}")
    damsm = damsm_case(COCO_PRETRAIN_BATCH, 15, seed=160)
    for name, row in damsm.items():
        say("kernel", name=name, case="coco_pretrain", **row)
    return rows, damsm


def coco_pretrain_cpu_refs():
    """The pretrain_step_coco phase's inputs (the COCO vocabulary) and the
    CPU's run of them, its launches not counted, so that it runs in a
    thread beside phases that count."""
    from sba_gan_tpu_torch.config import cfg_from_file

    inputs = pretrain_step_inputs(cfg_from_file(COCO_PRETRAIN_CFG), COCO_PRETRAIN_BATCH,
                                  n_words=COCO_N_WORDS)
    return inputs, pretrain_step_run(inputs, "cpu", count=False)


def write_coco_tree(root, seed=SEED):
    """A COCO layout under ``root`` (whose path holds no ``birds``, so the
    reader takes no boxes): flat ``images/`` of smooth random JPEGs of
    COCO_IMAGE named as COCO 2014's, ``text/`` with the preset's 5 captions
    an image over CUB_VOCAB made-up words, ``train``/``test`` filename
    pickles of COCO_TRAIN and COCO_TEST items, and no class pickles (every
    image its own class).  Returns ``root``."""
    import pickle

    rng = np.random.default_rng(seed + 7)
    words = made_up_words(rng)
    for d in ("images", "text", "train", "test"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for split, n, year in (("train", COCO_TRAIN, "train2014"), ("test", COCO_TEST, "val2014")):
        keys = [f"COCO_{year}_{i + 1:012d}" for i in range(n)]
        for key in keys:
            write_smooth_jpeg(rng, COCO_IMAGE, os.path.join(root, "images", key + ".jpg"))
            with open(os.path.join(root, "text", key + ".txt"), "w") as f:
                for _ in range(5):
                    f.write(" ".join(rng.choice(words, int(rng.integers(5, 19)))) + "\n")
        with open(os.path.join(root, split, "filenames.pickle"), "wb") as f:
            pickle.dump(keys, f)
    return root


def phase_coco_tree(root):
    """The COCO-layout tree, then its test split read with 4 reader threads:
    COCO_TEST items without boxes, each its own class, 5 captions an item,
    three image sizes; items/s."""
    from sba_gan_tpu_torch.config import cfg_from_file
    from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset

    t0 = time.perf_counter()
    write_coco_tree(root)
    written = time.perf_counter() - t0
    cfg = cfg_from_file(COCO_EVAL_CFG)
    cfg.DATA_DIR = root
    test = build_dataset(cfg, False, "test")
    t1 = time.perf_counter()
    (batch,) = list(DataLoader(test, COCO_TEST, shuffle=False, drop_last=False,
                               num_workers=4))
    rate = COCO_TEST / (time.perf_counter() - t1)
    shapes = [list(x.shape[1:]) for x in batch.imgs]
    say("coco_tree", write_s=written, items_per_s_4_threads=rate, n_words=test.n_words,
        test_items=len(test), train_items=len(build_dataset(cfg, False, "train")),
        boxes=test.bbox is not None, captions=len(test.captions), image_shapes=shapes)
    if not (test.bbox is None and len(test) == COCO_TEST
            and len(test.captions) == 5 * COCO_TEST
            and test.class_id.tolist() == list(range(COCO_TEST))
            and shapes == [[s, s, 3] for s in (64, 128, 256)]):
        raise AssertionError(f"coco_tree: boxes {test.bbox is not None}, {len(test)} items, "
                             f"{len(test.captions)} captions, images {shapes}")
    return test.n_words


def phase_coco_cli(root, out, n_words):
    """The three user paths of the COCO presets on the tree ``root``:
    ``pretrain.main`` with DAMSM/coco (one epoch: two steps of 48, two
    evaluation batches, a checkpoint; K1 4, K2 2, K3 2); ``main.main`` with
    coco_attn2 and that checkpoint as TRAIN.NET_E (batch 14: an epoch of 6
    steps, save, a resume for another; K4 2, K1 1, K2 1 a step; the
    rendering is the GAN CLI phase's);
    its EMA G as a reference-layout ``netG.pth`` beside the pretrained text
    encoder; ``main.main`` with eval_coco and ``B_VALIDATION`` (one batch of
    COCO_TEST PNGs, K4 twice; its first COCO_CPU_ROWS images on the card
    against the CPU).  Returns each path's launches."""
    damsm = os.path.join(out, "coco_damsm")
    pretrain_launches = phase_pretrain_cli(COCO_PRETRAIN_CFG, damsm, root, "coco_pretrain_cli")
    calls = phase_gan_cli(os.path.join(damsm, "Model"), out, 14, COCO_CFG, "coco_gan", root,
                          render=False)
    net_g, net_e = write_reference_checkpoints(
        os.path.join(out, "coco_gan", "Model"), os.path.join(damsm, "Model"), n_words, out,
        "coco_", own_text=True)
    sampling = phase_eval_sampling(root, net_g, net_e, n_words, out, COCO_EVAL_CFG, COCO_TEST,
                                   COCO_TEST, "coco_sampling", COCO_CPU_ROWS, timed=False)
    return {"pretrain_cli_epoch": pretrain_launches,
            "gan_cli_calls": [c["launches"] for c in calls],
            "sampling_word_attention": sampling}


def phase_gan_bench_coco(style_lines):
    """``bench.measure`` (no phase split or FLOP count; :data:`SHORT_BENCH`)
    with the coco_attn2 keys (WORDS_NUM 12, the COCO vocabulary's seeded
    weights) at the preset's batch 14 and at 128 (or the largest of
    ``bench.FALLBACK_BATCHES`` that fits, stated) in float32 and bfloat16,
    beside the bird_style lines of this call (``style_lines``): images/s, ms
    a step, device ms and launches a step, idle share, peak memory, each
    kernel's device ms a step; K4 2, K1 1, K2 1 a step."""
    from sba_gan_tpu_torch import bench
    from sba_gan_tpu_torch.config import cfg_from_file

    t0 = time.perf_counter()
    lines, bad = {}, []
    for dtype, batch in COCO_BENCH:
        cfg = cfg_from_file(COCO_CFG)
        cfg.JAX.DTYPE = cfg.JAX.LOSS_DTYPE = dtype
        label = f"{dtype}_b{batch}"
        r = bench.measure(cfg, batch, torch.device("cuda"), detail=False,
                          models=seeded_models(cfg, COCO_N_WORDS, SEED), **SHORT_BENCH)
        named = r["profile"]["hand_written_kernels"]
        lines[label] = dict(_bench_summary(r), kernel_ms_per_step={
            k: named[k]["device_ms_per_step"] for k in GAN_KERNELS})
        del r
        gc.collect()
        torch.cuda.empty_cache()
        line = lines[label]
        if not line["finite"] or line["kernel_launches_per_step"] != GAN_STEP_LAUNCHES:
            bad.append(f"{label}: finite {line['finite']}, "
                       f"launches {line['kernel_launches_per_step']}")
    style = {dtype: {"batch": ln["batch"], "images_per_sec": ln["value"],
                     "device_ms_per_step": ln["profile"]["device_ms_per_step"],
                     "launches_per_step": ln["profile"]["launches_per_step"],
                     "device_idle_share": ln["profile"]["device_idle_share"],
                     "peak_memory_bytes": ln["peak_memory_bytes"]}
             for dtype, ln in style_lines.items()}
    say("gan_bench_coco", lines=lines, bird_style=style,
        tf32={"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
              "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32},
        seconds=time.perf_counter() - t0)
    if bad:
        raise AssertionError(f"gan_bench_coco: {bad}")
    return {k: v["kernel_launches_per_step"] for k, v in lines.items()}


# ---------------------------------------------------------------------------
# the gen-2 conditional StyleGAN (configs/gen2_birds.yml)
# ---------------------------------------------------------------------------
GEN2_CFG = os.path.join(CONFIGS, "gen2_birds.yml")
GEN2_BATCH = 8
# the preset (WGAN-GP), BCE mode (Inception at MODEL.INCEPTION_INPUT 299),
# and the preset with every G toggle on
GEN2_RUNS = ("wgan", "bce", "toggles")
GEN2_TOL = {k: GAN_STEP_TOL[k] for k in ("logs", "d_grads", "g_grads", "ema_excess")}
GEN2_TOL["params_rms_excess"] = GAN_STEP_TOL["params_adam_excess"]
GEN2_TF32_TOL = {k: GAN_TF32_TOL[k] for k in ("logs", "d_grads", "g_grads")}
GEN2_BENCH_BATCHES = (8, 64)
GEN2_WARMUP, GEN2_D_STEPS = 3, 20  # the window: 20 D steps, a G step after every 5th
GEN2_TREE_ITEMS, GEN2_TREE_CAPTIONS = 16, 6


def gen2_cfg(run):
    """gen2_birds.yml at batch GEN2_BATCH, as ``run`` of GEN2_RUNS sets it."""
    from sba_gan_tpu_torch.config import cfg_from_file

    cfg = cfg_from_file(GEN2_CFG)
    cfg.TRAIN.BATCH_SIZE = GEN2_BATCH
    if run == "bce":
        cfg.GEN2.WGAN = False
    if run == "toggles":
        cfg.GEN2.update(USE_ATTENTION=True, USE_NOISE=True, USE_PIXEL_NORM=True,
                        USE_TRUNCATION=True)
    return cfg


def gen2_batch(cfg, batch, seed=SEED, device="cpu"):
    """Images (B, R, R, 3) in [-1, 1] and wordpiece ids (B, MAX_LENGTH), 4 to
    MAX_LENGTH of them a caption, zero-padded."""
    g2 = cfg.GEN2
    gen = torch.Generator().manual_seed(seed)
    real = torch.rand((batch, g2.RESOLUTION, g2.RESOLUTION, 3), generator=gen) * 2 - 1
    lens = torch.randint(4, g2.MAX_LENGTH + 1, (batch,), generator=gen)
    ids = torch.randint(1, g2.BERT_VOCAB, (batch, g2.MAX_LENGTH), generator=gen)
    tokens = torch.where(torch.arange(g2.MAX_LENGTH)[None, :] < lens[:, None], ids, 0)
    return real.to(device), tokens.to(device)


def gen2_trainer(cfg, state, device, dtype=torch.float32):
    """A trainer on ``device`` in ``dtype`` holding ``state``."""
    from sba_gan_tpu_torch.train.gen2 import Gen2Trainer

    t = Gen2Trainer(cfg, device=device, seed=SEED, dtype=dtype, init=False)
    t.load_state_dict(state)
    return t


def gen2_step_run(cfg, state, inputs, device, dtype=torch.float32, count=True):
    """One D step, then one G step, from ``state`` on ``device`` in ``dtype``
    with the draws of steps 0 and 1: the losses, the gradients, the trained
    parameters after their update, G's EMA and the BERT tower's largest
    change; the kernel counts set to 0 just before, read just after (with
    ``count``); all on the CPU."""
    wrappers = _kernel_wrappers()
    t = gen2_trainer(cfg, state, device, dtype)
    real, tokens = inputs
    tower = [p.detach().clone() for p in t.generator.bert_embedding.bert.parameters()]
    if count:
        reset_launches(wrappers)
    t0 = time.perf_counter()
    d_loss, d_grads = t.d_grads(real, tokens, t.draw(0, real.shape[0], t.wgan))
    t.apply_d(d_grads)
    g_loss, g_grads, e_grads = t.g_grads(tokens, t.draw(2 * t.step + 1, real.shape[0], False))
    t.apply_g(g_grads, e_grads)
    logs = {"d_loss": float(d_loss), "g_loss": float(g_loss)}
    seconds = time.perf_counter() - t0
    launches = read_launches(wrappers) if count else None
    frozen = max(float((p - p0).abs().max())
                 for p, p0 in zip(t.generator.bert_embedding.bert.parameters(), tower))
    nets = {"D": (t.d_names, d_grads, t.dnet), "G": (t.g_names, g_grads, t.generator),
            "E": (t.e_names, e_grads, t.image_encoder)}
    grads, params, lr = {}, {}, {}
    for net, (names, gs, module) in nets.items():
        if not names:
            continue
        p_of = dict(module.named_parameters())
        for n, g in zip(names, gs):
            grads[f"{net}.{n}"] = g.detach().cpu().double()
            params[f"{net}.{n}"] = p_of[n].detach().cpu()
    ema_of = dict(t.g_ema.named_parameters())
    return dict(logs=logs, grads=grads, params=params,
                ema={n: ema_of[n].detach().cpu() for n in t.g_names},
                lr={"D": t.d_opt.lr, "G": t.g_opt.lr, "E": t.e_opt.lr if t.e_opt else None},
                frozen_tower_max_change=frozen, launches=launches, seconds=seconds)


def gen2_cpu_refs():
    """For each of GEN2_RUNS: its config, the weights drawn from SEED on the
    CPU (float32; G's learned constant drawn too, as the weights of a
    trained G: the init's ones are flat in space, so the instance norm after
    them divides float32 rounding by sqrt(1e-8), and the gradient of the
    constant's bias, 0 in exact arithmetic, is that rounding alone), its
    batch, and the CPU's float64 run of :func:`gen2_step_run`, its launches
    not counted (it runs in a thread beside phases that count)."""
    from sba_gan_tpu_torch.train.gen2 import Gen2Trainer

    refs = {}
    for run in GEN2_RUNS:
        cfg = gen2_cfg(run)
        state = copy.deepcopy(Gen2Trainer(cfg, device="cpu", seed=SEED).state_dict())
        const = state["generator"]["const"]
        const.copy_(torch.randn(const.shape, generator=torch.Generator().manual_seed(SEED)))
        state["g_ema"]["const"].copy_(const)
        inputs = gen2_batch(cfg, GEN2_BATCH)
        refs[run] = (cfg, state, inputs,
                     gen2_step_run(cfg, state, inputs, "cpu", torch.float64, count=False),
                     gen2_step_run(cfg, state, inputs, "cpu", count=False))
    return refs


def _rms_first(g):
    """RMSprop's first update of ``g`` over its learning rate."""
    return g / torch.sqrt(0.1 * g * g + 1e-8)


def gen2_step_readings(got, want) -> dict:
    """``got`` (a float32 run) against ``want`` (the CPU's float64 run): the
    losses' relative gaps; each net's gradient norm, and the gap of its
    whole gradient over that norm (D's, and G's with the image encoder's
    ``fc``: ``d_grads``, ``g_grads``); each tensor's gap over its own norm,
    the largest of D's and of G's (``tensor_*``; G's tensors ahead of an
    instance norm, whose gradients nearly cancel, and its attention's,
    through a softmax that random weights saturate, are ill-conditioned in
    float32: the CPU's own float32 step is as far from float64 there); the parameters after their update: each entry's
    gap less that of RMSprop's first updates of the two gradients and one
    float32 rounding of the parameter, over lr, at most (``params_rms_
    excess``), and the largest gap over lr; the EMA: its gap past 1e-3 of
    the parameters' and two roundings."""
    ulp = torch.finfo(torch.float32).eps
    logs = max(abs(got["logs"][k] - want["logs"][k]) / abs(want["logs"][k])
               for k in want["logs"])
    norms = {}
    for net in ("D", "G", "E"):
        for label, run in (("got", got), ("want", want)):
            sq = [g.to(READINGS_DEVICE).pow(2).sum() for n, g in run["grads"].items()
                  if n.startswith(f"{net}.")]
            if sq:
                norms.setdefault(net, {})[label] = float(torch.stack(sq).sum().sqrt())
    errs = {n: _norm_rel(g, want["grads"][n]) for n, g in got["grads"].items()}
    gaps = {}
    for n, g in got["grads"].items():
        net = "D" if n.startswith("D.") else "G"  # the image encoder's fc with G
        gaps[net] = gaps.get(net, 0.0) + float(
            (g.to(READINGS_DEVICE) - want["grads"][n].to(READINGS_DEVICE)).pow(2).sum())
    want_sq = {net: sum(v["want"] ** 2 for k, v in norms.items()
                        if (k == "D") == (net == "D")) for net in gaps}
    excess = largest = 0.0
    for n, g_want in want["grads"].items():
        lr = want["lr"][n.split(".", 1)[0]]
        g_got = got["grads"][n].to(READINGS_DEVICE)
        g_want = g_want.to(READINGS_DEVICE)
        p_got, p_want = (r["params"][n].to(READINGS_DEVICE, torch.float64)
                         for r in (got, want))
        gap = (p_got - p_want).abs()
        past = gap - lr * (_rms_first(g_got) - _rms_first(g_want)).abs() - ulp * p_want.abs()
        excess = max(excess, past.max().item() / lr)
        largest = max(largest, gap.max().item() / lr)
    ema_excess = 0.0
    for n, e_want in want["ema"].items():
        p_got, p_want, e_got, e_want = (t.to(READINGS_DEVICE, torch.float64) for t in (
            got["params"][f"G.{n}"], want["params"][f"G.{n}"], got["ema"][n], e_want))
        slack = 1e-3 * (p_got - p_want).abs() + 2 * ulp * e_want.abs()
        ema_excess = max(ema_excess, ((e_got - e_want).abs() - slack).max().item())
    return {"logs": logs,
            "d_grads": (gaps["D"] / want_sq["D"]) ** 0.5,
            "g_grads": (gaps["G"] / want_sq["G"]) ** 0.5,
            "grad_norms": norms, "params_rms_excess": excess, "params_max_over_lr": largest,
            "ema_excess": ema_excess,
            "tensor_d_grads": max(e for n, e in errs.items() if n.startswith("D.")),
            "tensor_g_grads": max(e for n, e in errs.items() if not n.startswith("D.")),
            "worst_grads": _worst(errs)}


def phase_gen2_step(refs):
    """One D step and one G step of gen2_birds.yml at full width (bert-base
    at random init, 128^2, batch 8) on the card, TF32 off, for each of
    GEN2_RUNS, against the CPU's float64 run of the same weights, batch and
    draws (``refs``, :func:`gen2_cpu_refs`; float64 but for the
    align-corners resizes, G's 4->8 and 8->16 upsampling and BCE's 128->299,
    which compute in float32 on both devices) within the gan_step bounds
    (GEN2_TOL); the preset's card step at the bench's precision (GAN_TF32)
    against it within GEN2_TF32_TOL.  The frozen tower's largest change
    must be 0.0 on both devices; no K1-K4 launch.  Returns the card's
    launches by run."""
    t0 = time.perf_counter()
    none = dict.fromkeys(GAN_KERNELS, 0)
    out, bad = {}, []
    for run in GEN2_RUNS:
        cfg, state, inputs, cpu64, cpu32 = refs[run]
        with tf32(cudnn=False, matmul=False):
            card = gen2_step_run(cfg, state, inputs, "cuda")
        r = gen2_step_readings(card, cpu64)
        fields = dict(readings=r, cpu_f32=gen2_step_readings(cpu32, cpu64),
                      card_vs_cpu_f32={k: v for k, v in gen2_step_readings(card, cpu32).items()
                                       if k in ("logs", "d_grads", "g_grads", "tensor_d_grads",
                                                "tensor_g_grads", "worst_grads")},
                      logs_cuda=card["logs"], logs_cpu64=cpu64["logs"],
                      frozen_tower_max_change={"cuda": card["frozen_tower_max_change"],
                                               "cpu64": cpu64["frozen_tower_max_change"]},
                      step_s={"cuda": card["seconds"], "cpu64": cpu64["seconds"]},
                      launches=card["launches"])
        bad += [f"{run}.{k}" for k, tol in GEN2_TOL.items() if not r[k] <= tol]
        if run == "wgan":
            with tf32(**GAN_TF32):
                fast = gen2_step_run(cfg, state, inputs, "cuda")
            rf = gen2_step_readings(fast, cpu64)
            fields["tf32"] = {k: rf[k] for k in ("logs", "d_grads", "g_grads", "grad_norms")}
            bad += [f"{run}.tf32.{k}" for k, tol in GEN2_TF32_TOL.items() if not rf[k] <= tol]
            bad += [f"{run}.tf32.launches"] if fast["launches"] != none else []
        if card["frozen_tower_max_change"] != 0.0 or cpu64["frozen_tower_max_change"] != 0.0:
            bad.append(f"{run}.frozen_tower")
        if card["launches"] != none or not all(np.isfinite(v) for v in card["logs"].values()):
            bad.append(f"{run}.launches_or_finite")
        out[run] = fields
    g2 = refs["wgan"][0].GEN2
    say("gen2_step", batch=GEN2_BATCH, resolution=g2.RESOLUTION, bert_layers=g2.BERT_LAYERS,
        bert_hidden=g2.BERT_HIDDEN, critic_iter=refs["wgan"][0].TRAIN.CRITIC_ITER,
        inception_input=refs["bce"][0].MODEL.INCEPTION_INPUT, runs=out,
        tol={**GEN2_TOL, "tf32": GEN2_TF32_TOL}, tf32_run=GAN_TF32,
        seconds=time.perf_counter() - t0)
    if bad:
        raise AssertionError(f"gen2_step: card and CPU disagree in {bad}")
    return {run: v["launches"] for run, v in out.items()}


def preset_resolution() -> int:
    from sba_gan_tpu_torch.config import cfg_from_file

    return cfg_from_file(GEN2_CFG).GEN2.RESOLUTION


def write_gen2_tree(root, seed=SEED):
    """A birds-layout tree for ``prepare_data``: GEN2_TREE_ITEMS JPEGs of
    CUB's size in 4 class directories, GEN2_TREE_CAPTIONS captions each of
    6 to 14 made-up words; (image root, text root)."""
    rng = np.random.default_rng(seed)
    words = made_up_words(rng, 200)
    imgs, txts = os.path.join(root, "images"), os.path.join(root, "text")
    for i in range(GEN2_TREE_ITEMS):
        cls = f"{i % 4 + 1:03d}.Class_{i % 4}"
        os.makedirs(os.path.join(imgs, cls), exist_ok=True)
        os.makedirs(os.path.join(txts, cls), exist_ok=True)
        write_smooth_jpeg(rng, CUB_IMAGE, os.path.join(imgs, cls, f"item_{i:04d}.jpg"))
        caps = [" ".join(rng.choice(words, int(rng.integers(6, 15))))
                for _ in range(GEN2_TREE_CAPTIONS)]
        with open(os.path.join(txts, cls, f"item_{i:04d}.txt"), "w") as f:
            f.write("\n".join(caps) + "\n")
    return imgs, txts


def phase_gen2_cli(out):
    """``prepare_data`` over a tree of :func:`write_gen2_tree` (sizes 4 to
    128, 4 workers), then ``gen2_main`` on the card with gen2_birds.yml:
    one epoch of the pack at batch 2 (8 D steps, a G step after the 5th),
    a second call that resumes from its checkpoint for another, and one
    epoch of ``--synthetic`` data at the preset's batch 8; each call's grid
    and checkpoint, finite losses, no K1-K4 launch."""
    from sba_gan_tpu_torch import gen2_main, prepare_data
    from sba_gan_tpu_torch.utils.checkpoint import Checkpointer
    from PIL import Image

    t0 = time.perf_counter()
    wrappers = _kernel_wrappers()
    imgs, txts = write_gen2_tree(os.path.join(out, "gen2_tree"))
    pack = os.path.join(out, "gen2_pack")
    t1 = time.perf_counter()
    total = prepare_data.main(["--out", pack, "--img_path", imgs, "--txt_path", txts,
                               "--n_worker", "4", "--sizes", "4", "8", "16", "32", "64", "128"])
    pack_s = time.perf_counter() - t1
    runs, calls = {}, []
    for name, argv in (
            ("pack", ["--data_dir", pack, "--batch", "2", "--output_dir",
                      os.path.join(out, "gen2_pack_run")]),
            ("pack_resumed", ["--data_dir", pack, "--batch", "2", "--output_dir",
                              os.path.join(out, "gen2_pack_run")]),
            ("synthetic", ["--synthetic", "--output_dir", os.path.join(out, "gen2_synth")])):
        reset_launches(wrappers)
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            trainer = gen2_main.main(["--cfg", GEN2_CFG, "--max_epoch", "1", *argv])
        seconds = time.perf_counter() - t1
        printed = buf.getvalue()
        calls.append(read_launches(wrappers))
        losses = [float(v) for line in printed.splitlines() if "Loss_D" in line
                  for v in (line.split("Loss_D: ")[1].split()[0],
                            line.split("Loss_G: ")[1].split()[0])]
        run_dir = argv[argv.index("--output_dir") + 1]
        grid = np.asarray(Image.open(os.path.join(run_dir, "Image", "epoch_0.png")))
        runs[name] = dict(step=trainer.step, losses=losses, grid_shape=list(grid.shape),
                          checkpoints=Checkpointer(os.path.join(run_dir, "Model")).steps(),
                          resumed="resumed at step" in printed, seconds=seconds)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    say("gen2_cli", pack_items=total, pack_s=pack_s, runs=runs, launches=calls,
        seconds=time.perf_counter() - t0)
    side = preset_resolution() + 2  # an image and its pad
    want = {"pack": (8, [8], False, [side + 2, 2 * side + 2, 3]),
            "pack_resumed": (16, [8, 16], True, None),
            "synthetic": (8, [8], False, [2 * side + 2, 4 * side + 2, 3])}
    bad = [name for name, (step, ckpts, resumed, shape) in want.items()
           if runs[name]["step"] != step or runs[name]["checkpoints"] != ckpts
           or runs[name]["resumed"] != resumed or not runs[name]["losses"]
           or not np.all(np.isfinite(runs[name]["losses"]))
           or (shape and runs[name]["grid_shape"] != shape)]
    if total != GEN2_TREE_ITEMS or bad or any(c != dict.fromkeys(GAN_KERNELS, 0) for c in calls):
        raise AssertionError(f"gen2_cli: {total} items, wrong runs {bad}, launches {calls}")
    return calls


def phase_gen2_bench(style_lines, state):
    """The preset's training loop on the card at PyTorch's TF32 defaults
    (GAN_TF32, the precision gen2_step checked), from the weights of
    ``state``, at each of GEN2_BENCH_BATCHES: GEN2_WARMUP D steps, then a
    window of GEN2_D_STEPS D steps with a G step after every CRITIC_ITER-th,
    queued back to back and closed by one host read (images/s: the D
    steps' images over the window); then the D step, the G step and the
    loop (CRITIC_ITER D steps and one G step) traced apart: device ms,
    launches, idle share; peak memory; beside the bird_style lines of this
    call.  No K1-K4 launch, by the wrappers' counts or by name in the
    traces."""
    from sba_gan_tpu_torch import bench

    cfg = gen2_cfg("wgan")
    ci = cfg.TRAIN.CRITIC_ITER
    t0 = time.perf_counter()
    wrappers = _kernel_wrappers()
    lines = {}
    reset_launches(wrappers)
    for batch in GEN2_BENCH_BATCHES:
        torch.cuda.reset_peak_memory_stats()
        t = gen2_trainer(cfg, state, "cuda")
        real, tokens = gen2_batch(cfg, batch, device="cuda")

        def loop(d_steps):
            for i in range(d_steps):
                last = t.d_step(real, tokens)
                if (i + 1) % ci == 0:
                    t.g_step(tokens)
            return last
        with tf32(**GAN_TF32):
            float(loop(GEN2_WARMUP))
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            d_loss = float(loop(GEN2_D_STEPS))
            window_s = time.perf_counter() - w0
            d = bench.profile_steps(t.d_step, (real, tokens), ci, sync=float)
            g = bench.profile_steps(t.g_step, (tokens,), 2, sync=float)
            both = bench.profile_steps(loop, (ci,), 1, sync=float)
        lines[f"b{batch}"] = dict(
            batch=batch, d_steps=GEN2_D_STEPS, g_steps=GEN2_D_STEPS // ci,
            images_per_sec=GEN2_D_STEPS * batch / window_s, window_s=window_s,
            ms_per_d_step=window_s * 1e3 / GEN2_D_STEPS, d_step=d, g_step=g,
            loop_of_critic_iter=both, peak_memory_bytes=torch.cuda.max_memory_allocated(),
            d_loss=d_loss, finite=bool(np.isfinite(d_loss)))
        del t, real, tokens
        gc.collect()
        torch.cuda.empty_cache()
    launches = read_launches(wrappers)
    style = {dtype: {"batch": ln["batch"], "images_per_sec": ln["value"],
                     "device_ms_per_step": ln["profile"]["device_ms_per_step"],
                     "device_idle_share": ln["profile"]["device_idle_share"],
                     "peak_memory_bytes": ln["peak_memory_bytes"]}
             for dtype, ln in style_lines.items()}
    say("gen2_bench", lines=lines, bird_style=style, tf32_run=GAN_TF32,
        kernel_launches=launches, seconds=time.perf_counter() - t0)
    traced = sum(k["launches_per_step"] for v in lines.values()
                 for p in (v["d_step"], v["g_step"], v["loop_of_critic_iter"])
                 for k in p["hand_written_kernels"].values())
    if (launches != dict.fromkeys(GAN_KERNELS, 0) or traced
            or not all(v["finite"] for v in lines.values())):
        raise AssertionError(f"gen2_bench: launches {launches}, traced K1-K4 {traced}, "
                             f"finite {[v['finite'] for v in lines.values()]}")
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
CPU_POOL_THREADS = 6  # of the card's machine's 8 cores, for the CPU's reference runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from sba_gan_tpu_torch.config import preset
    from sba_gan_tpu_torch.data.vocab import synthetic_vocab

    name, smi = phase_device()
    phase_build()
    from concurrent.futures import ThreadPoolExecutor

    # one thread computes the CPU's reference runs (on CPU_POOL_THREADS of
    # torch's threads, a setting of that thread) beside phases whose host
    # time is no metric: the GAN step's beside the kernel rows (their device
    # times come from CUDA graphs; their eager times, and the serve phase's
    # latencies, are read beside it) and the pretraining phases, the BERT
    # steps' beside the GAN and BERT CLIs, the accumulation window's beside
    # the ranks, the DCGAN and COCO steps' beside the torchrun, DCGAN and
    # COCO CLIs
    cpu_pool = ThreadPoolExecutor(1, initializer=torch.set_num_threads,
                                  initargs=(CPU_POOL_THREADS,))
    dist_cli = None
    try:
        # the bird step's weights are drawn here, not in the pool's thread: a
        # draw's orthogonal factors depend on the drawing thread's count of
        # torch threads in their last bits, and dist_gloo2's ranks draw them
        # on their main threads
        gan_inputs = gan_step_inputs()
        gan_cpu = cpu_pool.submit(gan_step_cpu_runs, gan_inputs, False)
        rows, gan_rows = phase_kernels()
        rows16 = phase_kernels_bf16()
        damsm_rows = phase_damsm_kernels()
        damsm_rows16 = phase_damsm_kernels_bf16()
        cfg = preset("eval_bird")
        wordtoix, ixtoword = synthetic_vocab(N_WORDS)
        damsm_cfg = preset("DAMSM/bird")
        with tempfile.TemporaryDirectory() as out:
            sampler = phase_slice(cfg, wordtoix)
            launches = phase_serve(cfg, sampler, wordtoix, ixtoword)
            launches16 = phase_generation_bf16(cfg, wordtoix)
            pretrain_runs = phase_pretrain_step(damsm_cfg, batch_size=32)
            pretrain16 = phase_pretrain_step_bf16(damsm_cfg, 32, pretrain_runs)
            chunks_launches = phase_pretrain_step_chunks(damsm_cfg, 32, pretrain_runs)
            del pretrain_runs
            pretrain_cli = phase_pretrain_cli(PRETRAIN_CFG, os.path.join(out, "damsm"))
            launches.update((k, v) for k, v in pretrain_cli.items() if k in DAMSM_KERNELS)
            profiling_launches = phase_profiling(damsm_cfg, out)
            gan_launches, gan_runs = phase_gan_step(inputs=gan_inputs, cpu=gan_cpu.result())
            gan_launches16 = phase_gan_step_bf16(gan_runs)
            del gan_runs, gan_inputs, gan_cpu
            chunks_memory = phase_pretrain_chunks_memory(damsm_cfg)
            style_lines = {"float32": phase_gan_bench(), "bfloat16": phase_gan_bench_bf16()}
            tree = os.path.join(out, "birds")
            n_words, pil_rates = phase_cub_tree(tree)
            phase_native_loader(tree, pil_rates)
            bert_refs = cpu_pool.submit(gan_step_bert_cpu_refs)
            bert_pretrain_inputs = pretrain_bert_inputs()
            bert_pretrain_cpu = cpu_pool.submit(pretrain_bert_cpu_runs, bert_pretrain_inputs)
            phase_gan_cli(os.path.join(out, "damsm", "Model"), out)
            phase_cub_train(tree, out)
            bert_cli_pretrain_launches, bert_cli_gan_launches = phase_bert_cli(out)
            phase_bert_encoder()
            bert_gan_launches, mixing_launches = phase_gan_step_bert(bert_refs.result())
            bert_pretrain_launches = phase_pretrain_step_bert(bert_pretrain_inputs,
                                                              bert_pretrain_cpu.result())
            del bert_refs, bert_pretrain_inputs, bert_pretrain_cpu
            net_g, net_e = write_reference_checkpoints(
                os.path.join(out, "gan", "Model"), os.path.join(out, "damsm", "Model"),
                n_words, out)
            eval_launches = phase_eval_sampling(tree, net_g, net_e, n_words, out)
            gen_launches = phase_gen_example(tree, net_g, net_e, out)
            reproduce_launches = phase_reproduce(tree, net_g, net_e, out)
            bert_bench_launches = phase_gan_bench_bert(style_lines)
            inputs = accum_inputs()
            cpu_window = cpu_pool.submit(accum_cpu_window, inputs)
            gloo2_launches = phase_dist_gloo2()
            nccl1_launches = phase_dist_nccl1()
            accum_launches = phase_grad_accum(inputs, cpu_window.result())
            del inputs, cpu_window
            bench_dist_launches = phase_gan_bench_dist(style_lines["float32"])
            dcgan_refs = cpu_pool.submit(gan_step_cpu_refs, DCGAN_CFG)
            coco_pretrain_refs = cpu_pool.submit(coco_pretrain_cpu_refs)
            coco_gan_refs = cpu_pool.submit(gan_step_cpu_refs, COCO_CFG, words_num=None,
                                            n_words=COCO_N_WORDS)
            gen2_refs = cpu_pool.submit(gen2_cpu_refs)
            dist_cli = phase_dist_cli(out)  # its torchrun processes beside the CLIs below
            next(dist_cli)
            dcgan_cli_launches, dcgan_cub_launches = phase_dcgan_cli(
                os.path.join(out, "damsm", "Model"), out, tree)
            dcgan_serve_launches = phase_serve_dcgan(wordtoix, ixtoword, out)
            next(dist_cli)
            coco_tree = os.path.join(out, "coco")
            coco_cli = phase_coco_cli(coco_tree, out, phase_coco_tree(coco_tree))
            next(dist_cli, None)
            dcgan_step_launches = phase_gan_step_dcgan(*dcgan_refs.result())
            del dcgan_refs
            inputs, cpu = coco_pretrain_refs.result()
            coco_pretrain = phase_pretrain_step(inputs[0], COCO_PRETRAIN_BATCH,
                                                "pretrain_step_coco", inputs,
                                                cpu)["cuda"]["launches"]
            inputs, cpu = coco_gan_refs.result()
            coco_step_launches, _ = phase_gan_step(8, COCO_CFG, "gan_step_coco", inputs, cpu)
            del inputs, cpu, coco_pretrain_refs, coco_gan_refs
            coco_rows, coco_damsm_rows = phase_kernels_coco()
            dcgan_bench_launches = phase_gan_bench_dcgan(style_lines)
            coco_bench_launches = phase_gan_bench_coco(style_lines)
            refs = gen2_refs.result()
            gen2_step_launches = phase_gen2_step(refs)
            gen2_cli_launches = phase_gen2_cli(out)
            gen2_bench_launches = phase_gen2_bench(style_lines, refs["wgan"][1])
            del refs, gen2_refs
    finally:
        if dist_cli is not None:
            dist_cli.close()
        cpu_pool.shutdown(wait=True, cancel_futures=True)
    dist_paths = {  # each kernel's launches on the data-parallel and accumulation paths
        k: {"grad_accum_micro_steps": {m: [c[k] for c in v] for m, v in accum_launches.items()},
            "nccl_world_of_one_3_steps_float32": nccl1_launches["float32"][k],
            "nccl_world_of_one_1_step_bfloat16": nccl1_launches["bfloat16"][k],
            "gloo_2_ranks_per_rank": [{p: r[p][k] for p in r} for r in gloo2_launches],
            "bench_dist_per_step": {b: v[k] for b, v in bench_dist_launches.items()}}
        for k in GAN_KERNELS}
    dcgan_paths = {  # each kernel's launches on the GAN.B_DCGAN paths
        k: {"dcgan_gan_step": dcgan_step_launches[k],
            "dcgan_bench_step": {b: v[k] for b, v in dcgan_bench_launches.items()},
            "dcgan_cli_calls": [c[k] for c in dcgan_cli_launches],
            "dcgan_cub_train_2_steps": dcgan_cub_launches[k],
            "dcgan_serve_generation": dcgan_serve_launches.get(k, 0)}
        for k in GAN_KERNELS}
    chunks_paths = {  # K1-K3's launches on the JAX.DAMSM_CHUNKS and profiling paths
        k: {"pretrain_step_chunks": chunks_launches[k],
            "pretrain_chunks_memory_per_step": {b: v[k] for b, v in chunks_memory.items()},
            "profiling_3_steps": profiling_launches[k]}
        for k in DAMSM_KERNELS}
    coco_paths = {  # each kernel's launches on the COCO presets' paths
        k: {"pretrain_step_coco": coco_pretrain[k], "gan_step_coco": coco_step_launches[k],
            "coco_pretrain_cli_epoch": coco_cli["pretrain_cli_epoch"][k],
            "coco_gan_cli_calls": [c[k] for c in coco_cli["gan_cli_calls"]],
            "coco_sampling_batch_of_100": (coco_cli["sampling_word_attention"]
                                           if k == "word_attention" else 0),
            "coco_bench_per_step": {b: v[k] for b, v in coco_bench_launches.items()}}
        for k in GAN_KERNELS}
    gen2_paths = {  # each kernel's launches on the gen-2 paths: none is on them
        k: {"gen2_step": {run: v[k] for run, v in gen2_step_launches.items()},
            "gen2_cli_calls": [c[k] for c in gen2_cli_launches],
            "gen2_bench": gen2_bench_launches[k]}
        for k in GAN_KERNELS}
    bert_paths = {  # each kernel's launches on the BERT paths
        k: {"bird_bert_gan_step": bert_gan_launches[k],
            "bird_mixing_gan_step": mixing_launches[k],
            "bert_pretrain_step": bert_pretrain_launches[k],
            "bert_bench_step_float32": bert_bench_launches["float32"][k],
            "bert_bench_step_bfloat16": bert_bench_launches["bfloat16"][k],
            "bert_pretrain_cli_epoch": bert_cli_pretrain_launches[k],
            "bert_gan_cli_calls": [c[k] for c in bert_cli_gan_launches]}
        for k in GAN_KERNELS}

    # the kernels line: K4 at the largest serving shape of one request,
    # K1-K3 at the pretrain shape, with the GAN step's shapes beside; then
    # each in bfloat16, its launches those of the bfloat16 paths (the GAN
    # step; K3 the pretrain step's; K4 the generation's beside)
    gan_keys = ("shape", "instance", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "eager_ms", "max_abs_err")
    main_row = next(r for r in rows if r["shape"] == "B1 QL16384 T25 D32")
    kernels = [{
        "name": "word_attention",
        "route": "cuda",
        "source": "sba_gan_tpu_torch/ops/csrc/word_attention.cu",
        "replaces": "sba_gan_tpu/ops/word_attention.py:65",
        "dtype": "float32",
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
        "gan_step": [{k: r[k] for k in gan_keys} for r in gan_rows],
        "eval_launches": eval_launches,
        "gen_example_launches": gen_launches,
        "reproduce_launches": reproduce_launches,
        "bert_paths": bert_paths["word_attention"],
        "dist_paths": dist_paths["word_attention"],
        "dcgan_paths": dcgan_paths["word_attention"],
        "coco_paths": coco_paths["word_attention"],
        "coco": {label: {k: r[k] for k in gan_keys + ("padding_row_err",)}
                 for label, r in coco_rows.items()},
    }]
    for kname, (source, replaces) in DAMSM_KERNELS.items():
        row, gan = damsm_rows["pretrain"][kname], damsm_rows["gan_step"][kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "dtype": "float32",
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
            "bert_paths": bert_paths[kname],
            "dist_paths": dist_paths[kname],
            "dcgan_paths": dcgan_paths[kname],
            "chunks_paths": chunks_paths[kname],
            "coco_paths": coco_paths[kname],
            "coco_pretrain": {k: coco_damsm_rows[kname][k] for k in (
                "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "eager_ms",
                "bound_tc_ms", "max_abs_err")},
        })
    row16, gan_rows16 = rows16
    kernels.append({
        "name": "word_attention_bf16", "route": "cuda",
        "source": "sba_gan_tpu_torch/ops/csrc/word_attention.cu",
        "replaces": "sba_gan_tpu/ops/word_attention.py:65", "dtype": "bfloat16",
        "launches": gan_launches16["word_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in [row16] + gan_rows16),
        "ms": row16["kernel_ms"], "plain_ms": row16["plain_ms"],
        "bound_ms": row16["bound_ms"], "bound_by": row16["bound_by"],
        "library_ms": row16["library_ms"], "shape": row16["shape"],
        "eager_ms": row16["eager_ms"], "generation_launches": launches16["word_attention"],
        "gan_step": [{k: r[k] for k in gan_keys} for r in gan_rows16],
        "dcgan_paths": {"dcgan_bench_step_bfloat16_b30":
                        dcgan_bench_launches["bfloat16_b30"]["word_attention"]},
    })
    for kname, (source, replaces) in DAMSM_KERNELS.items():
        row, gan = damsm_rows16["pretrain"][kname], damsm_rows16["gan_step"][kname]
        n = pretrain16[kname] if kname == "damsm_sim_dwords" else gan_launches16[kname]
        kernels.append({
            "name": f"{kname}_bf16", "route": "cuda", "source": source,
            "replaces": replaces, "dtype": "bfloat16", "launches": n,
            "launches_counted_in": ("bfloat16 pretrain step" if kname == "damsm_sim_dwords"
                                    else "bfloat16 GAN step"),
            "max_abs_err": max(r[kname]["max_abs_err"] for r in damsm_rows16.values()),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": row["shape"], "eager_ms": row["eager_ms"],
            "pretrain_step_launches": pretrain16[kname],
            "gan_step_launches": gan_launches16[kname],
            "gan_step": {k: gan[k] for k in ("shape", "kernel_ms", "plain_ms", "bound_ms",
                                             "bound_by", "eager_ms", "max_abs_err")},
            "dcgan_paths": {"dcgan_bench_step_bfloat16_b30":
                            dcgan_bench_launches["bfloat16_b30"][kname]},
        })
    for entry in kernels:
        entry["gen2_paths"] = gen2_paths[entry["name"].removesuffix("_bf16")]
    print(smi, flush=True)  # again, near the end, beside the numbers above
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
