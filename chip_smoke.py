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
4. slice: the full-width ``eval_bird`` generator (vocabulary 5450, random
   weights from a seed, random BatchNorm statistics) on the card against
   the same models on the CPU, same captions and noise, TF32 off;
5. serve: the WSGI app on the card answers ``GET /``, a few
   ``POST /api/v1.0/bird`` and one ``POST /api/v1.0/birds``; the kernel
   launch counts are set to 0 just before and read just after, and every
   generation must launch the word-attention kernel exactly twice;
6. the ``kernels`` JSON line, then the device JSON line last.

Any failure raises, and the script exits non-zero.  Without CUDA it exits
non-zero and prints no result.
"""

from __future__ import annotations

import copy
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
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
    for _ in range(5):
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

    def library():
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from sba_gan_tpu_torch.config import preset
    from sba_gan_tpu_torch.data.vocab import synthetic_vocab

    name, _ = phase_device()
    phase_build()
    rows = phase_kernels()
    cfg = preset("eval_bird")
    wordtoix, ixtoword = synthetic_vocab(N_WORDS)
    sampler = phase_slice(cfg, wordtoix)
    launches = phase_serve(cfg, sampler, wordtoix, ixtoword)

    # the kernels line: times at the largest serving shape of one request
    main_row = next(r for r in rows if r["shape"] == "B1 QL16384 T25 D32")
    print(json.dumps({"kernels": [{
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
