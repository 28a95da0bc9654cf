"""Time design variants of the port's redesigned kernels in one process.

    python3 scripts/torch_kernel_variants.py [--out build/variants.json]
        [--only k4|damsm] [--k4_base OLD_word_attention.cu]

Needs a CUDA card and ``nvcc``.  A variant is a copy of a kernel's source
and of the headers of ``csrc/`` with some of their constants or lines
changed (``K4_VARIANTS``, ``SIM_VARIANTS``, ``K3_VARIANTS``); the port
itself builds only the sources as they are.  Every variant is built at
once into its own directory under ``build/variants/`` (one ``nvcc`` each).
Then, for each, ``_build.load`` is patched so that the public wrapper runs
the variant's library; it is checked against the plain PyTorch version and
timed as ``chip_smoke.py`` does (device ms of calls captured in a CUDA
graph):

* K4, word attention (``csrc/word_attention.cu``): query rows per block
  (``kRows``) and warps per block (``kWarps``); for the D 48 instance the
  query rows per block on a tall grid (``kTallTile``), the blocks an SM
  must fit (``kWideBlocks``) and 32 word slots at every T (no two rows a
  warp side by side at T <= 16); and, with ``--k4_base``, an
  earlier source of the kernel as it is (for example the parent commit's,
  ``git show <commit>:sba_gan_tpu_torch/ops/csrc/word_attention.cu``),
  timed in turns with the current one (base, current, ..., current,
  base).  At ``chip_smoke.py``'s shapes: D 32 at the serving shapes (T 25)
  and the GAN step's (B 128, T 18, float32 and bfloat16), D 48 at the
  COCO ones (B 14 and 128 at T 12, float32 and bfloat16; B 100 QL 64^2
  and B 1 QL 128^2 at T 20), beside the plain version and the library
  yardstick (three calls: ``baddbmm``, ``softmax``, ``bmm``);
* K1 and K2, the DAMSM similarity and its image gradient
  (``csrc/damsm_sim.cu``): texts per block (``kMaxTexts`` 1 or 2) and the
  products in 3xTF32 or in plain TF32 (one MMA a product); for K2 also
  the number of ranges of texts (``dimg_grid`` patched: 1, 2, 4, 8) and,
  to time the reload of dX from global memory, a copy that skips it
  (its result is wrong; the rows say by how much);
* K3, the DAMSM word gradient (``csrc/damsm_dwords.cu``): texts per block,
  warps per block (``kWarps`` 8 or 16) and plain TF32;

K1-K3 at B 32 T 20 and B 128 T 18 (R 289, D 256), beside their plain
versions, with the error against them relative to their largest entry.

Prints one JSON line per measurement and the card's name and power limit,
and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sba_gan_tpu_torch.ops import _build  # noqa: E402

VARIANT_DIR = os.path.join(ROOT, "build", "variants")


def _const(name: str, value: int):
    """Set ``constexpr int name`` of the source to ``value``."""
    return (rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};")


# plain TF32: v rounded to TF32 as the big part, no small part, and the two
# MMAs of each product that read a small part left out
PLAIN_TF32 = [
    (r"hi\[e\] = __float_as_uint\(v\[e\]\) & 0xffffe000u;\s*"
     r"lo\[e\] = __float_as_uint\(v\[e\] - __uint_as_float\(hi\[e\]\)\);",
     'asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi[e]) : "f"(v[e])); lo[e] = 0u;'),
    (r"mma_tf32\([^;]*\.lo[^;]*\)", "(void)0"),
]
K4_CURRENT = "rows32 warps4"  # the source as it is
K4_VARIANTS = {f"rows{rows} warps{warps}": [_const("kRows", rows), _const("kWarps", warps)]
               for rows, warps in ((16, 4), (32, 4), (64, 4))}
K4_VARIANTS.update({
    "wide tall32": [_const("kTallTile", 32)],
    "wide tall64": [_const("kTallTile", 64)],
    "wide blocks5": [_const("kWideBlocks", 5)],  # 96 registers: spills
    "wide slots32": [(r"return t_len <= 16", "return false")],
})
K4_BASE = "base"  # --k4_base: an earlier source, built as it is
SIM_VARIANTS = {
    "texts2": [],
    "texts1": [_const("kMaxTexts", 1)],
    "texts2 plain-tf32": PLAIN_TF32,
}
# K2 only: every group writes dX instead of adding to it, so the result is
# wrong (its rel_err shows it); its time against "texts2" is what the
# reload of dX from the block's slice of part costs
K2_VARIANTS = {
    "texts2 no-dx-reload": [(r"if \(!first && row < r && col < d\)",
                             "if (false && row < r && col < d)")],
}
K3_VARIANTS = {
    "texts2 warps16": [],
    "texts1 warps16": [_const("kMaxTexts", 1)],
    "texts2 warps8": [_const("kWarps", 8)],
    "texts1 warps8": [_const("kMaxTexts", 1), _const("kWarps", 8)],
    "texts2 warps16 plain-tf32": PLAIN_TF32,
}
K2_SPLITS = (1, 2, 4, 8)
F32, BF16 = torch.float32, torch.bfloat16


def k4_shapes(chip_smoke):
    """(B, QL, T, D, lengths, dtype) of ``chip_smoke.py``'s K4 rows."""
    lens = chip_smoke._caption_lens
    return ([(b, ql, 25, 32, ln, F32) for b, ln in ((1, [11]), (6, [25, 18, 9, 3, 1, 0]))
             for ql in (64 * 64, 128 * 128, 4133)]
            + [(128, ql, 18, 32, lens(128, 18, 5, shortest=4), dt) for dt in (F32, BF16)
               for ql in (64 * 64, 128 * 128)]
            + [(b, ql, 12, 48, lens(b, 12, b), dt) for b in (14, 128) for dt in (F32, BF16)
               for ql in (64 * 64, 128 * 128)]
            + [(100, 64 * 64, 20, 48, lens(100, 20, 0), F32),
               (1, 128 * 128, 20, 48, [13], F32)])


DAMSM_SHAPES = [(32, 20), (128, 18)]


def _sources(name: str, patches):
    """{file name: text} of the kernel's source and the headers, patched;
    every pattern must match somewhere."""
    files = {_build.SOURCES[name]: (_build.CSRC / _build.SOURCES[name]).read_text()}
    files.update({h.name: h.read_text() for h in sorted(_build.CSRC.glob("*.cuh"))})
    for pattern, repl in patches:
        hits = 0
        for fname, text in files.items():
            files[fname], n = re.subn(pattern, lambda _m, r=repl: r, text)
            hits += n
        if hits == 0:
            raise RuntimeError(f"{name}: no line matches {pattern!r}")
    return files


def _build_variant(name: str, tag: str, patches, source=None):
    """Compile the variant in a directory of its own (the source includes
    its patched headers from there); ``source``: the kernel's text to take
    instead of the current one's.  Returns (library path, nvcc log)."""
    vdir = os.path.join(VARIANT_DIR, f"{name}-{tag.replace(' ', '_')}")
    os.makedirs(vdir, exist_ok=True)
    files = _sources(name, patches)
    if source is not None:
        files[_build.SOURCES[name]] = source
    for fname, text in files.items():
        with open(os.path.join(vdir, fname), "w") as f:
            f.write(text)
    lib = os.path.join(vdir, f"lib{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
           os.path.join(vdir, _build.SOURCES[name])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name} {tag}: nvcc exit {proc.returncode}\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def _routed(name: str, lib):
    """Route ``_build.load(name)`` (and so the wrapper) to ``lib``."""
    load = _build.load
    return mock.patch.object(_build, "load", lambda n: lib if n == name else load(n))


def k4_rows(chip_smoke, libs):
    """Every K4 variant at every shape; with a base, base and current twice,
    in turns around the other variants."""
    from sba_gan_tpu_torch.ops import word_attention as wa

    tags = [tag for name, tag in libs if name == "word_attention"]
    order = [t for t in tags if t not in (K4_BASE, K4_CURRENT)]
    order = ([K4_BASE, K4_CURRENT] + order + [K4_CURRENT, K4_BASE] if K4_BASE in tags
             else [K4_CURRENT] + order)
    rows = []

    def add(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for b, ql, t, d, lens, dtype in k4_shapes(chip_smoke):
        gen = torch.Generator().manual_seed(ql + b + d)
        q = torch.randn((b, ql, d), generator=gen).cuda().to(dtype)
        s = torch.randn((b, t, d), generator=gen).cuda().to(dtype)
        pad = (torch.arange(t)[None, :] >= torch.tensor(lens)[:, None]).cuda()
        bias = wa.pad_bias(pad, s)
        ctx_p, att_p = wa.word_attention_plain(q, s, bias)
        bias_in = bias.to(dtype)[:, None, :]

        def library():  # three calls: no single PyTorch call returns both ctx and P
            p = torch.softmax(torch.baddbmm(bias_in, q, s.transpose(1, 2)).float(), -1)
            return torch.bmm(p.to(dtype), s)

        reps = dict(calls=5, replays=4) if b * ql >= 128 * 4096 else {}
        base = {"kernel": "word_attention", "shape": f"B{b} QL{ql} T{t} D{d}",
                "dtype": str(dtype).replace("torch.", "")}
        add({**base, "variant": "plain", "ms": chip_smoke.device_ms(
            lambda: wa.word_attention_plain(q, s, bias), **reps)})
        add({**base, "variant": "library", "ms": chip_smoke.device_ms(library, **reps)})
        for turn, tag in enumerate(order):
            lib = libs["word_attention", tag]
            inst = (lib.word_attention_instance(d, 1)
                    if hasattr(lib, "word_attention_instance") else None)
            row = {**base, "variant": tag, "turn": turn, "instance": inst}
            with _routed("word_attention", lib):
                try:
                    ctx, att = wa.word_attention(q, s, pad)
                except RuntimeError as e:  # a variant the launch refuses (shared memory)
                    add({**row, "error": str(e)})
                    continue
                torch.cuda.synchronize()
                err = max((ctx - ctx_p).abs().max().item(),
                          (att - att_p).abs().max().item())
                add({**row, "max_abs_err": err, "ms": chip_smoke.device_ms(
                    lambda: wa.word_attention(q, s, pad), **reps)})
        del q, s, pad, bias, ctx_p, att_p, bias_in
        torch.cuda.empty_cache()
    return rows


DAMSM_VARIANTS = {  # wrapper -> (library, its variants)
    "damsm_sim_fwd": ("damsm_sim", SIM_VARIANTS),
    "damsm_sim_dimg": ("damsm_sim", {**SIM_VARIANTS, **K2_VARIANTS}),
    "damsm_sim_dwords": ("damsm_dwords", K3_VARIANTS),
}


def damsm_rows(chip_smoke, libs):
    from sba_gan_tpu_torch.ops import damsm_sim as ds

    rows = []
    r, d = 289, 256
    for b, t in DAMSM_SHAPES:
        gen = torch.Generator().manual_seed(100 + b)
        words = torch.randn((b, t, d), generator=gen).cuda()
        img = torch.randn((b, r, d), generator=gen).cuda()
        g = torch.randn((b, b), generator=gen).cuda()
        lens = torch.randint(1, t + 1, (b,), generator=gen)
        lens[0], lens[-1] = 1, t
        lens_dev = lens.to(torch.int32).cuda()
        reps = dict(calls=3, replays=3) if b >= 128 else dict(calls=5, replays=4)
        calls = {  # wrapper -> (public call, launch call, plain call)
            "damsm_sim_fwd": (lambda: ds.damsm_sim_fwd(words, img, lens),
                              lambda: ds.launch_fwd(words, img, lens_dev, 4.0, 5.0),
                              lambda: ds.damsm_sim_plain(words, img, lens_dev)),
            "damsm_sim_dimg": (lambda: ds.damsm_sim_dimg(words, img, lens, g),
                               lambda: ds.launch_dimg(words, img, lens_dev, g, 4.0, 5.0),
                               lambda: ds.damsm_sim_dimg_plain(words, img, lens_dev, g)),
            "damsm_sim_dwords": (lambda: ds.damsm_sim_dwords(words, img, lens, g),
                                 lambda: ds.launch_dwords(words, img, lens_dev, g, 4.0, 5.0),
                                 lambda: ds.damsm_sim_dwords_plain(words, img, lens_dev, g)),
        }
        for kernel, (public, launch, plain) in calls.items():
            lib_name, variants = DAMSM_VARIANTS[kernel]
            want = plain()
            scale = want.abs().max().item()
            base = {"kernel": kernel, "shape": f"B{b} T{t} R{r} D{d}"}
            rows.append({**base, "variant": "plain",
                         "ms": chip_smoke.device_ms(plain, **reps)})

            def measure(tag, lib):
                got = public()
                torch.cuda.synchronize()
                return {**base, "variant": tag,
                        "texts": lib.damsm_dwords_texts(b, t, r, d) if lib_name ==
                        "damsm_dwords" else lib.damsm_sim_texts(b, t, r, d),
                        "rel_err": (got - want).abs().max().item() / scale,
                        "ms": chip_smoke.device_ms(launch, **reps)}

            for tag in variants:
                lib = libs[lib_name, tag]
                with _routed(lib_name, lib):
                    rows.append(measure(tag, lib))
            if kernel != "damsm_sim_dimg":
                continue
            texts = _build.load("damsm_sim").damsm_sim_texts(b, t, r, d)
            groups = -(-b // texts)
            for splits in K2_SPLITS:
                grid = (-(-groups // splits), -(-groups // -(-groups // splits)))
                with mock.patch.object(ds, "dimg_grid", lambda *_a, _g=grid: _g):
                    rows.append({**measure(f"texts{texts} splits{grid[1]}",
                                           _build.load("damsm_sim")),
                                 "splits": grid[1]})
    return rows


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(ROOT, "build", "variants.json"))
    p.add_argument("--only", choices=("k4", "damsm"), default=None,
                   help="time only K4's variants or only K1-K3's")
    p.add_argument("--k4_base", default=None,
                   help="an earlier word_attention.cu to time beside the current one")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    os.makedirs(VARIANT_DIR, exist_ok=True)
    jobs = []
    if args.only != "damsm":
        jobs += [("word_attention", tag, v, None) for tag, v in K4_VARIANTS.items()]
        if args.k4_base:
            with open(args.k4_base) as f:
                jobs.append(("word_attention", K4_BASE, [], f.read()))
    if args.only != "k4":
        jobs += ([("damsm_sim", tag, v, None)
                  for tag, v in {**SIM_VARIANTS, **K2_VARIANTS}.items()]
                 + [("damsm_dwords", tag, v, None) for tag, v in K3_VARIANTS.items()])
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: _build_variant(*job), jobs))
    libs = {(name, tag): ctypes.CDLL(path) for (name, tag, *_), (path, _) in zip(jobs, built)}
    rows = [{"build": name, "variant": tag, "ptxas": chip_smoke.ptxas_by_function(log)}
            for (name, tag, *_), (_, log) in zip(jobs, built)]
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.only != "damsm":
        rows += k4_rows(chip_smoke, libs)
    if args.only != "k4":
        for row in damsm_rows(chip_smoke, libs):
            print(json.dumps(row), flush=True)
            rows.append(row)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
                   "rows": rows}, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
