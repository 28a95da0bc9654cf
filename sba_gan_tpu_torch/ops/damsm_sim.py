"""DAMSM word-region similarity: the sim matrix of the words loss and its
two gradients.

For text i (words W_i, (T, D), the first ``cap_lens[i]`` real) and image j
(regions X_j, (R, D)):

    S   = W_i X_j^T                       (T x R) word/region scores
    A1  = softmax over real words of S    (Eq. 8)
    A2  = softmax over regions of g1 A1   (Eq. 9)
    C   = A2 X_j                          (T x D) region context per word
    sim[i, j] = logsumexp over real words of g2 cos(W_i[t], C[t])   (Eq. 10)

Three hand-written kernels, the port of the JAX package's Pallas
``_fwd_kernel``, ``_dimg_kernel`` and ``_dwords_kernel``, all on one
tensor-core product core (``csrc/damsm_common.cuh``):

* :func:`damsm_sim_fwd`    K1, sim (B, Bj)                    ``csrc/damsm_sim.cu``;
* :func:`damsm_sim_dimg`   K2, d_img (Bj, R, D) for a cotangent g (B, Bj), same file;
* :func:`damsm_sim_dwords` K3, d_words (B, T, D),             ``csrc/damsm_dwords.cu``.

Each wrapper sends CUDA tensors to its kernel (counting the launch in its
``launches``) or raises, and CPU tensors to its plain version
(:func:`damsm_sim_plain`, :func:`damsm_sim_dimg_plain`,
:func:`damsm_sim_dwords_plain`: the same math on the dense (B, Bj, T, R)
grid, float32 or float64).  :func:`damsm_sim` is the differentiable entry:
its backward runs K2 only when the image needs a gradient and K3 only when
the words do.

``mm_dtype`` (the JAX package's ``mm_dtype``, set by ``JAX.LOSS_DTYPE``) is
float32 or bfloat16.  The inputs stay float32 in memory either way; under
bfloat16 each operand of the six matrix products is rounded to bfloat16
(round to nearest even) and each product accumulates in float32:

* forward (``_pair_forward``): S from (W, X), C from (A2, X);
* backward (``_pair_backward``): dA2 from (dC, X), dX from (A2, dC),
  dW += (dS, X) and dX += (dS, W).

Everything else stays float32 and reads unrounded values: the softmaxes,
the cosine's numerator and norms, the log-sum-exp and its backward.  The
intermediates A2, dC and dS are computed in float32 and rounded only as
product operands.  The kernels have one instantiation per ``mm_dtype``;
each wrapper counts all its launches in ``launches`` and those of the
bfloat16 instantiation in ``bf16_launches`` too.  The kernels take any B (no tile has to divide it); a block
holds one or two texts (the C side decides, by shared memory), and the
grids (:func:`dwords_grid` for K1 and K3, :func:`dimg_grid`) put one
wave of blocks on the card's SMs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e9
EPS = 1e-8
MAX_T = 32  # what the kernels hold (kMaxT, kMaxD in csrc/damsm_common.cuh)
MAX_D = 256
_CUDA_ERROR_INVALID_VALUE = 1  # what the C entry points return for a shape


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------
def _valid(cap_lens: torch.Tensor, t: int, device) -> torch.Tensor:
    """(B, T) bool, True at real words."""
    lens = cap_lens.to(device=device, dtype=torch.long)
    return torch.arange(t, device=device)[None, :] < lens[:, None]


def _operand(x: torch.Tensor, mm_dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a product operand of ``mm_dtype``: rounded to bfloat16 and
    back, or as it is."""
    if mm_dtype == torch.bfloat16:
        return x.to(torch.bfloat16).to(x.dtype)
    if mm_dtype != torch.float32:
        raise ValueError(f"mm_dtype must be float32 or bfloat16, got {mm_dtype}")
    return x


def _grid_forward(words, img, valid, gamma1, gamma2, mm_dtype=torch.float32):
    """The pair forward of every (text i, image j) at once (JAX
    ``_pair_forward``).  Returns rs (B, Bj, T) and the intermediates."""
    img_mm = _operand(img, mm_dtype)
    s = torch.einsum("itd,jrd->ijtr", _operand(words, mm_dtype), img_mm)
    s = s.masked_fill(~valid[:, None, :, None], NEG_INF)
    a1 = torch.softmax(s, dim=2)
    a2 = torch.softmax(gamma1 * a1, dim=3)
    c = torch.einsum("ijtr,jrd->ijtd", _operand(a2, mm_dtype), img_mm)
    num = (words[:, None] * c).sum(-1)
    wn = torch.linalg.vector_norm(words, dim=-1)[:, None].expand_as(num)
    cn = torch.linalg.vector_norm(c, dim=-1)
    rs = torch.where(valid[:, None], gamma2 * num / torch.clamp(wn * cn, min=EPS),
                     torch.full_like(num, NEG_INF))
    return rs, a1, a2, c, num, wn, cn


def damsm_sim_plain(words, img, cap_lens, gamma1: float = 4.0,
                    gamma2: float = 5.0, mm_dtype=torch.float32) -> torch.Tensor:
    """sim (B, Bj) of words (B, T, D) against img (Bj, R, D)."""
    valid = _valid(cap_lens, words.shape[1], words.device)
    rs = _grid_forward(words, img, valid, gamma1, gamma2, mm_dtype)[0]
    return torch.logsumexp(rs, dim=2)


def _grid_backward(words, img, cap_lens, g, gamma1, gamma2, mm_dtype=torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_words, d_img) for the cotangent g (B, Bj) (JAX ``_pair_backward``,
    summed over images and over texts)."""
    valid = _valid(cap_lens, words.shape[1], words.device)
    rs, a1, a2, c, num, wn, cn = _grid_forward(words, img, valid, gamma1, gamma2,
                                               mm_dtype)
    p = torch.softmax(rs, dim=2) * valid[:, None]  # logsumexp backward
    d_rs = g[:, :, None] * p
    denom_raw = wn * cn
    denom = torch.clamp(denom_raw, min=EPS)
    d_num = d_rs * gamma2 / denom
    d_denom = torch.where(denom_raw > EPS, -d_rs * gamma2 * num / (denom * denom),
                          torch.zeros_like(num))
    d_cn = d_denom * wn
    d_wn = d_denom * cn
    w = words[:, None]
    d_c = d_num[..., None] * w + (d_cn / torch.clamp(cn, min=EPS))[..., None] * c
    d_w = d_num[..., None] * c + (d_wn / torch.clamp(wn, min=EPS))[..., None] * w
    img_mm, d_c_mm = _operand(img, mm_dtype), _operand(d_c, mm_dtype)
    d_a2 = torch.einsum("ijtd,jrd->ijtr", d_c_mm, img_mm)
    d_x = torch.einsum("ijtr,ijtd->jrd", _operand(a2, mm_dtype), d_c_mm)
    inner2 = (d_a2 * a2).sum(3, keepdim=True)
    d_a1 = gamma1 * a2 * (d_a2 - inner2)
    inner1 = (d_a1 * a1).sum(2, keepdim=True)
    d_s = a1 * (d_a1 - inner1)
    d_s_mm = _operand(d_s, mm_dtype)
    d_words = d_w.sum(1) + torch.einsum("ijtr,jrd->itd", d_s_mm, img_mm)
    d_x = d_x + torch.einsum("ijtr,itd->jrd", d_s_mm, _operand(words, mm_dtype))
    return d_words * valid[..., None], d_x


def damsm_sim_dimg_plain(words, img, cap_lens, g, gamma1: float = 4.0,
                         gamma2: float = 5.0, mm_dtype=torch.float32) -> torch.Tensor:
    """d_img (Bj, R, D) = sum_i g[i, j] d sim[i, j] / d img[j]."""
    return _grid_backward(words, img, cap_lens, g, gamma1, gamma2, mm_dtype)[1]


def damsm_sim_dwords_plain(words, img, cap_lens, g, gamma1: float = 4.0,
                           gamma2: float = 5.0, mm_dtype=torch.float32) -> torch.Tensor:
    """d_words (B, T, D) = sum_j g[i, j] d sim[i, j] / d words[i]; zero at
    padding."""
    return _grid_backward(words, img, cap_lens, g, gamma1, gamma2, mm_dtype)[0]


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------
def _library() -> ctypes.CDLL:
    from sba_gan_tpu_torch.ops import _build

    lib = _build.load("damsm_sim")
    if lib.damsm_sim_fwd.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.damsm_sim_fwd.argtypes = [ptr] * 4 + [i32] * 7 + [f32] * 2 + [i32, ptr]
        lib.damsm_sim_fwd.restype = i32
        lib.damsm_sim_dimg.argtypes = [ptr] * 6 + [i32] * 7 + [f32] * 2 + [i32, ptr]
        lib.damsm_sim_dimg.restype = i32
        lib.damsm_sim_texts.argtypes = [i32] * 4
        lib.damsm_sim_texts.restype = i32
    return lib


def _dwords_library() -> ctypes.CDLL:
    from sba_gan_tpu_torch.ops import _build

    lib = _build.load("damsm_dwords")
    if lib.damsm_sim_dwords.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.damsm_sim_dwords.argtypes = [ptr] * 6 + [i32] * 7 + [f32] * 2 + [i32, ptr]
        lib.damsm_sim_dwords.restype = i32
        lib.damsm_dwords_texts.argtypes = [i32] * 4
        lib.damsm_dwords_texts.restype = i32
    return lib


def _check_lens(cap_lens: torch.Tensor, b: int, t: int) -> None:
    lens = cap_lens.detach().to("cpu")
    if lens.shape != (b,):
        raise ValueError(f"cap_lens must be ({b},), got {tuple(lens.shape)}")
    if b and not (int(lens.min()) >= 1 and int(lens.max()) <= t):
        raise ValueError(f"every cap_len must lie in [1, {t}]; got "
                         f"{lens.tolist()}")


def _check(words, img, g=None) -> None:
    if words.dim() != 3 or img.dim() != 3 or words.shape[2] != img.shape[2]:
        raise ValueError(f"damsm_sim wants words (B, T, D) and img (Bj, R, D); "
                         f"got {tuple(words.shape)} and {tuple(img.shape)}")
    b, t, d = words.shape
    bj, r, _ = img.shape
    if g is not None and g.shape != (b, bj):
        raise ValueError(f"the cotangent must be ({b}, {bj}), got {tuple(g.shape)}")
    tensors = [("words", words), ("img", img)] + ([("g", g)] if g is not None else [])
    for name, x in tensors:
        if x.device != words.device or x.device.type != "cuda":
            raise ValueError(f"{name} must lie on words' CUDA device")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype} (mm_dtype picks "
                            "the products' precision; the inputs stay float32)")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not (1 <= t <= MAX_T and 4 <= d <= MAX_D and d % 4 == 0 and b >= 1
            and bj >= 1 and r >= 1):
        raise ValueError(f"the kernels take 1 <= T <= {MAX_T}, D a multiple of 4 "
                         f"in [4, {MAX_D}] and non-empty B, Bj, R; got B={b} "
                         f"Bj={bj} T={t} R={r} D={d}")


def _bf16(mm_dtype) -> int:
    """The C entry points' precision flag: 1 for bfloat16 operands, 0 for
    float32."""
    if mm_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mm_dtype must be float32 or bfloat16, got {mm_dtype}")
    return int(mm_dtype == torch.bfloat16)


def _count(wrapper, bf16: int) -> None:
    wrapper.launches += 1
    wrapper.bf16_launches += bf16


def _lens_on(words, cap_lens) -> torch.Tensor:
    return cap_lens.to(device=words.device, dtype=torch.int32).contiguous()


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise RuntimeError(f"{name}: CUDA error 1, invalid value: the kernel does "
                           "not take this shape (shape_ok in "
                           "csrc/damsm_common.cuh: a block's shared memory)")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _one_wave(majors: int, items: int, sms: int) -> Tuple[int, int]:
    """(items per block, ranges of items): ``majors`` blocks a range, one
    block per SM (a block holds most of an SM's shared memory), as many
    ranges as fill one wave of the card's ``sms`` SMs."""
    splits = max(1, min(items, sms // majors))
    chunk = math.ceil(items / splits)
    return chunk, math.ceil(items / chunk)


def dwords_grid(b: int, bj: int, texts: int, sms: int) -> Tuple[int, int]:
    """K3's and K1's (images per block, ranges of images): a block per
    group of ``texts`` texts and range of images."""
    return _one_wave(math.ceil(b / texts), bj, sms)


def dimg_grid(b: int, bj: int, texts: int, sms: int) -> Tuple[int, int]:
    """K2's (groups of ``texts`` texts per block, ranges of groups): a block
    per image and range of groups."""
    return _one_wave(bj, math.ceil(b / texts), sms)


def _texts(count, name: str, b: int, t: int, r: int, d: int) -> int:
    """Texts a block holds (``count``: the C side's choice); raises when
    no block fits in shared memory."""
    texts = count(b, t, r, d)
    if texts == 0:
        _raise_on(_CUDA_ERROR_INVALID_VALUE, name)
    return texts


def _scratch(out, splits: int) -> torch.Tensor:
    """The ranges' partial sums, or ``out`` itself when there is one range."""
    return out if splits == 1 else torch.empty(
        (splits, *out.shape), dtype=torch.float32, device=out.device)


def launch_fwd(words, img, lens, gamma1, gamma2, mm_dtype=torch.float32) -> torch.Tensor:
    """K1 on CUDA tensors; ``lens`` (B,) int32 on the device, already
    checked.  One block per group of texts and range of images."""
    _check(words, img)
    bf16 = _bf16(mm_dtype)
    b, t, d = words.shape
    bj, r, _ = img.shape
    lib = _library()
    texts = _texts(lib.damsm_sim_texts, "damsm_sim_fwd", b, t, r, d)
    chunk, _ = dwords_grid(b, bj, texts, _sm_count(words.device.index))
    sim = torch.empty((b, bj), dtype=torch.float32, device=words.device)
    with torch.cuda.device(words.device):
        err = lib.damsm_sim_fwd(
            words.data_ptr(), img.data_ptr(), lens.data_ptr(), sim.data_ptr(),
            b, bj, t, r, d, texts, chunk, float(gamma1), float(gamma2), bf16,
            _stream(words))
    _raise_on(err, "damsm_sim_fwd")
    _count(damsm_sim_fwd, bf16)
    return sim


def launch_dimg(words, img, lens, g, gamma1, gamma2, mm_dtype=torch.float32
                ) -> torch.Tensor:
    """K2 on CUDA tensors, as :func:`launch_fwd`: one block per image and
    range of text groups."""
    _check(words, img, g)
    bf16 = _bf16(mm_dtype)
    b, t, d = words.shape
    bj, r, _ = img.shape
    lib = _library()
    texts = _texts(lib.damsm_sim_texts, "damsm_sim_dimg", b, t, r, d)
    chunk, splits = dimg_grid(b, bj, texts, _sm_count(words.device.index))
    out = torch.empty_like(img)
    part = _scratch(out, splits)
    with torch.cuda.device(words.device):
        err = lib.damsm_sim_dimg(
            words.data_ptr(), img.data_ptr(), lens.data_ptr(), g.data_ptr(),
            part.data_ptr(), out.data_ptr(), b, bj, t, r, d, texts, chunk,
            float(gamma1), float(gamma2), bf16, _stream(words))
    _raise_on(err, "damsm_sim_dimg")
    _count(damsm_sim_dimg, bf16)
    return out


def launch_dwords(words, img, lens, g, gamma1, gamma2, mm_dtype=torch.float32
                  ) -> torch.Tensor:
    """K3 on CUDA tensors, as :func:`launch_fwd`: one block per group of
    texts and range of images."""
    _check(words, img, g)
    bf16 = _bf16(mm_dtype)
    b, t, d = words.shape
    bj, r, _ = img.shape
    lib = _dwords_library()
    texts = _texts(lib.damsm_dwords_texts, "damsm_sim_dwords", b, t, r, d)
    out = torch.empty_like(words)
    chunk, splits = dwords_grid(b, bj, texts, _sm_count(words.device.index))
    part = _scratch(out, splits)
    with torch.cuda.device(words.device):
        err = lib.damsm_sim_dwords(
            words.data_ptr(), img.data_ptr(), lens.data_ptr(), g.data_ptr(),
            part.data_ptr(), out.data_ptr(), b, bj, t, r, d, texts, chunk,
            float(gamma1), float(gamma2), bf16, _stream(words))
    _raise_on(err, "damsm_sim_dwords")
    _count(damsm_sim_dwords, bf16)
    return out


# --------------------------------------------------------------------------
# wrappers: CPU tensors -> plain version, CUDA tensors -> kernel
# --------------------------------------------------------------------------
def _route(words) -> bool:
    """True for the kernel, False for the plain version."""
    if words.device.type == "cpu":
        return False
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    return True


def damsm_sim_fwd(words, img, cap_lens, gamma1: float = 4.0,
                  gamma2: float = 5.0, mm_dtype=torch.float32) -> torch.Tensor:
    """K1: sim (B, Bj).  words (B, T, D), img (Bj, R, D), cap_lens (B,) ints
    in [1, T] on any device."""
    _check_lens(cap_lens, words.shape[0], words.shape[1])
    if not _route(words):
        return damsm_sim_plain(words, img, cap_lens, gamma1, gamma2, mm_dtype)
    return launch_fwd(words, img, _lens_on(words, cap_lens), gamma1, gamma2, mm_dtype)


def damsm_sim_dimg(words, img, cap_lens, g, gamma1: float = 4.0,
                   gamma2: float = 5.0, mm_dtype=torch.float32) -> torch.Tensor:
    """K2: d_img (Bj, R, D) for the cotangent g (B, Bj) of sim."""
    _check_lens(cap_lens, words.shape[0], words.shape[1])
    if not _route(words):
        return damsm_sim_dimg_plain(words, img, cap_lens, g, gamma1, gamma2, mm_dtype)
    return launch_dimg(words, img, _lens_on(words, cap_lens), g, gamma1, gamma2,
                       mm_dtype)


def damsm_sim_dwords(words, img, cap_lens, g, gamma1: float = 4.0,
                     gamma2: float = 5.0, mm_dtype=torch.float32) -> torch.Tensor:
    """K3: d_words (B, T, D) for the cotangent g (B, Bj) of sim."""
    _check_lens(cap_lens, words.shape[0], words.shape[1])
    if not _route(words):
        return damsm_sim_dwords_plain(words, img, cap_lens, g, gamma1, gamma2, mm_dtype)
    return launch_dwords(words, img, _lens_on(words, cap_lens), g, gamma1, gamma2,
                         mm_dtype)


for _wrapper in (damsm_sim_fwd, damsm_sim_dimg, damsm_sim_dwords):
    _wrapper.launches = 0
    _wrapper.bf16_launches = 0


class DAMSMSim(torch.autograd.Function):
    """sim = K1(words, img); backward K2 for img, K3 for words, each only
    when that input needs a gradient."""

    @staticmethod
    def forward(ctx, words, img, cap_lens, gamma1, gamma2, mm_dtype):
        ctx.save_for_backward(words, img)
        ctx.cap_lens, ctx.args = cap_lens, (gamma1, gamma2, mm_dtype)
        return damsm_sim_fwd(words, img, cap_lens, gamma1, gamma2, mm_dtype)

    @staticmethod
    def backward(ctx, grad):
        words, img = ctx.saved_tensors
        g = grad.contiguous()
        d_words: Optional[torch.Tensor] = None
        d_img: Optional[torch.Tensor] = None
        if ctx.needs_input_grad[0]:
            d_words = damsm_sim_dwords(words, img, ctx.cap_lens, g, *ctx.args)
        if ctx.needs_input_grad[1]:
            d_img = damsm_sim_dimg(words, img, ctx.cap_lens, g, *ctx.args)
        return d_words, d_img, None, None, None, None


def damsm_sim(words: torch.Tensor, img: torch.Tensor, cap_lens: torch.Tensor,
              gamma1: float = 4.0, gamma2: float = 5.0,
              mm_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Differentiable sim (B, Bj): sim[i, j] is text i against image j.

    words (B, T, D) and img (Bj, R, D) on one device; cap_lens (B,) with every
    length in [1, T], on any device; ``mm_dtype`` the products' operand dtype
    (float32 or bfloat16)."""
    return DAMSMSim.apply(words.contiguous(), img.contiguous(), cap_lens,
                          float(gamma1), float(gamma2), mm_dtype)
