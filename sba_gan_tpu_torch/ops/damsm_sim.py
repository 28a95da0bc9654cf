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
``_fwd_kernel``, ``_dimg_kernel`` and ``_dwords_kernel``:

* :func:`damsm_sim_fwd`    K1, sim (B, Bj)                    ``csrc/damsm_sim.cu``;
* :func:`damsm_sim_dimg`   K2, d_img (Bj, R, D) for a cotangent g (B, Bj), same file;
* :func:`damsm_sim_dwords` K3, d_words (B, T, D), on the tensor cores,
  ``csrc/damsm_dwords.cu``.

Each wrapper sends CUDA tensors to its kernel (counting the launch in its
``launches``) or raises, and CPU tensors to its plain version
(:func:`damsm_sim_plain`, :func:`damsm_sim_dimg_plain`,
:func:`damsm_sim_dwords_plain`: the same math on the dense (B, Bj, T, R)
grid, float32 or float64).  :func:`damsm_sim` is the differentiable entry:
its backward runs K2 only when the image needs a gradient and K3 only when
the words do.  The kernels take any B (no tile has to divide it).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e9
EPS = 1e-8
MAX_T = 32  # what the kernels hold (kMaxT, kMaxD in csrc/damsm_*.cu)
MAX_D = 256
_CUDA_ERROR_INVALID_VALUE = 1  # what the C entry points return for a shape


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------
def _valid(cap_lens: torch.Tensor, t: int, device) -> torch.Tensor:
    """(B, T) bool, True at real words."""
    lens = cap_lens.to(device=device, dtype=torch.long)
    return torch.arange(t, device=device)[None, :] < lens[:, None]


def _grid_forward(words, img, valid, gamma1, gamma2):
    """The pair forward of every (text i, image j) at once (JAX
    ``_pair_forward``).  Returns rs (B, Bj, T) and the intermediates."""
    s = torch.einsum("itd,jrd->ijtr", words, img)
    s = s.masked_fill(~valid[:, None, :, None], NEG_INF)
    a1 = torch.softmax(s, dim=2)
    a2 = torch.softmax(gamma1 * a1, dim=3)
    c = torch.einsum("ijtr,jrd->ijtd", a2, img)
    num = (words[:, None] * c).sum(-1)
    wn = torch.linalg.vector_norm(words, dim=-1)[:, None].expand_as(num)
    cn = torch.linalg.vector_norm(c, dim=-1)
    rs = torch.where(valid[:, None], gamma2 * num / torch.clamp(wn * cn, min=EPS),
                     torch.full_like(num, NEG_INF))
    return rs, a1, a2, c, num, wn, cn


def damsm_sim_plain(words, img, cap_lens, gamma1: float = 4.0,
                    gamma2: float = 5.0) -> torch.Tensor:
    """sim (B, Bj) of words (B, T, D) against img (Bj, R, D)."""
    valid = _valid(cap_lens, words.shape[1], words.device)
    rs = _grid_forward(words, img, valid, gamma1, gamma2)[0]
    return torch.logsumexp(rs, dim=2)


def _grid_backward(words, img, cap_lens, g, gamma1, gamma2
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_words, d_img) for the cotangent g (B, Bj) (JAX ``_pair_backward``,
    summed over images and over texts)."""
    valid = _valid(cap_lens, words.shape[1], words.device)
    rs, a1, a2, c, num, wn, cn = _grid_forward(words, img, valid, gamma1, gamma2)
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
    d_a2 = torch.einsum("ijtd,jrd->ijtr", d_c, img)
    d_x = torch.einsum("ijtr,ijtd->jrd", a2, d_c)
    inner2 = (d_a2 * a2).sum(3, keepdim=True)
    d_a1 = gamma1 * a2 * (d_a2 - inner2)
    inner1 = (d_a1 * a1).sum(2, keepdim=True)
    d_s = a1 * (d_a1 - inner1)
    d_words = d_w.sum(1) + torch.einsum("ijtr,jrd->itd", d_s, img)
    d_x = d_x + torch.einsum("ijtr,itd->jrd", d_s, words)
    return d_words * valid[..., None], d_x


def damsm_sim_dimg_plain(words, img, cap_lens, g, gamma1: float = 4.0,
                         gamma2: float = 5.0) -> torch.Tensor:
    """d_img (Bj, R, D) = sum_i g[i, j] d sim[i, j] / d img[j]."""
    return _grid_backward(words, img, cap_lens, g, gamma1, gamma2)[1]


def damsm_sim_dwords_plain(words, img, cap_lens, g, gamma1: float = 4.0,
                           gamma2: float = 5.0) -> torch.Tensor:
    """d_words (B, T, D) = sum_j g[i, j] d sim[i, j] / d words[i]; zero at
    padding."""
    return _grid_backward(words, img, cap_lens, g, gamma1, gamma2)[0]


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------
def _library() -> ctypes.CDLL:
    from sba_gan_tpu_torch.ops import _build

    lib = _build.load("damsm_sim")
    if lib.damsm_sim_fwd.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.damsm_sim_fwd.argtypes = [ptr] * 4 + [i32] * 5 + [f32] * 2 + [ptr]
        lib.damsm_sim_fwd.restype = i32
        lib.damsm_sim_dimg.argtypes = [ptr] * 6 + [i32] * 6 + [f32] * 2 + [ptr]
        lib.damsm_sim_dimg.restype = i32
    return lib


def _dwords_library() -> ctypes.CDLL:
    from sba_gan_tpu_torch.ops import _build

    lib = _build.load("damsm_dwords")
    if lib.damsm_sim_dwords.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.damsm_sim_dwords.argtypes = [ptr] * 6 + [i32] * 7 + [f32] * 2 + [ptr]
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
            raise TypeError(f"{name} must be float32, got {x.dtype}; the bfloat16 "
                            "LOSS_DTYPE path of the kernels is not ported yet "
                            "(ROADMAP.md, queue 2, K1-K3)")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not (1 <= t <= MAX_T and 4 <= d <= MAX_D and d % 4 == 0 and b >= 1
            and bj >= 1 and r >= 1):
        raise ValueError(f"the kernels take 1 <= T <= {MAX_T}, D a multiple of 4 "
                         f"in [4, {MAX_D}] and non-empty B, Bj, R; got B={b} "
                         f"Bj={bj} T={t} R={r} D={d}")


def _lens_on(words, cap_lens) -> torch.Tensor:
    return cap_lens.to(device=words.device, dtype=torch.int32).contiguous()


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise RuntimeError(f"{name}: CUDA error 1, invalid value: the kernel does "
                           "not take this shape (shape_ok in csrc/damsm_sim.cu or "
                           "csrc/damsm_dwords.cu: a block's shared memory)")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _chunk(majors: int, loop: int, sms: int) -> int:
    """K2: loop items per block so that majors * splits puts two blocks on
    each of the card's ``sms`` SMs."""
    splits = max(1, min(loop, math.ceil(2 * sms / majors)))
    return math.ceil(loop / splits)


def launch_fwd(words, img, lens, gamma1, gamma2) -> torch.Tensor:
    """K1 on CUDA tensors; ``lens`` (B,) int32 on the device, already checked."""
    _check(words, img)
    b, t, d = words.shape
    bj, r, _ = img.shape
    sim = torch.empty((b, bj), dtype=torch.float32, device=words.device)
    with torch.cuda.device(words.device):
        err = _library().damsm_sim_fwd(
            words.data_ptr(), img.data_ptr(), lens.data_ptr(), sim.data_ptr(),
            b, bj, t, r, d, float(gamma1), float(gamma2), _stream(words))
    _raise_on(err, "damsm_sim_fwd")
    damsm_sim_fwd.launches += 1
    return sim


def _scratch(out, splits: int) -> torch.Tensor:
    """The ranges' partial sums, or ``out`` itself when there is one range."""
    return out if splits == 1 else torch.empty(
        (splits, *out.shape), dtype=torch.float32, device=out.device)


def launch_dimg(words, img, lens, g, gamma1, gamma2) -> torch.Tensor:
    """K2 on CUDA tensors, as :func:`launch_fwd`: one block per image and
    range of texts."""
    _check(words, img, g)
    b, t, d = words.shape
    bj, r, _ = img.shape
    out = torch.empty_like(img)
    chunk = _chunk(bj, b, _sm_count(words.device.index))
    part = _scratch(out, math.ceil(b / chunk))
    with torch.cuda.device(words.device):
        err = _library().damsm_sim_dimg(
            words.data_ptr(), img.data_ptr(), lens.data_ptr(), g.data_ptr(),
            part.data_ptr(), out.data_ptr(), b, bj, t, r, d, chunk,
            float(gamma1), float(gamma2), _stream(words))
    _raise_on(err, "damsm_sim_dimg")
    damsm_sim_dimg.launches += 1
    return out


def dwords_grid(b: int, bj: int, texts: int, sms: int) -> Tuple[int, int]:
    """K3's (images per block, ranges of images): blocks of ``texts`` texts,
    one block per SM (the block holds most of an SM's shared memory), as
    many ranges of images as fill one wave of the card's ``sms`` SMs."""
    majors = math.ceil(b / texts)
    splits = max(1, min(bj, sms // majors))
    chunk = math.ceil(bj / splits)
    return chunk, math.ceil(bj / chunk)


def launch_dwords(words, img, lens, g, gamma1, gamma2) -> torch.Tensor:
    """K3 on CUDA tensors, as :func:`launch_fwd`: one block per group of
    texts (two where shared memory allows) and range of images."""
    _check(words, img, g)
    b, t, d = words.shape
    bj, r, _ = img.shape
    lib = _dwords_library()
    texts = lib.damsm_dwords_texts(b, t, r, d)
    if texts == 0:
        _raise_on(_CUDA_ERROR_INVALID_VALUE, "damsm_sim_dwords")
    out = torch.empty_like(words)
    chunk, splits = dwords_grid(b, bj, texts, _sm_count(words.device.index))
    part = _scratch(out, splits)
    with torch.cuda.device(words.device):
        err = lib.damsm_sim_dwords(
            words.data_ptr(), img.data_ptr(), lens.data_ptr(), g.data_ptr(),
            part.data_ptr(), out.data_ptr(), b, bj, t, r, d, texts, chunk,
            float(gamma1), float(gamma2), _stream(words))
    _raise_on(err, "damsm_sim_dwords")
    damsm_sim_dwords.launches += 1
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
                  gamma2: float = 5.0) -> torch.Tensor:
    """K1: sim (B, Bj).  words (B, T, D), img (Bj, R, D), cap_lens (B,) ints
    in [1, T] on any device."""
    _check_lens(cap_lens, words.shape[0], words.shape[1])
    if not _route(words):
        return damsm_sim_plain(words, img, cap_lens, gamma1, gamma2)
    return launch_fwd(words, img, _lens_on(words, cap_lens), gamma1, gamma2)


def damsm_sim_dimg(words, img, cap_lens, g, gamma1: float = 4.0,
                   gamma2: float = 5.0) -> torch.Tensor:
    """K2: d_img (Bj, R, D) for the cotangent g (B, Bj) of sim."""
    _check_lens(cap_lens, words.shape[0], words.shape[1])
    if not _route(words):
        return damsm_sim_dimg_plain(words, img, cap_lens, g, gamma1, gamma2)
    return launch_dimg(words, img, _lens_on(words, cap_lens), g, gamma1, gamma2)


def damsm_sim_dwords(words, img, cap_lens, g, gamma1: float = 4.0,
                     gamma2: float = 5.0) -> torch.Tensor:
    """K3: d_words (B, T, D) for the cotangent g (B, Bj) of sim."""
    _check_lens(cap_lens, words.shape[0], words.shape[1])
    if not _route(words):
        return damsm_sim_dwords_plain(words, img, cap_lens, g, gamma1, gamma2)
    return launch_dwords(words, img, _lens_on(words, cap_lens), g, gamma1, gamma2)


damsm_sim_fwd.launches = 0
damsm_sim_dimg.launches = 0
damsm_sim_dwords.launches = 0


class DAMSMSim(torch.autograd.Function):
    """sim = K1(words, img); backward K2 for img, K3 for words, each only
    when that input needs a gradient."""

    @staticmethod
    def forward(ctx, words, img, cap_lens, gamma1, gamma2):
        ctx.save_for_backward(words, img)
        ctx.cap_lens, ctx.gammas = cap_lens, (gamma1, gamma2)
        return damsm_sim_fwd(words, img, cap_lens, gamma1, gamma2)

    @staticmethod
    def backward(ctx, grad):
        words, img = ctx.saved_tensors
        g = grad.contiguous()
        d_words: Optional[torch.Tensor] = None
        d_img: Optional[torch.Tensor] = None
        if ctx.needs_input_grad[0]:
            d_words = damsm_sim_dwords(words, img, ctx.cap_lens, g, *ctx.gammas)
        if ctx.needs_input_grad[1]:
            d_img = damsm_sim_dimg(words, img, ctx.cap_lens, g, *ctx.gammas)
        return d_words, d_img, None, None, None


def damsm_sim(words: torch.Tensor, img: torch.Tensor, cap_lens: torch.Tensor,
              gamma1: float = 4.0, gamma2: float = 5.0) -> torch.Tensor:
    """Differentiable sim (B, Bj): sim[i, j] is text i against image j.

    words (B, T, D) and img (Bj, R, D) on one device; cap_lens (B,) with every
    length in [1, T], on any device."""
    return DAMSMSim.apply(words.contiguous(), img.contiguous(), cap_lens,
                          float(gamma1), float(gamma2))
