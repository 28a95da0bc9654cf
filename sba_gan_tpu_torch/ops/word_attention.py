"""Fused word attention: every pixel of a feature map attends over the
caption's words.

    scores  = Q @ S^T + pad_bias          (QL x T)
    P       = softmax(scores) over words
    context = P @ S                       (QL x D)

:func:`word_attention` is the wrapper, differentiable in ``query`` and
``source`` through :class:`WordAttention`.  Its forward, on CUDA tensors,
launches the hand-written kernel ``csrc/word_attention.cu`` (the port of
the JAX package's Pallas ``_attn_kernel``) or raises; on CPU tensors it runs
:func:`word_attention_plain`, the same function in plain PyTorch.  The
kernel takes the padding mask itself and builds the additive bias inside
(one launch a call).  The backward is the JAX package's ``_bwd`` (XLA math
there, no Pallas kernel), the same ``bmm`` and elementwise code on both
devices, from the saved query, source and P:

    dP = dCtx S^T (+ the cotangent of P)
    dZ = P * (dP - sum_t dP * P)
    dQ = dZ S,   dS = dZ^T Q + P^T dCtx
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e9  # additive pad bias: a fully padded row stays finite
MAX_T = 32  # what the kernel holds (csrc/word_attention.cu kMaxT, kMaxD)
MAX_D = 256


def pad_bias(pad_mask: Optional[torch.Tensor], source: torch.Tensor) -> torch.Tensor:
    """(B, T) float32 additive bias: -1e9 at padding (pad_mask True), else 0."""
    if pad_mask is None:
        return torch.zeros(source.shape[:2], dtype=torch.float32,
                           device=source.device)
    zero = torch.zeros((), dtype=torch.float32, device=pad_mask.device)
    return torch.where(pad_mask, zero + NEG_INF, zero)


def word_attention_plain(
    query: torch.Tensor, source: torch.Tensor, bias: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (B, QL, D), source (B, T, D), bias (B, T) additive.
    Returns (context (B, QL, D), attn (B, QL, T))."""
    scores = torch.einsum("bqd,btd->bqt", query, source)
    attn = torch.softmax(scores + bias[:, None, :], dim=2)
    context = torch.einsum("bqt,btd->bqd", attn, source)
    return context, attn


def _library() -> ctypes.CDLL:
    from sba_gan_tpu_torch.ops import _build

    lib = _build.load("word_attention")
    fn = lib.word_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.word_attention_tile_rows.argtypes = []
        lib.word_attention_tile_rows.restype = ctypes.c_int
    return lib


def tile_rows() -> int:
    """Query rows per block of the kernel (builds it; needs the toolkit)."""
    return _library().word_attention_tile_rows()


def _check(query, source, pad_mask):
    if query.dim() != 3 or source.dim() != 3 or (
            pad_mask is not None and pad_mask.dim() != 2):
        raise ValueError("word_attention wants query (B, QL, D), source "
                         "(B, T, D) and pad_mask (B, T)")
    b, ql, d = query.shape
    if source.shape[0] != b or source.shape[2] != d or (
            pad_mask is not None and pad_mask.shape != source.shape[:2]):
        mask = None if pad_mask is None else tuple(pad_mask.shape)
        raise ValueError(f"shape mismatch: query {tuple(query.shape)}, "
                         f"source {tuple(source.shape)}, mask {mask}")
    t = source.shape[1]
    if not (1 <= t <= MAX_T and 1 <= d <= MAX_D and b >= 1 and ql >= 1):
        raise ValueError(f"the kernel takes 1 <= T <= {MAX_T}, 1 <= D <= "
                         f"{MAX_D} and non-empty B, QL; got B={b} QL={ql} "
                         f"T={t} D={d}")
    for name, x in (("query", query), ("source", source)):
        if x.device != query.device or x.device.type != "cuda":
            raise ValueError(f"{name} must lie on query's CUDA device")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(query, source, pad_mask):
    """The kernel; it builds the pad bias from the mask itself."""
    _check(query, source, pad_mask)
    b, ql, d = query.shape
    t = source.shape[1]
    pad = None if pad_mask is None else pad_mask.to(
        device=query.device, dtype=torch.bool).contiguous()
    ctx = torch.empty_like(query)
    probs = torch.empty((b, ql, t), dtype=torch.float32, device=query.device)
    lib = _library()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = lib.word_attention_fwd(
            query.data_ptr(), source.data_ptr(), None if pad is None else pad.data_ptr(),
            ctx.data_ptr(), probs.data_ptr(), b, ql, t, d, stream)
    if err != 0:
        raise RuntimeError(f"word_attention kernel launch failed: CUDA error {err}")
    word_attention.launches += 1
    return ctx, probs


def word_attention_backward(query, source, p, d_ctx, d_p=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dQ, dS) for the cotangents ``d_ctx`` (B, QL, D) of the context and
    ``d_p`` (B, QL, T) of P; either may be None (no gradient flows there)."""
    if d_ctx is None:
        d_ctx = torch.zeros_like(query)
    dp = torch.bmm(d_ctx, source.transpose(1, 2))
    if d_p is not None:
        dp = dp + d_p
    dz = p * (dp - (dp * p).sum(dim=2, keepdim=True))
    dq = torch.bmm(dz, source)
    ds = torch.bmm(dz.transpose(1, 2), query) + torch.bmm(p.transpose(1, 2), d_ctx)
    return dq, ds


class WordAttention(torch.autograd.Function):
    """Forward: the kernel on CUDA, the plain version on the CPU; backward:
    :func:`word_attention_backward` on both."""

    @staticmethod
    def forward(ctx, query, source, pad_mask):
        ctx.set_materialize_grads(False)
        if query.device.type == "cpu":
            context, p = word_attention_plain(query, source, pad_bias(pad_mask, source))
        elif query.device.type == "cuda":
            context, p = _launch(query, source, pad_mask)
        else:
            raise ValueError(f"unsupported device {query.device}")
        ctx.save_for_backward(query, source, p)
        return context, p

    @staticmethod
    def backward(ctx, d_ctx, d_p):
        query, source, p = ctx.saved_tensors
        dq, ds = word_attention_backward(query, source, p, d_ctx, d_p)
        return dq, ds, None


def word_attention(
    query: torch.Tensor,
    source: torch.Tensor,
    pad_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused word attention.

    query:    (B, QL, D) float32 image-feature queries.
    source:   (B, T, D) float32 projected word embeddings.
    pad_mask: (B, T) bool, True at padding, or None.

    Returns (context (B, QL, D), attn (B, QL, T)), float32, differentiable in
    query and source.  CUDA tensors go to the kernel (which counts its
    launches in ``word_attention.launches``), CPU tensors to
    :func:`word_attention_plain`.
    """
    return WordAttention.apply(query, source, pad_mask)


word_attention.launches = 0
