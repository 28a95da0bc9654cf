"""Generator-side word attention: image features query the caption's words."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sba_gan_tpu_torch.models.layers import Linear
from sba_gan_tpu_torch.ops.word_attention import word_attention


class WordAttention(nn.Module):
    """Image-query word attention.

    forward(h, words, pad_mask):
      h:        (B, idf, H, W) image features (the query).
      words:    (B, T, cdf) word embeddings.
      pad_mask: (B, T) bool, True at padding, or None.

    Returns context (B, idf, H, W) and the attention maps (B, H, W, T), both
    in ``h``'s dtype.  ``conv_context`` is the bias-free projection of the
    words to ``idf`` (the reference's 1x1 conv, held as a linear), in the
    model's compute dtype: under bfloat16 the kernel takes bfloat16 query
    and source, and its float32 context and maps are cast back to ``h``'s
    dtype, as the JAX package's ``WordAttention`` casts them.
    """

    def __init__(self, idf: int, cdf: int):
        super().__init__()
        self.conv_context = Linear(cdf, idf, bias=False)

    def forward(self, h: torch.Tensor, words: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, idf, ih, iw = h.shape
        source = self.conv_context(words).contiguous()  # (B, T, idf)
        # (B, H*W, idf), rows in row-major (h, w) order
        query = h.permute(0, 2, 3, 1).reshape(b, ih * iw, idf).contiguous()
        context, attn = word_attention(query, source, pad_mask)
        context = context.to(h.dtype).view(b, ih, iw, idf).permute(0, 3, 1, 2)
        return context, attn.to(h.dtype).view(b, ih, iw, -1)
