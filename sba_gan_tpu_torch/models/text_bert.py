"""BERT text encoder (the port's copy of the JAX package's
``models/text_bert.py``): a ``bert-base-uncased`` transformer and two
projections, ``emb_words`` (hidden -> nef on every token, + tanh) and
``emb_sent`` (pooled -> nef, + tanh).

Module names follow HuggingFace's ``BertModel`` keys under ``bert.``
(``bert.embeddings.word_embeddings.weight``,
``bert.encoder.layer.0.attention.self.query.weight``, ...), so a
``bert-base-uncased`` torch state dict loads by key
(:func:`utils.torch_port.load_bert`).  The math is the JAX package's:

* the attention mask is additive, 0 at real tokens and -1e9 at padding, in
  float32; the scores are taken in (at least) float32 and the
  probabilities cast to the dtype of ``v``;
* exact GELU; LayerNorm with eps 1e-12, its statistics in (at least)
  float32; the pooler is tanh(Dense(x[:, 0]));
* no dropout anywhere (HuggingFace's BERT has 0.1; the JAX package has
  none), token types all 0;
* ``words`` are zeroed at padding by multiplying with the mask, and both
  outputs come back float32.

``dtype`` is the compute dtype (``JAX.DTYPE``), cast where flax casts: each
Dense is a :class:`models.layers.Linear`; the embedding tables are cast to
the compute dtype before the lookup and the three embeddings summed in it;
LayerNorm widens its input to float32 for the statistics and the
normalization and returns the compute dtype.  The parameters stay
float32.  The attention is plain ``torch.matmul`` and softmax, as the JAX
package's is XLA einsums (no Pallas kernel).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sba_gan_tpu_torch.models.layers import Linear, set_compute_dtype
from sba_gan_tpu_torch.models.norms import promote

BERT_BASE = dict(
    vocab_size=30522,
    hidden_size=768,
    num_layers=12,
    num_heads=12,
    intermediate_size=3072,
    max_position=512,
    type_vocab_size=2,
    layer_norm_eps=1e-12,
)
MASK_BIAS = -1e9
# flax's lecun_normal: a normal truncated at 2 standard units, whose
# standard deviation this factor corrects to 1 / sqrt(fan_in)
_TRUNC_STD = 0.87962566103423978


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm(dtype=...)``: statistics, normalization, scale
    and offset in at least float32, the result in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(promote(x), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        h = cfg["hidden_size"]
        self.word_embeddings = nn.Embedding(cfg["vocab_size"], h)
        self.position_embeddings = nn.Embedding(cfg["max_position"], h)
        self.token_type_embeddings = nn.Embedding(cfg["type_vocab_size"], h)
        self.LayerNorm = LayerNorm(h, eps=cfg["layer_norm_eps"])

    def forward(self, input_ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        t = input_ids.shape[1]
        # the gathered rows cast, not the table: the same values as flax's
        # cast-then-take, without a cast of the whole table each call
        word = F.embedding(input_ids, self.word_embeddings.weight).to(dtype)
        x = word + self.position_embeddings.weight[:t].to(dtype)
        x = x + self.token_type_embeddings.weight[0].to(dtype)  # token types all 0
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        h = cfg["hidden_size"]
        self.num_heads = cfg["num_heads"]
        self.query = Linear(h, h)
        self.key = Linear(h, h)
        self.value = Linear(h, h)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        b, t, h = x.shape
        nh = self.num_heads
        d = h // nh

        def split(a):
            return a.reshape(b, t, nh, d).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        scores = promote(q) @ promote(k).transpose(-1, -2)
        scores = scores / math.sqrt(d) + attn_bias.to(scores.dtype)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return (probs @ v).transpose(1, 2).reshape(b, t, h)


class _DenseLayerNorm(nn.Module):
    """``dense`` then LayerNorm of the residual sum (HuggingFace's
    ``BertSelfOutput`` / ``BertOutput`` without dropout)."""

    def __init__(self, cin: int, h: int, eps: float):
        super().__init__()
        self.dense = Linear(cin, h)
        self.LayerNorm = LayerNorm(h, eps=eps)

    def forward(self, y: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(residual + self.dense(y))


class BertLayer(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        h, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.attention = nn.ModuleDict({"self": BertSelfAttention(cfg),
                                        "output": _DenseLayerNorm(h, h, eps)})
        self.intermediate = nn.ModuleDict({"dense": Linear(h, cfg["intermediate_size"])})
        self.output = _DenseLayerNorm(cfg["intermediate_size"], h, eps)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        x = self.attention["output"](self.attention["self"](x, attn_bias), x)
        y = F.gelu(self.intermediate["dense"](x))
        return self.output(y, x)


class BertModel(nn.Module):
    """Embeddings, ``num_layers`` layers and the pooler; returns (hidden
    states (B, T, H), pooled (B, H)) in the compute dtype."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(
            BertLayer(cfg) for _ in range(cfg["num_layers"]))})
        self.pooler = nn.ModuleDict({"dense": Linear(cfg["hidden_size"], cfg["hidden_size"])})

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.embeddings(input_ids, dtype)
        attn_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, MASK_BIAS)
        for layer in self.encoder["layer"]:
            x = layer(x, attn_bias)
        return x, torch.tanh(self.pooler["dense"](x[:, 0]))


class BertEncoder(nn.Module):
    """``encoder(captions, cap_lens) -> (words (B, T, nef), sent (B, nef))``,
    float32, the words zero at padding; captions are wordpiece ids padded
    with 0, and ``cap_lens`` (any device) makes the attention mask."""

    def __init__(self, nef: int = 256, bert_cfg: Optional[Dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = dict(bert_cfg or BERT_BASE)
        self.compute_dtype = dtype
        self.bert = BertModel(self.cfg)
        self.emb_words = Linear(self.cfg["hidden_size"], nef)
        self.emb_sent = Linear(self.cfg["hidden_size"], nef)
        set_compute_dtype(self, dtype)

    def forward(self, captions: torch.Tensor, cap_lens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = captions.shape[1]
        lens = cap_lens.to(captions.device)
        mask = torch.arange(t, device=captions.device)[None, :] < lens[:, None]
        # the compute dtype, or float64 for a module moved to double
        dtype = (self.compute_dtype if self.compute_dtype != torch.float32
                 else self.emb_words.weight.dtype)
        hidden, pooled = self.bert(captions, mask, dtype)
        words = torch.tanh(self.emb_words(hidden)) * mask[:, :, None].to(dtype)
        sent = torch.tanh(self.emb_sent(pooled))
        return promote(words), promote(sent)


def bert_trainable_mask(encoder: BertEncoder) -> Dict[str, bool]:
    """{parameter name: trains} in the reference's freeze
    (model_bert.py:171-175): the projection heads and the pooler; the
    embeddings and the encoder layers stay frozen.  The JAX package's DAMSM
    trainer does not apply it (it trains every text parameter), and neither
    does the port's."""
    return {name: not name.startswith(("bert.embeddings.", "bert.encoder."))
            for name, _ in encoder.named_parameters()}


@torch.no_grad()
def init_weights(encoder: BertEncoder, generator: torch.Generator) -> None:
    """Random weights drawn as flax's initializers draw them: Dense kernels
    lecun-normal (a normal of std 1 / sqrt(fan_in) truncated at two of its
    standard units), zero biases, LayerNorm scale 1 and offset 0, embedding
    tables normal with std 1 / sqrt(hidden) (``nn.Embed``'s default)."""
    for m in encoder.modules():
        if isinstance(m, nn.Linear):
            std = m.in_features ** -0.5 / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, m.embedding_dim ** -0.5, generator=generator)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
