"""Bi-directional LSTM/GRU text encoder.

Embedding (ntoken, 300) -> dropout 0.5 in train mode -> one-layer bi-LSTM
(or GRU) with nhidden/2 units per direction, run over packed sequences so that padded steps neither move
the state nor produce output.  Returns per-word outputs (zero at padded
steps) and the sentence vector ``[h_fwd_final, h_bwd_final]``.  Module names
follow the reference RNN_ENCODER (``encoder``, ``rnn``); the gate layout is
torch's, which the JAX package copies, so weights carry over unchanged.

``dtype`` is the compute dtype (``JAX.DTYPE``).  In float32 the encoder runs
``nn.LSTM``/``nn.GRU`` over packed sequences.  In bfloat16 it runs the JAX
package's scan step by step on both devices: the embedding (after dropout)
and the float32 weights and biases cast to bfloat16, the input projection
of all steps as one product, then per step the hidden-side product, the
gates and the state in bfloat16, the state held and the output zeroed at
padded steps; the outputs come out bfloat16.  (A cuDNN bfloat16 LSTM may
keep its cell state in float32, which the JAX scan does not.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from sba_gan_tpu_torch.parallel import dist


class RNNEncoder(nn.Module):
    def __init__(self, ntoken: int, ninput: int = 300, nhidden: int = 256,
                 rnn_type: str = "LSTM", drop_prob: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if rnn_type not in ("LSTM", "GRU"):
            raise ValueError(f"rnn_type must be 'LSTM' or 'GRU', got {rnn_type!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.rnn_type = rnn_type
        self.drop_prob = drop_prob
        self.compute_dtype = dtype
        self.encoder = nn.Embedding(ntoken, ninput)
        rnn = nn.LSTM if rnn_type == "LSTM" else nn.GRU
        self.rnn = rnn(ninput, nhidden // 2, num_layers=1, batch_first=True,
                       bidirectional=True)

    def dropout_mask(self, captions: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
        """(B, T, ninput) bool keep-mask of the embedding dropout, drawn on
        the CPU from ``generator`` (the same mask whatever the device).
        Across ranks it is drawn for the global batch and this rank's rows
        are taken, so N ranks drop what one process drops."""
        b, t = captions.shape
        shape = (b * dist.world_size(), t, self.encoder.embedding_dim)
        keep = torch.rand(shape, generator=generator) >= self.drop_prob
        return keep[dist.rows(b)].to(captions.device)

    def forward(self, captions: torch.Tensor, cap_lens: torch.Tensor,
                keep_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """captions (B, T) int64 ids (0 = pad); cap_lens (B,) with every
        length >= 1.  Returns words_emb (B, T, nhidden), sent_emb (B, nhidden).

        In train mode the embedding goes through dropout: kept entries are
        scaled by 1 / (1 - drop_prob), as flax's ``nn.Dropout`` does, under
        ``keep_mask`` (B, T, ninput) bool if given, else a mask drawn from
        ``generator``."""
        t = captions.shape[1]
        emb = self.encoder(captions)
        if self.training and self.drop_prob > 0:
            if keep_mask is None:
                if generator is None:
                    raise ValueError("train mode needs a keep_mask or a "
                                     "torch.Generator for the dropout")
                keep_mask = self.dropout_mask(captions, generator)
            emb = torch.where(keep_mask, emb / (1.0 - self.drop_prob),
                              torch.zeros_like(emb))
        if self.compute_dtype != torch.float32:
            return self._scan(emb.to(self.compute_dtype), cap_lens)
        packed = pack_padded_sequence(emb, cap_lens.cpu().long(),
                                      batch_first=True, enforce_sorted=False)
        out, state = self.rnn(packed)
        h = state[0] if self.rnn_type == "LSTM" else state
        words_emb, _ = pad_packed_sequence(out, batch_first=True, total_length=t)
        return words_emb, torch.cat([h[0], h[1]], dim=1)

    def _scan(self, emb: torch.Tensor, cap_lens: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both directions of the JAX package's scan over ``emb`` (B, T, in)
        in its dtype: (words_emb (B, T, nhidden), sent_emb (B, nhidden))."""
        dt, (b, t, _) = emb.dtype, emb.shape
        lens = cap_lens.to(device=emb.device, dtype=torch.long)
        valid = (torch.arange(t, device=emb.device)[None, :] < lens[:, None])[..., None]
        outs, finals = [], []
        for suffix, steps in (("", range(t)), ("_reverse", range(t - 1, -1, -1))):
            w_ih, w_hh, b_ih, b_hh = (getattr(self.rnn, f"{name}_l0{suffix}").to(dt) for name
                                      in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
            gi_all = emb @ w_ih.T + b_ih  # every step's input side at once
            h = c = emb.new_zeros((b, self.rnn.hidden_size))
            out = [None] * t
            for k in steps:
                m = valid[:, k]
                if self.rnn_type == "LSTM":
                    z = gi_all[:, k] + h @ w_hh.T + b_hh
                    i, f, g, o = z.chunk(4, dim=1)
                    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                    h_new = torch.sigmoid(o) * torch.tanh(c_new)
                    c = torch.where(m, c_new, c)
                else:
                    i_r, i_z, i_n = gi_all[:, k].chunk(3, dim=1)
                    h_r, h_z, h_n = (h @ w_hh.T + b_hh).chunk(3, dim=1)
                    r, u = torch.sigmoid(i_r + h_r), torch.sigmoid(i_z + h_z)
                    n = torch.tanh(i_n + r * h_n)
                    h_new = (1.0 - u) * n + u * h
                h = torch.where(m, h_new, h)
                out[k] = torch.where(m, h_new, torch.zeros_like(h_new))
            outs.append(torch.stack(out, dim=1))
            finals.append(h)
        return torch.cat(outs, dim=2), torch.cat(finals, dim=1)


@torch.no_grad()
def init_weights(encoder: RNNEncoder, generator: torch.Generator) -> None:
    """Random weights as the JAX package draws them: embedding U(-0.1, 0.1),
    recurrent weights and biases U(-1/sqrt(H), 1/sqrt(H))."""
    encoder.encoder.weight.uniform_(-0.1, 0.1, generator=generator)
    bound = encoder.rnn.hidden_size ** -0.5
    for p in encoder.rnn.parameters():
        p.uniform_(-bound, bound, generator=generator)
