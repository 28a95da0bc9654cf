"""Bi-directional LSTM/GRU text encoder (eval mode).

Embedding (ntoken, 300) -> one-layer bi-LSTM (or GRU) with nhidden/2 units
per direction, run over packed sequences so that padded steps neither move
the state nor produce output.  Returns per-word outputs (zero at padded
steps) and the sentence vector ``[h_fwd_final, h_bwd_final]``.  Module names
follow the reference RNN_ENCODER (``encoder``, ``rnn``); the gate layout is
torch's, which the JAX package copies, so weights carry over unchanged.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class RNNEncoder(nn.Module):
    def __init__(self, ntoken: int, ninput: int = 300, nhidden: int = 256,
                 rnn_type: str = "LSTM"):
        super().__init__()
        if rnn_type not in ("LSTM", "GRU"):
            raise ValueError(f"rnn_type must be 'LSTM' or 'GRU', got {rnn_type!r}")
        self.rnn_type = rnn_type
        self.encoder = nn.Embedding(ntoken, ninput)
        rnn = nn.LSTM if rnn_type == "LSTM" else nn.GRU
        self.rnn = rnn(ninput, nhidden // 2, num_layers=1, batch_first=True,
                       bidirectional=True)

    def forward(self, captions: torch.Tensor, cap_lens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """captions (B, T) int64 ids (0 = pad); cap_lens (B,) with every
        length >= 1.  Returns words_emb (B, T, nhidden), sent_emb (B, nhidden)."""
        t = captions.shape[1]
        emb = self.encoder(captions)
        packed = pack_padded_sequence(emb, cap_lens.cpu().long(),
                                      batch_first=True, enforce_sorted=False)
        out, state = self.rnn(packed)
        h = state[0] if self.rnn_type == "LSTM" else state
        words_emb, _ = pad_packed_sequence(out, batch_first=True, total_length=t)
        return words_emb, torch.cat([h[0], h[1]], dim=1)


@torch.no_grad()
def init_weights(encoder: RNNEncoder, generator: torch.Generator) -> None:
    """Random weights as the JAX package draws them: embedding U(-0.1, 0.1),
    recurrent weights and biases U(-1/sqrt(H), 1/sqrt(H))."""
    encoder.encoder.weight.uniform_(-0.1, 0.1, generator=generator)
    bound = encoder.rnn.hidden_size ** -0.5
    for p in encoder.rnn.parameters():
        p.uniform_(-bound, bound, generator=generator)
