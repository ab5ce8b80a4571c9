"""The M2M100 encoder (the ``nllb-clip-*`` text trunk); port of
xtagclip_tpu/models/m2m100.py, with the semantics of transformers'
``M2M100Model.encoder``:

- token embeddings scaled by sqrt(d_model) (NLLB's ``scale_embedding``);
- fairseq's sinusoidal positions ([sin | cos] halves), offset 2, with
  pad-skipping position ids (cumsum(mask) * mask + padding_idx);
- pre-norm layers: LayerNorm -> self-attention (q scaled by dh^-0.5;
  q/k/v/out biased) under the -1e9 padding mask -> residual, LayerNorm ->
  fc1 -> relu -> fc2 -> residual; a final LayerNorm.

The attention core is models/layers.py's plain ``attention`` (XLA's in
JAX: flash attention takes no padding mask). Dropout (0.1, on the
attention probabilities too, as JAX's) is drawn from an explicit
``torch.Generator`` and is off without one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xtagclip_tpu_torch.models.layers import (
    Dense,
    Embed,
    LayerNorm,
    attention,
    dropout,
    local_heads,
    tp_input,
)


def sinusoidal_positions(num_positions: int, dim: int,
                         padding_idx: int = 1) -> np.ndarray:
    """fairseq / M2M100 sinusoidal table: [sin(pos f) | cos(pos f)]
    halves, the padding row zero (m2m100.py:32-44)."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64)
                  * -(np.log(10000.0) / (half - 1)))
    ang = np.arange(num_positions, dtype=np.float64)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num_positions, 1))], axis=1)
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return table.astype(np.float32)


class M2M100EncoderLayer(nn.Module):
    tp_size = 1  # the model size, once parallel/sharding.py splits it

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1):
        super().__init__()
        self.num_heads, self.rate, self.ffn_dim = num_heads, dropout, ffn_dim
        self.self_attn_ln = LayerNorm(d_model)
        self.q_proj = Dense(d_model, d_model)
        self.k_proj = Dense(d_model, d_model)
        self.v_proj = Dense(d_model, d_model)
        self.out_proj = Dense(d_model, d_model)
        self.final_ln = LayerNorm(d_model)
        self.fc1 = Dense(d_model, ffn_dim)
        self.fc2 = Dense(ffn_dim, d_model)

    def forward(self, x, mask=None, generator=None):
        h = tp_input(self, self.self_attn_ln(x))
        ctx = attention(self.q_proj(h), self.k_proj(h), self.v_proj(h),
                        local_heads(self, self.num_heads), self.rate,
                        generator, mask, whole_heads=self.num_heads)
        x = x + dropout(self.out_proj(ctx), self.rate, generator)
        h = tp_input(self, self.final_ln(x))
        h = dropout(F.relu(self.fc1(h)), self.rate, generator,
                    (-1, self.ffn_dim))
        return x + dropout(self.fc2(h), self.rate, generator)


class M2M100Encoder(nn.Module):
    """[B, L] ids -> the final hidden state sequence [B, L, d_model]."""

    POS_OFFSET = 2  # M2M100SinusoidalPositionalEmbedding's offset

    def __init__(self, vocab_size: int, d_model: int = 1024,
                 num_layers: int = 12, num_heads: int = 16,
                 ffn_dim: int = 4096, max_position_embeddings: int = 1024,
                 pad_token_id: int = 1, scale_embedding: bool = True,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.emb_scale = float(np.sqrt(d_model)) if scale_embedding else 1.0
        self.rate = dropout
        self.dtype = dtype
        self.embed_tokens = Embed(vocab_size, d_model,
                                  init_std=d_model ** -0.5)
        self.layers = nn.ModuleList(
            M2M100EncoderLayer(d_model, num_heads, ffn_dim, dropout)
            for _ in range(num_layers))
        self.layer_norm = LayerNorm(d_model)
        # torch.tensor (not from_numpy): on the build's device
        self.register_buffer("positions", torch.tensor(sinusoidal_positions(
            max_position_embeddings + self.POS_OFFSET, d_model,
            padding_idx=pad_token_id)), persistent=False)

    def forward(self, input_ids, attention_mask=None, generator=None):
        not_pad = (input_ids != self.pad_token_id).long()
        if attention_mask is None:
            attention_mask = not_pad
        x = self.embed_tokens(input_ids).to(self.dtype) * self.emb_scale
        pos_ids = torch.cumsum(not_pad, dim=1) * not_pad + self.pad_token_id
        x = x + self.positions.to(self.dtype)[pos_ids]
        x = dropout(x, self.rate, generator)
        mask = ((1.0 - attention_mask.float()) * -1e9)[:, None, None, :]
        for layer in self.layers:
            x = layer(x, mask, generator)
        return self.layer_norm(x)
