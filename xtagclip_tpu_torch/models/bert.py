"""BERT encoder (the PubMedBERT/BiomedCLIP text trunk); port of
xtagclip_tpu/models/bert.py, with the semantics of transformers'
``BertModel``.

Embeddings (word + position + token type, LayerNorm eps 1e-12, dropout),
then post-LN layers: self-attention + ``out_ln``, FFN + ``output_ln``. The
padding mask is additive -10000, not -inf (bert.py:118-119). Dropout (rate
``dropout``, 0.1 by default, as the JAX tower trains with it) is drawn
from an explicit ``torch.Generator`` and is off without one, as the port's
other dropout is (models/layers.py). ``roberta_positions``: position ids
start at ``pad_token_id + 1`` and skip pads (transformers'
``create_position_ids_from_input_ids``). ``add_pooling_layer``: the tanh
pooler over token 0.

JAX runs this tower through XLA: L = 256 with a padding mask has no Pallas
kernel, so it is plain PyTorch on every device.
"""

from __future__ import annotations

import torch
from torch import nn

from xtagclip_tpu_torch.models.layers import (
    Dense,
    Embed,
    LayerNorm,
    attention,
    dropout,
    gelu_exact,
)


class BertSelfAttentionLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, rate: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.rate = rate
        self.query = Dense(hidden_size, hidden_size)
        self.key = Dense(hidden_size, hidden_size)
        self.value = Dense(hidden_size, hidden_size)
        self.out_dense = Dense(hidden_size, hidden_size)
        self.out_ln = LayerNorm(hidden_size, 1e-12)

    def forward(self, x, mask=None, generator=None):
        ctx = attention(self.query(x), self.key(x), self.value(x),
                        self.num_heads, self.rate, generator, mask)
        out = dropout(self.out_dense(ctx), self.rate, generator)
        return self.out_ln(out + x)


class BertEncoderLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, rate: float = 0.1):
        super().__init__()
        self.rate = rate
        self.attention = BertSelfAttentionLayer(hidden_size, num_heads, rate)
        self.intermediate = Dense(hidden_size, intermediate_size)
        self.output = Dense(intermediate_size, hidden_size)
        self.output_ln = LayerNorm(hidden_size, 1e-12)

    def forward(self, x, mask=None, generator=None):
        x = self.attention(x, mask, generator)
        h = self.output(gelu_exact(self.intermediate(x)))
        return self.output_ln(dropout(h, self.rate, generator) + x)


class BertModel(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072,
                 max_position_embeddings: int = 512, type_vocab_size: int = 2,
                 dropout: float = 0.1, pad_token_id: int = 0,
                 add_pooling_layer: bool = False,
                 roberta_positions: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rate = dropout
        self.pad_token_id = pad_token_id
        self.roberta_positions = roberta_positions
        self.dtype = dtype
        self.word_embeddings = Embed(vocab_size, hidden_size, init_std=0.02)
        self.position_embeddings = Embed(max_position_embeddings, hidden_size,
                                         init_std=0.02)
        self.token_type_embeddings = Embed(type_vocab_size, hidden_size,
                                           init_std=0.02)
        self.embeddings_ln = LayerNorm(hidden_size, 1e-12)
        self.layers = nn.ModuleList(
            BertEncoderLayer(hidden_size, num_heads, intermediate_size,
                             dropout)
            for _ in range(num_layers))
        self.pooler = (Dense(hidden_size, hidden_size) if add_pooling_layer
                       else None)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator=None):
        """[B, L] ids -> (sequence [B, L, D], pooled [B, D] or None)."""
        if attention_mask is None:
            attention_mask = (input_ids != self.pad_token_id).long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if self.roberta_positions:
            not_pad = (input_ids != self.pad_token_id).long()
            pos_ids = torch.cumsum(not_pad, dim=1) * not_pad + self.pad_token_id
        else:
            pos_ids = torch.arange(input_ids.shape[1],
                                   device=input_ids.device)[None]
        dt = self.dtype  # each table read in the compute dtype, as flax's
        emb = (self.word_embeddings(input_ids).to(dt)
               + self.position_embeddings(pos_ids).to(dt)
               + self.token_type_embeddings(token_type_ids).to(dt))
        x = dropout(self.embeddings_ln(emb), self.rate, generator)
        ext_mask = ((1.0 - attention_mask.float()) * -10000.0)[:, None, None]
        for layer in self.layers:
            x = layer(x, ext_mask, generator)
        pooled = None
        if self.pooler is not None:
            pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled
