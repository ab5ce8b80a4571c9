"""The T5 / mT5 encoder stack (the ``mt5-*`` text trunk); port of
xtagclip_tpu/models/t5.py, with the semantics of transformers'
``T5EncoderModel``:

- ``RMSNorm`` (T5LayerNorm): no mean subtraction, no bias, fp32 variance;
- a bucketed relative position bias (bidirectional, 32 buckets, max
  distance 128) held by the stack and added to every layer's scores;
- attention UNscaled (no dh^-0.5: T5 folds it into the init), q/k/v/o
  without biases, inner width heads * d_kv;
- a gated feed-forward: wo(gelu_tanh(wi_0(x)) * wi_1(x));
- pre-norm residual blocks, a final RMSNorm.

The attention core is plain (XLA's in JAX: it takes a position bias and a
padding mask): scores in the stream's dtype, then fp32 with the bias and
the -1e9 padding mask, fp32 softmax, probabilities in the stream's dtype
for P @ V. Dropout (0.1, as the JAX tower trains with it) is drawn from
an explicit ``torch.Generator`` and is off without one (models/layers.py).
Parameter names are the flax tree's (``block_{i}_attn``, ...).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from xtagclip_tpu_torch.models.layers import (
    Dense,
    Embed,
    dropout,
    local_heads,
    tp_input,
)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))

    def init_params(self, generator):
        nn.init.ones_(self.scale)

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True)
                              + self.eps)
        return y.to(self.dtype) * self.scale.to(self.dtype)


def relative_position_bucket(relative_position, num_buckets: int = 32,
                             max_distance: int = 128):
    """Bidirectional T5 bucket ids of (memory_pos - query_pos)
    (t5.py:49-65; transformers' ``T5Attention._relative_position_bucket``)."""
    num_buckets //= 2
    ret = (relative_position > 0).long() * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # the log only counts where n >= max_exact; the floor at 1 keeps it finite
    val_large = max_exact + (
        torch.log(n.clamp_min(1).float() / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).long()
    val_large = val_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


class T5SelfAttention(nn.Module):
    tp_size = 1  # the model size, once parallel/sharding.py splits it

    def __init__(self, d_model: int, num_heads: int, d_kv: int,
                 dropout: float = 0.1):
        super().__init__()
        inner = num_heads * d_kv
        self.num_heads, self.d_kv, self.rate = num_heads, d_kv, dropout
        self.q = Dense(d_model, inner, bias=False)
        self.k = Dense(d_model, inner, bias=False)
        self.v = Dense(d_model, inner, bias=False)
        self.o = Dense(inner, d_model, bias=False)

    def forward(self, x, position_bias, mask_bias=None, generator=None):
        b, l, _ = x.shape
        heads = local_heads(self, self.num_heads)
        h = tp_input(self, x)
        q, k, v = (t(h).reshape(b, l, heads, self.d_kv).transpose(1, 2)
                   for t in (self.q, self.k, self.v))
        scores = torch.matmul(q, k.transpose(-1, -2)).float() + position_bias
        if mask_bias is not None:
            scores = scores + mask_bias
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        attn = dropout(attn, self.rate, generator, (1, self.num_heads))
        ctx = torch.matmul(attn, v).transpose(1, 2).reshape(b, l, -1)
        return self.o(ctx)


class T5GatedFF(nn.Module):
    tp_size = 1  # the model size, once parallel/sharding.py splits it

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.1):
        super().__init__()
        self.rate, self.d_ff = dropout, d_ff
        self.wi_0 = Dense(d_model, d_ff, bias=False)
        self.wi_1 = Dense(d_model, d_ff, bias=False)
        self.wo = Dense(d_ff, d_model, bias=False)

    def forward(self, x, generator=None):
        # gelu_new: the tanh-approximate gelu (mT5's dense_act_fn)
        x = tp_input(self, x)
        h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        return self.wo(dropout(h, self.rate, generator, (-1, self.d_ff)))


class T5EncoderStack(nn.Module):
    """[B, L] ids -> the final hidden state sequence [B, L, d_model]."""

    def __init__(self, vocab_size: int, d_model: int = 768,
                 num_layers: int = 12, num_heads: int = 12, d_kv: int = 64,
                 d_ff: int = 2048, num_buckets: int = 32,
                 max_distance: int = 128, dropout: float = 0.1,
                 layer_norm_eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.rate = dropout
        self.dtype = dtype
        self.shared = Embed(vocab_size, d_model, init_std=d_model ** -0.5)
        self.relpos_bias = Embed(num_buckets, num_heads,
                                 init_std=num_heads ** -0.5)
        for i in range(num_layers):
            self.add_module(f"block_{i}_attn_ln",
                            RMSNorm(d_model, layer_norm_eps, dtype))
            self.add_module(f"block_{i}_attn",
                            T5SelfAttention(d_model, num_heads, d_kv, dropout))
            self.add_module(f"block_{i}_ff_ln",
                            RMSNorm(d_model, layer_norm_eps, dtype))
            self.add_module(f"block_{i}_ff", T5GatedFF(d_model, d_ff, dropout))
        self.final_ln = RMSNorm(d_model, layer_norm_eps, dtype)

    def forward(self, input_ids, attention_mask=None, generator=None):
        b, l = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = dropout(self.shared(input_ids).to(self.dtype), self.rate,
                    generator)
        pos = torch.arange(l, device=input_ids.device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           self.num_buckets, self.max_distance)
        position_bias = self.relpos_bias(buckets).float().permute(2, 0, 1)[None]
        mask_bias = ((1.0 - attention_mask.float()) * -1e9)[:, None, None, :]
        for i in range(self.num_layers):
            blk = lambda name: getattr(self, f"block_{i}_{name}")  # noqa: E731
            h = blk("attn")(blk("attn_ln")(x), position_bias, mask_bias,
                            generator)
            x = x + dropout(h, self.rate, generator)
            h = blk("ff")(blk("ff_ln")(x), generator)
            x = x + dropout(h, self.rate, generator)
        return dropout(self.final_ln(x), self.rate, generator)
