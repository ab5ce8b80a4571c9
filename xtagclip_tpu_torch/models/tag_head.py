"""Tag-recognition head: a cross-attention-only BERT
(port of xtagclip_tpu/models/tag_head.py).

[cross-attn(label queries <- image tokens) + FFN] x 2, post-LN at eps
1e-12, exact gelu. Attention is plain torch (the JAX head uses XLA's
``jax.nn.dot_product_attention``, not a Pallas kernel).
"""

from __future__ import annotations

from torch import nn

from xtagclip_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    attention,
    gelu_exact,
)


class BertCrossAttention(nn.Module):
    """BertSelfAttention(is_cross_attention) + BertSelfOutput (post-LN)."""

    def __init__(self, hidden_size: int, num_heads: int, encoder_width: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = Dense(hidden_size, hidden_size)
        self.key = Dense(encoder_width, hidden_size)
        self.value = Dense(encoder_width, hidden_size)
        self.out_dense = Dense(hidden_size, hidden_size)
        self.out_ln = LayerNorm(hidden_size, eps=1e-12)

    def forward(self, hidden, encoder_hidden):
        ctx = attention(self.query(hidden), self.key(encoder_hidden),
                        self.value(encoder_hidden), self.num_heads)
        return self.out_ln(self.out_dense(ctx) + hidden)


class BertFFN(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int):
        super().__init__()
        self.intermediate = Dense(hidden_size, intermediate_size)
        self.output = Dense(intermediate_size, hidden_size)
        self.output_ln = LayerNorm(hidden_size, eps=1e-12)

    def forward(self, x):
        h = self.output(gelu_exact(self.intermediate(x)))
        return self.output_ln(h + x)


class TagBertLayer(nn.Module):
    """One [cross-attn + FFN] layer (the JAX tree's ``layer_{i}_*`` pair)."""

    def __init__(self, hidden_size, num_heads, intermediate_size,
                 encoder_width):
        super().__init__()
        self.crossattention = BertCrossAttention(hidden_size, num_heads,
                                                 encoder_width)
        self.ffn = BertFFN(hidden_size, intermediate_size)

    def forward(self, x, encoder_hidden):
        return self.ffn(self.crossattention(x, encoder_hidden))


class TagBertHead(nn.Module):
    def __init__(self, encoder_width: int, num_layers: int = 2,
                 hidden_size: int = 768, num_heads: int = 4,
                 intermediate_size: int = 3072):
        super().__init__()
        self.layers = nn.ModuleList(
            TagBertLayer(hidden_size, num_heads, intermediate_size,
                         encoder_width)
            for _ in range(num_layers))

    def forward(self, label_embeds, encoder_hidden):
        """label_embeds [B, Q, hidden], encoder_hidden [B, L, enc_width]."""
        x = label_embeds
        for layer in self.layers:
            x = layer(x, encoder_hidden)
        return x
