"""Tag-recognition head: a cross-attention-only BERT
(port of xtagclip_tpu/models/tag_head.py).

[cross-attn(label queries <- image tokens) + FFN] x 2, post-LN at eps
1e-12, exact gelu. Attention is plain torch (the JAX head uses XLA's
``jax.nn.dot_product_attention``, not a Pallas kernel). Dropout 0.1 on the
attention probabilities, the attention output and the FFN output
(tag_head.py:44-54, 72), drawn from ``generator`` when one is given (the
train step's ``deterministic=False``).
"""

from __future__ import annotations

from torch import nn

from xtagclip_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    attention,
    dropout,
    gelu_exact,
)

DROPOUT = 0.1


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

    def forward(self, hidden, encoder_hidden, generator=None):
        ctx = attention(self.query(hidden), self.key(encoder_hidden),
                        self.value(encoder_hidden), self.num_heads, DROPOUT,
                        generator)
        out = dropout(self.out_dense(ctx), DROPOUT, generator)
        return self.out_ln(out + hidden)


class BertFFN(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int):
        super().__init__()
        self.intermediate = Dense(hidden_size, intermediate_size)
        self.output = Dense(intermediate_size, hidden_size)
        self.output_ln = LayerNorm(hidden_size, eps=1e-12)

    def forward(self, x, generator=None):
        h = self.output(gelu_exact(self.intermediate(x)))
        return self.output_ln(dropout(h, DROPOUT, generator) + x)


class TagBertLayer(nn.Module):
    """One [cross-attn + FFN] layer (the JAX tree's ``layer_{i}_*`` pair)."""

    def __init__(self, hidden_size, num_heads, intermediate_size,
                 encoder_width):
        super().__init__()
        self.crossattention = BertCrossAttention(hidden_size, num_heads,
                                                 encoder_width)
        self.ffn = BertFFN(hidden_size, intermediate_size)

    def forward(self, x, encoder_hidden, generator=None):
        return self.ffn(self.crossattention(x, encoder_hidden, generator),
                        generator)


class TagBertHead(nn.Module):
    def __init__(self, encoder_width: int, num_layers: int = 2,
                 hidden_size: int = 768, num_heads: int = 4,
                 intermediate_size: int = 3072):
        super().__init__()
        self.layers = nn.ModuleList(
            TagBertLayer(hidden_size, num_heads, intermediate_size,
                         encoder_width)
            for _ in range(num_layers))

    def forward(self, label_embeds, encoder_hidden, generator=None):
        """label_embeds [B, Q, hidden], encoder_hidden [B, L, enc_width]."""
        x = label_embeds
        for layer in self.layers:
            x = layer(x, encoder_hidden, generator)
        return x
