"""Text transformer tower (port of xtagclip_tpu/models/text.py).

Token embedding + positional embedding -> causal blocks -> ln_final;
pooled = the EOT position (argmax of the token ids, first on ties, as
``jnp.argmax``) -> linear projection. Returns (projected, ln_final'd token
sequence), the XTag return contract.
"""

from __future__ import annotations

import torch
from torch import nn

from xtagclip_tpu_torch.models.layers import Embed, LayerNorm, Transformer


def build_causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask: upper triangle -inf, fp32 [L, L] (text.py:40-43)."""
    mask = torch.full((length, length), float("-inf"), dtype=torch.float32,
                      device=device)
    return torch.triu(mask, diagonal=1)


def text_global_pool(x, text):
    """Argmax-EOT pooling of a [B, L, D] sequence (text.py:27-37)."""
    eot = text.argmax(dim=-1)
    return x[torch.arange(x.shape[0], device=x.device), eot]


class TextTransformer(nn.Module):
    def __init__(self, context_length: int = 77, vocab_size: int = 49408,
                 width: int = 512, heads: int = 8, layers: int = 12,
                 mlp_ratio: float = 4.0, output_dim: int = 512,
                 act: str = "gelu", norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, **unported):
        super().__init__()
        defaults = {"pool_type": "argmax", "proj_type": "linear"}
        used = {k: v for k, v in unported.items()
                if v and v != defaults.get(k)}
        if used:
            raise NotImplementedError(
                f"text tower options not ported yet: {sorted(used)}")
        self.width = width
        self.dtype = dtype
        self.token_embedding = Embed(vocab_size, width, init_std=0.02)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        self.transformer = Transformer(width, layers, heads, mlp_ratio, act,
                                       norm_eps)
        self.ln_final = LayerNorm(width, norm_eps)
        self.text_projection = nn.Parameter(torch.empty(width, output_dim))
        self.register_buffer("attn_mask", build_causal_mask(context_length),
                             persistent=False)

    def init_params(self, generator):
        nn.init.normal_(self.positional_embedding, 0.0, 0.01,
                        generator=generator)
        nn.init.normal_(self.text_projection, 0.0, self.width**-0.5,
                        generator=generator)

    def forward(self, text):
        """[B, L] token ids -> (projected [B, E], sequence [B, L, D])."""
        seq_len = text.shape[1]
        x = self.token_embedding(text).to(self.dtype)
        x = x + self.positional_embedding[:seq_len].to(x.dtype)
        mask = self.attn_mask[:seq_len, :seq_len].contiguous()
        x = self.transformer(x, attn_mask=mask)
        x = self.ln_final(x)
        pooled = text_global_pool(x, text)
        projected = torch.matmul(pooled, self.text_projection.to(x.dtype))
        return projected, x
