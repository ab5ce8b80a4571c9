"""Text transformer tower (port of xtagclip_tpu/models/text.py).

Token embedding + positional embedding -> blocks (causal unless
``no_causal_mask``) -> ln_final -> pooled by ``pool_type`` -> projection.
Returns (projected, ln_final'd token sequence), the XTag return contract.

Options (text.py:46-66), as JAX applies them:

- ``pool_type``: ``"argmax"`` (the EOT position, the argmax of the token
  ids, first on ties, as ``jnp.argmax``), ``"first"``, ``"last"``, or
  ``"none"`` (the whole sequence);
- ``proj_type`` / ``proj_bias``: ``"linear"`` is a [width, output_dim]
  ``text_projection`` matrix, or with ``proj_bias`` a Dense layer of that
  name (kernel and bias); ``"none"`` (or no ``output_dim``) projects
  nothing;
- ``ls_init_value``: LayerScale blocks; ``grad_checkpointing``: JAX's
  ``remat``.

``embed_cls`` (CoCa's, with its per-sample pad mask) raises
NotImplementedError (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import torch
from torch import nn

from xtagclip_tpu_torch.models.layers import (
    Dense,
    Embed,
    LayerNorm,
    Transformer,
)

POOL_TYPES = ("argmax", "first", "last", "none")


def build_causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask: upper triangle -inf, fp32 [L, L] (text.py:40-43)."""
    mask = torch.full((length, length), float("-inf"), dtype=torch.float32,
                      device=device)
    return torch.triu(mask, diagonal=1)


def text_global_pool(x, text=None, pool_type: str = "argmax"):
    """Pool a [B, L, D] sequence (text.py:27-37)."""
    if pool_type == "first":
        return x[:, 0]
    if pool_type == "last":
        return x[:, -1]
    if pool_type == "argmax":
        eot = text.argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot]
    return x


class TextTransformer(nn.Module):
    def __init__(self, context_length: int = 77, vocab_size: int = 49408,
                 width: int = 512, heads: int = 8, layers: int = 12,
                 mlp_ratio: float = 4.0, output_dim=512,
                 act: str = "gelu", norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, ls_init_value=None,
                 no_causal_mask: bool = False, pool_type: str = "argmax",
                 proj_type: str = "linear", proj_bias: bool = False,
                 embed_cls: bool = False, pad_id: int = 0,
                 grad_checkpointing: bool = False):
        super().__init__()
        if embed_cls:
            raise NotImplementedError(
                "text embed_cls (CoCa's) is not ported yet (ROADMAP Queue 1 "
                "item 8)")
        if pool_type not in POOL_TYPES:
            raise ValueError(f"unknown text pool_type {pool_type!r}")
        if proj_type not in ("linear", "none"):
            raise ValueError(f"unknown text proj_type {proj_type!r}")
        self.width = width
        self.dtype = dtype
        self.pool_type = pool_type
        self.no_causal_mask = no_causal_mask
        self.token_embedding = Embed(vocab_size, width, init_std=0.02)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        self.transformer = Transformer(width, layers, heads, mlp_ratio, act,
                                       norm_eps, ls_init_value,
                                       grad_checkpointing)
        self.ln_final = LayerNorm(width, norm_eps)
        self.proj_bias = False
        if proj_type == "none" or not output_dim:
            self.text_projection = None
        elif proj_bias:
            self.proj_bias = True
            self.text_projection = Dense(width, output_dim)
        else:
            self.text_projection = nn.Parameter(torch.empty(width, output_dim))
        self.register_buffer("attn_mask", build_causal_mask(context_length),
                             persistent=False)

    def init_params(self, generator):
        nn.init.normal_(self.positional_embedding, 0.0, 0.01,
                        generator=generator)
        if isinstance(self.text_projection, nn.Parameter):
            nn.init.normal_(self.text_projection, 0.0, self.width**-0.5,
                            generator=generator)

    def forward(self, text):
        """[B, L] token ids -> (projected [B, E], sequence [B, L, D])."""
        seq_len = text.shape[1]
        x = self.token_embedding(text).to(self.dtype)
        x = x + self.positional_embedding[:seq_len].to(x.dtype)
        mask = (None if self.no_causal_mask
                else self.attn_mask[:seq_len, :seq_len].contiguous())
        x = self.transformer(x, attn_mask=mask)
        x = self.ln_final(x)
        pooled = text_global_pool(x, text, self.pool_type)
        if self.text_projection is None:
            projected = pooled
        elif self.proj_bias:
            projected = self.text_projection(pooled)
        else:
            projected = torch.matmul(pooled,
                                     self.text_projection.to(x.dtype))
        return projected, x
