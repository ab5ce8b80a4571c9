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
  ``remat``;
- ``embed_cls`` (CoCa's, text.py:76-105, 134-138): a learned ``cls_emb``
  is appended after the last token, the position table has
  ``context_length + 1`` rows, and the mask becomes per sample: the causal
  [L + 1, L + 1] mask plus -inf at every key whose token is ``pad_id``
  (the class token is never masked), a [B, 1, L + 1, L + 1] additive mask
  whose blocks take the plain attention core (models/layers.py). The
  pooled feature is ``ln_final`` of the class token's row, and the
  returned sequence is the other rows, without ``ln_final``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
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
        if pool_type not in POOL_TYPES:
            raise ValueError(f"unknown text pool_type {pool_type!r}")
        if proj_type not in ("linear", "none"):
            raise ValueError(f"unknown text proj_type {proj_type!r}")
        self.width = width
        self.dtype = dtype
        self.pool_type = pool_type
        self.no_causal_mask = no_causal_mask
        self.embed_cls = embed_cls
        self.pad_id = pad_id
        num_pos = context_length + (1 if embed_cls else 0)
        self.token_embedding = Embed(vocab_size, width, init_std=0.02)
        if embed_cls:
            self.cls_emb = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(num_pos, width))
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
        self.register_buffer("attn_mask", build_causal_mask(num_pos),
                             persistent=False)

    def init_params(self, generator):
        nn.init.normal_(self.positional_embedding, 0.0, 0.01,
                        generator=generator)
        if self.embed_cls:
            nn.init.normal_(self.cls_emb, 0.0, 0.01, generator=generator)
        if isinstance(self.text_projection, nn.Parameter):
            nn.init.normal_(self.text_projection, 0.0, self.width**-0.5,
                            generator=generator)

    def forward(self, text, generator=None):
        """[B, L] token ids -> (projected [B, E], sequence [B, L, D]). The
        blocks draw no random numbers (JAX's are rate-0), so ``generator``
        changes nothing."""
        seq_len = text.shape[1] + (1 if self.embed_cls else 0)
        x = self.token_embedding(text).to(self.dtype)
        mask = (None if self.no_causal_mask
                else self.attn_mask[:seq_len, :seq_len].contiguous())
        if self.embed_cls:
            cls = self.cls_emb.to(x.dtype).expand(x.shape[0], 1, -1)
            x = torch.cat([x, cls], dim=1)
            if mask is not None:  # padded keys masked per sample
                pad = F.pad(text == self.pad_id, (0, 1))
                mask = mask + torch.where(pad, float("-inf"), 0.0)[
                    :, None, None, :]
        x = x + self.positional_embedding[:seq_len].to(x.dtype)
        x = self.transformer(x, attn_mask=mask)
        if self.embed_cls:
            pooled, x = self.ln_final(x[:, -1]), x[:, :-1]
        else:
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
