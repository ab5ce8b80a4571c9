"""Vision Transformer tower (port of xtagclip_tpu/models/vit.py).

patchify (NHWC, (ph, pw, C) order within a patch) -> one matmul -> +cls ->
+pos -> ln_pre -> blocks -> pool; ``ln_post`` + ``proj`` are applied to the
pooled feature AND to every token (the XTag edit, vit.py:272-280), so the
tag head cross-attends in embed_dim space.

Pooling (vit.py:103-107, 226-235): ``pool_type="tok"`` takes the class
token; ``"avg"`` the mean of the patch tokens. ``no_class_token`` (with
``"avg"`` only, as in JAX) drops the class embedding: the cls-free GAP
tower, L = gh * gw (256 for ViT-B-16 at 256 px), whose blocks leave the
fused halves for flash attention and the fused MLP (models/layers.py).

Options (vit.py:42-79), as JAX applies them:

- ``ls_init_value``: LayerScale blocks (models/layers.py);
- ``pos_embed_type``: ``"learnable"`` or ``"sin_cos_2d"`` (a parameter
  initialized to the fixed 2-D sin-cos table, square grids only);
- ``n_learnable_tokens`` / ``insert_position``: learned tokens spliced in
  after the position embedding, at ``insert_position``
  (``learnable_tokens`` [n, width], vit.py:146-156; the XTag CLI's
  ``--add-learnable-tokens``);
- ``patch_dropout``: in training (``forward`` given a generator) the token
  subset of layers.patch_dropout, after the learnable tokens and before
  ``ln_pre``; the first token is always kept, as JAX keeps it;
- ``no_ln_pre``: no ``ln_pre``;
- ``final_ln_after_pool``: accepted and changes nothing. In the JAX tower
  the pool is always followed by ``ln_post`` (vit.py:225-236), whatever
  the flag says; the port does the same.
- ``grad_checkpointing``: per-block activation checkpointing (JAX's
  ``remat``);
- ``attentional_pool`` (CoCa's, vit.py:49-51, 210-221): the blocks'
  output goes through ``attn_pool`` (models/layers.AttentionalPooler:
  ``attn_pooler_queries`` queries of width ``output_dim`` over the
  [B, L, width] stream, ``attn_pooler_heads`` heads), then ``ln_post``
  (over ``output_dim``); the first query's row times ``proj``
  [output_dim, output_dim] is the pooled feature, and the other rows,
  unprojected, are the returned tokens (255 image embeddings for CoCa's
  256 queries).
"""

from __future__ import annotations

import torch
from torch import nn

from xtagclip_tpu_torch.models.layers import (
    AttentionalPooler,
    Dense,
    LayerNorm,
    Transformer,
    patch_dropout,
)
from xtagclip_tpu_torch.models.pos_embed import get_2d_sincos_pos_embed


def _to_2tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


# an option that means nothing while no learnable tokens are set, and the
# JAX factory's output_tokens, which it always sets
_INERT = {"add_learnable_tokens", "output_tokens"}


class VisionTransformer(nn.Module):
    def __init__(self, image_size=224, patch_size=16, width: int = 768,
                 layers: int = 12, heads: int = 12, mlp_ratio: float = 4.0,
                 output_dim: int = 512, act: str = "gelu",
                 norm_eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 pool_type: str = "tok", no_class_token: bool = False,
                 ls_init_value=None, patch_dropout: float = 0.0,
                 no_ln_pre: bool = False, pos_embed_type: str = "learnable",
                 final_ln_after_pool: bool = False,
                 n_learnable_tokens: int = 0, insert_position: int = 1,
                 attentional_pool: bool = False,
                 attn_pooler_queries: int = 256, attn_pooler_heads: int = 8,
                 grad_checkpointing: bool = False, **options):
        super().__init__()
        unknown = sorted(set(options) - _INERT)
        if unknown:
            raise TypeError(f"unknown vision tower options: {unknown}")
        if pool_type not in ("tok", "avg"):
            raise NotImplementedError(
                f"vision pool_type {pool_type!r} is not ported yet")
        if no_class_token and pool_type != "avg":
            raise ValueError(
                "no_class_token requires pool_type='avg' (GAP); "
                f"got pool_type={pool_type!r}")
        if pos_embed_type not in ("learnable", "sin_cos_2d"):
            raise ValueError(pos_embed_type)
        self.image_size = _to_2tuple(image_size)
        self.patch_size = _to_2tuple(patch_size)
        self.width = width
        self.dtype = dtype
        self.pool_type = pool_type
        self.no_class_token = no_class_token
        self.pos_embed_type = pos_embed_type
        self.patch_dropout = patch_dropout
        self.final_ln_after_pool = final_ln_after_pool  # no-op (module doc)
        self.n_learnable_tokens = n_learnable_tokens
        self.insert_position = insert_position
        ph, pw = self.patch_size
        gh, gw = self.grid_size
        if pos_embed_type == "sin_cos_2d" and gh != gw:
            raise ValueError("sin_cos_2d requires square grids")
        self.conv1 = Dense(ph * pw * 3, width, bias=False)
        if not no_class_token:
            self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(gh * gw + (0 if no_class_token else 1), width))
        if n_learnable_tokens > 0:
            self.learnable_tokens = nn.Parameter(
                torch.empty(n_learnable_tokens, width))
        self.ln_pre = None if no_ln_pre else LayerNorm(width, norm_eps)
        self.transformer = Transformer(width, layers, heads, mlp_ratio, act,
                                       norm_eps, ls_init_value,
                                       grad_checkpointing)
        self.attentional_pool = attentional_pool
        if attentional_pool:
            self.attn_pool = AttentionalPooler(output_dim, width,
                                               attn_pooler_heads,
                                               attn_pooler_queries)
        post = output_dim if attentional_pool else width
        self.ln_post = LayerNorm(post, norm_eps)
        self.proj = nn.Parameter(torch.empty(post, output_dim))

    @property
    def grid_size(self):
        (ih, iw), (ph, pw) = self.image_size, self.patch_size
        return ih // ph, iw // pw

    def init_params(self, generator):
        std = self.width**-0.5
        cls = () if self.no_class_token else (self.class_embedding,)
        extra = ((self.learnable_tokens,) if self.n_learnable_tokens > 0
                 else ())
        if self.pos_embed_type == "sin_cos_2d":
            table = get_2d_sincos_pos_embed(
                self.width, self.grid_size[0],
                cls_token=not self.no_class_token)
            self.positional_embedding.copy_(torch.from_numpy(table))
            learned = (*cls, self.proj, *extra)
        else:
            learned = (*cls, self.positional_embedding, self.proj, *extra)
        for p in learned:
            nn.init.normal_(p, 0.0, std, generator=generator)

    def patchify(self, x):
        """NHWC image -> [B, gh*gw, ph*pw*C] patches (row-major in a patch)."""
        b, h, w, c = x.shape
        ph, pw = self.patch_size
        gh, gw = h // ph, w // pw
        x = x.reshape(b, gh, ph, gw, pw, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * gw, ph * pw * c)

    def forward(self, x, generator=None):
        """[B, H, W, 3] normalized images -> (pooled [B, E], tokens [B, L,
        E]). ``generator`` (training) turns patch dropout on."""
        x = self.conv1(self.patchify(x.to(self.dtype)))
        if not self.no_class_token:
            cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
            x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding.to(x.dtype)
        if self.n_learnable_tokens > 0:
            extra = self.learnable_tokens.to(x.dtype).expand(
                x.shape[0], -1, -1)
            i = self.insert_position
            x = torch.cat([x[:, :i], extra, x[:, i:]], dim=1)
        if generator is not None and self.patch_dropout > 0.0:
            x = patch_dropout(x, generator, self.patch_dropout)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        tokens = self.transformer(x)
        if self.attentional_pool:
            normed = self.ln_post(self.attn_pool(tokens))
            pooled = torch.matmul(normed[:, 0], self.proj.to(normed.dtype))
            return pooled, normed[:, 1:]
        if self.pool_type == "tok":
            pooled = tokens[:, 0]
        else:  # the mean of the patch tokens, in fp32 as jnp.mean
            patches = tokens if self.no_class_token else tokens[:, 1:]
            pooled = patches.float().mean(dim=1).to(tokens.dtype)
        pooled = self.ln_post(pooled)
        proj = self.proj.to(pooled.dtype)
        pooled = torch.matmul(pooled, proj)
        tokens = torch.matmul(self.ln_post(tokens), proj)
        return pooled, tokens
