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

Options of the JAX tower that are set away from their JAX defaults and
not ported raise NotImplementedError; at their defaults they are accepted.
"""

from __future__ import annotations

import torch
from torch import nn

from xtagclip_tpu_torch.models.layers import Dense, LayerNorm, Transformer


def _to_2tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


# the JAX tower's options that are not ported, at their JAX defaults
_UNPORTED_DEFAULTS = {"ls_init_value": None, "attentional_pool": False,
                      "patch_dropout": 0.0, "no_ln_pre": False,
                      "final_ln_after_pool": False,
                      "pos_embed_type": "learnable", "n_learnable_tokens": 0}
# options that mean nothing while the ones above are at their defaults
# (the pooler's and the learnable tokens' sizes), and the JAX factory's
# output_tokens, which it always sets
_INERT = {"attn_pooler_queries", "attn_pooler_heads", "insert_position",
          "add_learnable_tokens", "output_tokens"}


def _check_options(options) -> None:
    """Raise on an option that is set and not ported (module doc)."""
    unported = sorted(
        k for k, v in options.items()
        if k not in _INERT and (v != _UNPORTED_DEFAULTS[k]
                                if k in _UNPORTED_DEFAULTS else bool(v)))
    if unported:
        raise NotImplementedError(
            f"vision tower options not ported yet: {unported}")


class VisionTransformer(nn.Module):
    def __init__(self, image_size=224, patch_size=16, width: int = 768,
                 layers: int = 12, heads: int = 12, mlp_ratio: float = 4.0,
                 output_dim: int = 512, act: str = "gelu",
                 norm_eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 pool_type: str = "tok", no_class_token: bool = False,
                 **options):
        super().__init__()
        _check_options(options)
        if pool_type not in ("tok", "avg"):
            raise NotImplementedError(
                f"vision pool_type {pool_type!r} is not ported yet")
        if no_class_token and pool_type != "avg":
            raise ValueError(
                "no_class_token requires pool_type='avg' (GAP); "
                f"got pool_type={pool_type!r}")
        self.image_size = _to_2tuple(image_size)
        self.patch_size = _to_2tuple(patch_size)
        self.width = width
        self.dtype = dtype
        self.pool_type = pool_type
        self.no_class_token = no_class_token
        ph, pw = self.patch_size
        gh, gw = self.grid_size
        self.conv1 = Dense(ph * pw * 3, width, bias=False)
        if not no_class_token:
            self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(gh * gw + (0 if no_class_token else 1), width))
        self.ln_pre = LayerNorm(width, norm_eps)
        self.transformer = Transformer(width, layers, heads, mlp_ratio, act,
                                       norm_eps)
        self.ln_post = LayerNorm(width, norm_eps)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    @property
    def grid_size(self):
        (ih, iw), (ph, pw) = self.image_size, self.patch_size
        return ih // ph, iw // pw

    def init_params(self, generator):
        std = self.width**-0.5
        cls = () if self.no_class_token else (self.class_embedding,)
        for p in (*cls, self.positional_embedding, self.proj):
            nn.init.normal_(p, 0.0, std, generator=generator)

    def patchify(self, x):
        """NHWC image -> [B, gh*gw, ph*pw*C] patches (row-major in a patch)."""
        b, h, w, c = x.shape
        ph, pw = self.patch_size
        gh, gw = h // ph, w // pw
        x = x.reshape(b, gh, ph, gw, pw, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * gw, ph * pw * c)

    def forward(self, x):
        """[B, H, W, 3] normalized images -> (pooled [B, E], tokens [B, L, E])."""
        x = self.conv1(self.patchify(x.to(self.dtype)))
        if not self.no_class_token:
            cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
            x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)
        tokens = self.transformer(x)
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
