"""Vision Transformer tower (port of xtagclip_tpu/models/vit.py).

patchify (NHWC, (ph, pw, C) order within a patch) -> one matmul -> +cls ->
+pos -> ln_pre -> blocks -> pooled = tokens[:, 0]; ``ln_post`` + ``proj``
are applied to the pooled feature AND to every token (the XTag edit,
vit.py:272-280), so the tag head cross-attends in embed_dim space.
Options of the JAX tower that ViT-B-32 does not use raise
NotImplementedError.
"""

from __future__ import annotations

import torch
from torch import nn

from xtagclip_tpu_torch.models.layers import Dense, LayerNorm, Transformer


def _to_2tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


class VisionTransformer(nn.Module):
    def __init__(self, image_size=224, patch_size=16, width: int = 768,
                 layers: int = 12, heads: int = 12, mlp_ratio: float = 4.0,
                 output_dim: int = 512, act: str = "gelu",
                 norm_eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 **unported):
        super().__init__()
        used = {k: v for k, v in unported.items() if v}
        if used:
            raise NotImplementedError(
                f"vision tower options not ported yet: {sorted(used)}")
        self.image_size = _to_2tuple(image_size)
        self.patch_size = _to_2tuple(patch_size)
        self.width = width
        self.dtype = dtype
        ph, pw = self.patch_size
        gh, gw = self.grid_size
        self.conv1 = Dense(ph * pw * 3, width, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(gh * gw + 1, width))
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
        for p in (self.class_embedding, self.positional_embedding, self.proj):
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
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)
        tokens = self.transformer(x)
        pooled = self.ln_post(tokens[:, 0])
        proj = self.proj.to(pooled.dtype)
        pooled = torch.matmul(pooled, proj)
        tokens = torch.matmul(self.ln_post(tokens), proj)
        return pooled, tokens
