"""EVA / EVA-02 vision trunks (timm ``eva_*`` / ``eva02_*``); port of
xtagclip_tpu/models/eva.py.

- EVA-01 giant: a pre-norm ViT with a fused, biased qkv, an absolute
  position table and a plain gelu MLP (hidden 6144 at width 1408, depth 40).
- EVA-02 B/L: separate q/k/v projections (k has no bias), 2-D axial rotary
  position embedding on the q/k patch tokens (the class token is not
  rotated), a SwiGLU MLP (``fc1_g``, ``fc1_x``) with a LayerNorm before
  ``fc2`` (sub-LN, ``scale_mlp``), and an absolute position table.
- EVA-02 enormous: EVA-01's blocks at width 1792, depth 64.

The attention core is ``layers.self_attention_core``: flash attention
(kernel #6; its plain version with ``use_kernels`` off or in fp32) where
``flash_attn.supported`` takes the head dim (64, 88 and 112 here, at L = 197
and 257), else the plain attention. JAX sends it through the same
``fused_attention`` (eva.py:96). ``grad_checkpointing`` checkpoints each
block while grad is on (``layers.run_blocks``). The trunk draws no random
numbers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xtagclip_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    gelu_exact,
    local_heads,
    run_blocks,
    self_attention_core,
    tp_input,
)


def axial_rope_tables(grid_h: int, grid_w: int, head_dim: int,
                      theta: float = 10000.0):
    """2-D axial rope (eva.py:35-50): half the rotated pairs turn with the
    row index, half with the column index. (cos, sin), [H*W, head_dim//2]
    fp32 numpy arrays."""
    quarter = head_dim // 4
    freqs = 1.0 / (theta ** (np.arange(quarter, dtype=np.float64) / quarter))
    th = np.arange(grid_h, dtype=np.float64)[:, None] * freqs[None]
    tw = np.arange(grid_w, dtype=np.float64)[:, None] * freqs[None]
    ang = np.concatenate(
        [np.broadcast_to(th[:, None, :], (grid_h, grid_w, quarter)),
         np.broadcast_to(tw[None, :, :], (grid_h, grid_w, quarter))],
        axis=-1).reshape(grid_h * grid_w, 2 * quarter)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def apply_rope(x, cos, sin):
    """Rotate the halves of x [B, L, H, D] by cos/sin [L, D//2], in x's
    dtype (eva.py:53-57)."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class EvaAttention(nn.Module):
    tp_size = 1  # the model size, once parallel/sharding.py splits it

    def __init__(self, width: int, num_heads: int, qkv_fused: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv_fused = qkv_fused
        self.use_kernels = True
        if qkv_fused:
            self.qkv = Dense(width, 3 * width)
        else:  # EVA-02: the k projection carries no bias
            self.q_proj = Dense(width, width)
            self.k_proj = Dense(width, width, bias=False)
            self.v_proj = Dense(width, width)
        self.proj = Dense(width, width)

    def forward(self, x, rope=None):
        b, l, _ = x.shape
        nh = local_heads(self, self.num_heads)
        x = tp_input(self, x)
        if self.qkv_fused:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if rope is not None:
            cos, sin = rope

            def rotate(t):  # the class token (index 0) is not rotated
                e = t.shape[-1]
                th = t.reshape(b, l, nh, e // nh)
                return torch.cat([th[:, :1], apply_rope(th[:, 1:], cos, sin)],
                                 dim=1).reshape(b, l, e)

            q, k = rotate(q), rotate(k)
        kernels = self.use_kernels and x.dtype == torch.bfloat16
        return self.proj(self_attention_core(q, k, v, nh, kernels))


class EvaBlock(nn.Module):
    tp_size = 1  # the model size, once parallel/sharding.py splits it

    def __init__(self, width: int, num_heads: int, mlp_hidden: int,
                 swiglu: bool = False, scale_mlp: bool = False,
                 qkv_fused: bool = True, post_norm: bool = False,
                 norm_eps: float = 1e-6):
        super().__init__()
        self.swiglu = swiglu
        self.post_norm = post_norm
        self.attn = EvaAttention(width, num_heads, qkv_fused)
        self.norm1 = LayerNorm(width, norm_eps)
        self.norm2 = LayerNorm(width, norm_eps)
        if swiglu:
            self.fc1_g = Dense(width, mlp_hidden)
            self.fc1_x = Dense(width, mlp_hidden)
        else:
            self.fc1 = Dense(width, mlp_hidden)
        self.mlp_norm = LayerNorm(mlp_hidden, norm_eps) if scale_mlp else None
        self.fc2 = Dense(mlp_hidden, width)

    def mlp(self, h):
        h = tp_input(self, h)
        if self.swiglu:
            h = F.silu(self.fc1_g(h)) * self.fc1_x(h)
        else:
            h = gelu_exact(self.fc1(h))
        if self.mlp_norm is not None:
            h = self.mlp_norm(h)
        return self.fc2(h)

    def forward(self, x, rope=None):
        if self.post_norm:
            x = x + self.norm1(self.attn(x, rope))
            return x + self.norm2(self.mlp(x))
        x = x + self.attn(self.norm1(x), rope)
        return x + self.mlp(self.norm2(x))


class EvaTrunk(nn.Module):
    """images [B, H, W, 3] -> [B, 1+N, width] tokens, final-normed (timm's
    Eva ``forward_features``)."""

    def __init__(self, patch_size: int, width: int, layers: int, heads: int,
                 mlp_hidden: int, swiglu: bool = False,
                 scale_mlp: bool = False, qkv_fused: bool = True,
                 post_norm: bool = False, use_rope: bool = False,
                 norm_eps: float = 1e-6, image_size=224,
                 dtype: torch.dtype = torch.float32,
                 grad_checkpointing: bool = False):
        super().__init__()
        ih, iw = (tuple(image_size) if isinstance(image_size, (list, tuple))
                  else (image_size, image_size))
        gh, gw = ih // patch_size, iw // patch_size
        self.patch_size = patch_size
        self.use_rope = use_rope
        self.dtype = dtype
        self.grad_checkpointing = grad_checkpointing
        self.patch_embed = Dense(patch_size * patch_size * 3, width)
        self.cls_token = nn.Parameter(torch.empty(1, 1, width))
        self.pos_embed = nn.Parameter(torch.empty(gh * gw + 1, width))
        self.blocks = nn.ModuleList(
            EvaBlock(width, heads, mlp_hidden, swiglu, scale_mlp, qkv_fused,
                     post_norm, norm_eps) for _ in range(layers))
        self.norm = LayerNorm(width, norm_eps)
        if use_rope:  # torch.tensor (not from_numpy): on the build's device
            cos, sin = axial_rope_tables(gh, gw, width // heads)
            self.register_buffer("rope_cos", torch.tensor(cos),
                                 persistent=False)
            self.register_buffer("rope_sin", torch.tensor(sin),
                                 persistent=False)

    def init_params(self, generator):
        nn.init.zeros_(self.cls_token)
        nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)

    def forward(self, x, generator=None):
        b, hh, ww, c = x.shape
        p = self.patch_size
        gh, gw = hh // p, ww // p
        x = x.to(self.dtype)
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_embed(x.reshape(b, gh * gw, p * p * c))
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, -1), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)[None]
        rope = (self.rope_cos, self.rope_sin) if self.use_rope else None
        x = run_blocks(self.blocks, x, self.grad_checkpointing, rope)
        return self.norm(x)


# name -> trunk kwargs (published EVA / EVA-CLIP configs; eva.py:201-225)
EVA_CONFIGS = {
    "eva_giant_patch14_224": dict(
        patch_size=14, width=1408, layers=40, heads=16, mlp_hidden=6144,
        qkv_fused=True),
    "eva02_base_patch16_clip_224": dict(
        patch_size=16, width=768, layers=12, heads=12,
        mlp_hidden=int(768 * 4 * 2 / 3), swiglu=True, scale_mlp=True,
        qkv_fused=False, use_rope=True),
    "eva02_large_patch14_clip_224": dict(
        patch_size=14, width=1024, layers=24, heads=16,
        mlp_hidden=int(1024 * 4 * 2 / 3), swiglu=True, scale_mlp=True,
        qkv_fused=False, use_rope=True),
    "eva02_large_patch14_clip_336": dict(
        patch_size=14, width=1024, layers=24, heads=16,
        mlp_hidden=int(1024 * 4 * 2 / 3), swiglu=True, scale_mlp=True,
        qkv_fused=False, use_rope=True),
    "eva02_enormous_patch14_clip_224": dict(
        patch_size=14, width=1792, layers=64, heads=16, mlp_hidden=15360,
        qkv_fused=True),
}
