"""Swin Transformer vision trunk (timm ``swin_base_patch4_window7_224``);
port of xtagclip_tpu/models/swin.py.

Swin-B (arXiv:2103.14030): patch 4, embed 128, depths (2, 2, 18, 2), heads
(4, 8, 16, 32), window 7, patch merging between stages, a final
LayerNorm; features 1024. The stream is [B, H, W, C] between blocks, as
JAX's; the window partition is a reshape and the cyclic shift
``torch.roll``. Window attention is a plain core (XLA's in JAX): q scaled
by dh^-0.5, fp32 scores plus the relative-position bias and, in shifted
blocks, the -1e9 shift mask, fp32 softmax, probabilities in the stream's
dtype for P @ V. A stage's window is min(7, its feature side), so the
block's bias table is sized from the image size at construction. The
trunk draws no random numbers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from xtagclip_tpu_torch.models.layers import (
    Conv2d,
    Dense,
    LayerNorm,
    gelu_exact,
)


def _rel_pos_index(window: int) -> np.ndarray:
    """[W*W, W*W] index into the (2W-1)^2 relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64)


def _shift_attn_mask(hw: int, window: int, shift: int) -> np.ndarray:
    """Additive mask [num_windows, W*W, W*W] for shifted windows."""
    img = np.zeros((hw, hw), np.int32)
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    nw = hw // window
    wins = img.reshape(nw, window, nw, window).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, window * window)
    diff = wins[:, :, None] - wins[:, None, :]
    return np.where(diff != 0, -1e9, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim)
        self.rel_pos_bias = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads))
        self.proj = Dense(dim, dim)
        # torch.tensor (not from_numpy): on the build's device
        self.register_buffer("index", torch.tensor(_rel_pos_index(window)),
                             persistent=False)

    def init_params(self, generator):
        nn.init.normal_(self.rel_pos_bias, 0.0, 0.02, generator=generator)

    def forward(self, x, mask=None):
        """x [B*nW, W*W, C]; mask [nW, W*W, W*W] or None."""
        bnw, n, c = x.shape
        nh = self.num_heads
        dh = c // nh
        q, k, v = (t.reshape(bnw, n, nh, dh).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        attn = torch.matmul(q * dh ** -0.5, k.transpose(-1, -2)).float()
        bias = self.rel_pos_bias[self.index].permute(2, 0, 1)
        attn = attn + bias[None].float()
        if mask is not None:  # broadcast over batch and heads
            nw = mask.shape[0]
            attn = attn.reshape(bnw // nw, nw, nh, n, n) + mask[None, :, None]
            attn = attn.reshape(bnw, nh, n, n)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(bnw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, side: int, window: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.win = min(window, side)
        self.shift = shift if self.win < side else 0
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, self.win)
        self.norm2 = LayerNorm(dim)
        self.fc1 = Dense(dim, int(dim * mlp_ratio))
        self.fc2 = Dense(int(dim * mlp_ratio), dim)
        if self.shift:
            self.register_buffer("mask", torch.tensor(_shift_attn_mask(
                side, self.win, self.shift)), persistent=False)

    def forward(self, x):
        b, h, w, c = x.shape
        win, shift = self.win, self.shift
        y = self.norm1(x)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        nwh, nww = h // win, w // win
        y = y.reshape(b, nwh, win, nww, win, c).permute(0, 1, 3, 2, 4, 5)
        y = self.attn(y.reshape(b * nwh * nww, win * win, c),
                      self.mask if shift else None)
        y = y.reshape(b, nwh, nww, win, win, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(b, h, w, c)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return x + self.fc2(gelu_exact(self.fc1(self.norm2(x))))


class SwinTrunk(nn.Module):
    """images [B, H, W, 3] -> [B, (H/32)*(W/32), 8*embed] final-normed
    tokens."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 128,
                 depths=(2, 2, 18, 2), heads=(4, 8, 16, 32), window: int = 7,
                 image_size=224, dtype: torch.dtype = torch.float32):
        super().__init__()
        side = (image_size[0] if isinstance(image_size, (list, tuple))
                else image_size) // patch_size
        self.dtype = dtype
        self.depths = tuple(depths)
        self.patch_embed = Conv2d(3, embed_dim, patch_size, patch_size,
                                  "SAME", bias=True)
        self.patch_norm = LayerNorm(embed_dim)
        c = embed_dim
        for si, (depth, nh) in enumerate(zip(depths, heads)):
            if si > 0:  # patch merging: 2x2 concat -> LN -> halve
                self.add_module(f"merge{si}_norm", LayerNorm(4 * c))
                self.add_module(f"merge{si}_reduce",
                                Dense(4 * c, 2 * c, bias=False))
                c, side = 2 * c, side // 2
            for di in range(depth):
                self.add_module(f"stage{si}_block{di}", SwinBlock(
                    c, nh, side, window, 0 if di % 2 == 0 else window // 2))
        self.norm = LayerNorm(c)

    def forward(self, x, generator=None):
        x = self.patch_embed(x.to(self.dtype).permute(0, 3, 1, 2))
        x = self.patch_norm(x.permute(0, 2, 3, 1))
        for si, depth in enumerate(self.depths):
            if si > 0:
                b, h, w, c = x.shape
                x = x.reshape(b, h // 2, 2, w // 2, 2, c)
                x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2,
                                                        4 * c)
                x = getattr(self, f"merge{si}_reduce")(
                    getattr(self, f"merge{si}_norm")(x))
            for di in range(depth):
                x = getattr(self, f"stage{si}_block{di}")(x)
        b, h, w, c = x.shape
        return self.norm(x.reshape(b, h * w, c))
