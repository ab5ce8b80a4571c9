"""ViTamin vision trunks (timm ``vitamin_*``); port of
xtagclip_tpu/models/vitamin.py.

The three-stage hybrid of the ViTamin paper (arXiv:2404.02132): a /2 conv
stem, two MBConv-LN stages (/4, /8), a 2x2 patchify conv (/16), then ViT
blocks with a GeGLU MLP (ratio 2) and a final LayerNorm. No class token:
the towers pool by the mean (``timm_pool`` "").

  small : (64, 128) -> 384,  depth 14, heads 6
  base  : (128, 256) -> 768,  depth 14, heads 12
  large : (160, 320) -> 1024, depth 31, heads 16   (large2: the same trunk)
  xlarge: (192, 384) -> 1152, depth 32, heads 16

The convs run NCHW (cuDNN's), their LayerNorms over the channels
(``layers.channels_last``), eps 1e-5 as JAX's default. The attention core
is ``layers.self_attention_core`` (JAX's ``fused_attention``,
vitamin.py:82): flash attention (kernel #6) at head dim 64 and 72, L =
(image / 16)^2. The configs' ``timm_drop_path`` 0.1 is read by neither
package: the trunk applies no drop path, as JAX's, and draws no random
numbers.
"""

from __future__ import annotations

import torch
from torch import nn

from xtagclip_tpu_torch.models.layers import (
    Conv2d,
    Dense,
    LayerNorm,
    channels_last,
    flash_on,
    gelu_exact,
    local_heads,
    run_blocks,
    self_attention_core,
    tp_input,
)


class MbConvLN(nn.Module):
    """MBConv with a LayerNorm pre-norm (ViTamin's MBConv-LN), expand 4."""

    def __init__(self, in_ch: int, channels: int, stride: int = 1,
                 expand: int = 4):
        super().__init__()
        mid = channels * expand
        self.residual = stride == 1 and in_ch == channels
        self.norm = LayerNorm(in_ch)
        self.conv_expand = Conv2d(in_ch, mid, 1, 1, "SAME", bias=True)
        self.conv_dw = Conv2d(mid, mid, 3, stride, "SAME", bias=True,
                              groups=mid)
        self.conv_project = Conv2d(mid, channels, 1, 1, "SAME", bias=True)

    def forward(self, x):
        h = gelu_exact(self.conv_expand(channels_last(self.norm, x)))
        h = self.conv_project(gelu_exact(self.conv_dw(h)))
        return x + h if self.residual else h


class GeGluBlock(nn.Module):
    """A pre-norm ViT block with a GeGLU MLP (ratio 2)."""

    tp_size = 1  # the model size, once parallel/sharding.py splits it

    def __init__(self, width: int, heads: int, mlp_ratio: float = 2.0):
        super().__init__()
        hidden = int(width * mlp_ratio)
        self.heads = heads
        self.use_kernels = True
        self.norm1 = LayerNorm(width)
        self.qkv = Dense(width, 3 * width)
        self.proj = Dense(width, width)
        self.norm2 = LayerNorm(width)
        self.fc1_g = Dense(width, hidden)
        self.fc1_x = Dense(width, hidden)
        self.fc2 = Dense(hidden, width)

    def forward(self, x):
        q, k, v = self.qkv(tp_input(self, self.norm1(x))).chunk(3, dim=-1)
        kernels = flash_on(self.use_kernels, x.dtype)
        x = x + self.proj(self_attention_core(
            q, k, v, local_heads(self, self.heads), kernels))
        h = tp_input(self, self.norm2(x))
        return x + self.fc2(gelu_exact(self.fc1_g(h)) * self.fc1_x(h))


class ViTaminTrunk(nn.Module):
    """images [B, H, W, 3] -> [B, (H/16)*(W/16), width] tokens."""

    def __init__(self, conv_channels=(160, 320), conv_depths=(2, 4),
                 width: int = 1024, depth: int = 31, heads: int = 16,
                 image_size=224, dtype: torch.dtype = torch.float32,
                 grad_checkpointing: bool = False):
        super().__init__()
        c1, c2 = conv_channels
        ih, iw = (tuple(image_size) if isinstance(image_size, (list, tuple))
                  else (image_size, image_size))
        self.dtype = dtype
        self.grad_checkpointing = grad_checkpointing
        self.stem_conv1 = Conv2d(3, c1, 3, 2, "SAME", bias=True)
        self.stem_norm = LayerNorm(c1)
        self.stem_conv2 = Conv2d(c1, c1, 3, 1, "SAME", bias=True)
        for s, (ch, n) in enumerate(zip((c1, c2), conv_depths), start=1):
            for i in range(n):
                # each stage's first block reads the stem's c1 channels
                self.add_module(f"stage{s}_{i}", MbConvLN(
                    c1 if i == 0 else ch, ch, 2 if i == 0 else 1))
        self.conv_depths = tuple(conv_depths)
        self.patch_conv = Conv2d(c2, width, 2, 2, "SAME", bias=True)
        self.pos_embed = nn.Parameter(
            torch.empty((ih // 16) * (iw // 16), width))
        self.blocks = nn.ModuleList(GeGluBlock(width, heads)
                                    for _ in range(depth))
        self.norm = LayerNorm(width)

    def init_params(self, generator):
        nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)

    def forward(self, x, generator=None):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = gelu_exact(channels_last(self.stem_norm, self.stem_conv1(x)))
        x = self.stem_conv2(x)
        for s, n in enumerate(self.conv_depths, start=1):
            for i in range(n):
                x = getattr(self, f"stage{s}_{i}")(x)
        x = self.patch_conv(x).flatten(2).transpose(1, 2)
        x = x + self.pos_embed.to(x.dtype)[None]
        x = run_blocks(self.blocks, x, self.grad_checkpointing)
        return self.norm(x)


VITAMIN_CONFIGS = {
    "vitamin_small": dict(conv_channels=(64, 128), width=384, depth=14,
                          heads=6),
    "vitamin_base": dict(conv_channels=(128, 256), width=768, depth=14,
                         heads=12),
    "vitamin_large": dict(conv_channels=(160, 320), width=1024, depth=31,
                          heads=16),
    "vitamin_large2": dict(conv_channels=(160, 320), width=1024, depth=31,
                           heads=16),
    "vitamin_xlarge": dict(conv_channels=(192, 384), width=1152, depth=32,
                           heads=16),
}


def vitamin_config(timm_name: str) -> dict:
    """The trunk kwargs of ``vitamin_<size>[_<res>]`` (vitamin.py:151)."""
    base = "_".join(timm_name.split("_")[:2])
    if base not in VITAMIN_CONFIGS:
        raise NotImplementedError(f"unknown ViTamin variant {timm_name!r}")
    return dict(VITAMIN_CONFIGS[base])
