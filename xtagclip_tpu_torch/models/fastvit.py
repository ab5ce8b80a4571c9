"""FastViT / MobileCLIP image trunks (timm ``fastvit_mci*``); port of
xtagclip_tpu/models/fastvit.py.

The train-time (un-reparameterized) FastViT of arXiv:2303.14189 in the
MobileCLIP MCi variants (arXiv:2311.17049): a conv stem (/4), three
stages of RepMixer blocks (a residual depthwise conv + ConvFFN), a fourth
of attention blocks (BatchNorm, qkv, head dim 32) after a conditional
position conv, and a final 2x grouped conv expansion.

  mci1: dims (64, 128, 256, 512), depths (4, 12, 24, 4) -> features 1024
  mci2: dims (80, 160, 320, 640), depths (4, 12, 24, 4) -> features 1280

The convs run NCHW; every flax conv pads "SAME". The BatchNorms are
models/layers.py's flax-semantics ``BatchNorm``: the forward given a
generator (training, JAX's ``deterministic=False``) normalizes with batch
statistics and moves the running ones; without one it uses the running
ones. A converted inference-form checkpoint (convert/timm_families.py)
folds each conv + BN into an identity BatchNorm that holds only in eval
form, as in JAX. The attention core at head dim 32 is the plain
``attention`` (XLA's in JAX: flash attention takes no head dim 32).
"""

from __future__ import annotations

import torch
from torch import nn

from xtagclip_tpu_torch.models.layers import (
    BatchNorm,
    Conv2d,
    Dense,
    attention,
    gelu_exact,
    local_heads,
    tp_input,
)


class ConvBN(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: bool = False):
        super().__init__()
        self.act = act
        self.conv = Conv2d(in_ch, features, kernel, stride, "SAME",
                           groups=groups)
        self.bn = BatchNorm(features)

    def forward(self, x, train: bool = False):
        x = self.bn(self.conv(x), train)
        return gelu_exact(x) if self.act else x


class ConvFFN(nn.Module):
    def __init__(self, channels: int, ratio: float = 3.0):
        super().__init__()
        c, hidden = channels, int(channels * ratio)
        self.dw = ConvBN(c, c, kernel=7, groups=c)
        self.fc1 = Conv2d(c, hidden, 1, 1, "SAME", bias=True)
        self.fc2 = Conv2d(hidden, c, 1, 1, "SAME", bias=True)

    def forward(self, x, train: bool = False):
        return self.fc2(gelu_exact(self.fc1(self.dw(x, train))))


class RepMixerBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.mixer = ConvBN(channels, channels, kernel=3, groups=channels)
        self.ffn = ConvFFN(channels)

    def forward(self, x, train: bool = False):
        # token mixing: the residual depthwise conv (RepMixer's train form)
        x = x + self.mixer(x, train)
        return x + self.ffn(x, train)


class AttnBlock(nn.Module):
    tp_size = 1  # the model size, once parallel/sharding.py splits it

    def __init__(self, channels: int, head_dim: int = 32):
        super().__init__()
        self.heads = max(1, channels // head_dim)
        self.norm = BatchNorm(channels)
        self.qkv = Dense(channels, 3 * channels)
        self.proj = Dense(channels, channels)
        self.ffn = ConvFFN(channels)

    def forward(self, x, train: bool = False):
        b, c, h, w = x.shape
        y = self.norm(x, train).flatten(2).transpose(1, 2)
        q, k, v = self.qkv(tp_input(self, y)).chunk(3, dim=-1)
        y = self.proj(attention(q, k, v, local_heads(self, self.heads)))
        x = x + y.transpose(1, 2).reshape(b, c, h, w)
        return x + self.ffn(x, train)


class Downsample(nn.Module):
    """Patch embedding between stages: depthwise 7x7 /2 + pointwise."""

    def __init__(self, in_ch: int, channels: int):
        super().__init__()
        self.dw = ConvBN(in_ch, in_ch, kernel=7, stride=2, groups=in_ch,
                         act=True)
        self.pw = ConvBN(in_ch, channels, kernel=1, act=True)

    def forward(self, x, train: bool = False):
        return self.pw(self.dw(x, train), train)


class FastVitTrunk(nn.Module):
    """images [B, H, W, 3] -> [B, (H/32)*(W/32), 2*dims[-1]] tokens."""

    def __init__(self, dims=(64, 128, 256, 512), depths=(4, 12, 24, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d0 = dims[0]
        self.dtype = dtype
        self.dims, self.depths = tuple(dims), tuple(depths)
        # stem /4: conv s2 + depthwise s2 + pointwise (MobileOne, train form)
        self.stem0 = ConvBN(3, d0, kernel=3, stride=2, act=True)
        self.stem1 = ConvBN(d0, d0, kernel=3, stride=2, groups=d0, act=True)
        self.stem2 = ConvBN(d0, d0, kernel=1, act=True)
        for si, (dim, depth) in enumerate(zip(dims, depths)):
            if si > 0:
                self.add_module(f"downsample{si}", Downsample(dims[si - 1],
                                                              dim))
            is_attn = si == len(dims) - 1
            if is_attn:  # RepCPE (train form: a residual 7x7 depthwise conv)
                self.add_module(f"stage{si}_pos_emb",
                                ConvBN(dim, dim, kernel=7, groups=dim))
            for di in range(depth):
                self.add_module(f"stage{si}_block{di}",
                                AttnBlock(dim) if is_attn
                                else RepMixerBlock(dim))
        self.final_conv = ConvBN(dims[-1], 2 * dims[-1], kernel=3,
                                 groups=dims[-1], act=True)

    def forward(self, x, generator=None):
        train = generator is not None
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for stem in (self.stem0, self.stem1, self.stem2):
            x = stem(x, train)
        for si, depth in enumerate(self.depths):
            if si > 0:
                x = getattr(self, f"downsample{si}")(x, train)
            if si == len(self.dims) - 1:
                x = x + getattr(self, f"stage{si}_pos_emb")(x, train)
            for di in range(depth):
                x = getattr(self, f"stage{si}_block{di}")(x, train)
        x = self.final_conv(x, train)
        return x.flatten(2).transpose(1, 2)


FASTVIT_CONFIGS = {
    "fastvit_mci1": dict(dims=(64, 128, 256, 512), depths=(4, 12, 24, 4)),
    "fastvit_mci2": dict(dims=(80, 160, 320, 640), depths=(4, 12, 24, 4)),
}
