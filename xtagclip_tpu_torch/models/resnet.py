"""OpenAI ModifiedResNet tower, the CLIP RN configs (RN50, RN101, RN50x4,
RN50x16, RN50x64, plain and quickgelu); port of xtagclip_tpu/models/resnet.py.

A 3-conv stem with a 2x2 average pool, anti-aliased strided bottlenecks
(average pool before the strided 1x1 conv3 and in the downsample), and a
QKV ``AttentionPool2d`` head. Images come in NHWC and run as NCHW through
cuDNN's convolutions (XLA's in JAX, so plain PyTorch here). The
BatchNorms are models/layers.py's flax-semantics ``BatchNorm``; training
(``forward`` given a generator, the port's ``deterministic=False``)
normalizes with batch statistics and moves the running ones.

Returns (pooled, tokens): pooled is the attention pool's mean-query output
[B, output_dim], tokens its output at the HW positions [B, HW, output_dim]
(they feed the tag head as a ViT's tokens do).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from xtagclip_tpu_torch.models.layers import (
    BatchNorm,
    Conv2d,
    Dense,
    local_heads,
    tp_input,
)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = Conv2d(in_ch, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, out, 1)
        self.bn3 = BatchNorm(out)
        self.has_downsample = stride > 1 or in_ch != out
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_ch, out, 1)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x, train: bool = False):
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out), train)
        identity = x
        if self.has_downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity), train)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """The spatial mean prepended as a query token, a learned position
    table, one multi-head attention over [1 + HW] tokens (fp32 scores and
    softmax), then ``c_proj`` (resnet.py:101-145)."""

    tp_size = 1  # the model size, once parallel/sharding.py splits it

    def __init__(self, grid: int, embed_dim: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.empty(grid * grid + 1, embed_dim))
        self.q_proj = Dense(embed_dim, embed_dim)
        self.k_proj = Dense(embed_dim, embed_dim)
        self.v_proj = Dense(embed_dim, embed_dim)
        self.c_proj = Dense(embed_dim, output_dim)

    def init_params(self, generator):
        nn.init.normal_(self.positional_embedding, 0.0,
                        self.positional_embedding.shape[1] ** -0.5,
                        generator=generator)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, C, H, W] -> (pooled [B, out], tokens [B, HW, out])."""
        b, c = x.shape[:2]
        seq = x.flatten(2).transpose(1, 2)  # [B, HW, C], (h, w) row order
        seq = torch.cat([seq.mean(dim=1, keepdim=True), seq], dim=1)
        seq = seq + self.positional_embedding.to(seq.dtype)[None]
        seq = tp_input(self, seq)
        nh = local_heads(self, self.num_heads)
        dh = c // self.num_heads

        def split(t):
            return t.reshape(b, -1, nh, dh).transpose(1, 2)

        q, k, v = (split(f(seq)) for f in (self.q_proj, self.k_proj,
                                           self.v_proj))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * dh**-0.5
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs.to(v.dtype), v).to(seq.dtype)
        out = self.c_proj(ctx.transpose(1, 2).reshape(b, -1, nh * dh))
        return out[:, 0], out[:, 1:]


class ModifiedResNet(nn.Module):
    """Blocks are children named as the flax tree names them
    (``layer{l}_{b}``)."""

    def __init__(self, layers: Tuple[int, ...], output_dim: int, heads: int,
                 image_size: int = 224, width: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, width // 2, 3, 2, 1)
        self.bn1 = BatchNorm(width // 2)
        self.conv2 = Conv2d(width // 2, width // 2, 3, 1, 1)
        self.bn2 = BatchNorm(width // 2)
        self.conv3 = Conv2d(width // 2, width, 3, 1, 1)
        self.bn3 = BatchNorm(width)
        self.block_names = []
        in_ch = width
        for li, blocks in enumerate(layers):
            planes = width * 2**li
            for bi in range(blocks):
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, Bottleneck(
                    in_ch, planes, 2 if bi == 0 and li > 0 else 1))
                self.block_names.append(name)
                in_ch = planes * Bottleneck.expansion
        self.attnpool = AttentionPool2d(image_size // 32, width * 32, heads,
                                        output_dim)

    def forward(self, x, generator=None):
        """[B, H, W, 3] normalized images -> (pooled, tokens). A
        ``generator`` (training) turns the BatchNorms to batch statistics."""
        train = generator is not None
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.relu(self.bn2(self.conv2(x), train))
        x = F.relu(self.bn3(self.conv3(x), train))
        x = F.avg_pool2d(x, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return self.attnpool(x)
