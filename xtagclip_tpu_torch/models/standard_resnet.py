"""Standard (torchvision-style) ResNet-50 backbone of the supervised
baseline (port of xtagclip_tpu/models/standard_resnet.py).

7x7 stride-2 stem + maxpool, bottleneck blocks with the stride on conv2,
a 1x1-conv downsample. Returns the 2048-d pooled feature (or, with
``num_classes``, the ``fc`` logits). Images come in NHWC, as everywhere in
the port, and run as NCHW through cuDNN's convolutions: JAX computes them
in XLA, not Pallas, so they are plain PyTorch here. The BatchNorms are
models/layers.py's flax-semantics ``BatchNorm``; ``train`` selects batch
statistics and moves the running ones (flax's ``mutable=["batch_stats"]``).

``convert_torchvision_resnet`` maps a torchvision state dict to flax-layout
(params, batch_stats) trees, as JAX's converter does; load them with
convert/from_jax.py ``load_jax_params``.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np
import torch.nn.functional as F
from torch import nn

from xtagclip_tpu_torch.models.layers import BatchNorm, Conv2d, Dense


class TorchBottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(in_ch, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, out, 1)
        self.bn3 = BatchNorm(out)
        self.has_downsample = stride != 1 or in_ch != out
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_ch, out, 1, stride)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x, train: bool = False):
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        identity = x
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Blocks are children named as the flax tree names them
    (``layer{l}_{b}``)."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3),
                 num_classes: Optional[int] = None):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm(64)
        self.block_names = []
        in_ch = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            for bi in range(blocks):
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, TorchBottleneck(
                    in_ch, planes, 2 if bi == 0 and li > 0 else 1))
                self.block_names.append(name)
                in_ch = planes * TorchBottleneck.expansion
        self.feature_dim = in_ch
        self.fc = Dense(in_ch, num_classes) if num_classes else None

    def forward(self, x, train: bool = False):
        """[B, H, W, 3] -> [B, 2048] pooled features (or [B, classes])."""
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, 2, 1)  # -inf padding, as jnp.pad + max_pool
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        feat = x.mean(dim=(2, 3))
        return self.fc(feat) if self.fc is not None else feat


def resnet50(num_classes: Optional[int] = None) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes)


def _put(tree, path, key, v):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node.setdefault(path[-1], {})[key] = v


def _bn_put(params, stats, path, key, v):
    if key in ("weight", "bias"):
        _put(params, path, "scale" if key == "weight" else "bias", v)
    elif key == "running_mean":
        _put(stats, path, "mean", v)
    elif key == "running_var":
        _put(stats, path, "var", v)
    # num_batches_tracked dropped


def convert_torchvision_resnet(sd) -> Tuple[dict, dict]:
    """torchvision resnet state dict -> flax-layout (params, batch_stats)
    trees (standard_resnet.py:85-135)."""
    params: dict = {}
    stats: dict = {}

    def conv_w(v):
        return np.ascontiguousarray(np.transpose(v, (2, 3, 1, 0)))

    for k, v in sd.items():
        v = np.asarray(v)
        if k == "conv1.weight":
            _put(params, ("conv1",), "kernel", conv_w(v))
        elif k.startswith("bn1."):
            _bn_put(params, stats, ("bn1",), k.split(".")[1], v)
        elif k.startswith("fc."):
            if k.endswith("weight"):
                _put(params, ("fc",), "kernel", np.ascontiguousarray(v.T))
            else:
                _put(params, ("fc",), "bias", v)
        else:
            m = re.match(r"layer(\d)\.(\d+)\.(.+)", k)
            if not m:
                continue
            base = (f"layer{m.group(1)}_{m.group(2)}",)
            parts = m.group(3).split(".")
            if parts[0].startswith("conv"):
                _put(params, base + (parts[0],), "kernel", conv_w(v))
            elif parts[0].startswith("bn"):
                _bn_put(params, stats, base + (parts[0],), parts[1], v)
            elif parts[0] == "downsample":
                if parts[1] == "0":
                    _put(params, base + ("downsample_conv",), "kernel",
                         conv_w(v))
                else:
                    _bn_put(params, stats, base + ("downsample_bn",),
                            parts[2], v)
    return params, stats
