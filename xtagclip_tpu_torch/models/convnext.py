"""ConvNeXt vision trunk (timm ``convnext_*``) with its pool and projection
head; port of xtagclip_tpu/models/convnext.py.

timm's structure: a 4x4/4 stem conv + LayerNorm, stages of [7x7 depthwise
conv -> LayerNorm -> 4x pointwise MLP (gelu) -> LayerScale ``gamma`` ->
residual] with a LayerNorm + 2x2/2 downsample conv between stages, eps
1e-6. ``ConvNeXtModel`` LayerNorms the tokens (``head_norm``), pools their
mean and applies the ``linear`` or ``mlp`` head (``convnext_large_d``) to
the pooled feature and to every token: (pooled, tokens), the TimmModel
contract. The convs run NCHW, the LayerNorms and MLPs over the channels
(``layers.channels_last``); JAX runs all of it through XLA, so it is plain
PyTorch here. The configs' ``timm_drop_path`` 0.1 is applied by neither
package, and nothing draws random numbers.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from xtagclip_tpu_torch.models.layers import (
    Conv2d,
    Dense,
    LayerNorm,
    channels_last,
    gelu_exact,
    tp_input,
)

# timm convnext variants: (depths, dims)
CONVNEXT_CFGS = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
    "convnext_xxlarge": ((3, 4, 30, 3), (384, 768, 1536, 3072)),
}


class ConvNeXtBlock(nn.Module):
    tp_size = 1  # the model size, once parallel/sharding.py splits it

    def __init__(self, dim: int, ls_init_value: float = 1e-6):
        super().__init__()
        self.ls_init_value = ls_init_value
        self.conv_dw = Conv2d(dim, dim, 7, 1, 3, bias=True, groups=dim)
        self.norm = LayerNorm(dim, 1e-6)
        self.mlp_fc1 = Dense(dim, 4 * dim)
        self.mlp_fc2 = Dense(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(ls_init_value)))

    def init_params(self, generator):
        nn.init.constant_(self.gamma, self.ls_init_value)

    def _mlp(self, h):
        h = self.mlp_fc1(tp_input(self, self.norm(h)))
        h = self.mlp_fc2(gelu_exact(h))
        return h * self.gamma.to(h.dtype)

    def forward(self, x):
        return x + channels_last(self._mlp, self.conv_dw(x))


class ConvNeXt(nn.Module):
    """images [B, H, W, 3] -> [B, (H/32)*(W/32), dims[-1]] tokens."""

    def __init__(self, depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.depths = tuple(depths)
        self.stem_conv = Conv2d(3, dims[0], 4, 4, "SAME", bias=True)
        self.stem_norm = LayerNorm(dims[0], 1e-6)
        for si, (depth, dim) in enumerate(zip(depths, dims)):
            if si > 0:
                self.add_module(f"stage{si}_downsample_norm",
                                LayerNorm(dims[si - 1], 1e-6))
                self.add_module(f"stage{si}_downsample_conv",
                                Conv2d(dims[si - 1], dim, 2, 2, "SAME",
                                       bias=True))
            for bi in range(depth):
                self.add_module(f"stage{si}_block{bi}", ConvNeXtBlock(dim))

    def forward(self, x, generator=None):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = channels_last(self.stem_norm, self.stem_conv(x))
        for si, depth in enumerate(self.depths):
            if si > 0:
                x = channels_last(getattr(self, f"stage{si}_downsample_norm"),
                                  x)
                x = getattr(self, f"stage{si}_downsample_conv")(x)
            for bi in range(depth):
                x = getattr(self, f"stage{si}_block{bi}")(x)
        return x.flatten(2).transpose(1, 2)  # token sequence (no cls)


class ConvNeXtModel(nn.Module):
    """ConvNeXt trunk + the TimmModel head contract (pooled, tokens)."""

    def __init__(self, embed_dim: int, depths, dims, proj: str = "linear",
                 proj_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width = dims[-1]
        self.proj = proj
        self.trunk = ConvNeXt(depths, dims, dtype)
        self.head_norm = LayerNorm(width, 1e-6)
        if proj == "linear":
            self.head_proj = Dense(width, embed_dim, bias=proj_bias)
        elif proj == "mlp":
            self.head_mlp_fc1 = Dense(width, 2 * embed_dim)
            self.head_mlp_fc2 = Dense(2 * embed_dim, embed_dim,
                                      bias=proj_bias)

    def _head(self, t):
        if self.proj == "linear":
            return self.head_proj(t)
        if self.proj == "mlp":
            return self.head_mlp_fc2(gelu_exact(self.head_mlp_fc1(t)))
        return t

    def forward(self, x, generator=None):
        """[B, H, W, 3] -> (pooled [B, E], tokens [B, L, E])."""
        tokens = self.head_norm(self.trunk(x))
        pooled = tokens.float().mean(dim=1).to(tokens.dtype)
        return self._head(pooled), self._head(tokens)


def build_convnext_tower(embed_dim: int, vision_cfg: dict,
                         dtype: torch.dtype = torch.float32) -> ConvNeXtModel:
    """The tower of a ``convnext*`` config (convnext.py:122-137); the pool
    is the mean whatever ``timm_pool`` says, as JAX's."""
    name = vision_cfg["timm_model_name"]
    base = re.sub(r"(_w|_d)?(_320|_384)?$", "", name)
    if base not in CONVNEXT_CFGS:
        raise NotImplementedError(f"convnext variant {name!r} not mapped")
    depths, dims = CONVNEXT_CFGS[base]
    return ConvNeXtModel(embed_dim, depths, dims,
                         proj=vision_cfg.get("timm_proj", "linear"),
                         proj_bias=vision_cfg.get("timm_proj_bias", False),
                         dtype=dtype)


def convert_timm_convnext_state_dict(sd, prefix: str = "visual.trunk."):
    """timm convnext torch keys -> the ConvNeXt trunk's flax-layout tree
    (convnext.py:140-197); keys it does not know are skipped, as there."""
    tree: dict = {}

    def put(path, key, v):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node.setdefault(path[-1], {})[key] = v

    def conv_w(v):  # [O, I, kh, kw] -> [kh, kw, I, O]
        return np.ascontiguousarray(np.transpose(v, (2, 3, 1, 0)))

    ln_key = {"weight": "scale", "bias": "bias"}
    blk = re.compile(re.escape(prefix) + r"stages\.(\d+)\.blocks\.(\d+)\.(.+)")
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        rest = k[len(prefix):]
        if rest == "stem.0.weight":
            put(("stem_conv",), "kernel", conv_w(v))
        elif rest == "stem.0.bias":
            put(("stem_conv",), "bias", v)
        elif rest.startswith("stem.1."):
            put(("stem_norm",), ln_key[rest.split(".")[2]], v)
        elif ".downsample." in rest:
            m = re.match(r"stages\.(\d+)\.downsample\.(\d+)\.(\w+)", rest)
            if not m:
                continue
            si, idx, key = int(m.group(1)), m.group(2), m.group(3)
            if idx == "0":
                put((f"stage{si}_downsample_norm",), ln_key[key], v)
            else:
                put((f"stage{si}_downsample_conv",),
                    "kernel" if key == "weight" else "bias",
                    conv_w(v) if key == "weight" else v)
        else:
            m = blk.match(k)
            if not m:
                continue
            si, bi, brest = int(m.group(1)), int(m.group(2)), m.group(3)
            base = (f"stage{si}_block{bi}",)
            parts = brest.split(".")
            if parts[0] == "conv_dw":
                put(base + ("conv_dw",),
                    "kernel" if parts[1] == "weight" else "bias",
                    conv_w(v) if parts[1] == "weight" else v)
            elif parts[0] == "norm":
                put(base + ("norm",), ln_key[parts[1]], v)
            elif parts[0] == "mlp":
                put(base + (f"mlp_{parts[1]}",),
                    "kernel" if parts[2] == "weight" else "bias",
                    np.ascontiguousarray(v.T) if parts[2] == "weight" else v)
            elif parts[0] == "gamma":
                tree.setdefault(f"stage{si}_block{bi}", {})["gamma"] = v
    return tree
