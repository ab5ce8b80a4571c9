"""timm-style ViT trunk + the XTag ``TimmModel`` head (the BiomedCLIP image
tower); port of xtagclip_tpu/models/timm_vit.py.

timm's ``vit_*`` structure: a biased patch-embed Dense over (p, p, c)
ordered patches, a class token, a position table that includes it,
pre-norm blocks with a fused biased qkv, LayerNorm eps 1e-6 and a final
norm. ``TimmModel`` pools (``""``/``"avg"``: the mean over ALL tokens, the
class token included; ``"cls"``/``"token"``: token 0; ``"map"``: SigLIP's
attention-pool latent), then applies its linear/mlp head to the pooled
feature AND to every token, returning (projected, projected tokens).

JAX runs these towers through XLA (the timm L = 197 is not lane-aligned
for its flash kernel, and its MLP is a plain Dense pair), so here they are
plain PyTorch on every device: attention is models/layers.py's
``attention`` (fp32 scores and softmax), the MLP two Dense products with
the exact gelu. Variants (timm_vit.py:75-88): no class token + ``fc_norm``
(the ``*_gap_*`` models), ``relpos`` (a per-model relative-position bias,
no absolute table), ``conv_stem`` (MobileCLIP-B's 3-conv stem).
``grad_checkpointing`` checkpoints each trunk block while grad is on, as
the port's ``Transformer`` does (JAX's builder takes ``remat`` and leaves
it unused; the recompute draws no random numbers, so the numbers are the
same).

Every name ``_TIMM_VIT_RE`` matches builds here, with the two named
medium variants and ``vit_base_mci_224``. ``build_timm_vision_tower``
routes the other timm families as JAX's does (timm_vit.py:314-350):
``convnext*`` to models/convnext.py's tower, ``eva_*`` / ``eva02_*``,
``vitamin_*``, ``swin_*`` and ``fastvit_*`` to their trunks
(models/{eva,vitamin,swin,fastvit}.py) under this ``TimmModel`` head. The
trunk is called with the forward's generator: FastViT's BatchNorms take
their batch statistics under one; no other trunk draws on it.
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
    attention,
    gelu_exact,
    local_heads,
    run_blocks,
    tp_input,
)


class TimmBlock(nn.Module):
    tp_size = 1  # the model size, once parallel/sharding.py splits it

    def __init__(self, width: int, num_heads: int, mlp_ratio: float = 4.0,
                 norm_eps: float = 1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm(width, norm_eps)
        self.qkv = Dense(width, 3 * width)
        self.proj = Dense(width, width)
        self.norm2 = LayerNorm(width, norm_eps)
        self.fc1 = Dense(width, int(width * mlp_ratio))
        self.fc2 = Dense(int(width * mlp_ratio), width)

    def forward(self, x, attn_bias=None):
        q, k, v = self.qkv(tp_input(self, self.norm1(x))).chunk(3, dim=-1)
        x = x + self.proj(attention(q, k, v, local_heads(self, self.num_heads),
                                    mask=attn_bias))
        h = tp_input(self, self.norm2(x))
        return x + self.fc2(gelu_exact(self.fc1(h)))


class RelPosBias(nn.Module):
    """timm vit_relpos-style bias with class-token entries: a
    (2g-1)^2 + 3 row table (cls->all, all->cls, cls->cls), read through a
    fixed [N+1, N+1] index into [1, heads, N+1, N+1]."""

    def __init__(self, grid: int, num_heads: int):
        super().__init__()
        g = grid
        coords = np.stack(np.meshgrid(np.arange(g), np.arange(g),
                                      indexing="ij")).reshape(2, -1)
        rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
        rel = rel + (g - 1)
        idx = rel[..., 0] * (2 * g - 1) + rel[..., 1]
        n, size = g * g, (2 * g - 1) ** 2
        full = np.zeros((n + 1, n + 1), np.int64)
        full[1:, 1:] = idx
        full[0, :] = size       # cls -> all
        full[:, 0] = size + 1   # all -> cls
        full[0, 0] = size + 2   # cls -> cls
        self.table = nn.Parameter(torch.empty(size + 3, num_heads))
        self.register_buffer("index", torch.from_numpy(full),
                             persistent=False)

    def init_params(self, generator):
        nn.init.normal_(self.table, 0.0, 0.02, generator=generator)

    def forward(self):
        return self.table[self.index].permute(2, 0, 1)[None]


class TimmViT(nn.Module):
    """timm ViT trunk: images -> [B, (1+)N, D] tokens, final-normed."""

    def __init__(self, image_size=224, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, mlp_ratio: float = 4.0,
                 norm_eps: float = 1e-6, use_cls_token: bool = True,
                 use_abs_pos: bool = True, final_norm: bool = True,
                 relpos: bool = False, conv_stem: bool = False,
                 dtype: torch.dtype = torch.float32,
                 grad_checkpointing: bool = False):
        super().__init__()
        self.grad_checkpointing = grad_checkpointing
        ih, iw = (tuple(image_size) if isinstance(image_size, (list, tuple))
                  else (image_size, image_size))
        self.patch_size = patch_size
        self.width = width
        self.dtype = dtype
        self.use_cls_token = use_cls_token
        self.conv_stem = conv_stem
        gh, gw = ih // patch_size, iw // patch_size
        if conv_stem:  # strides (4, 2, 2): a /16 grid, flax's SAME padding
            chans = (3, width // 6, width // 3, width)
            self.stem = nn.ModuleList(
                Conv2d(chans[i], chans[i + 1], 3, s, "SAME", bias=True)
                for i, s in enumerate((4, 2, 2)))
        else:
            self.patch_embed = Dense(patch_size * patch_size * 3, width)
        if use_cls_token:
            self.cls_token = nn.Parameter(torch.empty(1, 1, width))
        if use_abs_pos:
            self.pos_embed = nn.Parameter(
                torch.empty(gh * gw + int(use_cls_token), width))
        else:
            self.pos_embed = None
        self.relpos = RelPosBias(gh, heads) if relpos else None
        self.blocks = nn.ModuleList(
            TimmBlock(width, heads, mlp_ratio, norm_eps) for _ in range(layers))
        self.norm = LayerNorm(width, norm_eps) if final_norm else None

    def init_params(self, generator):
        if self.use_cls_token:
            nn.init.zeros_(self.cls_token)
        if self.pos_embed is not None:
            nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)

    def forward(self, x, generator=None):
        b, hh, ww, c = x.shape
        p = self.patch_size
        gh, gw = hh // p, ww // p
        x = x.to(self.dtype)
        if self.conv_stem:
            x = x.permute(0, 3, 1, 2)
            for i, conv in enumerate(self.stem):
                x = conv(x)
                if i < 2:
                    x = gelu_exact(x)
            x = x.flatten(2).transpose(1, 2)
        else:
            # valid-padding patchify: a remainder past a patch multiple drops
            x = x[:, :gh * p, :gw * p]
            x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
            x = self.patch_embed(x.reshape(b, gh * gw, p * p * c))
        if self.use_cls_token:
            x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, -1), x],
                          dim=1)
        if self.pos_embed is not None:
            x = x + self.pos_embed.to(x.dtype)[None]
        bias = self.relpos() if self.relpos is not None else None
        x = run_blocks(self.blocks, x, self.grad_checkpointing, bias)
        return self.norm(x) if self.norm is not None else x


class MapPool(nn.Module):
    """timm's AttentionPoolLatent (SigLIP's ``map`` pool): one learned
    latent query over the tokens, proj, then LN + a residual MLP."""

    tp_size = 1  # the model size, once parallel/sharding.py splits it

    def __init__(self, width: int, num_heads: int, mlp_ratio: float = 4.0,
                 norm_eps: float = 1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.latent = nn.Parameter(torch.empty(1, 1, width))
        self.q = Dense(width, width)
        self.kv = Dense(width, 2 * width)
        self.proj = Dense(width, width)
        self.norm = LayerNorm(width, norm_eps)
        self.mlp_fc1 = Dense(width, int(width * mlp_ratio))
        self.mlp_fc2 = Dense(int(width * mlp_ratio), width)

    def init_params(self, generator):
        nn.init.normal_(self.latent, 0.0, self.latent.shape[-1] ** -0.5,
                        generator=generator)

    def forward(self, tokens):
        b = tokens.shape[0]
        latent = tp_input(self, self.latent.to(tokens.dtype))
        q = self.q(latent.expand(b, 1, -1))
        k, v = self.kv(tp_input(self, tokens)).chunk(2, dim=-1)
        x = self.proj(attention(q, k, v, local_heads(self, self.num_heads)))
        h = tp_input(self, self.norm(x))
        h = self.mlp_fc2(gelu_exact(self.mlp_fc1(h)))
        return (x + h)[:, 0]


class TimmModel(nn.Module):
    """A trunk + pool + projection head with the (pooled, tokens) contract
    (timm_vit.py:204-297)."""

    def __init__(self, trunk: nn.Module, width: int, embed_dim: int,
                 heads: int = 12, pool: str = "avg", proj: str = "linear",
                 proj_bias: bool = False, fc_norm: bool = False,
                 map_mlp_ratio: float = 4.0):
        super().__init__()
        self.trunk = trunk
        self.pool = pool
        self.proj = proj
        if pool == "map":
            self.attn_pool = MapPool(width, heads, map_mlp_ratio)
        self.fc_norm = LayerNorm(width, 1e-6) if fc_norm else None
        if proj == "linear":
            self.head_proj = Dense(width, embed_dim, bias=proj_bias)
        elif proj == "mlp":
            self.head_mlp_fc1 = Dense(width, 2 * embed_dim)
            self.head_mlp_fc2 = Dense(2 * embed_dim, embed_dim, bias=proj_bias)
        elif proj in (None, "none", ""):
            # a timm clip trunk carries its own classifier head
            self.trunk_head = (Dense(width, embed_dim) if width != embed_dim
                               else None)
        else:
            raise ValueError(f"unknown timm proj {proj!r}")

    def _head(self, t):
        if self.proj == "linear":
            return self.head_proj(t)
        if self.proj == "mlp":
            return self.head_mlp_fc2(gelu_exact(self.head_mlp_fc1(t)))
        return self.trunk_head(t) if self.trunk_head is not None else t

    def forward(self, x, generator=None):
        """[B, H, W, 3] -> (pooled [B, E], tokens [B, L, E]). The
        ``generator`` (training) reaches the trunk (module doc)."""
        tokens = self.trunk(x, generator)
        if self.pool in ("cls", "token"):
            pooled = tokens[:, 0]
        elif self.pool == "map":
            pooled = self.attn_pool(tokens)
        else:  # "", "avg": the mean over ALL tokens, in fp32 as jnp.mean
            pooled = tokens.float().mean(dim=1).to(tokens.dtype)
        if self.fc_norm is not None:
            pooled, tokens = self.fc_norm(pooled), self.fc_norm(tokens)
        return self._head(pooled), self._head(tokens)


_TIMM_VIT_RE = re.compile(
    r"vit_(tiny|small|base|large|huge|so400m)_patch(\d+)(?:_\w+)*_(\d+)")
_VIT_DIMS = {
    "tiny": (192, 12, 3), "small": (384, 12, 6), "base": (768, 12, 12),
    "large": (1024, 24, 16), "huge": (1280, 32, 16),
    "so400m": (1152, 27, 16),
}


def build_timm_vision_tower(embed_dim: int, vision_cfg: dict,
                            dtype: torch.dtype = torch.float32,
                            grad_checkpointing: bool = False) -> TimmModel:
    """The tower of a ``timm_model_name`` config (timm_vit.py:315-408)."""
    name = vision_cfg["timm_model_name"]
    image_size = vision_cfg.get("image_size", 224)
    pool = vision_cfg.get("timm_pool", "avg")
    proj = vision_cfg.get("timm_proj", "linear")
    proj_bias = vision_cfg.get("timm_proj_bias", False)

    def wrap(trunk, width, **kw):
        return TimmModel(trunk, width, embed_dim,
                         pool=pool if pool is not None else "avg", proj=proj,
                         proj_bias=proj_bias, **kw)

    def vit(**kw):
        return TimmViT(image_size=image_size, dtype=dtype,
                       grad_checkpointing=grad_checkpointing, **kw)

    if name.startswith("convnext"):
        from xtagclip_tpu_torch.models.convnext import build_convnext_tower

        return build_convnext_tower(embed_dim, vision_cfg, dtype)
    if name.startswith(("eva_", "eva02_")):
        from xtagclip_tpu_torch.models.eva import EVA_CONFIGS, EvaTrunk

        if name not in EVA_CONFIGS:
            raise NotImplementedError(f"unknown EVA variant {name!r}")
        cfg = EVA_CONFIGS[name]
        return wrap(EvaTrunk(image_size=image_size, dtype=dtype,
                             grad_checkpointing=grad_checkpointing, **cfg),
                    cfg["width"])
    if name.startswith("vitamin_"):
        from xtagclip_tpu_torch.models.vitamin import (
            ViTaminTrunk,
            vitamin_config,
        )

        cfg = vitamin_config(name)
        return wrap(ViTaminTrunk(image_size=image_size, dtype=dtype,
                                 grad_checkpointing=grad_checkpointing,
                                 **cfg), cfg["width"])
    if name.startswith("swin_"):
        from xtagclip_tpu_torch.models.swin import SwinTrunk

        # swin_base_patch4_window7_224 is the only registry config
        return wrap(SwinTrunk(image_size=image_size, dtype=dtype), 8 * 128)
    if name.startswith("fastvit_"):
        from xtagclip_tpu_torch.models.fastvit import (
            FASTVIT_CONFIGS,
            FastVitTrunk,
        )

        if name not in FASTVIT_CONFIGS:
            raise NotImplementedError(f"unknown FastViT variant {name!r}")
        cfg = FASTVIT_CONFIGS[name]
        return wrap(FastVitTrunk(dtype=dtype, **cfg), 2 * cfg["dims"][-1])
    if name == "vit_base_mci_224":  # MobileCLIP-B image tower
        return wrap(vit(patch_size=16, width=768, layers=12, heads=12,
                        conv_stem=True), 768)
    if name == "vit_medium_patch16_gap_256":
        return wrap(vit(patch_size=16, width=512, layers=12, heads=8,
                        use_cls_token=False, final_norm=False), 512,
                    fc_norm=True)
    if name == "vit_relpos_medium_patch16_cls_224":
        return wrap(vit(patch_size=16, width=512, layers=12, heads=8,
                        use_abs_pos=False, relpos=True), 512)
    m = _TIMM_VIT_RE.match(name)
    if not m:
        raise NotImplementedError(f"timm model {name!r} not supported natively")
    size, patch = m.group(1), int(m.group(2))
    width, layers, heads = _VIT_DIMS[size]
    if "_siglip" in name:
        # no class token, the MAP head, and so400m's hidden 4304 at width
        # 1152 (3.7362 floors to it where 4304/1152 may not)
        ratio = 3.7362 if size == "so400m" else 4.0
        trunk = vit(patch_size=patch, width=width, layers=layers, heads=heads,
                    mlp_ratio=ratio, use_cls_token=False)
        return TimmModel(trunk, width, embed_dim, heads=heads,
                         pool=pool or "map", proj=proj, proj_bias=proj_bias,
                         map_mlp_ratio=ratio)
    trunk = vit(patch_size=patch, width=width, layers=layers, heads=heads)
    return TimmModel(trunk, width, embed_dim, heads=heads,
                     pool=pool or "avg", proj=proj, proj_bias=proj_bias)
