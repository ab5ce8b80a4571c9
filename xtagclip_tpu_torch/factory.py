"""Model factory: config registry + tower assembly + seeded init
(port of the CLIP-family path of xtagclip_tpu/factory.py).

The built-in architecture JSONs are read by file path from the JAX
package's ``assets/model_configs``. As in the JAX factory, the
':'-separated directories of ``XTAGCLIP_EXTRA_CONFIGS`` are scanned after
them (a config there extends or overrides the built-in ones; a malformed
file there warns and is skipped, where a malformed built-in one raises),
and ``add_model_config`` registers a file over both. The variable is read
at each lookup, so a process may set it after import. Only ViT +
text-transformer configs are ported; other families raise
NotImplementedError.

``precision`` has the JAX package's meaning: parameters are fp32 masters
and ``"bf16"`` sets the compute dtype, to which every module casts its
weights at use (models/layers.py). The model comes back trainable, with
fp32 parameters. For serving, ``cast_for_compute`` casts the matmul
weights to the compute dtype once, so the casts at use cost nothing;
LayerNorm parameters, the logit scales and the biases of the transformer
blocks (which the fused kernels add in fp32, as the Pallas kernels do)
stay fp32. Both give the same arithmetic.

The model is built and initialized on ``device`` (default ``"cuda"``); a
missing card raises before anything is allocated.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import warnings
from pathlib import Path
from typing import Dict, Optional

import torch
from torch import nn

from xtagclip_tpu_torch.data.transforms import (
    PreprocessCfg,
    image_transform_eval,
    image_transform_train,
)
from xtagclip_tpu_torch.models.clip import CLIP
from xtagclip_tpu_torch.models.layers import LayerNorm, ResidualAttentionBlock
from xtagclip_tpu_torch.models.text import TextTransformer
from xtagclip_tpu_torch.models.vit import VisionTransformer
from xtagclip_tpu_torch.tokenize.bpe import SimpleTokenizer
from xtagclip_tpu_torch.utils.assets import asset_path

_EXTRA_CONFIGS: Dict[str, dict] = {}


def _builtin_config(name: str) -> Optional[dict]:
    path = asset_path("model_configs") / f"{name}.json"
    if not path.exists():
        return None
    with open(path) as f:
        return json.load(f)


def _user_config(name: str) -> Optional[dict]:
    """``name`` from the XTAGCLIP_EXTRA_CONFIGS directories (the last one
    that has it wins, as in the JAX scan), with the nested ``model_cfg``
    schema flattened; None if no directory has a valid one."""
    found = None
    for d in os.environ.get("XTAGCLIP_EXTRA_CONFIGS", "").split(":"):
        path = Path(d) / f"{name}.json" if d else None
        if path is None or not path.is_file():
            continue
        try:
            with open(path) as f:
                cfg = json.load(f)
        except (OSError, ValueError) as e:
            warnings.warn(f"XTAGCLIP_EXTRA_CONFIGS: skipping {path}: {e}")
            continue
        if "model_cfg" in cfg:  # nested schema (e.g. BiomedCLIP hub cfg)
            cfg = dict(cfg["model_cfg"],
                       preprocess_cfg=cfg.get("preprocess_cfg", {}))
        if all(k in cfg for k in ("embed_dim", "vision_cfg", "text_cfg")):
            found = cfg
    return found


def get_model_config(model_name: str) -> Optional[dict]:
    cfg = (_EXTRA_CONFIGS.get(model_name) or _user_config(model_name)
           or _builtin_config(model_name))
    return json.loads(json.dumps(cfg)) if cfg is not None else None


def add_model_config(path) -> None:
    """Register a config JSON under its file stem (as the JAX factory)."""
    path = Path(path)
    with open(path) as f:
        _EXTRA_CONFIGS[path.stem] = json.load(f)


def get_cast_dtype(precision: str) -> torch.dtype:
    if precision == "bf16":
        return torch.bfloat16
    if precision == "fp32":
        return torch.float32
    raise NotImplementedError(f"precision {precision!r} is not ported yet")


def resolve_device(device) -> torch.device:
    """The device a model is built on; a CUDA device needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def _vision_tower(embed_dim, v, act, dtype):
    if v.get("timm_model_name") or isinstance(v.get("layers"), (list, tuple)):
        raise NotImplementedError("timm and ResNet towers are not ported yet")
    known = {"image_size", "patch_size", "width", "layers", "head_width",
             "mlp_ratio", "norm_kwargs"}
    return VisionTransformer(
        image_size=v.get("image_size", 224), patch_size=v.get("patch_size", 16),
        width=v.get("width", 768), layers=v.get("layers", 12),
        heads=v.get("width", 768) // v.get("head_width", 64),
        mlp_ratio=v.get("mlp_ratio", 4.0), output_dim=embed_dim, act=act,
        norm_eps=(v.get("norm_kwargs") or {}).get("eps", 1e-5), dtype=dtype,
        **{k: val for k, val in v.items() if k not in known})


def _text_tower(embed_dim, t, act, dtype):
    if t.get("hf_model_name"):
        raise NotImplementedError("HF text towers are not ported yet")
    known = {"context_length", "vocab_size", "width", "heads", "layers",
             "mlp_ratio", "norm_kwargs"}
    return TextTransformer(
        context_length=t.get("context_length", 77),
        vocab_size=t.get("vocab_size", 49408), width=t.get("width", 512),
        heads=t.get("heads", 8), layers=t.get("layers", 12),
        mlp_ratio=t.get("mlp_ratio", 4.0), output_dim=embed_dim, act=act,
        norm_eps=(t.get("norm_kwargs") or {}).get("eps", 1e-5), dtype=dtype,
        **{k: val for k, val in t.items() if k not in known})


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with flax's distributions: each module initializes its
    own direct parameters (lecun-normal Dense kernels, zero biases,
    normal(width^-0.5) cls/pos/proj, normal(1.0) tag labels, ...)."""
    for m in model.modules():
        if hasattr(m, "init_params"):
            m.init_params(generator)


@torch.no_grad()
def cast_for_compute(model: nn.Module, dtype: torch.dtype) -> None:
    """Cast the matmul weights to the compute dtype, once, for serving
    (module doc). The model then holds no fp32 masters to train."""
    keep = {id(p) for m in model.modules() if isinstance(m, LayerNorm)
            for p in m.parameters()}
    keep |= {id(p) for m in model.modules()
             if isinstance(m, ResidualAttentionBlock)
             for p in (m.attn.in_proj.bias, m.attn.out_proj.bias,
                       m.mlp.c_fc.bias, m.mlp.c_proj.bias)}
    keep |= {id(p) for name, p in model.named_parameters()
             if name.endswith("logit_scale")}
    for p in model.parameters():
        if id(p) not in keep:
            p.data = p.data.to(dtype)


def create_model(model_name: str, precision: str = "fp32", device="cuda",
                 use_tagging: bool = False,
                 use_fusion: bool = False, init_seed: int = 0,
                 **model_kwargs) -> CLIP:
    """Build a CLIP/XTag model with seeded random init on ``device``."""
    dev = resolve_device(device)
    cfg = get_model_config(model_name.replace("/", "-"))
    if cfg is None:
        raise RuntimeError(f"Model config for {model_name} not found")
    for k, v in model_kwargs.items():
        if k in ("vision_cfg", "text_cfg") and isinstance(v, dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    if "multimodal_cfg" in cfg:
        raise NotImplementedError("CoCa models are not ported yet")
    unported = {"init_logit_bias", "nonscalar_logit_scale"} & set(cfg)
    if unported:
        raise NotImplementedError(f"config keys not ported yet: {unported}")
    act = "quick_gelu" if cfg.get("quick_gelu") else "gelu"
    dtype = get_cast_dtype(precision)
    with dev:
        model = CLIP(
            _vision_tower(cfg["embed_dim"], cfg["vision_cfg"], act, dtype),
            _text_tower(cfg["embed_dim"], cfg["text_cfg"], act, dtype),
            embed_dim=cfg["embed_dim"], use_tagging=use_tagging,
            use_fusion=use_fusion, fusion_dim=cfg.get("fusion_dim", 512),
            init_logit_scale=cfg.get("init_logit_scale",
                                     math.log(1 / 0.07)),
            dtype=dtype)
    init_params(model, torch.Generator(device=dev).manual_seed(init_seed))
    model.model_name = model_name
    model.model_cfg = cfg
    return model


def create_model_and_transforms(model_name: str, pretrained=None,
                                precision: str = "fp32", device="cuda",
                                image_mean=None, image_std=None,
                                image_interpolation=None,
                                image_resize_mode=None, aug_cfg=None,
                                **kwargs):
    """(model, train transform, eval transform). Both transforms yield
    uint8 HWC crops; normalize them on the device with
    ops.preprocess.normalize_images. ``pretrained`` is a local
    open_clip-layout .pt file (convert/loader.py); named tags are not
    ported. The preprocess config is kept on the model
    (``get_model_preprocess_cfg``), for a serving artifact's manifest."""
    model = create_model(model_name, precision=precision, device=device,
                         **kwargs)
    if pretrained:
        if not Path(pretrained).is_file():
            raise NotImplementedError(
                f"pretrained {pretrained!r}: only a local .pt file is ported; "
                "named tags wait for pretrained.py (ROADMAP Queue 1 item 9)")
        from xtagclip_tpu_torch.convert.loader import load_checkpoint_into

        load_checkpoint_into(model, str(pretrained))
    pp = PreprocessCfg(
        size=model.model_cfg["vision_cfg"].get("image_size", 224),
        mean=image_mean, std=image_std,
        interpolation=image_interpolation or "bicubic",
        resize_mode=image_resize_mode or "shortest")
    set_model_preprocess_cfg(model, dataclasses.asdict(pp))
    return model, image_transform_train(pp, aug_cfg=aug_cfg), \
        image_transform_eval(pp)


def get_model_preprocess_cfg(model) -> dict:
    """The preprocess config kept on a model (JAX factory.py:455), with
    its image size filled in."""
    pp = dict(getattr(model, "preprocess_cfg", None) or {})
    pp.setdefault("size", model.model_cfg["vision_cfg"].get("image_size", 224))
    return pp


def set_model_preprocess_cfg(model, preprocess_cfg: dict) -> None:
    """Keep ``preprocess_cfg`` on the model (JAX factory.py:464)."""
    model.preprocess_cfg = dict(preprocess_cfg)


@torch.no_grad()
def load_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Load weights into a built model in place (JAX factory.py:519): one
    of the port's own checkpoint tags (a directory holding
    train/checkpoint.py's ``state.pt``, or that file) loads its
    ``state["model"]``; any other file goes through the open_clip loader
    (convert/loader.py). As in JAX (strict=False), a parameter the
    checkpoint lacks keeps its value and an extra one is ignored; both are
    logged."""
    from xtagclip_tpu_torch.train.checkpoint import STATE_FILE

    path = str(path)
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    if os.path.basename(path) != STATE_FILE:
        from xtagclip_tpu_torch.convert.loader import load_checkpoint_into

        return load_checkpoint_into(model, path)
    tree = torch.load(path, map_location="cpu", weights_only=True)
    result = model.load_state_dict(tree["state"]["model"], strict=False)
    if result.missing_keys or result.unexpected_keys:
        logging.info("checkpoint %s: %d parameters kept (%s), %d ignored "
                     "(%s)", path, len(result.missing_keys),
                     result.missing_keys[:5], len(result.unexpected_keys),
                     result.unexpected_keys[:5])
    return model


def get_tokenizer(model_name: str = ""):
    cfg = get_model_config(model_name) if model_name else None
    text_cfg = (cfg or {}).get("text_cfg", {})
    if text_cfg.get("hf_tokenizer_name"):
        raise NotImplementedError("HF tokenizers are not ported yet")
    return SimpleTokenizer(
        context_length=text_cfg.get("context_length", 77),
        **(text_cfg.get("tokenizer_kwargs") or {}))
