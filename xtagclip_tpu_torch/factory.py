"""Model factory: config registry + tower assembly + seeded init
(port of the CLIP-family path of xtagclip_tpu/factory.py).

The built-in architecture JSONs are read by file path from the JAX
package's ``assets/model_configs``. As in the JAX factory, the
':'-separated directories of ``XTAGCLIP_EXTRA_CONFIGS`` are scanned after
them (a config there extends or overrides the built-in ones; a malformed
file there warns and is skipped, where a malformed built-in one raises),
and ``add_model_config`` registers a file over both. The variable is read
at each lookup, so a process may set it after import. A config in
open_clip's hub schema (``model_cfg`` + ``preprocess_cfg``, as
BiomedCLIP's) is flattened, as JAX's scan flattens it.

The towers are routed as JAX's ``_build_vision_tower`` and
``_build_text_tower`` route them (factory.py:166-260): a
``timm_model_name`` builds models/timm_vit.py's tower, list-valued
``layers`` the ModifiedResNet (models/resnet.py), an ``hf_model_name`` the
HF text tower (models/hf_text.py); everything else the ViT and the text
transformer. A ``multimodal_cfg`` builds CoCa (models/coca.py) around the
two towers, as JAX's factory does (factory.py:333-356). All 117 built-in
configs build, the zoo's timm and HF families included.

``precision`` has the JAX package's meaning (factory.py:106-115,
311-315): ``"bf16"`` sets the compute dtype over fp32 master parameters,
to which every module casts its weights at use (models/layers.py);
``"pure_bf16"`` makes the parameters themselves bf16, biases, BatchNorms
and logit scales included (JAX's ``param_dtype``); the LayerNorms keep
fp32 parameters, as JAX's ``LayerNorm`` module does (layers.py:44-61; only
its TPU fused halves declare them in ``param_dtype``). The kernels' fp32
bias operands are upcast at the call, which is exact, and AdamW steps the
bf16 parameters, as optax does; ``"fp16"`` and ``"pure_fp16"``
compute in float16, which no kernel takes, so they run the plain versions
on the CPU and raise on the card. The model comes back trainable. For
serving, ``cast_for_compute`` casts the matmul weights to the compute
dtype once, so the casts at use cost nothing;
LayerNorm parameters (CoCa's pooler and cross-attention ``ln_1_kv``
included), the logit scales and the biases of the transformer blocks
(which the fused kernels add in fp32, as the Pallas kernels do; CoCa's
cross-attention blocks too) stay fp32. Both give the same arithmetic.

The model is built and initialized on ``device`` (default ``"cuda"``); a
missing card raises before anything is allocated. ``pretrained`` then
loads weights as JAX's ``create_model`` resolves them (factory.py:428-450,
``load_pretrained``): a registry tag, a URL or an ``hf-hub:`` id through
pretrained.py, ``"openai"`` through convert/openai.py, a local file or a
port checkpoint tag through ``load_checkpoint``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
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
from xtagclip_tpu_torch.models.coca import CoCa, MultimodalTransformer
from xtagclip_tpu_torch.models.hf_text import HFTextEncoder
from xtagclip_tpu_torch.models.layers import (
    BatchNorm,
    Dense,
    LayerNorm,
    ResidualAttentionBlock,
)
from xtagclip_tpu_torch.models.resnet import ModifiedResNet
from xtagclip_tpu_torch.models.text import TextTransformer
from xtagclip_tpu_torch.models.timm_vit import (
    TimmModel,
    build_timm_vision_tower,
)
from xtagclip_tpu_torch.models.vit import VisionTransformer
from xtagclip_tpu_torch.tokenize.bpe import SimpleTokenizer
from xtagclip_tpu_torch.utils.assets import asset_path

_EXTRA_CONFIGS: Dict[str, dict] = {}


def _flatten_hub_schema(cfg: dict) -> dict:
    """open_clip's hub schema (``model_cfg`` + ``preprocess_cfg``) as one
    flat config (JAX factory.py:54-57)."""
    if "model_cfg" in cfg:
        cfg = dict(cfg["model_cfg"], preprocess_cfg=cfg.get("preprocess_cfg", {}))
    return cfg


def _builtin_config(name: str) -> Optional[dict]:
    path = asset_path("model_configs") / f"{name}.json"
    if not path.exists():
        return None
    with open(path) as f:
        return _flatten_hub_schema(json.load(f))


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
        cfg = _flatten_hub_schema(cfg)
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
        register_model_config(path.stem, json.load(f))


def register_model_config(name: str, cfg: dict) -> None:
    """Register ``cfg`` under ``name``, over the files' configs."""
    _EXTRA_CONFIGS[name] = cfg


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t
            for t in re.split(r"(\d+)", s.lower())]


def _valid_names(directory, strict: bool) -> list:
    """The stems of the JSONs in ``directory`` that hold a model config
    (``embed_dim``, ``vision_cfg``, ``text_cfg``, after the hub schema is
    flattened), as JAX's ``_scan_config_dir`` keeps them."""
    names = []
    for f in sorted(Path(directory).glob("*.json")):
        try:
            with open(f) as fh:
                cfg = _flatten_hub_schema(json.load(fh))
        except (OSError, ValueError):
            if strict:
                raise
            continue
        if all(k in cfg for k in ("embed_dim", "vision_cfg", "text_cfg")):
            names.append(f.stem)
    return names


def list_builtin_models() -> list:
    """The shipped configs' names in natural order (JAX factory.py:87)."""
    return sorted(_valid_names(asset_path("model_configs"), strict=True),
                  key=_natural_key)


def list_models() -> list:
    """Every name ``create_model`` takes, as JAX's registry lists them
    (factory.py:60-84): the shipped configs and those of the
    XTAGCLIP_EXTRA_CONFIGS directories in natural order, then the names
    ``add_model_config`` registered beside them, in registration order."""
    names = set(list_builtin_models())
    for d in os.environ.get("XTAGCLIP_EXTRA_CONFIGS", "").split(":"):
        if d and os.path.isdir(d):
            names.update(_valid_names(d, strict=False))
    out = sorted(names, key=_natural_key)
    return out + [n for n in _EXTRA_CONFIGS if n not in names]


_CAST_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
                "pure_bf16": torch.bfloat16, "fp16": torch.float16,
                "pure_fp16": torch.float16}


def get_cast_dtype(precision: str) -> torch.dtype:
    """The compute dtype of ``precision`` (module doc)."""
    if precision not in _CAST_DTYPES:
        raise NotImplementedError(
            f"precision {precision!r} is not ported yet (one of "
            f"{sorted(_CAST_DTYPES)})")
    return _CAST_DTYPES[precision]


def get_input_dtype(precision: str) -> torch.dtype:
    """The dtype a model's normalized images take (JAX factory.py:113)."""
    return get_cast_dtype(precision)




def resolve_device(device) -> torch.device:
    """The device a model is built on; a CUDA device needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def vision_tower_type(v: dict) -> type:
    """The class of the vision tower of ``vision_cfg`` ``v``, picked on
    the keys JAX's ``_build_vision_tower`` picks it on."""
    if v.get("timm_model_name"):
        return TimmModel
    if isinstance(v.get("layers"), (list, tuple)):
        return ModifiedResNet
    return VisionTransformer


def text_tower_type(t: dict) -> type:
    """The class of the text tower of ``text_cfg`` ``t``."""
    return HFTextEncoder if t.get("hf_model_name") else TextTransformer


def _vision_tower(embed_dim, v, act, dtype, grad_checkpointing=False):
    """The vision tower of ``vision_cfg`` ``v``, reading the keys JAX's
    ``_build_vision_tower`` reads (factory.py:166-222); others are ignored,
    as there."""
    kind = vision_tower_type(v)
    if kind is TimmModel:
        return build_timm_vision_tower(embed_dim, v, dtype,
                                       grad_checkpointing)
    if kind is ModifiedResNet:
        return ModifiedResNet(
            tuple(v["layers"]), output_dim=embed_dim,
            heads=v.get("width", 64) * 32 // v.get("head_width", 64),
            image_size=v.get("image_size", 224), width=v.get("width", 64),
            dtype=dtype)
    return VisionTransformer(
        image_size=v.get("image_size", 224), patch_size=v.get("patch_size", 16),
        width=v.get("width", 768), layers=v.get("layers", 12),
        heads=v.get("width", 768) // v.get("head_width", 64),
        mlp_ratio=v.get("mlp_ratio", 4.0), output_dim=embed_dim, act=act,
        norm_eps=(v.get("norm_kwargs") or {}).get("eps", 1e-5), dtype=dtype,
        ls_init_value=v.get("ls_init_value"),
        patch_dropout=v.get("patch_dropout", 0.0),
        attentional_pool=v.get("attentional_pool", False),
        attn_pooler_queries=v.get("attn_pooler_queries", 256),
        attn_pooler_heads=v.get("attn_pooler_heads", 8),
        pos_embed_type=v.get("pos_embed_type", "learnable"),
        no_ln_pre=v.get("no_ln_pre", False),
        final_ln_after_pool=v.get("final_ln_after_pool", False),
        pool_type=v.get("pool_type", "tok"),
        no_class_token=v.get("no_class_token", False),
        n_learnable_tokens=v.get("n_learnable_tokens", 0),
        insert_position=v.get("insert_position", 1),
        grad_checkpointing=grad_checkpointing)


def _text_tower(embed_dim, t, act, dtype, grad_checkpointing=False):
    """The text transformer of ``text_cfg`` ``t``, reading the keys JAX's
    ``_build_text_tower`` reads (factory.py:225-260)."""
    if text_tower_type(t) is HFTextEncoder:
        return HFTextEncoder(t["hf_model_name"], output_dim=embed_dim,
                             proj_type=t.get("hf_proj_type", "mlp"),
                             pooler_type=t.get("hf_pooler_type",
                                               "mean_pooler"),
                             dtype=dtype)
    return TextTransformer(
        context_length=t.get("context_length", 77),
        vocab_size=t.get("vocab_size", 49408), width=t.get("width", 512),
        heads=t.get("heads", 8), layers=t.get("layers", 12),
        mlp_ratio=t.get("mlp_ratio", 4.0), output_dim=embed_dim, act=act,
        norm_eps=(t.get("norm_kwargs") or {}).get("eps", 1e-5), dtype=dtype,
        ls_init_value=t.get("ls_init_value"),
        embed_cls=t.get("embed_cls", False),
        no_causal_mask=t.get("no_causal_mask", False),
        pad_id=t.get("pad_id", 0), pool_type=t.get("pool_type", "argmax"),
        proj_type=t.get("proj_type", "linear"),
        proj_bias=t.get("proj_bias", False),
        grad_checkpointing=grad_checkpointing)


def _text_decoder(cfg: dict, act: str) -> MultimodalTransformer:
    """CoCa's decoder from ``multimodal_cfg``, with the text config's
    vocabulary (JAX factory.py:333-345); its cross-attention reads the
    image embeddings, of the embed dim."""
    m = cfg["multimodal_cfg"]
    return MultimodalTransformer(
        width=m.get("width", 512), layers=m.get("layers", 12),
        heads=m.get("heads", 8), context_length=m.get("context_length", 76),
        mlp_ratio=m.get("mlp_ratio", 4.0),
        ls_init_value=m.get("ls_init_value"),
        output_dim=cfg["text_cfg"].get("vocab_size", 49408), act=act,
        kv_width=cfg["embed_dim"])


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
    keep |= {id(d.bias) for m in model.modules()
             if isinstance(m, ResidualAttentionBlock)
             for d in m.modules() if isinstance(d, Dense)}
    keep |= {id(p) for name, p in model.named_parameters()
             if name.endswith("logit_scale")}
    for p in model.parameters():
        if id(p) not in keep:
            p.data = p.data.to(dtype)


def create_model(model_name: str, pretrained: Optional[str] = None,
                 precision: str = "fp32", device="cuda",
                 use_tagging: bool = False,
                 use_fusion: bool = False, init_seed: int = 0,
                 grad_checkpointing: bool = False,
                 force_patch_dropout=None, skip_init: bool = False,
                 cache_dir: Optional[str] = None, use_bn_sync: bool = False,
                 **model_kwargs) -> CLIP:
    """Build a CLIP/XTag model with seeded random init on ``device``, then
    load ``pretrained`` if given (``load_pretrained``: a registry tag such
    as ``laion400m_e32`` or ``openai``, a URL, an ``hf-hub:`` id or a local
    file or checkpoint tag; ``cache_dir`` is where fetches are cached).
    An ``hf-hub:<org>/<name>`` model name is the config ``<name>``, which
    must ship in the registry, as in JAX (factory.py:287-306).
    ``grad_checkpointing`` checkpoints every block of both towers (JAX's
    ``remat``); ``force_patch_dropout`` overrides the vision config's
    ``patch_dropout`` (JAX's CLI passes it as a vision_cfg override);
    ``skip_init`` leaves the parameters uninitialized (JAX's, for a build
    whose weights come next, or on the ``meta`` device).
    ``use_bn_sync`` marks a ModifiedResNet tower's BatchNorms ``sync``,
    as JAX gives them ``bn_axis_name`` (factory.py:327); their statistics
    span every rank either way (models/layers.py ``BatchNorm``)."""
    if get_cast_dtype(precision) == torch.float16 and \
            torch.device(device).type == "cuda":
        raise NotImplementedError(
            f"precision {precision!r}: every kernel of the port is bf16, so "
            "float16 runs only on the CPU (its plain versions)")
    dev = resolve_device(device)
    hub_id = None
    if model_name.startswith("hf-hub:"):
        hub_id = model_name[len("hf-hub:"):]
        model_name = hub_id.split("/")[-1]
    model_name = model_name.replace("/", "-")
    cfg = get_model_config(model_name)
    if cfg is None:
        if hub_id is not None:
            raise RuntimeError(
                f"hf-hub model {hub_id!r} has no local config (looked for "
                f"{model_name!r} in the registry): nothing is fetched; "
                "register its open_clip_config.json with add_model_config")
        raise RuntimeError(f"Model config for {model_name} not found")
    for k, v in model_kwargs.items():
        if k in ("vision_cfg", "text_cfg") and isinstance(v, dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    if force_patch_dropout is not None:
        cfg["vision_cfg"]["patch_dropout"] = force_patch_dropout
    act = "quick_gelu" if cfg.get("quick_gelu") else "gelu"
    dtype = get_cast_dtype(precision)
    with dev:
        visual = _vision_tower(cfg["embed_dim"], cfg["vision_cfg"], act,
                               dtype, grad_checkpointing)
        if use_bn_sync and isinstance(visual, ModifiedResNet):
            for m in visual.modules():
                if isinstance(m, BatchNorm):
                    m.sync = True
        text = _text_tower(cfg["embed_dim"], cfg["text_cfg"], act, dtype,
                           grad_checkpointing)
        common = dict(init_logit_scale=cfg.get("init_logit_scale",
                                               math.log(1 / 0.07)),
                      init_logit_bias=cfg.get("init_logit_bias"),
                      dtype=dtype)
        if "multimodal_cfg" in cfg:
            model = CoCa(visual, text, _text_decoder(cfg, act),
                         embed_dim=cfg["embed_dim"], **common)
        else:
            model = CLIP(visual, text, embed_dim=cfg["embed_dim"],
                         use_tagging=use_tagging, use_fusion=use_fusion,
                         fusion_dim=cfg.get("fusion_dim", 512),
                         nonscalar_logit_scale=cfg.get(
                             "nonscalar_logit_scale", False), **common)
    if not skip_init:
        init_params(model, torch.Generator(device=dev).manual_seed(init_seed))
    if precision.startswith("pure_"):  # JAX's param_dtype (factory.py:311)
        keep = {id(p) for m in model.modules() if isinstance(m, LayerNorm)
                for p in m.parameters()}
        for p in model.parameters():
            if id(p) not in keep:
                p.data = p.data.to(dtype)
    model.model_name = model_name
    model.model_cfg = cfg
    if pretrained:
        load_pretrained(model, pretrained, cache_dir)
    return model


def load_pretrained(model: nn.Module, pretrained: str,
                    cache_dir: Optional[str] = None) -> nn.Module:
    """Load ``pretrained`` into a built model in place, resolved as JAX's
    ``create_model`` resolves it (factory.py:428-450): ``"openai"`` through
    the registry to an OpenAI archive (convert/openai.py), an existing
    path as it is (``load_checkpoint``), anything else through
    ``pretrained.resolve_pretrained`` (a tag of the model's registry
    entries, a URL or an ``hf-hub:`` id, fetched into ``cache_dir`` or
    found in the hub cache). As in JAX, the registry's ``quick_gelu`` is
    not applied: the activation is the model config's (ROADMAP Queue 3)."""
    from xtagclip_tpu_torch.pretrained import resolve_pretrained

    if pretrained == "openai":
        from xtagclip_tpu_torch.convert.loader import load_state_dict_into
        from xtagclip_tpu_torch.convert.openai import load_openai_state_dict

        path = resolve_pretrained(model.model_name, pretrained, cache_dir)
        return load_state_dict_into(model, load_openai_state_dict(path),
                                    path)
    if not os.path.exists(pretrained):
        pretrained = resolve_pretrained(model.model_name, pretrained,
                                        cache_dir)
    return load_checkpoint(model, pretrained)


def create_model_and_transforms(model_name: str, pretrained=None,
                                precision: str = "fp32", device="cuda",
                                image_mean=None, image_std=None,
                                image_interpolation=None,
                                image_resize_mode=None, aug_cfg=None,
                                **kwargs):
    """(model, train transform, eval transform). Both transforms yield
    uint8 HWC crops; normalize them on the device with
    ops.preprocess.normalize_images with ``transforms.image_mean_std``.
    ``pretrained`` (and ``cache_dir`` among ``kwargs``) is
    ``create_model``'s: a registry tag, URL, ``hf-hub:`` id, local
    open_clip ``.pt`` / ``.bin`` / ``.safetensors``, big_vision ``.npz``
    or port checkpoint tag. The
    preprocess config is kept on the model (``get_model_preprocess_cfg``),
    for a serving artifact's manifest and the device normalize."""
    model = create_model(model_name, pretrained, precision=precision,
                         device=device, **kwargs)
    pp = PreprocessCfg(
        size=model.model_cfg["vision_cfg"].get("image_size", 224),
        mean=image_mean, std=image_std,
        interpolation=image_interpolation or "bicubic",
        resize_mode=image_resize_mode or "shortest")
    set_model_preprocess_cfg(model, dataclasses.asdict(pp))
    return model, image_transform_train(pp, aug_cfg=aug_cfg), \
        image_transform_eval(pp)


def create_model_from_pretrained(model_name: str, pretrained=None,
                                 **kwargs):
    """(model, eval transform) (JAX factory.py:527-541): an ``hf-hub:``
    name is read as its last part, a config that ships in the registry."""
    if model_name.startswith("hf-hub:"):
        model_name = model_name[len("hf-hub:"):].split("/")[-1]
    model, _, eval_t = create_model_and_transforms(model_name, pretrained,
                                                   **kwargs)
    return model, eval_t


def get_model_preprocess_cfg(model) -> dict:
    """The preprocess config kept on a model (JAX factory.py:455), with
    its image size filled in."""
    pp = dict(getattr(model, "preprocess_cfg", None) or {})
    pp.setdefault("size", model.model_cfg["vision_cfg"].get("image_size", 224))
    return pp


def set_model_preprocess_cfg(model, preprocess_cfg: dict) -> None:
    """Keep ``preprocess_cfg`` on the model (JAX factory.py:464)."""
    model.preprocess_cfg = dict(preprocess_cfg)


def get_model_tokenize_cfg(model) -> dict:
    """The text config's ``context_length`` and ``vocab_size`` (JAX
    factory.py:469-473): 76 tokens for CoCa, whose tower appends its
    class token after them."""
    t = model.model_cfg.get("text_cfg", {})
    return {k: t[k] for k in ("context_length", "vocab_size") if k in t}


def create_loss(args):
    """The training loss ``args`` pick, in JAX's order (factory.py:475-500):
    ``DistillClipLoss`` for a ``--distill-model``, CoCa's for a
    ``--model coca_*``, ``SigLipLoss`` for ``--siglip`` (its
    ``--loss-dist-impl`` kept), else ``ClipLoss``; all on one process."""
    from xtagclip_tpu_torch.losses import (
        ClipLoss,
        CoCaLoss,
        DistillClipLoss,
        SigLipLoss,
    )

    world = getattr(args, "world_size", 1)
    common = dict(local_loss=getattr(args, "local_loss", False),
                  gather_with_grad=getattr(args, "gather_with_grad", False),
                  cache_labels=True, rank=getattr(args, "rank", 0),
                  world_size=world)
    if getattr(args, "distill", None) or getattr(args, "distill_model", None):
        return DistillClipLoss(**common)
    if "coca" in getattr(args, "model", "").lower():
        return CoCaLoss(
            caption_loss_weight=getattr(args, "coca_caption_loss_weight", 2.0),
            clip_loss_weight=getattr(args, "coca_contrastive_loss_weight",
                                     1.0))
    if getattr(args, "siglip", False):
        return SigLipLoss(rank=common["rank"], world_size=world,
                          dist_impl=getattr(args, "loss_dist_impl", None))
    return ClipLoss(**common)


def list_openai_models() -> list:
    """The models with an ``openai`` tag in the registry (JAX
    factory.py:504)."""
    from xtagclip_tpu_torch.pretrained import list_pretrained_models_by_tag

    return list_pretrained_models_by_tag("openai")


def load_openai_model(name: str, precision: str = "fp32", **kwargs):
    """``create_model(name, pretrained="openai")`` (JAX factory.py:511):
    ``name`` is a registry model with an ``openai`` tag."""
    return create_model(name, pretrained="openai", precision=precision,
                        **kwargs)


@torch.no_grad()
def load_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Load weights into a built model in place (JAX factory.py:519): one
    of the port's own checkpoint tags (a directory holding
    train/checkpoint.py's ``state.pt``, or that file) loads its
    ``state["model"]``; any other file goes through convert/loader.py (an
    open_clip .pt, or a big_vision .npz). As in JAX (strict=False), a
    parameter the checkpoint lacks keeps its value and an extra one is
    ignored; both are logged. A position table of another length is
    resized, from any source (``--pretrained`` of a stage trained at
    another image size or context length)."""
    from xtagclip_tpu_torch.train.checkpoint import STATE_FILE

    path = str(path)
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    if os.path.basename(path) != STATE_FILE:
        from xtagclip_tpu_torch.convert.loader import load_checkpoint_into

        return load_checkpoint_into(model, path)
    from xtagclip_tpu_torch.convert.loader import load_state_into

    tree = torch.load(path, map_location="cpu", weights_only=True)
    return load_state_into(model, tree["state"]["model"], path)


def get_tokenizer(model_name: str = ""):
    """The model's tokenizer (JAX factory.py:570): its HF vocabulary
    (tokenize/hf.py, found on disk, never downloaded) where the config
    names one, else the BPE tokenizer, with the config's context length
    and tokenizer_kwargs."""
    cfg = get_model_config(model_name) if model_name else None
    text_cfg = (cfg or {}).get("text_cfg", {})
    if text_cfg.get("hf_tokenizer_name"):
        from xtagclip_tpu_torch.tokenize.hf import HFTokenizer

        return HFTokenizer(text_cfg["hf_tokenizer_name"],
                           context_length=text_cfg.get("context_length", 77),
                           **(text_cfg.get("tokenizer_kwargs") or {}))
    return SimpleTokenizer(
        context_length=text_cfg.get("context_length", 77),
        **(text_cfg.get("tokenizer_kwargs") or {}))
