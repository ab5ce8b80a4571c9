"""PyTorch + CUDA port of xtagclip_tpu for NVIDIA Hopper (H100).

The JAX package ``xtagclip_tpu`` is the reference; this package mirrors its
layout and names and never imports it (nor jax/flax). Entry points run on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``.
Every Pallas kernel of the JAX package runs as a hand-written sm_90a CUDA
kernel (``csrc/``, built on first use into ``_build/``).

The package exports the public names of the JAX package's ``__init__``
(the reference open_clip surface). They resolve at first access, so that
importing one module of the package (the serving artifact's ``ops``, say)
imports nothing else.
"""

from __future__ import annotations

import importlib

# bound now: the name is also the subpackage's, which the first import of
# any tokenizer module would set on this package (as in the JAX package,
# whose __init__ binds the function after the subpackage)
from xtagclip_tpu_torch.tokenize.bpe import tokenize
from xtagclip_tpu_torch.version import __version__

_FACTORY = "xtagclip_tpu_torch.factory"
_LOSSES = "xtagclip_tpu_torch.losses"
_TRANSFORMS = "xtagclip_tpu_torch.data.transforms"
_CONSTANTS = "xtagclip_tpu_torch.utils.constants"
_META = "xtagclip_tpu_torch.train.metadata"
_ZERO_SHOT = "xtagclip_tpu_torch.train.zero_shot"
_BPE = "xtagclip_tpu_torch.tokenize.bpe"
_PRETRAINED = "xtagclip_tpu_torch.pretrained"
_EXPORT = "xtagclip_tpu_torch.convert.export"

# public name -> (module, attribute)
_EXPORTS = {
    **{n: (_FACTORY, n) for n in (
        "add_model_config", "create_loss", "create_model",
        "create_model_and_transforms", "create_model_from_pretrained",
        "get_cast_dtype", "get_input_dtype", "get_model_config",
        "get_model_preprocess_cfg", "get_model_tokenize_cfg",
        "get_tokenizer", "list_models", "list_openai_models",
        "load_checkpoint", "load_openai_model", "set_model_preprocess_cfg")},
    **{n: (_PRETRAINED, n) for n in (
        "get_pretrained_cfg", "get_pretrained_url", "is_pretrained_cfg",
        "list_pretrained", "list_pretrained_models_by_tag",
        "list_pretrained_tags_by_model")},
    **{n: (_EXPORT, n) for n in (
        "push_to_hf_hub", "push_pretrained_to_hf_hub")},
    **{n: (_LOSSES, n) for n in (
        "AsymmetricLoss", "ClipLoss", "CoCaLoss", "DQNCOSLoss",
        "DistillClipLoss", "SigLipLoss")},
    "CLIP": ("xtagclip_tpu_torch.models.clip", "CLIP"),
    "CustomTextCLIP": ("xtagclip_tpu_torch.models.clip", "CLIP"),
    "CoCa": ("xtagclip_tpu_torch.models.coca", "CoCa"),
    "CLIPVisionCfg": ("xtagclip_tpu_torch.models.config", "CLIPVisionCfg"),
    "CLIPTextCfg": ("xtagclip_tpu_torch.models.config", "CLIPTextCfg"),
    **{n: (_TRANSFORMS, n) for n in (
        "AugmentationCfg", "PreprocessCfg", "image_transform")},
    **{n: (_BPE, n) for n in ("SimpleTokenizer", "decode")},
    **{n: (_ZERO_SHOT, n) for n in (
        "build_zero_shot_classifier", "build_zero_shot_classifier_legacy")},
    **{n: (_META, n) for n in (
        "IMAGENET_CLASSNAMES", "OPENAI_IMAGENET_TEMPLATES",
        "SIMPLE_IMAGENET_TEMPLATES", "MEDICALMNIST_CLASSNAMES",
        "PATHMNIST_CLASSNAMES", "SCAR_CLASSNAMES",
        "SIMPLE_MEDICALMNIST_TEMPLATES", "SIMPLE_SCAR_TEMPLATES")},
    **{n: (_CONSTANTS, n) for n in (
        "IMAGENET_MEAN", "IMAGENET_STD", "OPENAI_DATASET_MEAN",
        "OPENAI_DATASET_STD")},
}


def __getattr__(name: str):
    if name in _EXPORTS:
        module, attr = _EXPORTS[name]
        value = getattr(importlib.import_module(module), attr)
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


__all__ = ["__version__", "tokenize", *_EXPORTS]
