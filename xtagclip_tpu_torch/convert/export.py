"""The port's parameters -> an open_clip (CustomTextCLIP-layout) torch
checkpoint and an HF hub directory: port of xtagclip_tpu/convert/export.py
(:28-226), the inverse of convert/openclip.py's
``openclip_key``/``from_openclip``. A machine without JAX writes the
``.pt`` that ``--pretrained`` (convert/loader.py), the JAX package and the
PyTorch reference read, and the hub layout (``open_clip_pytorch_model.bin``
and ``open_clip_config.json``) that ``pretrained="hf-hub:<org>/<name>"``
reads back. Like JAX's exporter, it writes the CLIP and XTag towers only:
CoCa, timm, HF and ResNet towers raise.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from xtagclip_tpu_torch.convert.openclip import openclip_key
from xtagclip_tpu_torch.utils.constants import (
    HF_CONFIG_NAME,
    HF_WEIGHTS_NAME,
    OPENAI_DATASET_MEAN,
    OPENAI_DATASET_STD,
)


def to_openclip(value: np.ndarray, kind: str, patch_size) -> np.ndarray:
    """A port parameter in open_clip's layout (``from_openclip``'s
    inverse); ``patch_size`` (ph, pw) shapes the patch-embed conv."""
    if kind == "linear":
        return np.ascontiguousarray(value.T)
    if kind == "conv":
        ph, pw = patch_size
        rows, width = value.shape
        c = rows // (ph * pw)
        return np.ascontiguousarray(
            value.reshape(ph, pw, c, width).transpose(3, 2, 0, 1))
    if kind == "scalar":
        return value.reshape(())
    return value


@torch.no_grad()
def to_openclip_state_dict(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters as an open_clip state dict of fp32 numpy
    arrays. TQN's ``decoder_norm`` is written twice, as JAX's exporter
    writes it (``fusion_model.decoder.norm`` is the reference's second
    registration of the same module)."""
    if hasattr(model, "text_decoder"):
        raise NotImplementedError(
            "exporting a CoCa model to an open_clip .pt is not implemented, "
            "nor is it in the JAX package: JAX's exporter drops its decoder "
            "and attentional pooler (export.py:154, ROADMAP Queue 3)")
    patch = getattr(model.visual, "patch_size", None)
    refused = ("exporting a timm, HF or ResNet tower to an open_clip .pt is "
               "not implemented (nor is it in the JAX package, "
               "export.py:154)")
    if patch is None:
        raise NotImplementedError(
            f"{type(model.visual).__name__}: {refused}")
    sd: Dict[str, np.ndarray] = {}
    for name, p in model.named_parameters():
        try:
            key, kind = openclip_key(name)
        except KeyError as e:
            raise NotImplementedError(f"{name}: {refused}") from e
        sd[key] = to_openclip(p.detach().float().cpu().numpy(), kind, patch)
        if key.startswith("fusion_model.decoder_norm."):
            sd[key.replace("decoder_norm", "decoder.norm")] = sd[key]
    return sd


def save_open_clip_checkpoint(model: nn.Module, path: str,
                              epoch: int = 0) -> str:
    """Write ``{"epoch", "name", "state_dict"}`` as JAX's exporter does: a
    torch checkpoint the open_clip loaders read."""
    sd = {k: torch.from_numpy(np.array(v, np.float32, copy=True))
          for k, v in to_openclip_state_dict(model).items()}
    torch.save({"epoch": epoch, "name": getattr(model, "model_name", ""),
                "state_dict": sd}, path)
    return path


def save_hf_checkpoint(model: nn.Module, save_dir: str,
                       tokenizer=None) -> str:
    """The hub directory layout (JAX export.py:169-189): the open_clip
    ``.pt`` as ``open_clip_pytorch_model.bin``, ``open_clip_config.json``
    (the model config without its ``preprocess_cfg``, and the preprocess
    config kept on the model, else the config's, else OpenAI's mean and
    std) and, for an HF tokenizer, its files."""
    os.makedirs(save_dir, exist_ok=True)
    save_open_clip_checkpoint(model, os.path.join(save_dir, HF_WEIGHTS_NAME))
    cfg = {
        "model_cfg": {k: v for k, v in model.model_cfg.items()
                      if k != "preprocess_cfg"},
        "preprocess_cfg": (getattr(model, "preprocess_cfg", None)
                           or model.model_cfg.get("preprocess_cfg")
                           or {"mean": list(OPENAI_DATASET_MEAN),
                               "std": list(OPENAI_DATASET_STD)}),
    }
    with open(os.path.join(save_dir, HF_CONFIG_NAME), "w") as f:
        json.dump(cfg, f, indent=2)
    if tokenizer is not None and hasattr(tokenizer, "save_pretrained"):
        tokenizer.save_pretrained(save_dir)
    return save_dir


def push_to_hf_hub(model: nn.Module, repo_id: str, tokenizer=None,
                   commit_message: Optional[str] = None,
                   private: bool = False,
                   local_dir: Optional[str] = None) -> str:
    """Write the hub directory (``local_dir`` or a new temporary one) and
    upload it to ``repo_id`` with ``huggingface_hub.HfApi``. Where the
    upload cannot run (no ``huggingface_hub``, no credentials, no network)
    it raises RuntimeError naming the prepared directory, as JAX's does
    (export.py:192-218)."""
    save_dir = local_dir or tempfile.mkdtemp(prefix="hf_push_")
    save_hf_checkpoint(model, save_dir, tokenizer=tokenizer)
    try:
        from huggingface_hub import HfApi

        api = HfApi()
        api.create_repo(repo_id, private=private, exist_ok=True)
        api.upload_folder(folder_path=save_dir, repo_id=repo_id,
                          commit_message=commit_message or "Add model")
        return repo_id
    except Exception as e:  # noqa: BLE001 (any failure: say where the files are)
        raise RuntimeError(
            f"hub upload unavailable ({type(e).__name__}); the packaged "
            f"checkpoint is at {save_dir}") from e


def push_pretrained_to_hf_hub(model_name: str, pretrained: str,
                              repo_id: str, device="cuda", **kwargs) -> str:
    """``create_model(model_name, pretrained)`` on ``device``, then
    ``push_to_hf_hub`` with the model's tokenizer (JAX export.py:221)."""
    from xtagclip_tpu_torch.factory import create_model, get_tokenizer

    model = create_model(model_name, pretrained, device=device)
    return push_to_hf_hub(model, repo_id,
                          tokenizer=get_tokenizer(model_name), **kwargs)
