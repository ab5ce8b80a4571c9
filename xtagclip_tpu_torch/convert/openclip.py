"""The open_clip (CustomTextCLIP-layout) torch state dict -> the port's
parameters: the inverse of xtagclip_tpu/convert/export.py
``to_openclip_state_dict`` (:28), tag head and TQN included, for the
towers the port has (ViT, text transformer); ModifiedResNet waits for
ROADMAP Queue 1 item 9.

``openclip_key(name)`` gives, for a port parameter name, the state-dict
key it is stored under and how its layout differs:

- ``"same"``: as it is;
- ``"linear"``: a torch ``nn.Linear`` weight [out, in], the transpose of
  the port's (flax) Dense kernel [in, out];
- ``"conv"``: the patch-embed conv weight [W, C, ph, pw], the port's
  kernel [ph*pw*C, W] in (ph, pw, C) row order;
- ``"scalar"``: a 0-d tensor (the logit scales).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_BLOCK = re.compile(r"(visual|text)\.transformer\.resblocks\.(\d+)\.(.+)")
_TAG = re.compile(r"tag_head\.layers\.(\d+)\.(crossattention|ffn)\.(.+)")
_TQN = re.compile(r"fusion_model\.decoder_layers\.(\d+)\.(.+)")
_MLP_HEAD = {"mlp_0": 0, "mlp_1": 3, "mlp_2": 6, "mlp_3": 9}


def _leaf(part: str) -> str:
    return "weight" if part in ("kernel", "scale") else "bias"


def openclip_key(name: str) -> Tuple[str, str]:
    """(state-dict key, layout kind) of the port parameter ``name``."""
    parts = name.split(".")
    last = parts[-1]
    m = _BLOCK.fullmatch(name)
    if m:
        tower, i, rest = m.groups()
        base = f"{tower}.transformer.resblocks.{i}"
        sub = rest.split(".")
        if sub[0] in ("ln_1", "ln_2"):
            return f"{base}.{sub[0]}.{_leaf(last)}", "same"
        if sub[:2] == ["attn", "in_proj"]:
            return (f"{base}.attn.in_proj_{_leaf(last)}",
                    "linear" if last == "kernel" else "same")
        if sub[0] in ("attn", "mlp"):
            return (f"{base}.{sub[0]}.{sub[1]}.{_leaf(last)}",
                    "linear" if last == "kernel" else "same")
    if name == "visual.conv1.kernel":
        return "visual.conv1.weight", "conv"
    if name in ("visual.class_embedding", "visual.positional_embedding",
                "visual.proj", "text.positional_embedding",
                "text.text_projection"):
        return name, "same"
    if parts[:2] in (["visual", "ln_pre"], ["visual", "ln_post"],
                     ["text", "ln_final"]):
        return f"{parts[0]}.{parts[1]}.{_leaf(last)}", "same"
    if name == "text.token_embedding.embedding":
        return "text.token_embedding.weight", "same"
    if name == "logit_scale":
        return "logit_scale", "scalar"
    if name == "tag_labels.embedding":
        return "tag_labels.weight", "same"
    if parts[0] == "tag_fc":
        return f"tag_fc.{_leaf(last)}", ("linear" if last == "kernel"
                                         else "same")
    m = _TAG.fullmatch(name)
    if m:
        i, kind, rest = m.groups()
        sub = rest.split(".")
        base = f"tag_head.encoder.layer.{i}"
        lin = "linear" if last == "kernel" else "same"
        if kind == "crossattention":
            if sub[0] in ("query", "key", "value"):
                return f"{base}.crossattention.self.{sub[0]}.{_leaf(last)}", lin
            if sub[0] == "out_dense":
                return f"{base}.crossattention.output.dense.{_leaf(last)}", lin
            if sub[0] == "out_ln":
                return (f"{base}.crossattention.output.LayerNorm."
                        f"{_leaf(last)}", "same")
        else:
            if sub[0] == "intermediate":
                return f"{base}.intermediate.dense.{_leaf(last)}", lin
            if sub[0] == "output":
                return f"{base}.output.dense.{_leaf(last)}", lin
            if sub[0] == "output_ln":
                return f"{base}.output.LayerNorm.{_leaf(last)}", "same"
    if name == "fusion_model.logit_scale":
        return name, "scalar"
    if parts[:2] == ["fusion_model", "decoder_norm"]:
        return f"fusion_model.decoder_norm.{_leaf(last)}", "same"
    m = _TQN.fullmatch(name)
    if m:
        i, rest = m.groups()
        sub = rest.split(".")
        base = f"fusion_model.decoder.layers.{i}"
        lin = "linear" if last == "kernel" else "same"
        if sub[:2] == ["multihead_attn", "in_proj"]:
            return f"{base}.multihead_attn.in_proj_{_leaf(last)}", lin
        if sub[:2] == ["multihead_attn", "out_proj"]:
            return f"{base}.multihead_attn.out_proj.{_leaf(last)}", lin
        if sub[0] in ("linear1", "linear2"):
            return f"{base}.{sub[0]}.{_leaf(last)}", lin
        if sub[0] in ("norm2", "norm3"):
            return f"{base}.{sub[0]}.{_leaf(last)}", "same"
    if len(parts) == 3 and parts[0] == "fusion_model" and parts[1] in _MLP_HEAD:
        return (f"fusion_model.mlp_head.{_MLP_HEAD[parts[1]]}.{_leaf(last)}",
                "linear" if last == "kernel" else "same")
    raise KeyError(f"no open_clip key for port parameter {name!r}")


def from_openclip(value: np.ndarray, kind: str, shape) -> np.ndarray:
    """A state-dict value in the port's layout (``shape``: the port's)."""
    if kind == "linear":
        return np.ascontiguousarray(value.T)
    if kind == "conv":
        width, c, ph, pw = value.shape
        return np.ascontiguousarray(
            value.transpose(2, 3, 1, 0).reshape(ph * pw * c, width))
    if kind == "scalar":
        return value.reshape(shape)
    return value


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a torch checkpoint file into numpy arrays (``state_dict`` and
    ``module.`` wrappers removed)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    if isinstance(ckpt, dict) and "module" in ckpt:
        ckpt = ckpt["module"]
    out = {}
    for k, v in ckpt.items():
        k = k[len("module."):] if k.startswith("module.") else k
        out[k] = (v.detach().float().cpu().numpy() if hasattr(v, "detach")
                  else np.asarray(v))
    return out


_TEXT_ALIAS_PREFIXES = (
    "token_embedding", "ln_final", "transformer.", "positional_embedding",
    "text_projection", "cls_emb", "attn_mask",
)


def normalize_to_custom_text(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Prefix top-level text-tower keys with 'text.' (CLIP ->
    CustomTextCLIP); where ``text.*`` exists the top-level aliases are
    duplicates and are dropped (xtagclip_tpu/convert/openclip.py:43-63)."""
    has_text = any(k.startswith("text.") for k in sd)
    out = {}
    for k, v in sd.items():
        if k in ("logit_scale", "logit_bias") or k.startswith(
                ("visual.", "tag_", "fusion_model.", "text.")):
            out[k] = v
        elif k.startswith(_TEXT_ALIAS_PREFIXES):
            if not has_text:
                out["text." + k] = v
        else:
            out[k] = v
    return out
