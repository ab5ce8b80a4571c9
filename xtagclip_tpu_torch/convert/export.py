"""The port's parameters -> an open_clip (CustomTextCLIP-layout) torch
checkpoint: port of xtagclip_tpu/convert/export.py ``to_openclip_state_dict``
and ``save_open_clip_checkpoint`` (:28-166), the inverse of
convert/openclip.py's ``openclip_key``/``from_openclip``. A machine without
JAX writes the ``.pt`` that ``--pretrained`` (convert/loader.py), the JAX
package and the PyTorch reference read. The HF-hub save and push
functions (:169-226) wait for the ``hf_*`` converters (ROADMAP Queue 1
item 9).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from xtagclip_tpu_torch.convert.openclip import openclip_key


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
    patch = getattr(model.visual, "patch_size", None)
    sd: Dict[str, np.ndarray] = {}
    for name, p in model.named_parameters():
        try:
            key, kind = openclip_key(name)
        except KeyError as e:
            raise NotImplementedError(
                f"{name}: exporting a timm, HF or ResNet tower to an "
                "open_clip .pt is not implemented (nor is it in the JAX "
                "package, export.py:154)") from e
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
