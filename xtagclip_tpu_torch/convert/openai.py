"""OpenAI CLIP checkpoints (port of xtagclip_tpu/convert/openai.py:15-91):
a TorchScript archive or a bare state dict (fp16 tensors upcast to fp32,
the ``input_resolution``, ``context_length`` and ``vocab_size`` entries
dropped), the architecture inferred from its tensor shapes (a ViT or a
ModifiedResNet, QuickGELU), and the model built and loaded through
convert/loader.py. OpenAI's keys are open_clip's CLIP layout (the text
tower at the top level).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict

import numpy as np
import torch

_METADATA = ("input_resolution", "context_length", "vocab_size")


def load_openai_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The archive's tensors as fp32 numpy arrays: a TorchScript archive
    (``torch.jit.load``), else a ``torch.load`` state dict (optionally under
    ``state_dict``), else a ``.safetensors`` file."""
    if str(path).endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path, device="cpu")
    else:
        try:
            sd = torch.jit.load(path, map_location="cpu").eval().state_dict()
        except RuntimeError:  # not a TorchScript archive
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
            sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) \
                else ckpt
    return {k: v.float().numpy() if hasattr(v, "float") else np.asarray(v)
            for k, v in sd.items() if k not in _METADATA}


def config_from_openai_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """The model config the tensor shapes imply (QuickGELU, text heads of
    64, ViT head width 64), as JAX infers it."""
    if "visual.proj" in sd:
        patch = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        vision_cfg = dict(
            layers=len([k for k in sd if k.startswith("visual.")
                        and k.endswith(".attn.in_proj_weight")]),
            width=sd["visual.conv1.weight"].shape[0], patch_size=patch,
            image_size=patch * grid)
    else:
        counts = [len({k.split(".")[2] for k in sd
                       if k.startswith(f"visual.layer{b}")})
                  for b in (1, 2, 3, 4)]
        out_grid = round(
            (sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        vision_cfg = dict(layers=counts,
                          width=sd["visual.layer1.0.conv1.weight"].shape[0],
                          image_size=out_grid * 32)
    text_width = sd["ln_final.weight"].shape[0]
    text_cfg = dict(
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        width=text_width, heads=text_width // 64,
        layers=len({k.split(".")[2] for k in sd
                    if k.startswith("transformer.resblocks")}))
    return dict(embed_dim=sd["text_projection"].shape[1], quick_gelu=True,
                vision_cfg=vision_cfg, text_cfg=text_cfg)


def load_openai_model(path: str, precision: str = "fp32", **model_kwargs):
    """Build the model an OpenAI checkpoint's shapes imply, registered as
    ``openai-<file stem>``, and load the checkpoint into it
    (``model_kwargs``, ``device`` included, go to ``create_model``)."""
    from xtagclip_tpu_torch.convert.loader import load_state_dict_into
    from xtagclip_tpu_torch.factory import create_model, register_model_config

    sd = load_openai_state_dict(path)
    name = f"openai-{Path(path).stem}"
    register_model_config(name, config_from_openai_state_dict(sd))
    model = create_model(name, precision=precision, **model_kwargs)
    load_state_dict_into(model, sd, str(path))
    logging.info("loaded OpenAI checkpoint %s (%s)", path,
                 "ViT" if "visual.proj" in sd else "ResNet")
    return model
