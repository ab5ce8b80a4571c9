"""timm trunk-family dispatch for ``visual.trunk.*`` state dicts (port of
the ViT branch of xtagclip_tpu/convert/timm_families.py).

``detect_trunk_family`` sniffs the key signature as JAX's does; the ViT
family converts (convert/timm_convert.py), and EVA, ViTamin, Swin and
FastViT raise, naming ROADMAP Queue 1 item 8, where their towers are.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class UnmappedKeysError(KeyError):
    pass


def detect_trunk_family(keys) -> str:
    ks = set(keys)

    def has(s):
        return any(s in k for k in ks)

    if has("attn.relative_position_bias_table"):
        return "swin"
    if has("patch_embed.backbone."):
        return "vitamin"
    if has("attn.q_proj.") or has("attn.q_bias"):
        return "eva"
    if has("rbr_conv") or has("conv_kxk"):
        raise UnmappedKeysError(
            "FastViT checkpoint is in TRAIN (multi-branch) form; "
            "reparameterize it first (timm.utils.reparameterize_model or "
            "Apple's export) — this converter accepts the inference form.")
    if has("reparam_conv"):
        return "fastvit"
    if "cls_token" in ks or has("blocks.0.attn.qkv."):
        return "vit"
    raise UnmappedKeysError(
        f"unrecognized timm trunk layout (families: vit, eva, swin, vitamin, "
        f"fastvit-reparam); sample keys: {sorted(ks)[:6]}")


def convert_timm_trunk(sd: Dict[str, np.ndarray],
                       prefix: str = "visual.trunk.") -> dict:
    """``prefix``-ed timm trunk keys -> a flax-layout trunk tree."""
    fam = detect_trunk_family(k[len(prefix):] for k in sd
                              if k.startswith(prefix))
    if fam != "vit":
        raise NotImplementedError(
            f"timm {fam} trunk checkpoint: only the ViT family is ported; "
            f"{fam} waits for ROADMAP Queue 1 item 8")
    from xtagclip_tpu_torch.convert.timm_convert import (
        convert_timm_vit_state_dict,
    )

    return convert_timm_vit_state_dict(sd, prefix=prefix)
