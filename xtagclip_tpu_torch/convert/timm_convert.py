"""timm ViT torch state dict -> flax-layout TimmViT tree (port of
xtagclip_tpu/convert/timm_convert.py); load it by the names of
convert/from_jax.py. ``fc_norm`` and the SigLIP ``attn_pool`` are hoisted
out of the trunk by the caller (convert/openclip.py), as JAX's are. A key
the map does not know (a conv stem's, a relpos table's) raises
``UnmappedKeysError``, as JAX's converter does.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

_LN = {"weight": "scale", "bias": "bias"}


def _lin(v, leaf):
    return ("kernel", np.ascontiguousarray(v.T)) if leaf == "weight" \
        else ("bias", v)


def convert_timm_vit_state_dict(sd: Dict[str, np.ndarray],
                                prefix: str = "") -> dict:
    tree: dict = {}
    leftovers = []

    def put(path, key, v):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node.setdefault(path[-1], {})[key] = v

    block_re = re.compile(re.escape(prefix) + r"blocks\.(\d+)\.(.+)")
    for k, v in sd.items():
        if prefix and not k.startswith(prefix):
            continue
        rest = k[len(prefix):]
        if rest == "cls_token":
            tree["cls_token"] = v.reshape(1, 1, -1)
        elif rest == "pos_embed":
            tree["pos_embed"] = v.reshape(v.shape[-2], v.shape[-1])
        elif rest == "patch_embed.proj.weight":
            w = v.transpose(2, 3, 1, 0)  # [D, C, p, p] -> [p, p, C, D]
            put(("patch_embed",), "kernel",
                np.ascontiguousarray(w.reshape(-1, w.shape[-1])))
        elif rest == "patch_embed.proj.bias":
            put(("patch_embed",), "bias", v)
        elif rest.startswith("norm."):
            put(("norm",), _LN[rest.split(".")[1]], v)
        elif rest.startswith("fc_norm."):
            put(("__fc_norm__",), _LN[rest.split(".")[1]], v)
        elif rest.startswith("attn_pool."):
            sub = rest[len("attn_pool."):].split(".")
            if sub[0] == "latent":
                tree.setdefault("__attn_pool__", {})["latent"] = v
            elif sub[0] in ("q", "kv", "proj"):
                put(("__attn_pool__", sub[0]), *_lin(v, sub[1]))
            elif sub[0] == "norm":
                put(("__attn_pool__", "norm"), _LN[sub[1]], v)
            elif sub[0] == "mlp":
                put(("__attn_pool__", f"mlp_{sub[1]}"), *_lin(v, sub[2]))
            else:
                leftovers.append(rest)
        else:
            m = block_re.match(k)
            if not m:
                leftovers.append(rest)
                continue
            base = f"blocks_{int(m.group(1))}"
            parts = m.group(2).split(".")
            if parts[0] in ("norm1", "norm2"):
                put((base, parts[0]), _LN[parts[1]], v)
            elif parts[0] == "attn" and parts[1] in ("qkv", "proj"):
                put((base, parts[1]), *_lin(v, parts[2]))
            elif parts[0] == "mlp":
                put((base, parts[1]), *_lin(v, parts[2]))
            else:
                leftovers.append(rest)
    if leftovers:
        from xtagclip_tpu_torch.convert.timm_families import UnmappedKeysError

        raise UnmappedKeysError(
            f"timm ViT converter: {len(leftovers)} unmapped trunk keys "
            f"(conv-stem / relpos / gap variants need their own map): "
            f"{sorted(leftovers)[:10]}")
    return tree
