"""HF torch M2M100 (NLLB) encoder state dict -> the flax-layout tree of
models/m2m100.py's ``M2M100Encoder`` (a copy of
xtagclip_tpu/convert/hf_m2m100.py; convert/from_jax.py names its leaves).

Key layout (reference builds these via AutoModel + `.encoder`,
src/open_clip/hf_model.py:123-126; arch registry hf_configs.py "m2m_100"):
  encoder.embed_tokens.weight / shared.weight -> embed_tokens/embedding
  encoder.layers.N.self_attn.{q,k,v,out}_proj -> layer_N/{q,k,v,out}_proj
  encoder.layers.N.self_attn_layer_norm       -> layer_N/self_attn_ln
  encoder.layers.N.fc1 / fc2                  -> layer_N/fc1 / fc2
  encoder.layers.N.final_layer_norm           -> layer_N/final_ln
  encoder.layer_norm                          -> layer_norm
Sinusoidal position buffers (embed_positions.weights) are recomputed, not
loaded.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

_LN_MAP = {"weight": "scale", "bias": "bias"}


def convert_hf_m2m100_state_dict(sd: Dict[str, np.ndarray],
                                 prefix: str = "") -> dict:
    tree: dict = {}

    def put(path, leaf_name, v):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf_name] = v

    layer_re = re.compile(re.escape(prefix) + r"encoder\.layers\.(\d+)\.(.+)")
    for k, v in sd.items():
        v = np.asarray(v)
        if k in (f"{prefix}encoder.embed_tokens.weight", f"{prefix}shared.weight"):
            put(("embed_tokens",), "embedding", v)
            continue
        if k.startswith(f"{prefix}encoder.layer_norm."):
            put(("layer_norm",), _LN_MAP[k.rsplit(".", 1)[1]], v)
            continue
        m = layer_re.match(k)
        if not m:
            continue
        i, rest = int(m.group(1)), m.group(2)
        base = f"layer_{i}"
        parts = rest.split(".")
        if parts[0] == "self_attn":
            name, wb = parts[1], parts[2]  # q_proj/.../out_proj, weight|bias
            if wb == "weight":
                put((base, name), "kernel", np.ascontiguousarray(v.T))
            else:
                put((base, name), "bias", v)
        elif parts[0] == "self_attn_layer_norm":
            put((base, "self_attn_ln"), _LN_MAP[parts[1]], v)
        elif parts[0] in ("fc1", "fc2"):
            if parts[1] == "weight":
                put((base, parts[0]), "kernel", np.ascontiguousarray(v.T))
            else:
                put((base, parts[0]), "bias", v)
        elif parts[0] == "final_layer_norm":
            put((base, "final_ln"), _LN_MAP[parts[1]], v)
    return tree
