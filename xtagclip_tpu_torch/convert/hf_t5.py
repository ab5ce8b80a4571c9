"""HF torch T5EncoderModel state dict -> the flax-layout tree of
models/t5.py's ``T5EncoderStack`` (a copy of xtagclip_tpu/convert/hf_t5.py;
convert/from_jax.py names its leaves in the port).

Key layout (reference arch: transformers T5/mT5, built by the reference via
AutoModel + `.encoder`, src/open_clip/hf_model.py:123-126):
  shared.weight                                        -> shared/embedding
  encoder.block.N.layer.0.SelfAttention.{q,k,v,o}      -> block_N_attn/{q,k,v,o}
  encoder.block.0.layer.0.SelfAttention
      .relative_attention_bias.weight                  -> relpos_bias/embedding
  encoder.block.N.layer.0.layer_norm.weight            -> block_N_attn_ln/scale
  encoder.block.N.layer.1.DenseReluDense.{wi_0,wi_1,wo}-> block_N_ff/{...}
  encoder.block.N.layer.1.layer_norm.weight            -> block_N_ff_ln/scale
  encoder.final_layer_norm.weight                      -> final_ln/scale
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np


def convert_hf_t5_state_dict(sd: Dict[str, np.ndarray],
                             prefix: str = "") -> dict:
    tree: dict = {}

    def put(path, leaf_name, v):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf_name] = v

    block_re = re.compile(
        re.escape(prefix) + r"encoder\.block\.(\d+)\.layer\.([01])\.(.+)"
    )
    for k, v in sd.items():
        v = np.asarray(v)
        if k == f"{prefix}shared.weight" or k == f"{prefix}encoder.embed_tokens.weight":
            put(("shared",), "embedding", v)
            continue
        if k == f"{prefix}encoder.final_layer_norm.weight":
            put(("final_ln",), "scale", v)
            continue
        m = block_re.match(k)
        if not m:
            continue
        i, sub, rest = int(m.group(1)), m.group(2), m.group(3)
        if sub == "0":  # self-attention
            if rest == "layer_norm.weight":
                put((f"block_{i}_attn_ln",), "scale", v)
            elif rest.startswith("SelfAttention."):
                name = rest.split(".")[1]
                if name == "relative_attention_bias":
                    put(("relpos_bias",), "embedding", v)
                else:  # q/k/v/o linear, no bias
                    put((f"block_{i}_attn", name), "kernel",
                        np.ascontiguousarray(v.T))
        else:  # feed-forward
            if rest == "layer_norm.weight":
                put((f"block_{i}_ff_ln",), "scale", v)
            elif rest.startswith("DenseReluDense."):
                name = rest.split(".")[1]  # wi_0 / wi_1 / wo
                put((f"block_{i}_ff", name), "kernel",
                    np.ascontiguousarray(v.T))
    return tree
