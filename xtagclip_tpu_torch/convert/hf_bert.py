"""HF torch ``BertModel`` state dict -> flax-layout BertModel tree (port of
xtagclip_tpu/convert/hf_bert.py); load it by the names of
convert/from_jax.py. The ``position_ids`` buffer is dropped.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np


def _node(tree, path):
    for p in path:
        tree = tree.setdefault(p, {})
    return tree


def _linear(tree, path, key, v):
    leaf = _node(tree, path)
    if key == "weight":
        leaf["kernel"] = np.ascontiguousarray(v.T)
    else:
        leaf["bias"] = v


def _ln(tree, path, key, v):
    _node(tree, path)[{"weight": "scale", "bias": "bias"}[key]] = v


def convert_hf_bert_state_dict(sd: Dict[str, np.ndarray],
                               prefix: str = "") -> dict:
    """Map ``{prefix}embeddings.*``, ``{prefix}encoder.layer.N.*`` and
    ``{prefix}pooler.dense.*`` keys."""
    tree: dict = {}
    layer_re = re.compile(re.escape(prefix) + r"encoder\.layer\.(\d+)\.(.+)")
    for k, v in sd.items():
        if prefix and not k.startswith(prefix):
            continue
        rest = k[len(prefix):]
        if rest.startswith("embeddings."):
            sub = rest[len("embeddings."):]
            name = sub.split(".")[0]
            if name in ("word_embeddings", "position_embeddings",
                        "token_type_embeddings"):
                tree.setdefault(name, {})["embedding"] = v
            elif name == "LayerNorm":
                _ln(tree, ("embeddings_ln",), sub.split(".")[1], v)
            continue
        m = layer_re.match(k)
        if m:
            base = f"layer_{int(m.group(1))}"
            parts = m.group(2).split(".")
            if parts[0] == "attention":
                if parts[1] == "self":
                    _linear(tree, (base, "attention", parts[2]), parts[3], v)
                elif parts[2] == "dense":
                    _linear(tree, (base, "attention", "out_dense"), parts[3], v)
                else:
                    _ln(tree, (base, "attention", "out_ln"), parts[3], v)
            elif parts[0] == "intermediate":
                _linear(tree, (base, "intermediate"), parts[2], v)
            elif parts[0] == "output":
                if parts[1] == "dense":
                    _linear(tree, (base, "output"), parts[2], v)
                else:
                    _ln(tree, (base, "output_ln"), parts[2], v)
            continue
        if rest.startswith("pooler.dense."):
            _linear(tree, ("pooler",), rest.split(".")[2], v)
    return tree
