"""Weights bridge: the JAX package's flax param tree -> the port's modules.

The port's parameter names mirror the flax tree; a leaf's path joined with
"." is its parameter name, except for the unrolled layer stacks, which are
``nn.ModuleList``s here:

- ``resblocks_{i}``            -> ``resblocks.{i}``
- ``decoder_layer_{i}``        -> ``decoder_layers.{i}``
- ``layer_{i}_crossattention`` -> ``layers.{i}.crossattention``
- ``layer_{i}_ffn``            -> ``layers.{i}.ffn``

Layouts need no change: flax Dense kernels are [in, out] and the MHA
in_proj is [E, 3E] in both. A cls-free GAP tower has no
``class_embedding`` and a [gh * gw, D] ``positional_embedding`` in both. Loading is strict: every port parameter is
filled and every JAX leaf is used, with matching shapes; values are cast
to each parameter's dtype (so a bf16 model takes fp32 JAX params as the
JAX package casts them at use).
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_RULES = (
    (re.compile(r"(^|\.)resblocks_(\d+)(?=\.)"), r"\1resblocks.\2"),
    (re.compile(r"(^|\.)decoder_layer_(\d+)(?=\.)"), r"\1decoder_layers.\2"),
    (re.compile(r"(^|\.)layer_(\d+)_crossattention(?=\.)"),
     r"\1layers.\2.crossattention"),
    (re.compile(r"(^|\.)layer_(\d+)_ffn(?=\.)"), r"\1layers.\2.ffn"),
)


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, name)
        else:
            yield name, val


def port_name(jax_path: str) -> str:
    """The port's parameter name for a "."-joined flax param path."""
    for pat, repl in _RULES:
        jax_path = pat.sub(repl, jax_path)
    return jax_path


@torch.no_grad()
def load_jax_params(model: nn.Module, params) -> None:
    """Fill ``model`` from a flax param tree of numpy arrays (nested dicts,
    e.g. ``jax.tree.map(np.asarray, bundle.params)``). Raises on a missing,
    unused or mis-shaped leaf."""
    ours = dict(model.named_parameters())
    leaves = {port_name(k): v for k, v in _flatten(params)}
    missing = sorted(set(ours) - set(leaves))
    unused = sorted(set(leaves) - set(ours))
    if missing or unused:
        raise ValueError(f"load_jax_params: port parameters without a JAX "
                         f"leaf: {missing}; JAX leaves without a port "
                         f"parameter: {unused}")
    for name, p in ours.items():
        arr = np.asarray(leaves[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"load_jax_params: {name} has shape "
                             f"{tuple(p.shape)}, JAX leaf {arr.shape}")
        p.copy_(torch.from_numpy(np.array(arr, np.float32)))
