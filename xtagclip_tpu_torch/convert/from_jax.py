"""Weights bridge: the JAX package's flax param tree -> the port's modules.

The port's parameter names mirror the flax tree; a leaf's path joined with
"." is its parameter name, except for the unrolled layer stacks, which are
``nn.ModuleList``s here:

- ``resblocks_{i}``            -> ``resblocks.{i}``
- ``decoder_layer_{i}``        -> ``decoder_layers.{i}``
- ``layer_{i}_crossattention`` -> ``layers.{i}.crossattention``
- ``layer_{i}_ffn``            -> ``layers.{i}.ffn``
- ``blocks_{i}`` (timm ViT)    -> ``blocks.{i}``
- ``stem_{i}`` (conv stem)     -> ``stem.{i}``
- ``layer_{i}`` (BERT)         -> ``layers.{i}``

The ResNets keep flax's block names (``layer{l}_{b}``) as child names.
Layouts need no change, but for one: flax Dense kernels are [in, out] and
the MHA in_proj is [E, 3E] in both, while a conv kernel (the only 4-D
leaf) is flax's [kh, kw, in, out] and torch's [out, in, kh, kw] here
(``port_value``). A cls-free GAP tower has no ``class_embedding`` and a
[gh * gw, D] ``positional_embedding`` in both. The ``batch_stats``
collection (BatchNorm ``mean``/``var``) goes into the buffers of the same
names. Loading is strict: every port parameter is filled and every JAX
leaf is used, with matching shapes (and so for the statistics when they
are given); values are cast to each parameter's dtype (so a bf16 model
takes fp32 JAX params as the JAX package casts them at use).
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
    (re.compile(r"(^|\.)blocks_(\d+)(?=\.)"), r"\1blocks.\2"),
    (re.compile(r"(^|\.)stem_(\d+)(?=\.)"), r"\1stem.\2"),
    (re.compile(r"(^|\.)layer_(\d+)(?=\.)"), r"\1layers.\2"),
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


def port_value(arr) -> np.ndarray:
    """A flax leaf in the port's layout: a conv kernel [kh, kw, in, out]
    becomes [out, in, kh, kw]; everything else is as it is."""
    arr = np.asarray(arr)
    return np.ascontiguousarray(arr.transpose(3, 2, 0, 1)) if arr.ndim == 4 \
        else arr


def stats_buffers(model: nn.Module) -> dict:
    """The BatchNorm statistics of ``model``: its persistent buffers."""
    params = {n for n, _ in model.named_parameters()}
    state = model.state_dict(keep_vars=True)
    return {n: b for n, b in state.items() if n not in params}


def _fill(kind: str, ours: dict, tree) -> None:
    leaves = {port_name(k): v for k, v in _flatten(tree)}
    missing = sorted(set(ours) - set(leaves))
    unused = sorted(set(leaves) - set(ours))
    if missing or unused:
        raise ValueError(f"load_jax_params: port {kind} without a JAX "
                         f"leaf: {missing}; JAX leaves without a port "
                         f"{kind[:-1]}: {unused}")
    for name, p in ours.items():
        arr = port_value(leaves[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"load_jax_params: {name} has shape "
                             f"{tuple(p.shape)}, JAX leaf {arr.shape}")
        p.copy_(torch.from_numpy(np.array(arr, np.float32)))


@torch.no_grad()
def load_jax_params(model: nn.Module, params, batch_stats=None) -> None:
    """Fill ``model`` from a flax param tree of numpy arrays (nested dicts,
    e.g. ``jax.tree.map(np.asarray, bundle.params)``) and, if given, its
    BatchNorm statistics from the ``batch_stats`` tree. Raises on a
    missing, unused or mis-shaped leaf."""
    _fill("parameters", dict(model.named_parameters()), params)
    if batch_stats is not None:
        _fill("buffers", stats_buffers(model), batch_stats)
