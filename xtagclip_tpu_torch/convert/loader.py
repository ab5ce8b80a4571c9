"""Checkpoint loading into a port model (port of the open_clip branch of
xtagclip_tpu/convert/loader.py:124-161).

An open_clip-layout torch ``.pt`` (``--pretrained <file>``, ``--resume
<file>``, ``--load-tagging-only``) is mapped name for name onto the
model's parameters (convert/openclip.py). As in the JAX loader, a
parameter the file lacks keeps its value and a key the model lacks is
ignored (both are logged); ``key_filter(name)`` restricts which
parameters load. A table of another length is resized as JAX's
``merge_converted_params`` (:82-106) resizes it: the vision table drops or
gains the cls row and resizes bicubically, the text table linearly
(models/pos_embed.py); a value that differs from the parameter only in
singleton dims (``logit_scale`` () vs (1,)) is reshaped. Any other shape
mismatch is skipped with a warning (JAX's ``strict=False``). A port
checkpoint's own state dict loads the same way (``load_state_into``), as
JAX's loader merges its orbax trees, and so does a big_vision ``.npz``
(``load_big_vision_into``: convert/big_vision.py's tree by the names of
convert/from_jax.py). A timm trunk, an HF BERT and a ModifiedResNet load
as whole groups (convert/openclip.py ``convert_tower_groups``), the
ResNet's BatchNorm running statistics into its buffers.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from xtagclip_tpu_torch.convert.from_jax import stats_buffers
from xtagclip_tpu_torch.convert.openclip import (
    convert_tower_groups,
    from_openclip,
    load_torch_state_dict,
    normalize_to_custom_text,
    openclip_key,
)
from xtagclip_tpu_torch.models.pos_embed import (
    resize_text_pos_embed,
    resize_vision_pos_embed,
)


def _pos_prefix_tokens(n: int) -> int:
    """1 if an [L, D] vision table carries a cls row (L = S^2 + 1), 0 for
    a pure grid (L = S^2, the cls-free GAP towers)."""
    side = int(round(n ** 0.5))
    if side * side == n:
        return 0
    side = int(round((n - 1) ** 0.5))
    if side * side == n - 1:
        return 1
    raise ValueError(f"vision pos-embed length {n} is neither S^2 nor S^2+1")


def _fit(name: str, val: np.ndarray, p: torch.Tensor):
    """``val`` brought to the shape of parameter ``p`` as JAX's
    ``merge_converted_params`` does (module doc), or None to skip it."""
    target = tuple(p.shape)
    if name == "visual.positional_embedding":
        tgt_prefix = _pos_prefix_tokens(target[0])
        src_prefix = _pos_prefix_tokens(val.shape[0])
        side = int(round((target[0] - tgt_prefix) ** 0.5))
        if src_prefix and not tgt_prefix:
            val = val[1:]  # the cls row has no position in a GAP tower
        elif tgt_prefix and not src_prefix:
            # a cls-free source into a cls tower keeps the model's cls row
            val = np.concatenate([p[:1].detach().cpu().float().numpy(), val])
        return resize_vision_pos_embed(val, (side, side),
                                       num_prefix_tokens=tgt_prefix)
    if name == "text.positional_embedding":
        return resize_text_pos_embed(val, target[0])
    if val.size == p.numel() and tuple(s for s in val.shape if s != 1) == \
            tuple(s for s in target if s != 1):
        return val.reshape(target)
    logging.warning("skipping shape mismatch for %s: checkpoint %s, model %s",
                    name, val.shape, target)
    return None


@torch.no_grad()
def load_checkpoint_into(model: nn.Module, path: str,
                         key_filter=None) -> nn.Module:
    """Load the open_clip-layout state dict in ``path`` into ``model`` in
    place; a table of another length is resized (module doc)."""
    if path.endswith(".npz"):
        return load_big_vision_into(model, path, key_filter)
    sd = normalize_to_custom_text(load_torch_state_dict(path))
    groups, stats, sd = convert_tower_groups(sd)
    used, loaded, missing = set(), 0, []
    for name, p in model.named_parameters():
        if key_filter is not None and not key_filter(name):
            continue
        if name in groups:
            used.add(name)
            val = groups[name]
        else:
            try:
                key, kind = openclip_key(name)
            except KeyError:  # a group tower's parameter the file lacks
                key = None
            if key not in sd:
                missing.append(name)
                continue
            used.add(key)
            val = from_openclip(np.asarray(sd[key]), kind, tuple(p.shape))
        if tuple(val.shape) != tuple(p.shape):
            val = _fit(name, val, p)
            if val is None:
                continue
        p.copy_(torch.from_numpy(np.array(val, np.float32)))
        loaded += 1
    if missing and key_filter is None:
        logging.info("checkpoint missing %d params (kept): %s", len(missing),
                     missing[:5])
    if key_filter is None:
        buffers = stats_buffers(model)
        for name, val in stats.items():
            if name in buffers and tuple(val.shape) == tuple(buffers[name].shape):
                buffers[name].copy_(torch.from_numpy(np.array(val, np.float32)))
                used.add(name)
    unused = [k for k in (*sd, *groups, *stats)
              if k not in used and key_filter is None]
    if unused:
        logging.info("checkpoint had %d unused entries: %s", len(unused),
                     unused[:5])
    logging.info("loaded %d params from %s", loaded, path)
    return model


@torch.no_grad()
def load_state_into(model: nn.Module, state: dict, source: str = "") -> nn.Module:
    """Load a state dict in the port's own parameter names (a port
    checkpoint's ``state["model"]``) into ``model`` in place, as JAX's
    loader merges an orbax tree (``merge_converted_params``): a table of
    another length is resized (module doc), a parameter the state lacks
    keeps its value and an entry the model lacks is ignored (both logged).
    BatchNorm running statistics (persistent buffers) load by name too."""
    loaded, missing = 0, []
    for name, p in model.named_parameters():
        if name not in state:
            missing.append(name)
            continue
        val = state[name]
        if tuple(val.shape) != tuple(p.shape):
            val = _fit(name, val.detach().float().cpu().numpy(), p)
            if val is None:
                continue
            val = torch.from_numpy(np.array(val, np.float32))
        p.copy_(val)
        loaded += 1
    params = dict(model.named_parameters())
    buffers = stats_buffers(model)
    for name, buf in buffers.items():  # BatchNorm running statistics
        if name in state and tuple(state[name].shape) == tuple(buf.shape):
            buf.copy_(state[name])
    unused = [k for k in state if k not in params and k not in buffers]
    if missing or unused:
        logging.info("checkpoint %s: %d parameters kept (%s), %d entries "
                     "ignored (%s)", source, len(missing), missing[:5],
                     len(unused), unused[:5])
    logging.info("loaded %d params from %s", loaded, source)
    return model


def load_big_vision_into(model: nn.Module, path: str,
                         key_filter=None) -> nn.Module:
    """Load a big_vision ``.npz`` into ``model`` in place: the archive's
    flax-layout tree (convert/big_vision.py) by the port's names of its
    leaves (convert/from_jax.py ``port_name``), through the merge of
    ``load_state_into``, position tables resized (JAX's loader.py:127-130
    takes the same merge). An archive none of whose keys maps raises, where
    JAX would load nothing and keep the init. The archive keys the
    converter leaves unread and the parameters that keep their init are
    logged as a warning, both lists whole (also on the record, as
    ``big_vision_unread`` and ``big_vision_kept``)."""
    from xtagclip_tpu_torch.convert.big_vision import load_big_vision_weights
    from xtagclip_tpu_torch.convert.from_jax import _flatten, port_name

    unread = []
    tree = load_big_vision_weights(path, unread)
    if not tree:
        raise ValueError(f"{path}: no big_vision parameters ('img/...', "
                         "'txt/...', 't' or 'b', optionally under 'params/')")
    state = {}
    for key, val in _flatten(tree):
        name = port_name(key)
        if key_filter is None or key_filter(name):
            state[name] = torch.from_numpy(np.array(val, np.float32))
    kept = [n for n, _ in model.named_parameters()
            if n not in state and (key_filter is None or key_filter(n))]
    if unread or kept:
        logging.warning(
            "big_vision archive %s: %d keys unread %s; %d parameters keep "
            "their init %s", path, len(unread), unread, len(kept), kept,
            extra={"big_vision_unread": unread, "big_vision_kept": kept})
    return load_state_into(model, state, path)


def tagging_only_filter(name: str) -> bool:
    """--load-tagging-only: only the tag_head / tag_labels / tag_fc
    parameters."""
    return name.split(".")[0] in ("tag_head", "tag_labels", "tag_fc")
