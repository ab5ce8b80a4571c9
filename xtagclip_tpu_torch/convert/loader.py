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
mismatch is skipped with a warning (JAX's ``strict=False``). The
big_vision .npz and orbax-directory sources are not ported.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from xtagclip_tpu_torch.convert.openclip import (
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
        raise NotImplementedError(
            "big_vision .npz checkpoints are not ported yet (ROADMAP Queue 1 "
            "item 10)")
    sd = normalize_to_custom_text(load_torch_state_dict(path))
    used, loaded, missing = set(), 0, []
    for name, p in model.named_parameters():
        if key_filter is not None and not key_filter(name):
            continue
        key, kind = openclip_key(name)
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
    unused = [k for k in sd if k not in used and key_filter is None]
    if unused:
        logging.info("checkpoint had %d unused entries: %s", len(unused),
                     unused[:5])
    logging.info("loaded %d params from %s", loaded, path)
    return model


def tagging_only_filter(name: str) -> bool:
    """--load-tagging-only: only the tag_head / tag_labels / tag_fc
    parameters."""
    return name.split(".")[0] in ("tag_head", "tag_labels", "tag_fc")
