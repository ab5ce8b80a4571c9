"""Checkpoint loading into a port model (port of the open_clip branch of
xtagclip_tpu/convert/loader.py:124-161).

An open_clip-layout torch ``.pt`` (``--pretrained <file>``, ``--resume
<file>``, ``--load-tagging-only``) is mapped name for name onto the
model's parameters (convert/openclip.py). As in the JAX loader, a
parameter the file lacks keeps its value and a key the model lacks is
ignored (both are logged); ``key_filter(name)`` restricts which
parameters load. The JAX loader's position-embedding resize and the
big_vision .npz and orbax-directory sources are not ported: a positional
embedding of another length raises.
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


@torch.no_grad()
def load_checkpoint_into(model: nn.Module, path: str,
                         key_filter=None) -> nn.Module:
    """Load the open_clip-layout state dict in ``path`` into ``model`` in
    place; a parameter whose shape differs is skipped with a warning."""
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
            msg = (f"shape mismatch for {name}: checkpoint {val.shape}, "
                   f"model {tuple(p.shape)}")
            if name.endswith("positional_embedding"):
                raise NotImplementedError(
                    f"{msg}; the position-embedding resize is not ported yet")
            logging.warning("skipping %s", msg)
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
