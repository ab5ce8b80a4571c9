"""Train state: AdamW with the reference's no-decay partition, tower locking
through trainability masks, and the post-step logit_scale clamp (port of
xtagclip_tpu/train/train_state.py).

Masks are dicts from the port's parameter names (``model.named_parameters()``,
the flax paths joined by "." with the unrolled stacks as
``resblocks.{i}`` etc., convert/from_jax.port_name) to bools.

optax's ``adamw`` with a weight-decay mask is ``torch.optim.AdamW`` over two
parameter groups, decay and no-decay, with the lr set from the schedule
before each step (optax reads the schedule at the update count). Frozen
parameters are in no group and never change; the optional global-norm
clip, like optax's ``clip_by_global_norm`` inside ``multi_transform``,
sees the trainable gradients only. The state is updated in place.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

MAX_LOGIT_SCALE = math.log(100.0)

_RESBLOCK = re.compile(r"resblocks\.(\d+)\.")


def decay_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """True = apply weight decay: parameters of two or more dimensions,
    except biases and logit scales (train_state.py:34-45)."""
    def rule(name, p):
        name = name.lower()
        if p.dim() < 2:
            return False
        return not (name.endswith(".bias") or "logit_scale" in name)

    return {name: rule(name, p) for name, p in params.items()}


def _block_index(name: str) -> Optional[int]:
    m = _RESBLOCK.search(name)
    return int(m.group(1)) if m else None


def _vit_group_of(name: str, num_blocks: int) -> int:
    """Lock group of a visual parameter (name without "visual."): 0 = stem
    (conv1/cls/pos/ln_pre), 1..num_blocks-1 = resblocks[:-1], num_blocks =
    last block + ln_post, num_blocks+1 = proj (train_state.py:48-62)."""
    i = _block_index(name)
    if i is not None:
        return min(i, num_blocks - 1) + 1 if i < num_blocks - 1 else num_blocks
    if "ln_post" in name or "attn_pool" in name:
        return num_blocks
    if name.endswith("proj") or ".proj" in name:
        return num_blocks + 1
    return 0


def _text_group_of(name: str, num_blocks: int) -> int:
    """0 = embeddings, 1..B-1 = blocks[:-1], B = last block + ln_final;
    text_projection is never unlocked (train_state.py:145-155)."""
    i = _block_index(name)
    if i is not None:
        return min(i, num_blocks - 1) + 1 if i < num_blocks - 1 else num_blocks
    if "ln_final" in name:
        return num_blocks
    if "text_projection" in name:
        return -1
    return 0


# timm-family trunks (train_state.py:64-150): block-module names sort into
# depth order, stage downsamples/merges/pos-embeds group with their stage's
# first block, final norms join the last block, the head is the last group.
# The names are the flax tree's trunk children (``blocks_{i}``, ...), which
# ``_trunk_child`` recovers from the port's names.
_BLOCK_NAME = re.compile(
    r"(?:resblocks|blocks)_(\d+)$"          # ViT / EVA / ViTamin transformer
    r"|stage(\d+)_block(\d+)$"              # swin / fastvit / convnext
    r"|stage(\d+)_(\d+)$"                   # vitamin MBConv stages
)
_BLOCK_PRELUDE = re.compile(
    r"(?:downsample|merge)(\d+)(?:_.*)?$"   # fastvit/convnext/swin downsample
    r"|stage(\d+)_(?:downsample|pos_emb).*$"
)
_TRUNK_FINAL = ("norm", "ln_post", "final_conv")
_HEAD_NAMES = ("head_proj", "head_mlp_fc1", "head_mlp_fc2", "head_norm",
               "fc_norm", "proj")


def _block_sort_key(name: str):
    """Depth-sortable key for a block-ish trunk child, or None."""
    m = _BLOCK_NAME.fullmatch(name)
    if m:
        if m.group(1) is not None:          # (res)blocks_{i}: after conv stages
            return (100, int(m.group(1)), 1)
        if m.group(2) is not None:          # stage{s}_block{b}
            return (int(m.group(2)), int(m.group(3)), 1)
        return (int(m.group(4)), int(m.group(5)), 1)  # vitamin stage{s}_{b}
    m = _BLOCK_PRELUDE.fullmatch(name)
    if m:
        s = int(next(g for g in m.groups() if g is not None))
        return (s, -1, 0)                   # groups with the stage's 1st block
    return None


def _trunk_child(rest: str) -> str:
    """The flax trunk child of a port name under ``visual.trunk.``: an
    unrolled stack's ``blocks.{i}`` is flax's ``blocks_{i}``."""
    parts = rest.split(".")
    if len(parts) > 2 and parts[1].isdigit():
        return f"{parts[0]}_{parts[1]}"
    return parts[0]


def _trunk_groups(children):
    """child name -> group ordinal for a trunk's children; returns
    (mapping, number of blocks) (train_state.py:103-120)."""
    keyed = [(k, _block_sort_key(k)) for k in dict.fromkeys(children)]
    blocks = sorted((key, name) for name, key in keyed if key is not None)
    # preludes (key[2] == 0) share the ordinal of the next real block
    mapping, ordinal = {}, -1
    for key, name in blocks:
        if key[2] == 1:
            ordinal += 1
            mapping[name] = ordinal
        else:
            mapping[name] = ordinal + 1
    nb = ordinal + 1
    for name in mapping:  # clamp trailing preludes
        mapping[name] = min(mapping[name], max(nb - 1, 0))
    return mapping, nb


def _timm_visual_group_of(rest: str, groups) -> tuple:
    """(group, total groups) of a timm tower's parameter (its name without
    "visual."), given the trunk's ``_trunk_groups`` (train_state.py:123-142)."""
    mapping, nb = groups
    total = nb + 2
    parts = rest.split(".")
    if parts[0] == "trunk" and len(parts) > 1:
        child = _trunk_child(rest[len("trunk."):])
        if child in mapping:
            g = mapping[child]
            # the last block and the final norm form one group, like ln_post
            return (min(g, nb - 1) + 1 if g < nb - 1 else nb, total)
        if child in _TRUNK_FINAL:
            return (nb, total)
        return (0, total)  # patch_embed / cls_token / pos_embed / stem
    if parts[0] in _HEAD_NAMES:
        return (nb + 1, total)
    return (0, total)


def trainable_mask(params: Dict[str, torch.Tensor], lock_image: bool = False,
                   lock_image_unlocked_groups: int = 0,
                   lock_text: bool = False,
                   lock_text_unlocked_layers: int = 0,
                   lock_text_freeze_layer_norm: bool = False,
                   num_vision_blocks: Optional[int] = None,
                   num_text_blocks: Optional[int] = None) -> Dict[str, bool]:
    """True = trainable: LiT-style tower locking (train_state.py:158-215).
    A timm tower's groups come from its trunk's children
    (``_trunk_groups``). With ``lock_text``, a text LayerNorm stays
    trainable only where its name holds ``.ln_`` or ``LayerNorm``, as
    JAX's ``/ln_`` rule has it, so a BERT tower's ``embeddings_ln``,
    ``out_ln`` and ``output_ln`` lock with the rest."""
    def count_blocks(tower):
        return len({_block_index(n) for n in params
                    if n.startswith(f"{tower}.transformer.resblocks.")})

    nv = num_vision_blocks or count_blocks("visual")
    nt = num_text_blocks or count_blocks("text")
    trunk = [_trunk_child(n[len("visual.trunk."):]) for n in params
             if n.startswith("visual.trunk.")]
    timm_groups = _trunk_groups(trunk) if nv == 0 and trunk else None

    def rule(p):
        if lock_image and p.startswith("visual."):
            if lock_image_unlocked_groups == 0:
                return False
            if timm_groups is not None:
                g, total = _timm_visual_group_of(p[len("visual."):],
                                                 timm_groups)
            else:
                g, total = _vit_group_of(p[len("visual."):], nv), nv + 2
            return g >= total - lock_image_unlocked_groups
        if lock_text and p.startswith("text."):
            if not lock_text_freeze_layer_norm and (
                    ".ln_" in p or "LayerNorm" in p
                    or p.endswith("ln_final.scale")
                    or p.endswith("ln_final.bias")):
                return True
            if lock_text_unlocked_layers == 0:
                return False
            g = _text_group_of(p[len("text."):], nt)
            if g < 0:
                return False
            return g >= nt + 1 - lock_text_unlocked_layers
        return True

    return {name: rule(name) for name in params}


class AdamW:
    """optax ``adamw`` (+ optional ``clip_by_global_norm``) over the
    trainable parameters: a ``torch.optim.AdamW`` with a decay and a
    no-decay group, its lr set from ``schedule`` at each update."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Callable,
                 beta1: float, beta2: float, eps: float, weight_decay: float,
                 grad_clip_norm: Optional[float],
                 train_mask: Optional[Dict[str, bool]]):
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        wd = decay_mask(params)
        self.trainable = [p for n, p in params.items()
                          if train_mask is None or train_mask[n]]
        groups = [
            {"params": [p for n, p in params.items()
                        if (train_mask is None or train_mask[n]) and wd[n]],
             "weight_decay": weight_decay},
            {"params": [p for n, p in params.items()
                        if (train_mask is None or train_mask[n]) and not wd[n]],
             "weight_decay": 0.0},
        ]
        self.optimizer = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=0.0, betas=(beta1, beta2),
            eps=eps)

    def update(self, count: int) -> None:
        """One update from the parameters' ``.grad`` (a missing gradient
        counts as zero, as in JAX, where every leaf has one)."""
        for p in self.trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip_norm is not None:
            grads = [p.grad for p in self.trainable]
            norm = optax_global_norm(grads)
            for g in grads:
                g.copy_(torch.where(norm < self.grad_clip_norm, g,
                                    g / norm * self.grad_clip_norm))
        lr = self.schedule(count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()


def optax_global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32
    (loop.py:262-265), as one multi-tensor norm: a step has ~400
    gradients, and three ops for each cost more host time than the
    device work they launch."""
    return torch.nn.utils.get_total_norm(
        [t if t.dtype == torch.float32 else t.float() for t in tensors], 2.0)


def make_optimizer(schedule: Callable, beta1: float = 0.9,
                   beta2: float = 0.98, eps: float = 1e-6,
                   weight_decay: float = 0.2,
                   grad_clip_norm: Optional[float] = None,
                   params: Optional[Dict[str, torch.Tensor]] = None,
                   train_mask: Optional[Dict[str, bool]] = None,
                   opt: str = "adamw") -> AdamW:
    """The ``--opt adamw`` optimizer over ``params`` (name -> parameter);
    the other ``--opt`` values are not ported yet."""
    name = (opt or "adamw").lower().replace("timm/", "")
    if name != "adamw":
        raise NotImplementedError(f"--opt {opt!r} is not ported yet")
    if params is None:
        raise ValueError("make_optimizer needs the parameters to optimize")
    return AdamW(params, schedule, beta1, beta2, eps, weight_decay,
                 grad_clip_norm, train_mask)


@dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: AdamW


def create_train_state(model: nn.Module, tx: AdamW) -> TrainState:
    return TrainState(step=0, model=model, tx=tx)


@torch.no_grad()
def apply_gradients(state: TrainState) -> TrainState:
    """One optimizer update from the gradients in ``.grad``, then
    logit_scale.clamp_(0, ln 100) on the top-level scale
    (train_state.py:293-304)."""
    state.tx.update(state.step)
    scale = getattr(state.model, "logit_scale", None)
    if isinstance(scale, torch.Tensor):
        scale.clamp_(0.0, MAX_LOGIT_SCALE)
    state.step += 1
    return state
