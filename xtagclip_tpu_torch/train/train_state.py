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


def trainable_mask(params: Dict[str, torch.Tensor], lock_image: bool = False,
                   lock_image_unlocked_groups: int = 0,
                   lock_text: bool = False,
                   lock_text_unlocked_layers: int = 0,
                   lock_text_freeze_layer_norm: bool = False,
                   num_vision_blocks: Optional[int] = None,
                   num_text_blocks: Optional[int] = None) -> Dict[str, bool]:
    """True = trainable: LiT-style tower locking (train_state.py:158-215)
    for the ViT and text-transformer towers."""
    def count_blocks(tower):
        return len({_block_index(n) for n in params
                    if n.startswith(f"{tower}.transformer.resblocks.")})

    nv = num_vision_blocks or count_blocks("visual")
    nt = num_text_blocks or count_blocks("text")
    if lock_image and nv == 0 and any(n.startswith("visual.trunk.")
                                      for n in params):
        raise NotImplementedError(
            "locking a timm-trunk vision tower is not ported yet")

    def rule(p):
        if lock_image and p.startswith("visual."):
            if lock_image_unlocked_groups == 0:
                return False
            g = _vit_group_of(p[len("visual."):], nv)
            return g >= nv + 2 - lock_image_unlocked_groups
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
