"""Train state: the ``--opt`` optimizers with the reference's no-decay
partition, tower locking through trainability masks, and the post-step
logit_scale clamp (port of xtagclip_tpu/train/train_state.py).

Masks are dicts from the port's parameter names (``model.named_parameters()``,
the flax paths joined by "." with the unrolled stacks as
``resblocks.{i}`` etc., convert/from_jax.port_name) to bools.

Each optax optimizer of JAX's ``make_optimizer`` is a
``torch.optim.Optimizer`` over the trainable parameters, in a decay and a
no-decay group where it decays: ``adamw``, ``adam`` and ``sgd`` are
PyTorch's (the same arithmetic as optax's), ``lion`` and ``adafactor``
are written here as optax computes them. The lr is set from the schedule
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

import numpy as np
import torch
from torch import nn

from xtagclip_tpu_torch.parallel.sharding import (
    full,
    is_sharded,
    jax_axes,
    local,
    local_piece,
)

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


class Optimizer:
    """optax's ``chain(clip_by_global_norm, <optimizer>)`` inside
    ``multi_transform`` over the trainable parameters
    (train_state.py:257-270): ``optimizer`` (a ``torch.optim.Optimizer``
    over the trainable parameters only, its checkpointed state included)
    steps from ``.grad`` with the lr that ``schedule`` gives at the update
    count, as optax reads the schedule at its count."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable,
                 grad_clip_norm: Optional[float]):
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.trainable = [p for g in optimizer.param_groups
                          for p in g["params"]]

    def update(self, count: int) -> None:
        """One update from the parameters' ``.grad`` (a missing gradient
        counts as zero, as in JAX, where every leaf has one)."""
        for p in self.trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip_norm is not None:
            grads = [p.grad for p in self.trainable]
            norm = optax_global_norm(grads)
            for g in map(local, grads):
                g.copy_(torch.where(norm < self.grad_clip_norm, g,
                                    g / norm * self.grad_clip_norm))
        lr = self.schedule(count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()


def optax_global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (loop.py:262-265), as
    one multi-tensor norm (a step has ~400 gradients, and three ops for
    each cost more host time than the device work they launch), summed in
    fp64 and returned in fp32: a CPU's fp32 norm of a 2.4M-element
    gradient is off by 1e-4, so that two summation orders of the same
    gradients (one process, DDP, FSDP's pieces) would disagree at that
    size. Over FSDP's sharded gradients (beside the whole ones of the
    parameters it leaves whole) it is the norm of the whole gradients: the
    pieces' squares are summed over the ranks."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    sq = torch.stack(torch._foreach_norm(
        [local(t) for t in tensors], 2.0, dtype=torch.float64)).square()
    sharded = torch.tensor([is_sharded(t) for t in tensors],
                           device=sq.device)
    if sharded.any():
        pieces = sq[sharded].sum()
        torch.distributed.all_reduce(pieces)
        return (pieces + sq[~sharded].sum()).sqrt().float()
    return sq.sum().sqrt().float()


class Lion(torch.optim.Optimizer):
    """optax ``lion`` (``scale_by_lion``, ``add_decayed_weights`` and the
    learning rate): ``u = sign((1 - b1) g + b1 m)``, ``m <- (1 - b2) g +
    b2 m``, ``p <- p - lr (u + wd p)``, each group with its own decay, in
    multi-tensor ops. PyTorch has no Lion."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.99),
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ps = group["params"]
            grads = [p.grad for p in ps]
            mus = []
            for p in ps:
                if "exp_avg" not in self.state[p]:
                    self.state[p]["exp_avg"] = torch.zeros_like(p)
                mus.append(self.state[p]["exp_avg"])
            u = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(u, torch._foreach_mul(mus, b1))
            torch._foreach_sign_(u)
            torch._foreach_mul_(mus, b2)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - b2))
            if group["weight_decay"]:
                torch._foreach_add_(
                    u, torch._foreach_mul(ps, group["weight_decay"]))
            torch._foreach_mul_(u, -group["lr"])
            torch._foreach_add_(ps, u)


def factored_dims(p: torch.Tensor, min_dim_size_to_factor: int = 128):
    """optax's ``_factored_dims`` on the leaf's JAX shape, as port axes:
    (the second largest axis, the largest) where the second largest has
    at least ``min_dim_size_to_factor`` entries, else None. The axes are
    picked on the JAX shape, ties and all, so a transposed conv kernel
    factors over the same physical axes as in JAX."""
    if p.dim() < 2:
        return None
    axes = jax_axes(p)
    shape = [p.shape[a] for a in axes]
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return axes[order[-2]], axes[order[-1]]


class Adafactor(torch.optim.Optimizer):
    """optax ``adafactor(learning_rate)`` with its defaults, as optax's
    chain: ``scale_by_factored_rms`` (decay rate 0.8, factored over the
    two largest axes where the second is >= 128, eps 1e-30),
    ``clip_by_block_rms(1.0)``, the learning rate,
    ``scale_by_param_block_rms`` (min scale 1e-3), no momentum, no decay.
    ``torch.optim.Adafactor`` is another algorithm (its decay, clipping
    and parameter scale differ). The unfactored leaves' statistics, the
    block norms and the update run as multi-tensor ops; the factored
    leaves' row and column statistics leaf by leaf. Every leaf of a group
    steps together, so they share optax's count. Over FSDP's sharded
    parameters it steps on the whole leaves (the factored statistics and
    the block norms are the whole leaf's) and each rank keeps its piece
    of the result; the statistics are whole tensors."""

    # optax's defaults, the only values JAX's make_optimizer passes
    DECAY_RATE, MIN_DIM_SIZE_TO_FACTOR, EPS = 0.8, 128, 1e-30
    CLIPPING_THRESHOLD, MIN_SCALE = 1.0, 1e-3

    def __init__(self, params, lr: float = 0.0):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            self._step_group(group)

    def _init_state(self, p, whole) -> None:
        state = self.state[p]
        if state:
            return
        state["step"] = 0
        dims = factored_dims(whole, self.MIN_DIM_SIZE_TO_FACTOR)
        if dims is None:
            state["v"] = torch.zeros_like(whole)
        else:
            d1, d0 = dims
            state["v_row"] = torch.zeros_like(whole).mean(dim=d0)
            state["v_col"] = torch.zeros_like(whole).mean(dim=d1)

    def _step_group(self, group) -> None:
        owners = group["params"]
        ps = [full(p) for p in owners]
        for p, whole in zip(owners, ps):
            self._init_state(p, whole)
        # optax's _decay_rate_pow, in fp32 as there
        t = np.float32(self.state[owners[0]]["step"] + 1)
        rate = float(np.float32(1.0) - t ** np.float32(-self.DECAY_RATE))
        grads = [full(p.grad) for p in owners]
        grad_sqr = torch._foreach_mul(grads, grads)
        torch._foreach_add_(grad_sqr, self.EPS)
        updates = [None] * len(ps)
        flat = [i for i, p in enumerate(owners) if "v" in self.state[p]]
        if flat:
            vs = [self.state[owners[i]]["v"] for i in flat]
            torch._foreach_mul_(vs, rate)
            torch._foreach_add_(vs, torch._foreach_mul(
                [grad_sqr[i] for i in flat], 1.0 - rate))
            for i, u in zip(flat, torch._foreach_mul(
                    [grads[i] for i in flat], torch._foreach_pow(vs, -0.5))):
                updates[i] = u
        for i, p in enumerate(ps):
            if updates[i] is not None:
                continue
            state = self.state[owners[i]]
            d1, d0 = factored_dims(p, self.MIN_DIM_SIZE_TO_FACTOR)
            v_row = state["v_row"].mul_(rate).add_(
                (1.0 - rate) * grad_sqr[i].mean(dim=d0))
            v_col = state["v_col"].mul_(rate).add_(
                (1.0 - rate) * grad_sqr[i].mean(dim=d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)
                          ).pow(-0.5)
            updates[i] = (grads[i] * row_factor.unsqueeze(d0)
                          * v_col.pow(-0.5).unsqueeze(d1))
        # clip_by_block_rms, the learning rate and scale_by_param_block_rms:
        # one scale a leaf, from the leaves' block norms, summed in fp64 (a
        # CPU's fp32 norm of a 25M-element embedding is off by 1e-3)
        root_n = torch.tensor([u.numel() for u in updates],
                              dtype=torch.float64, device=ps[0].device).sqrt()
        u_rms = (torch.stack(torch._foreach_norm(
            updates, 2, dtype=torch.float64)) / root_n).float()
        p_rms = (torch.stack(torch._foreach_norm(
            ps, 2, dtype=torch.float64)) / root_n).float()
        p_rms = torch.where(p_rms <= self.MIN_SCALE,
                            torch.full_like(p_rms, self.MIN_SCALE), p_rms)
        scale = group["lr"] * p_rms / torch.clamp(
            u_rms / self.CLIPPING_THRESHOLD, min=1.0)
        torch._foreach_mul_(updates, list(scale.unbind()))
        torch._foreach_sub_(ps, updates)
        for p, whole in zip(owners, ps):
            if is_sharded(p):
                p.to_local().copy_(local_piece(whole, p))
            self.state[p]["step"] += 1


def _groups(params: Dict[str, torch.Tensor],
            train_mask: Optional[Dict[str, bool]],
            weight_decay: Optional[float]) -> list:
    """The trainable parameters as optimizer groups: one decayed and one
    not (``decay_mask``), or one group where the optimizer decays
    nothing (``weight_decay`` None)."""
    trainable = {n: p for n, p in params.items()
                 if train_mask is None or train_mask[n]}
    if weight_decay is None:
        return [{"params": list(trainable.values())}]
    wd = decay_mask(params)
    groups = [
        {"params": [p for n, p in trainable.items() if wd[n]],
         "weight_decay": weight_decay},
        {"params": [p for n, p in trainable.items() if not wd[n]],
         "weight_decay": 0.0},
    ]
    return [g for g in groups if g["params"]]


def make_optimizer(schedule: Callable, beta1: float = 0.9,
                   beta2: float = 0.98, eps: float = 1e-6,
                   weight_decay: float = 0.2,
                   grad_clip_norm: Optional[float] = None,
                   params: Optional[Dict[str, torch.Tensor]] = None,
                   train_mask: Optional[Dict[str, bool]] = None,
                   opt: str = "adamw",
                   momentum: Optional[float] = None) -> Optimizer:
    """The ``--opt`` optimizer over ``params`` (name -> parameter), as JAX's
    ``make_optimizer`` (train_state.py:218-270) picks it: adamw (decay
    masked), adam (no decay: JAX ignores ``--wd`` there), sgd (decay
    masked, then momentum 0.9 when ``momentum`` is None), lion (decay
    masked) and adafactor (optax's defaults, the lr from ``schedule``).
    Every one runs behind the optional global-norm clip and the train
    mask. An unknown name raises ValueError."""
    name = (opt or "adamw").lower().replace("timm/", "")
    if params is None:
        raise ValueError("make_optimizer needs the parameters to optimize")
    if name == "adamw":
        optimizer = torch.optim.AdamW(
            _groups(params, train_mask, weight_decay), lr=0.0,
            betas=(beta1, beta2), eps=eps)
    elif name == "adam":
        optimizer = torch.optim.Adam(_groups(params, train_mask, None),
                                     lr=0.0, betas=(beta1, beta2), eps=eps)
    elif name == "sgd":
        optimizer = torch.optim.SGD(
            _groups(params, train_mask, weight_decay), lr=0.0,
            momentum=0.9 if momentum is None else momentum)
    elif name == "lion":
        optimizer = Lion(_groups(params, train_mask, weight_decay),
                         betas=(beta1, beta2))
    elif name == "adafactor":
        optimizer = Adafactor(_groups(params, train_mask, None))
    else:
        raise ValueError(f"unknown optimizer {opt!r}")
    return Optimizer(optimizer, schedule, grad_clip_norm)


@dataclass
class TrainState:
    """``model`` is the model itself (FSDP shards it in place); ``ddp``
    the DDP wrapper its step runs through across ranks, or None
    (parallel/sharding.py ``wrap_model``)."""
    step: int
    model: nn.Module
    tx: Optimizer
    ddp: Optional[nn.Module] = None


def create_train_state(model: nn.Module, tx: Optimizer,
                       ddp: Optional[nn.Module] = None) -> TrainState:
    return TrainState(step=0, model=model, tx=tx, ddp=ddp)


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
