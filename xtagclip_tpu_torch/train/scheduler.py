"""LR schedules (port of xtagclip_tpu/train/scheduler.py:14-77): const_lr,
const_lr_cooldown and cosine_lr with linear warmup.

Each returns a plain function from step to lr (a Python float). The JAX
schedules compute in float32; these do too (numpy float32), so both give
the same numbers.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def _warmup_lr(base_lr, warmup_length, step):
    return _F32(base_lr) * (step + _F32(1.0)) / _F32(max(1.0, float(warmup_length)))


def const_lr(base_lr, warmup_length, steps):
    def schedule(step) -> float:
        step = _F32(step)
        if step < warmup_length:
            return float(_warmup_lr(base_lr, warmup_length, step))
        return float(_F32(base_lr))

    return schedule


def const_lr_cooldown(base_lr, warmup_length, steps, cooldown_steps,
                      cooldown_power=1.0, cooldown_end_lr=0.0):
    start_cooldown_step = steps - cooldown_steps

    def schedule(step) -> float:
        step = _F32(step)
        if step < warmup_length:
            return float(_warmup_lr(base_lr, warmup_length, step))
        if step < start_cooldown_step:
            return float(_F32(base_lr))
        e = max(step - _F32(start_cooldown_step), _F32(0.0))
        decay = (_F32(1.0) - e / _F32(cooldown_steps)) ** _F32(cooldown_power)
        return float(decay * _F32(base_lr - cooldown_end_lr)
                     + _F32(cooldown_end_lr))

    return schedule


def cosine_lr(base_lr, warmup_length, steps):
    es = max(1, steps - warmup_length)

    def schedule(step) -> float:
        step = _F32(step)
        if step < warmup_length:
            return float(_warmup_lr(base_lr, warmup_length, step))
        e = max(step - _F32(warmup_length), _F32(0.0))
        return float(_F32(0.5) * (_F32(1.0) + np.cos(_F32(np.pi) * e / _F32(es)))
                     * _F32(base_lr))

    return schedule


def create_scheduler(args, total_steps: int):
    """The schedule the train CLI's flags select (args: lr, warmup,
    lr_scheduler, skip_scheduler, epochs, epochs_cooldown,
    lr_cooldown_power, lr_cooldown_end)."""
    if args.skip_scheduler:
        return lambda step: float(_F32(args.lr))
    if args.lr_scheduler == "cosine":
        return cosine_lr(args.lr, args.warmup, total_steps)
    if args.lr_scheduler == "const":
        return const_lr(args.lr, args.warmup, total_steps)
    if args.lr_scheduler == "const-cooldown":
        cooldown_steps = (
            total_steps * args.epochs_cooldown // args.epochs
            if args.epochs_cooldown else total_steps
        )
        return const_lr_cooldown(
            args.lr, args.warmup, total_steps, cooldown_steps,
            args.lr_cooldown_power, args.lr_cooldown_end,
        )
    raise ValueError(f"Unknown scheduler {args.lr_scheduler}")
