"""The train steps (port of the CLIP/XTag branch of
xtagclip_tpu/train/loop.py:31-217, and of ``make_accum_train_step``,
:268-386).

One step: the forward in train mode (dropout from an explicit generator),
the XTag loss combination of the reference's train_other.py:117-136,

    total = contrastive + 2 * ASL(tag logits, tile(additional, 2))
            + 2 * (DQNCOS(i2t) + DQNCOS(t2i)),

the backward, one optimizer update and the logit_scale clamp. PyTorch runs
it eagerly: there is no jit, and the gradients live in ``.grad``. The
CoCa, SigLIP and distillation branches of the JAX step are not ported yet
and raise.

A ResNet tower's BatchNorms normalize with batch statistics in the
train-mode forward and move their running ones in place, as JAX's
``mutable=["batch_stats"]`` step returns them (loop.py:40-41, 92).
``lock_image_freeze_bn_stats`` runs the vision tower in eval mode inside
the step: it normalizes with, and keeps, its running statistics
(loop.py:67-87). The accumulation step, as JAX's, ignores that flag; each
of its forwards starts from the step's statistics, and the last
microbatch's pass-2 update is kept (loop.py:283-288, 380-383).

The accumulation step replays the reference's feature cache
(train_other.py:140-216): pass 1 computes every microbatch's features
without gradients; pass 2 runs each microbatch again with gradients
against all the cached negatives, and the summed gradients make one
update. Its objective is the reference's, not the plain step's
(trap 5): contrastive + ASL at 1x, and no DQNCOS.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from xtagclip_tpu_torch.convert.from_jax import stats_buffers
from xtagclip_tpu_torch.losses import asymmetric_loss, clip_loss, dqncos_loss
from xtagclip_tpu_torch.train.train_state import (
    TrainState,
    apply_gradients,
    optax_global_norm,
)

_UNPORTED = ("coca", "siglip")


def _model_losses(model, batch, args_cfg: Dict[str, Any], prompt_table=None,
                  generator=None, deterministic: bool = False, teacher=None):
    """Forward + the XTag loss combination -> (total, metrics).

    batch: ``images`` [B, H, W, 3] normalized, ``class_ids`` [B] (with a
    prompt table) or ``texts`` [B, ctx], optional ``additional`` [B, 22]
    multi-hot tags and ``template_id``. ``deterministic=False`` (the JAX
    step's mode, loop.py:86) needs ``generator`` for the dropout masks."""
    unported = [k for k in _UNPORTED if args_cfg.get(k)]
    if teacher is not None:
        unported.append("distillation")
    if unported:
        raise NotImplementedError(
            f"train-step branches not ported yet: {unported}")
    out = model(batch["images"], text=batch.get("texts"),
                prompt_table=prompt_table, class_ids=batch.get("class_ids"),
                template_id=batch.get("template_id", 0),
                deterministic=deterministic, generator=generator,
                visual_deterministic=bool(args_cfg.get(
                    "lock_image_freeze_bn_stats")))
    logit_scale = out["logit_scale"]
    contrastive = clip_loss(out["image_features"], out["text_features"],
                            logit_scale)
    metrics = {"contrastive_loss": contrastive, "logit_scale": logit_scale}
    total = contrastive
    if args_cfg.get("use_tagging_loss", True) and "additional" in batch:
        target = batch["additional"].repeat(1, 2)
        tag_l = asymmetric_loss(
            out["tag_logits"], target,
            gamma_neg=args_cfg.get("asl_gamma_neg", 4),
            gamma_pos=args_cfg.get("asl_gamma_pos", 1),
            clip=args_cfg.get("asl_clip", 0.05))
        metrics["tagging_loss"] = tag_l
        total = total + 2.0 * tag_l  # double-added as in train_other.py:135-136
    if out.get("i2t_cls") is not None:
        ce = dqncos_loss(out["i2t_cls"]) + dqncos_loss(out["t2i_cls"])
        metrics["ce_loss"] = ce
        total = total + 2.0 * ce
    metrics["loss"] = total
    return total, metrics


def make_train_step(args_cfg: Dict[str, Any], prompt_table=None,
                    teacher=None):
    """(state, batch, generator) -> (state, metrics): one step, with the
    metrics JAX returns (``contrastive_loss``, ``tagging_loss``,
    ``ce_loss``, ``loss``, ``logit_scale``, ``grad_norm``) as detached
    tensors on the model's device. ``generator`` draws this step's dropout
    masks; being stateful, it gives each step its own. The state is
    updated in place."""

    def step(state: TrainState, batch, generator):
        model = state.model
        model.zero_grad(set_to_none=True)
        total, metrics = _model_losses(model, batch, args_cfg, prompt_table,
                                       generator, teacher=teacher)
        total.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        metrics["grad_norm"] = optax_global_norm(grads)
        state = apply_gradients(state)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_accum_train_step(args_cfg: Dict[str, Any], accum_freq: int,
                          prompt_table=None, deterministic: bool = False):
    """(state, batch, generator) -> (state, metrics): one update from
    ``accum_freq`` microbatches. Tensors of ``batch`` are shaped
    [accum_freq, micro_b, ...] (images normalized), scalars are shared.

    Microbatch i draws the same dropout masks in both passes, as the JAX
    step folds the same key into both: the generator's state before its
    pass-1 forward is restored before its pass-2 forward.
    ``deterministic=True`` turns dropout off (the parity tests). The
    metrics are the means over microbatches of ``contrastive_loss``,
    ``tagging_loss``, ``loss`` and ``logit_scale``, as JAX returns them."""
    unported = [k for k in _UNPORTED if args_cfg.get(k)]
    if unported:
        raise NotImplementedError(
            f"train-step branches not ported yet: {unported}")

    def micro(batch, i):
        return {k: v[i] if isinstance(v, torch.Tensor) and v.dim() > 0
                else v for k, v in batch.items()}

    def forward(model, mb, generator):
        return model(mb["images"], text=mb.get("texts"),
                     prompt_table=prompt_table, class_ids=mb.get("class_ids"),
                     template_id=mb.get("template_id", 0),
                     deterministic=deterministic, generator=generator)

    def step(state: TrainState, batch, generator):
        model: nn.Module = state.model
        model.zero_grad(set_to_none=True)
        stats = {n: b.clone() for n, b in stats_buffers(model).items()}

        def restore_stats():
            with torch.no_grad():
                for n, b in stats_buffers(model).items():
                    b.copy_(stats[n])

        gen_states = []
        img_f, txt_f = [], []
        with torch.no_grad():  # pass 1: cache features
            for i in range(accum_freq):
                if not deterministic:
                    gen_states.append(generator.get_state())
                restore_stats()
                out = forward(model, micro(batch, i), generator)
                img_f.append(out["image_features"])
                txt_f.append(out["text_features"])
        per_micro = []
        for i in range(accum_freq):  # pass 2: gradients vs all negatives
            mb = micro(batch, i)
            if not deterministic:
                generator.set_state(gen_states[i])
            restore_stats()
            out = forward(model, mb, generator)
            all_img = torch.cat(img_f[:i] + [out["image_features"]]
                                + img_f[i + 1:])
            all_txt = torch.cat(txt_f[:i] + [out["text_features"]]
                                + txt_f[i + 1:])
            contrastive = clip_loss(all_img, all_txt, out["logit_scale"])
            total = contrastive
            metrics = {"contrastive_loss": contrastive,
                       "logit_scale": out["logit_scale"]}
            # reference accum objective (train_other.py:191-194): tag loss
            # at 1x and no DQNCOS, unlike the plain step's 2x combination
            if args_cfg.get("use_tagging_loss") and "additional" in mb:
                tag_l = asymmetric_loss(
                    out["tag_logits"], mb["additional"].repeat(1, 2),
                    gamma_neg=args_cfg.get("asl_gamma_neg", 4),
                    gamma_pos=args_cfg.get("asl_gamma_pos", 1),
                    clip=args_cfg.get("asl_clip", 0.05))
                total = total + tag_l
                metrics["tagging_loss"] = tag_l
            metrics["loss"] = total
            total.backward()  # .grad sums over the microbatches
            per_micro.append({k: v.detach() for k, v in metrics.items()})
        state = apply_gradients(state)
        return state, {k: torch.stack([m[k] for m in per_micro]).mean()
                       for k in per_micro[0]}

    return step
