"""The train steps (port of the CLIP/XTag branch of
xtagclip_tpu/train/loop.py:31-217, and of ``make_accum_train_step``,
:268-386).

One step: the forward in train mode (dropout from an explicit generator),
the XTag loss combination of the reference's train_other.py:117-136,

    total = contrastive + 2 * ASL(tag logits, tile(additional, 2))
            + 2 * (DQNCOS(i2t) + DQNCOS(t2i)),

the backward, one optimizer update and the logit_scale clamp. PyTorch runs
it eagerly: there is no jit, and the gradients live in ``.grad``. With
``args_cfg["coca"]`` the step is CoCa's (loop.py:43-65): the contrastive
loss times ``coca_contrastive_loss_weight`` plus the pad-masked caption
cross-entropy times ``coca_caption_loss_weight`` (losses/coca.py).
With ``args_cfg["siglip"]`` the contrastive term is SigLIP's sigmoid loss
with the model's ``logit_bias`` (loop.py:95-141; on one process JAX's
``else`` at :134-140: every ``siglip_dist_impl`` is the local loss). With a
``teacher`` (loop.py:149-166) the frozen teacher runs deterministic, in
eval mode and under ``torch.no_grad()`` (JAX's ``stop_gradient``) on the
same batch, and ``distill_loss`` of the student's logits against its
logits is added to the total and recorded as ``distill_loss``.

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
update; with ``args_cfg["siglip"]`` its contrastive term is the SigLIP
loss over the whole cached batch, a missing bias taken as 0
(loop.py:343-349). It takes no teacher: the CLIs drop the distillation
with ``--accum-freq`` > 1, as JAX's do. Its objective is the reference's,
not the plain step's (trap 5): contrastive + ASL at 1x, and no DQNCOS.
JAX's accumulation step cannot run a CoCa model: it calls the model with
the XTag keywords (``prompt_table``, ``class_ids``, ``template_id``),
which CoCa's ``__call__`` does not take, and raises TypeError at the
first step. The port refuses CoCa there too, when the step is made.

Across ranks (``args_cfg["world_size"]`` > 1, each rank stepping on its
share of the global batch; under ``--model-parallel`` the size and rank
of the data group, core/mesh.py, and every rank of a model group steps on
the same rows) JAX runs one program over the global batch;
the port's step gives each rank a loss whose mean over the ranks is that
program's loss, and DDP or FSDP (parallel/sharding.py) averages the
gradients, so the update is the one-process update on the concatenated
batch. The contrastive, SigLIP, distillation and caption terms gather
across ranks (losses/), the fusion head's queries are every rank's pooled
features and its [b, B] rows are gathered into the global [B, B]
matrices before DQNCOS, and ASL, a sum over the batch, counts W times
on each rank. The accumulation step caches every rank's features of
each microbatch and reduces the gradients only in the last microbatch's
backward. The returned metrics are the means over the ranks: the global
values, as JAX's are. The step runs its forward through ``state.ddp``
where DDP wraps it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from xtagclip_tpu_torch.convert.from_jax import stats_buffers
from xtagclip_tpu_torch.losses import (
    asymmetric_loss,
    caption_loss,
    clip_loss,
    distill_loss,
    dqncos_loss,
    siglip_loss,
)
from xtagclip_tpu_torch.parallel.collectives import (
    gather_rows,
    gather_rows_no_grad,
    mean_over_ranks,
)
from xtagclip_tpu_torch.parallel.sharding import grad_sync, is_model_sharded
from xtagclip_tpu_torch.train.train_state import (
    TrainState,
    apply_gradients,
    optax_global_norm,
)

# metrics that are the same on every rank; the others are averaged
_SHARED_METRICS = ("logit_scale", "grad_norm")


def _ranks(args_cfg):
    """(world size, rank, local_loss) of the step."""
    return (int(args_cfg.get("world_size", 1)), int(args_cfg.get("rank", 0)),
            bool(args_cfg.get("local_loss", False)))


def _run(state: TrainState, fn):
    """``fn(model)``, through DDP where it wraps the model."""
    return state.ddp(fn) if state.ddp is not None else fn(state.model)


def _global(metrics: Dict[str, torch.Tensor], world: int):
    """The metrics averaged over the ranks (module doc)."""
    if world == 1:
        return metrics
    keys = [k for k in metrics if k not in _SHARED_METRICS]
    means = mean_over_ranks([metrics[k] for k in keys])
    return {**metrics, **dict(zip(keys, means))}


def _tag_loss(out, additional, args_cfg, world: int):
    """ASL of the tag logits against the doubled tags: a sum over the
    batch, counted ``world`` times on each rank (module doc)."""
    tag_l = asymmetric_loss(
        out["tag_logits"], additional.repeat(1, 2),
        gamma_neg=args_cfg.get("asl_gamma_neg", 4),
        gamma_pos=args_cfg.get("asl_gamma_pos", 1),
        clip=args_cfg.get("asl_clip", 0.05))
    return tag_l * world if world > 1 else tag_l


def _model_losses(model, batch, args_cfg: Dict[str, Any], prompt_table=None,
                  generator=None, deterministic: bool = False, teacher=None):
    """Forward + the XTag loss combination -> (total, metrics).

    batch: ``images`` [B, H, W, 3] normalized, ``class_ids`` [B] (with a
    prompt table) or ``texts`` [B, ctx], optional ``additional`` [B, 22]
    multi-hot tags and ``template_id``. ``deterministic=False`` (the JAX
    step's mode, loop.py:86) needs ``generator`` for the dropout masks.
    ``teacher``: a model whose features and scale the student distills
    (module doc)."""
    if args_cfg.get("coca"):
        return _coca_losses(model, batch, args_cfg, generator,
                            deterministic)
    world, rank, local_loss = _ranks(args_cfg)
    out = model(batch["images"], text=batch.get("texts"),
                prompt_table=prompt_table, class_ids=batch.get("class_ids"),
                template_id=batch.get("template_id", 0),
                deterministic=deterministic, generator=generator,
                visual_deterministic=bool(args_cfg.get(
                    "lock_image_freeze_bn_stats")),
                **({"gather_queries": gather_rows} if world > 1 else {}))
    logit_scale = out["logit_scale"]
    if args_cfg.get("siglip"):
        contrastive = siglip_loss(
            out["image_features"], out["text_features"], logit_scale,
            out.get("logit_bias"), args_cfg.get("siglip_dist_impl", "shift"),
            world, rank)
    else:
        contrastive = clip_loss(out["image_features"], out["text_features"],
                                logit_scale, local_loss, world, rank)
    metrics = {"contrastive_loss": contrastive, "logit_scale": logit_scale}
    total = contrastive
    if teacher is not None:
        teacher.eval()
        with torch.no_grad():
            t_out = teacher(batch["images"], text=batch.get("texts"),
                            prompt_table=prompt_table,
                            class_ids=batch.get("class_ids"),
                            template_id=batch.get("template_id", 0),
                            deterministic=True)
        dist_l = distill_loss(out["image_features"], out["text_features"],
                              logit_scale, t_out["image_features"],
                              t_out["text_features"], t_out["logit_scale"],
                              local_loss, world, rank)
        metrics["distill_loss"] = dist_l
        total = total + dist_l
    if args_cfg.get("use_tagging_loss", True) and "additional" in batch:
        tag_l = _tag_loss(out, batch["additional"], args_cfg, world)
        metrics["tagging_loss"] = tag_l
        total = total + 2.0 * tag_l  # double-added as in train_other.py:135-136
    if out.get("i2t_cls") is not None:
        # this rank's rows of the global [B, B] matrices, gathered whole
        i2t, t2i = out["i2t_cls"], out["t2i_cls"]
        if world > 1:
            i2t, t2i = gather_rows(i2t), gather_rows(t2i)
        ce = dqncos_loss(i2t) + dqncos_loss(t2i)
        metrics["ce_loss"] = ce
        total = total + 2.0 * ce
    metrics["loss"] = total
    return total, metrics


def _coca_losses(model, batch, args_cfg, generator, deterministic):
    """CoCa's branch (loop.py:43-65): contrastive + pad-masked caption
    cross-entropy over the decoder's fp32 logits, each times its weight."""
    world, rank, local_loss = _ranks(args_cfg)
    out = model(batch["images"], batch["texts"],
                generator=None if deterministic else generator)
    contrastive = clip_loss(out["image_features"], out["text_features"],
                            out["logit_scale"], local_loss, world,
                            rank) * args_cfg.get(
                                "coca_contrastive_loss_weight", 1.0)
    caption = caption_loss(out["logits"], out["labels"],
                           args_cfg.get("pad_id", 0), world) * args_cfg.get(
                               "coca_caption_loss_weight", 2.0)
    total = contrastive + caption
    return total, {"contrastive_loss": contrastive, "caption_loss": caption,
                   "logit_scale": out["logit_scale"], "loss": total}


def make_train_step(args_cfg: Dict[str, Any], prompt_table=None,
                    teacher=None, deterministic: bool = False):
    """(state, batch, generator) -> (state, metrics): one step, with the
    metrics JAX returns (``contrastive_loss``, ``tagging_loss``,
    ``ce_loss``, ``loss``, ``logit_scale``, ``grad_norm``) as detached
    tensors on the model's device. ``generator`` draws this step's dropout
    masks; being stateful, it gives each step its own. The state is
    updated in place. ``deterministic=True`` turns dropout off (the
    parity tests)."""

    world = _ranks(args_cfg)[0]

    def step(state: TrainState, batch, generator):
        model = state.model
        model.zero_grad(set_to_none=True)
        total, metrics = _run(state, lambda m: _model_losses(
            m, batch, args_cfg, prompt_table, generator, deterministic,
            teacher))
        total.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        metrics["grad_norm"] = optax_global_norm(
            [p.grad for p in params], [is_model_sharded(p) for p in params])
        state = apply_gradients(state)
        return state, _global({k: v.detach() for k, v in metrics.items()},
                              world)

    return step


def make_multi_step(args_cfg: Dict[str, Any], num_steps: int,
                    prompt_table=None, teacher=None,
                    deterministic: bool = False):
    """(state, batches, generator) -> (state, metrics): ``num_steps``
    optimizer steps in one call (JAX's ``make_multi_step``,
    loop.py:220-259, a ``lax.scan`` of the step over stacked batches).
    Every tensor of ``batches`` is stacked [K, B, ...]; step k is
    ``make_train_step``'s step on the k-th slice, in order, drawing its
    dropout masks from ``generator`` after step k - 1 drew its own (JAX
    splits its key K ways instead). ``state.step`` advances by K, and the
    metrics come back stacked [K] under ``make_train_step``'s keys."""
    if num_steps < 1:
        raise ValueError(f"make_multi_step: num_steps must be >= 1, got "
                         f"{num_steps}")
    one = make_train_step(args_cfg, prompt_table, teacher, deterministic)

    def multi(state: TrainState, batches, generator):
        for key, v in batches.items():
            if v.shape[:1] != (num_steps,):
                raise ValueError(f"make_multi_step: batches[{key!r}] must be "
                                 f"stacked [{num_steps}, ...], got "
                                 f"{tuple(v.shape)}")
        per_step = []
        for k in range(num_steps):
            state, metrics = one(state, {key: v[k] for key, v in
                                         batches.items()}, generator)
            per_step.append(metrics)
        return state, {key: torch.stack([m[key] for m in per_step])
                       for key in per_step[0]}

    return multi


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
    if args_cfg.get("coca"):
        raise TypeError(
            "the accumulation step cannot run a CoCa model (--accum-freq "
            "> 1): it calls the model with the XTag keywords, as JAX's "
            "make_accum_train_step does, which raises TypeError for CoCa "
            "(ROADMAP Queue 3)")

    def micro(batch, i):
        return {k: v[i] if isinstance(v, torch.Tensor) and v.dim() > 0
                else v for k, v in batch.items()}

    def forward(model, mb, generator):
        return model(mb["images"], text=mb.get("texts"),
                     prompt_table=prompt_table, class_ids=mb.get("class_ids"),
                     template_id=mb.get("template_id", 0),
                     deterministic=deterministic, generator=generator)

    world = _ranks(args_cfg)[0]

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
                img_f.append(gather_rows_no_grad(out["image_features"]))
                txt_f.append(gather_rows_no_grad(out["text_features"]))

        def losses(m, mb, i):
            """Microbatch i's pass-2 loss against every cached feature of
            every rank (the global loss on each rank), + its tag loss."""
            out = forward(m, mb, generator)
            all_img = torch.cat(img_f[:i] + [gather_rows(
                out["image_features"])] + img_f[i + 1:])
            all_txt = torch.cat(txt_f[:i] + [gather_rows(
                out["text_features"])] + txt_f[i + 1:])
            if args_cfg.get("siglip"):
                bias = out.get("logit_bias")
                if bias is None:
                    bias = torch.zeros((), device=all_img.device)
                contrastive = siglip_loss(all_img, all_txt,
                                          out["logit_scale"], bias)
            else:
                contrastive = clip_loss(all_img, all_txt, out["logit_scale"])
            total = contrastive
            metrics = {"contrastive_loss": contrastive,
                       "logit_scale": out["logit_scale"]}
            # reference accum objective (train_other.py:191-194): tag loss
            # at 1x and no DQNCOS, unlike the plain step's 2x combination
            if args_cfg.get("use_tagging_loss") and "additional" in mb:
                tag_l = _tag_loss(out, mb["additional"], args_cfg, world)
                total = total + tag_l
                metrics["tagging_loss"] = tag_l
            metrics["loss"] = total
            return total, metrics

        per_micro = []
        for i in range(accum_freq):  # pass 2: gradients vs all negatives
            mb = micro(batch, i)
            if not deterministic:
                generator.set_state(gen_states[i])
            restore_stats()
            with grad_sync(state.ddp, model, i == accum_freq - 1):
                total, metrics = _run(state, lambda m: losses(m, mb, i))
                total.backward()  # .grad sums over the microbatches
            per_micro.append({k: v.detach() for k, v in metrics.items()})
        state = apply_gradients(state)
        return state, _global({k: torch.stack([m[k] for m in per_micro]).mean()
                               for k in per_micro[0]}, world)

    return step
