"""The vanilla CLIP training CLI, open_clip_train.main's counterpart (port
of xtagclip_tpu/cli/main.py:40-246; the entry of scripts/h14_*.sh, the
CLIPA ViT-H/14 recipe):

    python -m xtagclip_tpu_torch.cli.main --model ViT-H-14-CL32-GAP \\
        --dataset-type synthetic --train-num-samples 1792 --batch-size 256 \\
        --precision amp_bf16 --force-image-size 224 --grad-checkpointing \\
        --pretrained logs/stage1/checkpoints/epoch_1 ...

parse (train/params.py, without the XTag flags) -> experiment naming and
out.log -> optional tensorboard / wandb sinks -> ``--remote-sync`` (as
main_other's; JAX's cli/main.py ignores the flag) -> the model on ``--device``
(default cuda) with ``--force-image-size``, ``--force-quick-gelu``,
``--force-patch-dropout``, ``--grad-checkpointing``, the
``--image-*`` preprocessing and ``--pretrained`` (a registry tag, URL or
``hf-hub:`` id, fetched into ``--cache-dir``; a local open_clip .pt, a
big_vision .npz or a port checkpoint tag; position tables of another
length are resized) ->
with ``--torchscript``/``--trace`` the serving artifact
(convert/serving.py) under ``<checkpoints>/serving`` -> resume latest ->
data (``get_data``: CSV, synthetic or webdataset shards; ``--imagenet-val``
an image folder) -> without train data one ``evaluate`` (the 336 px
script's zero-shot ImageNet eval) -> tower locks, AdamW and the
schedule -> ``--resume`` (a checkpoint tag: the full train state; a file:
the weights) -> ``--distill-model`` (with ``--distill-pretrained``, resolved
as ``--pretrained``), the frozen teacher, built with the
student's precision and ``--force-image-size`` -> the contrastive step
(``--siglip``: SigLIP's sigmoid loss with the model's ``logit_bias``;
``--model coca_*``: CoCa's contrastive + caption step, weighted by
``--coca-contrastive-loss-weight`` and ``--coca-caption-loss-weight``; a
teacher adds the distillation term; ``--accum-freq`` > 1: the
accumulation step, which refuses CoCa as JAX's does and drops the
distillation with JAX's warning) -> per epoch: ``train_one_epoch``,
``evaluate`` (train/evaluate.py) and the epoch checkpoint.

Under a launcher (``torchrun --nproc_per_node N -m
xtagclip_tpu_torch.cli.main ...``) the run is data-parallel across the
ranks as cli/main_other.py describes: DDP, or FSDP2 with ``--fsdp`` (the
teacher sharded too, without gradients), ``--local-loss`` and
``--loss-dist-impl`` choose how the contrastive terms span the ranks,
and ``--gather-with-grad`` changes nothing (the gathers always carry
their gradient, as JAX's). Flags whose branches are not ported
(train/params.py ``unported``) raise NotImplementedError.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time

import torch
import torch.distributed as dist

from xtagclip_tpu_torch.cli.main_other import (
    PRECISION,
    build_train_state,
    resolve_resume,
    start_run,
    step_config,
)
from xtagclip_tpu_torch.core.mesh import (
    data_rank_of,
    init_distributed,
    is_master,
)
from xtagclip_tpu_torch.data.registry import get_data
from xtagclip_tpu_torch.factory import (
    cast_for_compute,
    create_model_and_transforms,
    get_cast_dtype,
    get_tokenizer,
)
from xtagclip_tpu_torch.parallel.sharding import fully_shard_model, unsharded
from xtagclip_tpu_torch.train.checkpoint import CheckpointManager, state_tree
from xtagclip_tpu_torch.train.evaluate import evaluate
from xtagclip_tpu_torch.train.file_utils import remote_sync_running
from xtagclip_tpu_torch.train.loop import make_accum_train_step, make_train_step
from xtagclip_tpu_torch.train.params import parse_args, unported
from xtagclip_tpu_torch.train.scheduler import create_scheduler
from xtagclip_tpu_torch.train.trainer import train_one_epoch


def _sinks(args, log_base_path):
    """The tensorboard writer of ``--report-to tensorboard`` (or None) and
    wandb's run, where the packages exist (a warning where they do not)."""
    tb_writer = None
    if "tensorboard" in (args.report_to or ""):
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(os.path.join(log_base_path,
                                                   "tensorboard"))
        except ImportError:
            logging.warning("tensorboard unavailable")
    if "wandb" in (args.report_to or ""):
        try:
            import wandb

            wandb.init(project=args.wandb_project_name, name=args.name,
                       notes=args.wandb_notes, config=vars(args))
        except ImportError:
            logging.warning("wandb unavailable")
    return tb_writer


def _teacher(args, force_size):
    """The frozen distillation teacher (JAX cli/main.py:175-198): the
    student's precision and ``--force-image-size`` (it reads the
    student's batches), ``--distill-pretrained`` loaded as
    ``--pretrained`` is; no gradient, and with bf16 compute its matmul
    weights cast once (``cast_for_compute``: the same arithmetic as the
    casts at use)."""
    teacher, _, _ = create_model_and_transforms(
        args.distill_model, args.distill_pretrained or None,
        precision=PRECISION[args.precision], device=args.device,
        cache_dir=args.cache_dir,
        **({"vision_cfg": {"image_size": force_size}} if force_size else {}))
    teacher.requires_grad_(False)
    teacher.eval()
    dtype = get_cast_dtype(PRECISION[args.precision])
    if dtype != torch.float32:
        cast_for_compute(teacher, dtype)
    if args.fsdp and dist.is_initialized():  # JAX cli/main.py:193-196
        fully_shard_model(teacher, requires_grad=False)
    return teacher


def main(argv=None):
    """Train (returns ``{"state": TrainState, "epochs": [per-epoch
    record]}``) or, without train data, evaluate (returns the metrics)."""
    args = parse_args(argv, include_xtag=False)
    for attr, default in (("use_tagging", False), ("use_fusion", False),
                          ("prompt_template_setting", None),
                          ("save_embed", False), ("save_best", False),
                          ("load_tagging_only", False)):
        if not hasattr(args, attr):
            setattr(args, attr, default)
    missing = unported(args)
    if missing:
        raise NotImplementedError(f"not ported yet: {'; '.join(missing)}")
    if args.precision not in PRECISION:
        raise NotImplementedError(
            f"--precision {args.precision} is not ported yet")
    init_distributed(args)
    log_base_path = start_run(args)
    if args.copy_codebase and is_master(args):
        from xtagclip_tpu_torch.train.file_utils import copy_codebase

        logging.info("copied codebase to %s", copy_codebase(args))
    tb_writer = _sinks(args, log_base_path) if is_master(args) else None
    sync = remote_sync_running(args, log_base_path) if is_master(args) \
        else contextlib.nullcontext()
    with sync:
        return _run(args, tb_writer)


def _run(args, tb_writer):
    """The model, data, optimizer and epochs of ``main``."""
    force_size = args.force_image_size
    if force_size and len(force_size) == 1:
        force_size = force_size[0]
    model_kwargs = {"vision_cfg": {"image_size": force_size}} if force_size \
        else {}
    if args.force_quick_gelu:
        model_kwargs["quick_gelu"] = True
    model, preprocess_train, preprocess_val = create_model_and_transforms(
        args.model, args.pretrained or None,
        precision=PRECISION[args.precision], device=args.device,
        grad_checkpointing=args.grad_checkpointing,
        force_patch_dropout=args.force_patch_dropout,
        image_mean=args.image_mean, image_std=args.image_std,
        image_interpolation=args.image_interpolation,
        image_resize_mode=args.image_resize_mode, aug_cfg=args.aug_cfg,
        cache_dir=args.cache_dir, use_bn_sync=args.use_bn_sync,
        **model_kwargs)
    tokenizer = get_tokenizer(args.model)
    logging.info("Model %s: %.2fM params on %s", args.model,
                 sum(p.numel() for p in model.parameters()) / 1e6,
                 args.device)

    if (args.torchscript or args.trace) and is_master(args):
        # the reference's trace_model (training.main:226): the serving
        # artifact, one torch.export program per entry
        from xtagclip_tpu_torch.convert.serving import save_serving

        serve_dir = os.path.join(args.checkpoint_path, "serving")
        manifest = save_serving(model, serve_dir, model_name=args.model)
        logging.info("serving artifact: %s (%s)", serve_dir, ", ".join(
            f"{k}={v['bytes'] / 1e6:.1f}MB"
            for k, v in manifest["entries"].items()))

    resolve_resume(args)

    data = get_data(args, (preprocess_train, preprocess_val), epoch=0,
                    tokenizer=tokenizer)
    if not data:
        raise RuntimeError("no data specified (--train-data/--val-data)")
    if "train" not in data:
        return evaluate(model, data, 0, args, tokenizer, tb_writer)

    steps_per_epoch = len(data["train"].dataloader)
    schedule = create_scheduler(args, steps_per_epoch * args.epochs)
    state, start_epoch = build_train_state(model, args, schedule)

    teacher = None
    if args.distill_model:
        teacher = _teacher(args, force_size)
        logging.info("Teacher %s: %.2fM params", args.distill_model,
                     sum(p.numel() for p in teacher.parameters()) / 1e6)

    args_cfg = {
        **step_config(args),
        "siglip": args.siglip, "use_tagging_loss": False,
        "lock_image_freeze_bn_stats": bool(
            args.lock_image and args.lock_image_freeze_bn_stats),
    }
    if "coca" in args.model.lower():
        args_cfg.update(
            coca=True,
            coca_caption_loss_weight=args.coca_caption_loss_weight,
            coca_contrastive_loss_weight=args.coca_contrastive_loss_weight)
    if args.accum_freq > 1:
        if teacher is not None:
            logging.warning(
                "--distill-model is not supported with --accum-freq > 1 "
                "(feature-cache replay path); distillation disabled.")
        step_fn = make_accum_train_step(args_cfg, args.accum_freq)
    else:
        step_fn = make_train_step(args_cfg, teacher=teacher)

    ckpt_mgr = CheckpointManager(
        args.checkpoint_path, save_frequency=args.save_frequency,
        save_most_recent=args.save_most_recent,
        delete_previous=args.delete_previous_checkpoint,
        write=is_master(args))
    generator = torch.Generator(device=args.device).manual_seed(
        args.seed + data_rank_of(args))
    history = []
    for epoch in range(start_epoch, args.epochs):
        logging.info("Start epoch %d", epoch)
        state, train_metrics = train_one_epoch(
            state, step_fn, data, epoch, args, schedule=schedule,
            generator=generator, train_key="train")
        completed = epoch + 1
        t0 = time.perf_counter()
        with unsharded(model):
            eval_metrics = evaluate(model, data, completed, args, tokenizer,
                                    tb_writer)
        eval_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt_mgr.save_epoch(completed, state_tree(state, epoch))
        history.append({"epoch": completed, "train": train_metrics,
                        "eval": eval_metrics, "eval_s": eval_s,
                        "checkpoint_s": time.perf_counter() - t0})
    return {"state": state, "epochs": history}


if __name__ == "__main__":
    main(sys.argv[1:])
