"""XTag training/eval CLI (port of xtagclip_tpu/cli/main_other.py:50-334).

    python -m xtagclip_tpu_torch.cli.main_other --model ViT-B-32 \\
        --use-tagging --use-fusion --train-data /data/scar_train \\
        --val-data /data/scar_val --batch-size 32 --epochs 10 ...

parse -> experiment naming, params.txt, out.log -> resume-latest ->
``--remote-sync`` (a daemon process mirroring the run directory, stopped
when main returns or raises) -> model (use_tagging/use_fusion; its
``--pretrained`` a registry tag, URL, ``hf-hub:`` id or local file,
fetched into ``--cache-dir``) on ``--device`` (default cuda) -> tower locks ->
optimizer -> partial or full resume -> data (get_data, falling back to
get_data_other) -> scheduler -> epoch loop with the scar eval and the
four-way best checkpoints -> a final 'last' save. Without train data it
evaluates once and returns the metrics.

Images cross to the card as uint8 and are normalized there (the CUDA
kernel of ops/preprocess.py). Flags whose branches are not ported
(train/params.py ``unported``) raise NotImplementedError.

Under a launcher (``torchrun --nproc_per_node N -m
xtagclip_tpu_torch.cli.main_other ...``, or any family core/mesh.py
reads) each process joins the process group (NCCL on the card, one rank
per GPU; gloo on the CPU), trains on its share of the train split, and
steps through DDP, or FSDP2 with ``--fsdp`` (parallel/sharding.py). With
``--model-parallel N`` the ranks form a (world / N data) x (N model) mesh
(core/mesh.py): every ``ResidualAttentionBlock`` is split over the N
ranks of a model group, which read the same rows, and DDP or FSDP2 runs
over the data group; every rank runs the evaluations, since the sharded
forward meets its model group in each block. Rank
0 names the run, writes params.txt, out.log (every rank its
``out-{rank}`` with ``--log-local``), the checkpoints and the eval
artifacts, and resolves ``--resume latest`` for every rank; every rank
evaluates the whole val split, as in JAX.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from datetime import datetime

import numpy as np
import torch

from xtagclip_tpu_torch.core.mesh import (
    broadcast_object,
    data_rank_of,
    data_size_of,
    init_distributed,
    is_master,
)
from xtagclip_tpu_torch.data.registry import get_data, get_data_other
from xtagclip_tpu_torch.factory import (
    create_model_and_transforms,
    get_tokenizer,
)
from xtagclip_tpu_torch.parallel.sharding import unsharded, wrap_model
from xtagclip_tpu_torch.tokenize.prompts import PromptTable
from xtagclip_tpu_torch.train import metadata
from xtagclip_tpu_torch.train.checkpoint import (
    CheckpointManager,
    find_latest_checkpoint,
    restore_train_state,
    state_tree,
)
from xtagclip_tpu_torch.train.file_utils import remote_sync_running
from xtagclip_tpu_torch.train.logger import setup_logging
from xtagclip_tpu_torch.train.loop import make_accum_train_step, make_train_step
from xtagclip_tpu_torch.train.params import parse_args, unported
from xtagclip_tpu_torch.train.scheduler import create_scheduler
from xtagclip_tpu_torch.train.train_state import (
    create_train_state,
    make_optimizer,
    trainable_mask,
)
from xtagclip_tpu_torch.train.trainer import train_one_epoch
from xtagclip_tpu_torch.train.zero_shot import train_data_eval, zero_shot_eval

# the tag of the newest epoch's clone (JAX main_other.py:47)
LATEST_CHECKPOINT_NAME = "epoch_latest"
# --precision -> the factory's precision (main_other.py:106-110): bf16
# compute over fp32 masters, or bf16 parameters (pure_bf16), or float16
# parameters (pure_fp16, routed as factory.py says); fp16 is bf16, as JAX
# maps it
PRECISION = {"amp": "bf16", "amp_bf16": "bf16", "amp_bfloat16": "bf16",
             "fp16": "bf16", "bf16": "bf16", "fp32": "fp32",
             "pure_bf16": "pure_bf16", "pure_fp16": "pure_fp16"}


def main(argv=None):
    """Train (returns ``{"state": TrainState, "epochs": [per-epoch
    record]}``) or, without train data, evaluate (returns the metrics)."""
    args = parse_args(argv)
    missing = unported(args)
    if missing:
        raise NotImplementedError(f"not ported yet: {'; '.join(missing)}")
    init_distributed(args)
    log_base_path = start_run(args)
    if is_master(args):
        with open(os.path.join(log_base_path, "params.txt"), "w") as f:
            for name in sorted(vars(args)):
                f.write(f"{name}: {getattr(args, name)}\n")
    if args.copy_codebase and is_master(args):
        from xtagclip_tpu_torch.train.file_utils import copy_codebase

        logging.info("copied codebase to %s", copy_codebase(args))
    resolve_resume(args)
    sync = remote_sync_running(args, log_base_path) if is_master(args) \
        else contextlib.nullcontext()
    with sync:
        return _run(args)


def start_run(args) -> str:
    """Name the run (rank 0's name for every rank), set up logging (rank
    0's out.log, or every rank's out-{rank} with --log-local) and make
    the run's directories on rank 0; returns the run directory."""
    if args.name is None:
        args.name = broadcast_object("-".join([
            datetime.now().strftime("%Y_%m_%d-%H_%M_%S"),
            f"model_{args.model.replace('/', '-')}", f"lr_{args.lr}",
            f"b_{args.batch_size}", f"p_{args.precision}"]))
    log_base_path = os.path.join(args.logs, args.name)
    args.log_path = None
    if is_master(args) or args.log_local:
        os.makedirs(log_base_path, exist_ok=True)
        args.log_path = os.path.join(
            log_base_path, f"out-{args.rank}" if args.log_local else "out.log")
    setup_logging(args.log_path, logging.DEBUG if args.debug else logging.INFO)
    args.checkpoint_path = os.path.join(log_base_path, "checkpoints")
    if is_master(args):
        os.makedirs(args.checkpoint_path, exist_ok=True)
    return log_base_path


def resolve_resume(args) -> None:
    """``--resume latest`` -> rank 0's latest tag, sent to every rank."""
    if args.resume == "latest":
        tag = find_latest_checkpoint(args.checkpoint_path) \
            if is_master(args) else None
        tag = broadcast_object(tag)
        args.resume = os.path.join(args.checkpoint_path, tag) if tag else None
        logging.info("resume latest -> %s", args.resume)


def build_train_state(model, args, schedule):
    """The train state of ``model``: a ``--resume`` file's weights, the
    wrap across ranks (DDP or FSDP), the tower locks and the optimizer,
    then a ``--resume`` checkpoint tag's whole state. Returns (state,
    first epoch)."""
    if args.resume and not os.path.isdir(args.resume):
        from xtagclip_tpu_torch.convert.loader import load_checkpoint_into

        load_checkpoint_into(model, args.resume)
    ddp = wrap_model(model, args)
    named = dict(model.named_parameters())
    mask = trainable_mask(
        named, lock_image=args.lock_image,
        lock_image_unlocked_groups=args.lock_image_unlocked_groups,
        lock_text=args.lock_text,
        lock_text_unlocked_layers=args.lock_text_unlocked_layers,
        lock_text_freeze_layer_norm=args.lock_text_freeze_layer_norm)
    tx = make_optimizer(schedule, beta1=args.beta1, beta2=args.beta2,
                        eps=args.eps, weight_decay=args.wd,
                        grad_clip_norm=args.grad_clip_norm, params=named,
                        train_mask=mask, opt=args.opt,
                        momentum=args.momentum)
    state = create_train_state(model, tx, ddp)
    start_epoch = 0
    if args.resume and os.path.isdir(args.resume):
        start_epoch = restore_train_state(
            os.path.dirname(args.resume), os.path.basename(args.resume),
            state) + 1
        logging.info("resumed full state from %s (epoch %d)", args.resume,
                     start_epoch)
    return state, start_epoch


def step_config(args) -> dict:
    """The step's view of the ranks (train/loop.py): the data group's
    size and rank (core/mesh.py)."""
    return {"world_size": data_size_of(args), "rank": data_rank_of(args),
            "local_loss": args.local_loss,
            "siglip_dist_impl": args.loss_dist_impl or "shift"}


def _run(args):
    """The model, data, optimizer and epochs of ``main``."""
    if args.precision not in PRECISION:
        raise NotImplementedError(
            f"--precision {args.precision} is not ported yet")
    force_size = args.force_image_size
    if force_size and len(force_size) == 1:
        force_size = force_size[0]
    vision_cfg = {}
    if force_size:
        vision_cfg["image_size"] = force_size
    if args.force_patch_dropout is not None:
        vision_cfg["patch_dropout"] = args.force_patch_dropout
    if args.add_learnable_tokens:
        vision_cfg.update(n_learnable_tokens=args.n_learnable_tokens,
                          insert_position=args.insert_position)
    model_kwargs = {"vision_cfg": vision_cfg} if vision_cfg else {}
    if args.force_quick_gelu:
        model_kwargs["quick_gelu"] = True
    model, preprocess_train, preprocess_val = create_model_and_transforms(
        args.model, args.pretrained or None,
        precision=PRECISION[args.precision], device=args.device,
        use_tagging=args.use_tagging, use_fusion=args.use_fusion,
        init_seed=args.seed, grad_checkpointing=args.grad_checkpointing,
        image_mean=args.image_mean, image_std=args.image_std,
        image_interpolation=args.image_interpolation,
        image_resize_mode=args.image_resize_mode, aug_cfg=args.aug_cfg,
        cache_dir=args.cache_dir, use_bn_sync=args.use_bn_sync,
        **model_kwargs)
    tokenizer = get_tokenizer(args.model)

    if args.load_tagging_only and args.resume:
        from xtagclip_tpu_torch.convert.loader import (
            load_checkpoint_into,
            tagging_only_filter,
        )

        load_checkpoint_into(model, args.resume,
                             key_filter=tagging_only_filter)
        args.resume = None

    n_params = sum(p.numel() for p in model.parameters())
    logging.info("Model %s: %.2fM params on %s", args.model, n_params / 1e6,
                 args.device)

    # reference main_other.py:473-486: try get_data, fall back to the
    # scar/PathMNIST/MedicalMNIST dispatch on any failure
    try:
        data = get_data(args, (preprocess_train, preprocess_val), epoch=0,
                        tokenizer=tokenizer)
    except Exception as e:  # noqa: BLE001
        logging.info("get_data failed (%s); trying get_data_other", e)
        data = get_data_other(args, (preprocess_train, preprocess_val),
                              epoch=0, tokenizer=tokenizer)
    logging.info("datasets: %s", list(data))
    train_key = "scar_train" if "scar_train" in data else (
        "train" if "train" in data else None)

    prompt_table = None
    if args.use_tagging:
        table = PromptTable(list(metadata.SCAR_CLASSNAMES),
                            tokenizer=tokenizer).table
        prompt_table = torch.from_numpy(table.astype(np.int64)).to(
            args.device)

    steps_per_epoch = len(data[train_key].dataloader) if train_key else 0
    schedule = create_scheduler(args, max(steps_per_epoch * args.epochs, 1))
    state, start_epoch = build_train_state(model, args, schedule)

    args_cfg = {
        **step_config(args),
        "siglip": args.siglip,
        "use_tagging_loss": args.use_tagging,
        # the reference main builds ASL with its defaults (main_other.py:553)
        "asl_gamma_neg": 4, "asl_gamma_pos": 1, "asl_clip": 0.05,
        "lock_image_freeze_bn_stats": bool(
            args.lock_image and args.lock_image_freeze_bn_stats),
    }
    if args.accum_freq > 1:
        step_fn = make_accum_train_step(args_cfg, args.accum_freq,
                                        prompt_table=prompt_table)
    else:
        step_fn = make_train_step(args_cfg, prompt_table=prompt_table)

    ckpt_mgr = CheckpointManager(
        args.checkpoint_path, save_frequency=args.save_frequency,
        save_most_recent=True, delete_previous=args.delete_previous_checkpoint,
        save_best=args.save_best, write=is_master(args))

    if train_key is None:  # eval-only (reference main_other.py:561-568)
        with unsharded(model):
            metrics = zero_shot_eval(model, data, 0, args, tokenizer)
        logging.info("eval: %s", json.dumps(metrics, default=float))
        return metrics

    # each data rank draws its own dropout masks, the ranks of a model
    # group the same ones; data rank 0's are one process's
    generator = torch.Generator(device=args.device).manual_seed(
        args.seed + data_rank_of(args))
    history = []
    last_tree = None
    for epoch in range(start_epoch, args.epochs):
        logging.info("Start epoch %d", epoch)
        state, train_metrics = train_one_epoch(
            state, step_fn, data, epoch, args, schedule=schedule,
            generator=generator, train_key=train_key)
        completed = epoch + 1

        eval_metrics = {}
        eval_s = 0.0
        zs_every = args.zeroshot_frequency or args.val_frequency
        if (completed % max(zs_every, 1) == 0) or completed == args.epochs:
            t0 = time.perf_counter()
            with unsharded(model):
                eval_metrics = zero_shot_eval(model, data, completed, args,
                                              tokenizer)
                # the train-split validation pass (reference
                # train_other.py:290-496): its top1 is the live train_top1
                if args.use_tagging and train_key == "scar_train":
                    eval_metrics.update(train_data_eval(model, data, args,
                                                        tokenizer))
            eval_s = time.perf_counter() - t0
            logging.info("Eval epoch %d: %s", completed,
                         json.dumps(eval_metrics, default=float))

        t0 = time.perf_counter()
        tree = last_tree = state_tree(state, epoch)
        ckpt_mgr.save_epoch(completed, tree)
        best_metrics = {
            "train_top1": eval_metrics.get(
                "train_data-top1", train_metrics.get("top1", -np.inf)),
            "train_loss": train_metrics.get("loss", np.inf),
            "val_top1": eval_metrics.get(
                "scar_val-top1", eval_metrics.get("val-top1", -np.inf)),
            "tag_acc": eval_metrics.get("scar_val-tag_accuracy", -np.inf),
        }
        saved = ckpt_mgr.save_if_best(best_metrics, tree)
        if saved:
            logging.info("saved best checkpoints: %s", saved)
        history.append({"epoch": completed, "train": train_metrics,
                        "eval": eval_metrics, "eval_s": eval_s,
                        "checkpoint_s": time.perf_counter() - t0})

    # the final epoch's tree, so that 'last' is a hardlink clone of it
    ckpt_mgr.save_last(last_tree if last_tree is not None
                       else state_tree(state, args.epochs - 1))
    return {"state": state, "epochs": history}


if __name__ == "__main__":
    main(sys.argv[1:])
