"""XTag training/eval CLI (port of xtagclip_tpu/cli/main_other.py:50-334).

    python -m xtagclip_tpu_torch.cli.main_other --model ViT-B-32 \\
        --use-tagging --use-fusion --train-data /data/scar_train \\
        --val-data /data/scar_val --batch-size 32 --epochs 10 ...

parse -> experiment naming, params.txt, out.log -> resume-latest -> model
(use_tagging/use_fusion) on ``--device`` (default cuda) -> tower locks ->
optimizer -> partial or full resume -> data (get_data, falling back to
get_data_other) -> scheduler -> epoch loop with the scar eval and the
four-way best checkpoints -> a final 'last' save. Without train data it
evaluates once and returns the metrics.

Images cross to the card as uint8 and are normalized there (the CUDA
kernel of ops/preprocess.py). One process: flags whose branches are not
ported (train/params.py ``unported``) raise NotImplementedError.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from datetime import datetime

import numpy as np
import torch

from xtagclip_tpu_torch.data.registry import get_data, get_data_other
from xtagclip_tpu_torch.factory import (
    create_model_and_transforms,
    get_tokenizer,
)
from xtagclip_tpu_torch.tokenize.prompts import PromptTable
from xtagclip_tpu_torch.train import metadata
from xtagclip_tpu_torch.train.checkpoint import (
    CheckpointManager,
    find_latest_checkpoint,
    restore_train_state,
    state_tree,
)
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

# --precision -> compute dtype over fp32 masters (main_other.py:106-110)
PRECISION = {"amp": "bf16", "amp_bf16": "bf16", "amp_bfloat16": "bf16",
             "fp16": "bf16", "bf16": "bf16", "fp32": "fp32"}


def main(argv=None):
    """Train (returns ``{"state": TrainState, "epochs": [per-epoch
    record]}``) or, without train data, evaluate (returns the metrics)."""
    args = parse_args(argv)
    missing = unported(args)
    if missing:
        raise NotImplementedError(f"not ported yet: {'; '.join(missing)}")

    if args.name is None:
        args.name = "-".join([
            datetime.now().strftime("%Y_%m_%d-%H_%M_%S"),
            f"model_{args.model.replace('/', '-')}", f"lr_{args.lr}",
            f"b_{args.batch_size}", f"p_{args.precision}"])
    log_base_path = os.path.join(args.logs, args.name)
    os.makedirs(log_base_path, exist_ok=True)
    args.log_path = os.path.join(log_base_path, "out.log")
    setup_logging(args.log_path, logging.DEBUG if args.debug else logging.INFO)
    args.checkpoint_path = os.path.join(log_base_path, "checkpoints")
    os.makedirs(args.checkpoint_path, exist_ok=True)
    with open(os.path.join(log_base_path, "params.txt"), "w") as f:
        for name in sorted(vars(args)):
            f.write(f"{name}: {getattr(args, name)}\n")
    if args.copy_codebase:
        from xtagclip_tpu_torch.train.file_utils import copy_codebase

        logging.info("copied codebase to %s", copy_codebase(args))

    if args.resume == "latest":
        tag = find_latest_checkpoint(args.checkpoint_path)
        args.resume = os.path.join(args.checkpoint_path, tag) if tag else None
        logging.info("resume latest -> %s", args.resume)

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
        init_seed=args.seed, image_interpolation=args.image_interpolation,
        image_resize_mode=args.image_resize_mode, aug_cfg=args.aug_cfg,
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
                        train_mask=mask, opt=args.opt)
    state = create_train_state(model, tx)

    start_epoch = 0
    if args.resume:
        if os.path.isdir(args.resume):
            start_epoch = restore_train_state(
                os.path.dirname(args.resume), os.path.basename(args.resume),
                state) + 1
            logging.info("resumed full state from %s (epoch %d)",
                         args.resume, start_epoch)
        else:
            from xtagclip_tpu_torch.convert.loader import load_checkpoint_into

            load_checkpoint_into(model, args.resume)

    args_cfg = {
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
        save_best=args.save_best)

    if train_key is None:  # eval-only (reference main_other.py:561-568)
        metrics = zero_shot_eval(model, data, 0, args, tokenizer)
        logging.info("eval: %s", json.dumps(metrics, default=float))
        return metrics

    generator = torch.Generator(device=args.device).manual_seed(args.seed)
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
