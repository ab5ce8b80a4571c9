"""Epoch loop: batch adaptation, template selection, throughput telemetry
(port of xtagclip_tpu/train/trainer.py; reference
others/train_other.py:65-287).

One process. Each host batch crosses to the card as uint8
(``device_prefetch``: pinned memory, asynchronous copies one batch ahead),
is normalized there once (ops/preprocess.py, the CUDA kernel), split into
[accum_freq, micro_b, ...] for the accumulation step, and stepped. The
step's dropout masks come from one ``torch.Generator`` on the model's
device, seeded from ``--seed``; the GT-prompt template pick of
``--prompt-template-setting total`` from ``random.Random(seed + epoch)``,
as in the JAX trainer.

PyTorch dispatches the card's work asynchronously, so, as the JAX trainer
does, throughput is measured over whole log intervals ending in a read of
the step's metrics, which waits for the card.
"""

from __future__ import annotations

import logging
import os
import random
import statistics
import time
from typing import Any, Dict, Optional

import torch

from xtagclip_tpu_torch.data.loader import device_prefetch
from xtagclip_tpu_torch.ops.preprocess import normalize_images
from xtagclip_tpu_torch.train.logger import AverageMeter


def adapt_batch(batch, use_tagging: bool, template_id: int = 0,
                prompt_template_setting: Optional[str] = None,
                rng: Optional[random.Random] = None):
    """A dataset batch (on the device) -> (train-step dict, labels, class
    words).

    Scar batches: (image, label, additional, gt_tokens[B,5,ctx], class_word,
    class_idx); generic: (image, texts)."""
    if isinstance(batch, (tuple, list)) and len(batch) >= 6:
        images, label, additional, gt_tokens, class_words, class_idx = batch[:6]
        # reference train_other.py:97-110: pick one GT prompt variant per step
        sel = template_id
        if prompt_template_setting == "total":
            sel = (rng or random).randint(0, gt_tokens.shape[1] - 1)
        out = {"images": images, "texts": gt_tokens[:, sel],
               "additional": additional, "class_ids": class_idx,
               "template_id": sel}
        return out, label, list(class_words)
    images, texts = batch[:2]
    out = {"images": images, "texts": texts}
    if use_tagging:
        # generic batches carry no class label; the pseudo-prompt lookup
        # still needs a class row: class 0, as in the JAX trainer
        out["class_ids"] = torch.zeros(texts.shape[0], dtype=torch.long,
                                       device=texts.device)
        out["template_id"] = template_id
    return out, None, None


def _to_microbatches(batch: Dict[str, Any], accum_freq: int):
    """[B, ...] -> [accum_freq, B // accum_freq, ...]; scalars stay."""
    def split(x):
        if isinstance(x, torch.Tensor) and x.dim() > 0:
            return x.reshape((accum_freq, x.shape[0] // accum_freq)
                             + tuple(x.shape[1:]))
        return x

    return {k: split(v) for k, v in batch.items()}


def train_one_epoch(state, step_fn, data: Dict[str, Any], epoch: int, args,
                    schedule=None, generator: Optional[torch.Generator] = None,
                    train_key: Optional[str] = None):
    """Run one epoch of steps. Returns (state, epoch_metrics): the means of
    the logged step metrics, ``samples_per_second`` over the epoch's log
    intervals and ``p50_step_s``, the median over those intervals of their
    seconds per step."""
    train_key = train_key or ("scar_train" if "scar_train" in data
                              else "train")
    info = data[train_key]
    info.set_epoch(epoch)
    dataloader = info.dataloader
    num_batches = len(dataloader)
    model = state.model
    device = model.logit_scale.device
    compute_dtype = getattr(model, "dtype", torch.float32)

    meters: Dict[str, AverageMeter] = {}
    data_time = AverageMeter()
    interval_step_s = []
    host_rng = random.Random(args.seed + epoch)
    accum_freq = max(int(getattr(args, "accum_freq", 1) or 1), 1)

    # --profile: a torch.profiler trace of a short steady-state window
    # (past the first steps) in epoch 0
    profile = bool(getattr(args, "profile", False)) and epoch == 0
    profile_dir = getattr(args, "profile_dir", None) or (
        f"{getattr(args, 'logs', '.')}/{getattr(args, 'name', 'run')}/trace")
    prof_start = 2
    prof_stop = prof_start + int(getattr(args, "profile_steps", 5) or 5)
    prof = None

    end = time.time()
    t_interval = time.time()
    interval_samples = interval_steps = 0
    epoch_samples = 0
    epoch_time = 0.0
    for i, batch in enumerate(device_prefetch(dataloader, device)):
        if profile and i == prof_start:
            from torch.profiler import ProfilerActivity, profile as tprofile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            prof = tprofile(activities=acts)
            prof.__enter__()
            logging.info("profiler trace started -> %s", profile_dir)
        batch_dict, _, _ = adapt_batch(
            batch, use_tagging=getattr(args, "use_tagging", False),
            prompt_template_setting=getattr(args, "prompt_template_setting",
                                            None),
            rng=host_rng)
        batch_dict["images"] = normalize_images(batch_dict["images"],
                                                dtype=compute_dtype)
        if accum_freq > 1:
            batch_dict = _to_microbatches(batch_dict, accum_freq)
        data_time.update(time.time() - end)
        state, metrics = step_fn(state, batch_dict, generator)
        interval_samples += int(batch[0].shape[0])
        interval_steps += 1

        if prof is not None and (i + 1 == prof_stop or i == num_batches - 1):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            prof = None
            logging.info("profiler trace written -> %s", profile_dir)

        if (i % args.log_every_n_steps) == 0 or i == num_batches - 1:
            metrics = {k: v.item() for k, v in metrics.items()}  # waits
            for k, v in metrics.items():
                meters.setdefault(k, AverageMeter()).update(v)
            now = time.time()
            interval_t = max(now - t_interval, 1e-9)
            interval_step_s.append(interval_t / max(interval_steps, 1))
            samples_per_s = interval_samples / interval_t
            epoch_samples += interval_samples
            epoch_time += interval_t
            t_interval = now
            interval_samples = interval_steps = 0
            lr = float(schedule(int(state.step))) if schedule else float("nan")
            logging.info(
                "Train Epoch: %d [%d/%d] loss: %.5g lr: %.3g "
                "logit_scale: %.3f data: %.3fs batch: %.3fs "
                "samples/s: %.1f samples/s/device: %.1f",
                epoch, i, num_batches, metrics.get("loss", float("nan")), lr,
                metrics.get("logit_scale", float("nan")), data_time.val,
                interval_step_s[-1], samples_per_s, samples_per_s)
        end = time.time()

    epoch_metrics = {k: m.avg for k, m in meters.items()}
    if epoch_samples:
        epoch_metrics["samples_per_second"] = epoch_samples / max(epoch_time,
                                                                  1e-9)
        epoch_metrics["p50_step_s"] = statistics.median(interval_step_s)
    return state, epoch_metrics
