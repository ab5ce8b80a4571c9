"""The vanilla evaluation loop (port of xtagclip_tpu/train/evaluate.py
:22-101; reference open_clip_train/train.py:251-378): the zero-shot
classification splits (train/zero_shot.py), then on ``--val-data`` the
contrastive val loss and the cumulative R@{1,5,10} and mean/median ranks
in both directions (train/metrics.py), appended to
``<logs>/<name>/results.jsonl``.

As in JAX, the val features are the L2-normalized tower outputs
(``encode_image``/``encode_text`` with ``normalize=True``) and the logits
are exp(logit_scale) times their products; the per-batch loss is the mean
of the two directions' cross-entropies, and ``clip_val_loss`` is its
sample-weighted mean. The
images cross to the device as uint8 and are normalized there with the
model's ``--image-mean``/``--image-std`` (ops/preprocess.py). Across
ranks every rank evaluates the whole val split and rank 0 writes
results.jsonl.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict

import numpy as np
import torch

from xtagclip_tpu_torch.core.mesh import is_master
from xtagclip_tpu_torch.data.loader import device_prefetch
from xtagclip_tpu_torch.data.transforms import image_mean_std
from xtagclip_tpu_torch.ops.preprocess import normalize_images
from xtagclip_tpu_torch.train.metrics import retrieval_metrics
from xtagclip_tpu_torch.train.zero_shot import zero_shot_eval


def _logsumexp(x, axis):
    m = np.max(x, axis=axis, keepdims=True)
    return m + np.log(np.sum(np.exp(x - m), axis=axis, keepdims=True))


@torch.no_grad()
def val_features(model, dataloader):
    """(image features, text features, logit scale, clip val loss, n) over
    a val loader of (uint8 images, token ids) batches."""
    device = model.logit_scale.device
    norm = image_mean_std(model)
    was_training = model.training
    model.eval()
    all_img, all_txt = [], []
    total_loss, n, scale = 0.0, 0, 100.0
    try:
        for images_u8, texts in device_prefetch(dataloader, device):
            images = normalize_images(images_u8, *norm, dtype=model.dtype)
            img = model.encode_image(images, normalize=True)[0]
            txt = model.encode_text(texts.long(), normalize=True)[0]
            img, txt = img.float().cpu().numpy(), txt.float().cpu().numpy()
            scale = float(model.logit_scale.exp())
            all_img.append(img)
            all_txt.append(txt)
            logits = scale * img @ txt.T
            labels = np.arange(logits.shape[0])
            logp_i = logits - _logsumexp(logits, axis=1)
            logp_t = logits.T - _logsumexp(logits.T, axis=1)
            loss = -(logp_i[labels, labels].mean()
                     + logp_t[labels, labels].mean()) / 2
            total_loss += loss * logits.shape[0]
            n += logits.shape[0]
    finally:
        model.train(was_training)
    return (np.concatenate(all_img), np.concatenate(all_txt), scale,
            float(total_loss / max(n, 1)), n)


def evaluate(model, data: Dict[str, Any], epoch: int, args, tokenizer=None,
             tb_writer=None) -> dict:
    """The zero-shot metrics of ``data``'s classification splits and, at
    the val frequency, the val loss and retrieval metrics of
    ``data["val"]`` (module doc)."""
    metrics = dict(zero_shot_eval(model, data, epoch, args, tokenizer))
    if "val" in data and args.val_frequency and (
            epoch % args.val_frequency == 0 or epoch == args.epochs):
        img, txt, scale, loss, n = val_features(model,
                                                data["val"].dataloader)
        metrics.update(retrieval_metrics(img, txt, scale))
        metrics.update({"clip_val_loss": loss, "epoch": epoch,
                        "num_samples": n})
    if not metrics:
        return metrics
    logging.info("Eval Epoch: %d %s", epoch, "\t".join(
        f"{k}: {round(v, 4) if isinstance(v, float) else v}"
        for k, v in metrics.items()))
    log_base = getattr(args, "checkpoint_path", None)
    if log_base and getattr(args, "save_logs", True) and is_master(args):
        with open(os.path.join(os.path.dirname(log_base), "results.jsonl"),
                  "a") as f:
            f.write(json.dumps(metrics, default=float) + "\n")
    if tb_writer is not None:
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                tb_writer.add_scalar(f"val/{k}", v, epoch)
    return metrics
