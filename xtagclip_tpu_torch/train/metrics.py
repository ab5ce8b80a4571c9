"""Evaluation metrics: top-k accuracy (int and one-hot targets), per-class
breakdown, grouped tag P/R/F1 (a copy of xtagclip_tpu/train/metrics.py,
numpy only).

Semantics match reference zero_shot_other.py:13-55 (accuracy) and
train_other.py:549-648 (calculate_batch_metrics): positive-focused accuracy
TP/(TP+FP+FN), sample-averaged precision/recall/F1, overall and per attribute
group [3,4,3,4,4,4].
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

TAG_GROUP_SIZES = [3, 4, 3, 4, 4, 4]
TAG_GROUP_NAMES = [
    "Width", "Color", "Pigmentation", "Surface", "Irregular Color",
    "Irregular Height",
]


def accuracy_topk(logits: np.ndarray, target: np.ndarray,
                  topk: Sequence[int] = (1,)) -> list:
    """Counts of correct top-k predictions (integer targets)."""
    logits = np.asarray(logits)
    target = np.asarray(target)
    maxk = max(topk)
    pred = np.argsort(-logits, axis=1)[:, :maxk]
    correct = pred == target[:, None]
    return [float(correct[:, :k].any(axis=1).sum()) for k in topk]


def accuracy_onehot(
    logits: np.ndarray, target_onehot: np.ndarray, topk: Sequence[int] = (1,)
) -> Tuple[list, np.ndarray, Dict[int, np.ndarray]]:
    """One-hot-aware top-k: returns (overall correct counts, per-class positive
    counts, per-class correct counts per k)."""
    logits = np.asarray(logits)
    target = np.asarray(target_onehot).astype(bool)
    b, c = logits.shape
    maxk = max(topk)
    pred = np.argsort(-logits, axis=1)[:, :maxk]
    correct = np.take_along_axis(target, pred, axis=1)
    overall = [float(correct[:, :k].any(axis=1).sum()) for k in topk]
    class_counts = target.sum(axis=0).astype(np.float64)
    class_correct = {}
    for k in topk:
        in_topk = np.zeros((b, c), bool)
        np.put_along_axis(in_topk, pred[:, :k], True, axis=1)
        class_correct[k] = (target & in_topk).sum(axis=0).astype(np.float64)
    return overall, class_counts, class_correct


def tags_to_binary(tag_indices: np.ndarray, num_tags: int = 22) -> np.ndarray:
    """[B, 6] global tag indices -> [B, num_tags] binary matrix."""
    idx = np.asarray(tag_indices)
    out = np.zeros((idx.shape[0], num_tags), np.float32)
    np.put_along_axis(out, idx, 1.0, axis=1)
    return out


def _prf(tp, fp, fn):
    eps = 1e-8
    acc = tp / (tp + fp + fn + eps)
    p = tp / (tp + fp + eps)
    r = tp / (tp + fn + eps)
    f1 = 2 * p * r / (p + r + eps)
    return {
        "accuracy": float(acc.mean()),
        "precision": float(p.mean()),
        "recall": float(r.mean()),
        "f1": float(f1.mean()),
    }


def tag_batch_metrics(
    true_binary: np.ndarray,
    pred_binary: np.ndarray,
    group_sizes: Sequence[int] = tuple(TAG_GROUP_SIZES),
) -> dict:
    t = np.asarray(true_binary) > 0.5
    p = np.asarray(pred_binary) > 0.5
    tp = (t & p).sum(axis=1).astype(np.float64)
    fp = (~t & p).sum(axis=1).astype(np.float64)
    fn = (t & ~p).sum(axis=1).astype(np.float64)
    out = _prf(tp, fp, fn)
    groups = {}
    start = 0
    for gi, size in enumerate(group_sizes):
        sl = slice(start, start + size)
        gtp = (t[:, sl] & p[:, sl]).sum(axis=1).astype(np.float64)
        gfp = (~t[:, sl] & p[:, sl]).sum(axis=1).astype(np.float64)
        gfn = (t[:, sl] & ~p[:, sl]).sum(axis=1).astype(np.float64)
        name = TAG_GROUP_NAMES[gi] if gi < len(TAG_GROUP_NAMES) else f"Group {gi+1}"
        groups[name] = _prf(gtp, gfp, gfn)
        start += size
    out["groups"] = groups
    return out


def retrieval_metrics(image_features: np.ndarray,
                      text_features: np.ndarray,
                      logit_scale: float = 100.0) -> dict:
    """R@{1,5,10} + mean/median rank both directions
    (reference open_clip_train/train.py:360-378)."""
    logits_per_image = logit_scale * image_features @ text_features.T
    logits = {"image_to_text": logits_per_image,
              "text_to_image": logits_per_image.T}
    n = logits_per_image.shape[0]
    gt = np.arange(n)
    out = {}
    for name, logit in logits.items():
        ranking = np.argsort(-logit, axis=1)
        preds = np.where(ranking == gt[:, None])[1]
        out[f"{name}_mean_rank"] = float(preds.mean() + 1)
        out[f"{name}_median_rank"] = float(np.floor(np.median(preds)) + 1)
        for k in (1, 5, 10):
            out[f"{name}_R@{k}"] = float((preds < k).mean())
    return out
