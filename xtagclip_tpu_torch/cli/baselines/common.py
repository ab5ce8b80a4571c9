"""Shared machinery of the three fine-tune baselines (port of
xtagclip_tpu/cli/baselines/common.py): supervised cross-entropy training
over the scar CSVs with early stopping, macro P/R/F1 evaluation and the
result plot.

A classifier is an ``nn.Module`` called as ``model(images, additional,
train, generator)`` on normalized fp32 NHWC images. The loaders yield
uint8 crops; each batch crosses to ``device`` as uint8 and is normalized
there to fp32 by ops/preprocess.py ``normalize_images`` (the CUDA kernel
on the card, its plain version on the CPU), which is the function JAX's
baselines compute on the host. ``train`` turns on the heads' dropout
(masks from ``generator``) and a ResNet's batch statistics, whose running
values move as flax's ``mutable=["batch_stats"]`` moves them.

The optimizer is optax's ``adamw(lr, weight_decay=wd)`` with its defaults
(b1 0.9, b2 0.999, eps 1e-8, decay on every parameter): a
``torch.optim.AdamW`` over the trainable parameters. Under a mask the
frozen ones are in no group and never change, as ``set_to_zero`` leaves
them. The best epoch (lowest validation loss) is kept and saved with
``_save_pytree``: a pickle of ``{"params": {name: array}, "extra": {name:
array}}`` (the BatchNorm statistics), numpy arrays as JAX's pickle holds
them, by the port's names.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xtagclip_tpu_torch.convert.from_jax import stats_buffers
from xtagclip_tpu_torch.data.scar import ScarDataset
from xtagclip_tpu_torch.ops.preprocess import normalize_images
from xtagclip_tpu_torch.utils.constants import (
    OPENAI_DATASET_MEAN,
    OPENAI_DATASET_STD,
)

_MEAN, _STD = OPENAI_DATASET_MEAN, OPENAI_DATASET_STD


class ScarClassificationDataset:
    """ScarDataset as (image, class_idx, additional, file name), the
    baselines' contract (resnet50_baseline.py:56-187)."""

    def __init__(self, root, csv_file, transform, is_train=True):
        def null_tokenizer(texts):
            return np.zeros((1, 1), np.int32)

        self.inner = ScarDataset(root, csv_file=csv_file, transform=transform,
                                 is_train=is_train, tokenizer=null_tokenizer)

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, idx):
        image, _label_vec, additional, _t, _w, class_idx = self.inner[idx]
        return (image, np.int32(class_idx), additional,
                os.path.basename(self.inner.imgs[idx]))


class EarlyStopping:
    """Patience-based early stop on the validation loss
    (biomedclip_baseline.py:439-470)."""

    def __init__(self, patience: int = 5, mode: str = "min"):
        self.patience = patience
        self.mode = mode
        self.best = np.inf if mode == "min" else -np.inf
        self.counter = 0
        self.should_stop = False

    def step(self, value: float) -> bool:
        """True when ``value`` is a new best."""
        better = value < self.best if self.mode == "min" else value > self.best
        if better:
            self.best = value
            self.counter = 0
            return True
        self.counter += 1
        if self.counter >= self.patience:
            self.should_stop = True
        return False


def classification_metrics(logits: np.ndarray, targets: np.ndarray,
                           num_classes: int) -> Dict[str, Any]:
    """Accuracy and per-class, macro and weighted P/R/F1
    (resnet50_baseline.py:235-414 reporting)."""
    pred = np.argmax(logits, axis=1)
    acc = float((pred == targets).mean())
    per_class = {}
    ps, rs, f1s, ns = [], [], [], []
    for c in range(num_classes):
        tp = float(((pred == c) & (targets == c)).sum())
        fp = float(((pred == c) & (targets != c)).sum())
        fn = float(((pred != c) & (targets == c)).sum())
        p = tp / (tp + fp) if tp + fp > 0 else 0.0
        r = tp / (tp + fn) if tp + fn > 0 else 0.0
        f1 = 2 * p * r / (p + r) if p + r > 0 else 0.0
        n = int((targets == c).sum())
        per_class[c] = {"precision": p, "recall": r, "f1": f1, "support": n}
        ps.append(p)
        rs.append(r)
        f1s.append(f1)
        ns.append(n)
    total = max(sum(ns), 1)
    return {
        "accuracy": acc,
        "macro_precision": float(np.mean(ps)),
        "macro_recall": float(np.mean(rs)),
        "macro_f1": float(np.mean(f1s)),
        "weighted_f1": float(sum(f * n for f, n in zip(f1s, ns)) / total),
        "per_class": per_class,
    }


def device_batch(batch, device, mean=_MEAN, std=_STD):
    """(normalized fp32 images, int64 targets, fp32 additional) of a
    loader batch on ``device``: the uint8 crops normalized there (#5)."""
    images, targets, additional = batch[0], batch[1], batch[2]
    images = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    return (normalize_images(images, mean, std, torch.float32),
            torch.from_numpy(np.asarray(targets)).long().to(device),
            torch.from_numpy(np.asarray(additional, np.float32)).to(device))


def _snapshot(model: nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def eval_logits(model: nn.Module, loader, device, mean=_MEAN, std=_STD):
    """(fp32 logits, targets) of every batch of ``loader``, in eval mode."""
    logits, targets = [], []
    with torch.no_grad():
        for batch in loader:
            images, t, additional = device_batch(batch, device, mean, std)
            logits.append(model(images, additional).float().cpu().numpy())
            targets.append(t.cpu().numpy())
    return logits, targets


def train_supervised(model: nn.Module, train_loader, val_loader,
                     num_classes: int, lr: float = 1e-4,
                     weight_decay: float = 1e-4, num_epochs: int = 100,
                     patience: int = 15,
                     trainable_mask: Optional[Dict[str, bool]] = None,
                     ckpt_path: Optional[str] = None, device="cuda",
                     mean=_MEAN, std=_STD):
    """The supervised loop all three baselines share (common.py:98-214).
    Returns (model holding the best epoch's weights, history)."""
    params = [p for n, p in model.named_parameters()
              if trainable_mask is None or trainable_mask[n]]
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    generator = torch.Generator(device=device).manual_seed(0)
    stopper = EarlyStopping(patience=patience, mode="min")
    history = {"train_loss": [], "train_acc": [], "val_loss": [],
               "val_acc": [], "epoch_s": []}
    best = _snapshot(model)

    for epoch in range(num_epochs):
        train_loader.set_epoch(epoch)
        t0 = time.time()
        tl, ta, n = 0.0, 0.0, 0
        for batch in train_loader:
            images, targets, additional = device_batch(batch, device, mean,
                                                       std)
            model.zero_grad(set_to_none=True)
            logits = model(images, additional, True, generator)
            loss = F.cross_entropy(logits.float(), targets)
            loss.backward()
            opt.step()
            b = images.shape[0]
            tl += loss.item() * b
            ta += (logits.argmax(dim=1) == targets).float().mean().item() * b
            n += b
        val_logits, val_targets = eval_logits(model, val_loader, device,
                                              mean, std)
        vn = sum(len(t) for t in val_targets)
        vl = sum(float(F.cross_entropy(torch.from_numpy(lg),
                                       torch.from_numpy(t))) * len(t)
                 for lg, t in zip(val_logits, val_targets))
        val_logits = (np.concatenate(val_logits) if val_logits
                      else np.zeros((0, num_classes)))
        val_targets = (np.concatenate(val_targets) if val_targets
                       else np.zeros((0,), np.int64))
        val_acc = (float((np.argmax(val_logits, 1) == val_targets).mean())
                   if vn else 0.0)
        history["train_loss"].append(tl / max(n, 1))
        history["train_acc"].append(ta / max(n, 1))
        history["val_loss"].append(vl / max(vn, 1))
        history["val_acc"].append(val_acc)
        history["epoch_s"].append(time.time() - t0)
        logging.info(
            "epoch %d: train_loss %.4f acc %.4f | val_loss %.4f acc %.4f "
            "(%.1fs)", epoch, history["train_loss"][-1],
            history["train_acc"][-1], history["val_loss"][-1], val_acc,
            history["epoch_s"][-1])
        if stopper.step(history["val_loss"][-1]):
            best = _snapshot(model)
            if ckpt_path:
                _save_pytree(ckpt_path, _named_arrays(model))
        if stopper.should_stop:
            logging.info("early stopping at epoch %d", epoch)
            break
    model.load_state_dict(best)
    return model, history


def evaluate_supervised(model: nn.Module, loader, num_classes: int,
                        device="cuda", mean=_MEAN,
                        std=_STD) -> Dict[str, Any]:
    logits, targets = eval_logits(model, loader, device, mean, std)
    if not logits:
        return {"accuracy": 0.0}
    return classification_metrics(np.concatenate(logits),
                                  np.concatenate(targets), num_classes)


def plot_history(history: dict, out_path: str):
    """Loss and accuracy curves (resnet50_baseline.py:545-589); without
    matplotlib, a warning and no plot, as in JAX."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logging.warning("matplotlib unavailable; skipping plot")
        return
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    axes[0].plot(history["train_loss"], label="train")
    axes[0].plot(history["val_loss"], label="val")
    axes[0].set_title("Loss")
    axes[0].legend()
    axes[1].plot(history["train_acc"], label="train")
    axes[1].plot(history["val_acc"], label="val")
    axes[1].set_title("Accuracy")
    axes[1].legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    logging.info("saved plot to %s", out_path)


def _named_arrays(model: nn.Module) -> dict:
    """The checkpoint tree: parameters and BatchNorm statistics, as fp32
    numpy arrays by the port's names."""
    def arrays(named):
        return {n: t.detach().float().cpu().numpy() for n, t in named}

    return {"params": arrays(model.named_parameters()),
            "extra": arrays(stats_buffers(model).items())}


def _save_pytree(path, tree):
    with open(path, "wb") as f:
        pickle.dump(tree, f)


def load_pytree(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@torch.no_grad()
def load_into(model: nn.Module, tree: dict) -> nn.Module:
    """Fill ``model`` from a ``_save_pytree`` checkpoint tree (strict)."""
    state = {**tree["params"], **tree.get("extra", {})}
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in state.items()}, strict=True)
    return model
