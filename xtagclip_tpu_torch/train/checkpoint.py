"""Train-state checkpoints: epoch saves, latest, the four-way best policy,
resume discovery (port of xtagclip_tpu/train/checkpoint.py; reference
main_other.py:580-644).

The format is the port's own: one directory per tag (``epoch_N``,
``epoch_latest``, ``best_*``, ``last``), as the JAX package's orbax tags
are, holding ``state.pt``, a ``torch.save`` of ``{"state": {"model":
state dict, "optimizer": the AdamW state (moments and their step
counts), "step": update count}, "epoch": N}``. The update count is also
the schedule's position. A save writes a temporary directory and renames
it, so a crash never leaves a half-written tag. Reading the JAX package's
orbax directories is not ported.

Across ranks only rank 0 writes (``CheckpointManager(write=...)``, JAX's
``is_master`` gates), and under FSDP the tree holds the whole model and
optimizer state, gathered from every rank (``state_tree`` is a
collective there), so a checkpoint of any world size resumes at any
other, FSDP or not: every rank reads the file and keeps its piece.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch

from xtagclip_tpu_torch.parallel.sharding import (
    full_state_dict,
    is_fsdp,
    load_full_state_dict,
    shard_optimizer_state,
)

BEST_KEYS = ("train_top1", "train_loss", "val_top1", "tag_acc")
STATE_FILE = "state.pt"


def state_tree(state, epoch: int) -> dict:
    """What a checkpoint holds for ``state`` after ``epoch`` (every rank
    calls it: module doc)."""
    return {"state": {"model": full_state_dict(state.model),
                      "optimizer": full_state_dict(state.tx.optimizer),
                      "step": state.step},
            "epoch": epoch}


def save_train_state(ckpt_dir: str, tag: str, tree: Any) -> str:
    """Save ``tree`` under ckpt_dir/tag (written aside, then renamed)."""
    path = os.path.abspath(os.path.join(ckpt_dir, tag))
    tmp = path + ".tmp_save"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, STATE_FILE))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def restore_train_state(ckpt_dir: str, tag: str, state) -> int:
    """Load checkpoint ckpt_dir/tag into ``state`` (model parameters,
    optimizer moments, update count) in place; returns its epoch. The file
    is read to host memory: the parameters and moments are copied onto
    the model's device, and AdamW's per-parameter step counts stay on the
    host, where the optimizer keeps them."""
    tree = torch.load(os.path.join(ckpt_dir, tag, STATE_FILE),
                      map_location="cpu", weights_only=True)
    saved = tree["state"]
    if is_fsdp(state.model):
        load_full_state_dict(state.model, saved["model"])
    else:
        state.model.load_state_dict(saved["model"])
    state.tx.optimizer.load_state_dict(
        shard_optimizer_state(state.tx.optimizer, saved["optimizer"]))
    state.step = int(saved["step"])
    return int(tree["epoch"])


def _clone_tree(src: str, dst: str) -> str:
    """Duplicate a finished checkpoint dir via hardlinks (fallback: copy).

    Checkpoint files are write-once (re-saves remove the dir first, which
    only unlinks), so hardlink clones are safe and make the epoch_latest /
    best_* duplicates metadata operations."""
    tmp = dst + ".tmp_clone"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    try:
        shutil.copytree(src, tmp, copy_function=os.link)
    except OSError:  # cross-device / fs without hardlinks
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.copytree(src, tmp)
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.rename(tmp, dst)
    return dst


class CheckpointManager:
    """Epoch/latest/best checkpoint policy (reference main_other.py:580-644).

    Each distinct state is serialized once; the other tags of the same
    state (epoch_latest, best_*, last) are hardlink clones of that save.
    With ``write`` False (a rank other than 0) it keeps the best metrics
    and writes nothing."""

    def __init__(self, ckpt_dir: str, save_frequency: int = 1,
                 save_most_recent: bool = True,
                 delete_previous: bool = False, save_best: bool = False,
                 write: bool = True):
        self.dir = ckpt_dir
        self.write = write
        if write:
            os.makedirs(ckpt_dir, exist_ok=True)
        self.save_frequency = save_frequency
        self.save_most_recent = save_most_recent
        self.delete_previous = delete_previous
        self.save_best = save_best
        self.best = {k: -np.inf for k in BEST_KEYS}
        self.best["train_loss"] = np.inf
        self._last_saved = None  # ((id, epoch, step), path)

    def _save_or_clone(self, tag: str, tree: Any) -> str:
        path = os.path.abspath(os.path.join(self.dir, tag))
        if not self.write:
            return path
        # id() alone can be reused after GC; epoch + step pin the content
        marker = (id(tree), tree.get("epoch"), tree["state"].get("step"))
        if self._last_saved is not None:
            last_marker, src = self._last_saved
            if last_marker == marker and src != path and os.path.isdir(src):
                return _clone_tree(src, path)
        save_train_state(self.dir, tag, tree)
        self._last_saved = (marker, path)
        return path

    def save_epoch(self, epoch: int, tree: Any):
        if self.save_frequency > 0 and (epoch % self.save_frequency) == 0:
            self._save_or_clone(f"epoch_{epoch}", tree)
            if self.delete_previous and self.write:
                prev = os.path.join(self.dir,
                                    f"epoch_{epoch - self.save_frequency}")
                if os.path.isdir(prev):
                    shutil.rmtree(prev)
                    if (self._last_saved
                            and self._last_saved[1] == os.path.abspath(prev)):
                        self._last_saved = None
        if self.save_most_recent:
            self._save_or_clone("epoch_latest", tree)

    def save_if_best(self, metrics: dict, tree: Any):
        if not self.save_best:
            return []
        saved = []
        for key in BEST_KEYS:
            if key not in metrics:
                continue
            v = float(metrics[key])
            better = (v < self.best[key] if key == "train_loss"
                      else v > self.best[key])
            if better:
                self.best[key] = v
                self._save_or_clone(f"best_{key}", tree)
                saved.append(key)
        return saved

    def save_last(self, tree: Any):
        self._save_or_clone("last", tree)


def find_latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """'--resume latest' discovery (main_other.py:195-227)."""
    if not os.path.isdir(ckpt_dir):
        return None
    if os.path.isdir(os.path.join(ckpt_dir, "epoch_latest")):
        return "epoch_latest"
    epochs = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"epoch_(\d+)", name)
        if m and os.path.isdir(os.path.join(ckpt_dir, name)):
            epochs.append(int(m.group(1)))
    if epochs:
        return f"epoch_{max(epochs)}"
    return None
