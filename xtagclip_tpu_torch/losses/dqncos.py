"""DQNCOS loss (port of xtagclip_tpu/losses/dqncos.py:13-19): symmetric
cross-entropy of a [B, B] fusion logit matrix against its diagonal."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dqncos_loss(logits):
    logits = logits.float()
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.t(), labels)) / 2
