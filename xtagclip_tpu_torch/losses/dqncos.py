"""DQNCOS loss (port of xtagclip_tpu/losses/dqncos.py): symmetric
cross-entropy of a [B, B] fusion logit matrix against its diagonal
(:13-19), and ``DQNCOSLoss``, its callable (:22-24)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dqncos_loss(logits):
    logits = logits.float()
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.t(), labels)) / 2


class DQNCOSLoss:
    """``dqncos_loss`` called as ``loss(logits)`` (JAX dqncos.py:22-24)."""

    def __call__(self, logits):
        return dqncos_loss(logits)
