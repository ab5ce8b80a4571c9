"""InfoNCE contrastive loss on one device (port of
xtagclip_tpu/losses/clip_loss.py:48-76 without the feature gather, which
belongs to the multi-process slice)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clip_loss(image_features, text_features, logit_scale):
    """Symmetric InfoNCE over [B, E] features and the scalar logit scale
    (already exponentiated). The logits are fp32, as JAX promotes the bf16
    features against the fp32 scale; TF32 stays off."""
    labels = torch.arange(image_features.shape[0],
                          device=image_features.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        logits_per_image = ((logit_scale.float() * image_features.float())
                            @ text_features.float().t())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return (F.cross_entropy(logits_per_image, labels)
            + F.cross_entropy(logits_per_image.t(), labels)) / 2
