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


class ClipLoss:
    """The reference constructor surface (JAX losses/clip_loss.py:79-105)
    on one process: ``local_loss`` and ``gather_with_grad`` change nothing
    without other processes' features to gather."""

    def __init__(self, local_loss: bool = False,
                 gather_with_grad: bool = False, cache_labels: bool = False,
                 rank: int = 0, world_size: int = 1,
                 use_horovod: bool = False):
        if world_size > 1:
            raise NotImplementedError(
                "the feature gather across processes is not ported yet "
                "(ROADMAP Queue 1 item 7: multi-process)")
        self.local_loss = local_loss
        self.gather_with_grad = gather_with_grad

    def __call__(self, image_features, text_features, logit_scale,
                 output_dict: bool = False, **unused):
        loss = clip_loss(image_features, text_features, logit_scale)
        return {"contrastive_loss": loss} if output_dict else loss
