"""SigLIP's sigmoid contrastive loss on one process (port of
xtagclip_tpu/losses/siglip.py:20-103; reference loss.py:226-311).

The loss of a block of image rows against a block of text rows is the
mean over the image rows of the summed ``-log_sigmoid(label * logit)``,
with fp32 logits ``scale * img @ txt^T + bias`` and labels +1 on the
diagonal and -1 off it (-1 everywhere with ``negative_only``). JAX's
distributed variants (``bidir`` and ``shift`` rings, ``reduce`` and
``gather``) add the negative-only blocks of the other processes; on one
process every one of them is the local block's loss, which is all this
module computes. The ring and the all-gather wait for ROADMAP Queue 1
item 7 (multi-process): a launcher world size above 1 is refused before a
model is built (train/params.py ``unported``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

DIST_IMPLS = ("bidir", "shift", "reduce", "gather")


def _sigmoid_block_loss(image_features, text_features, logit_scale,
                        logit_bias, negative_only: bool = False):
    """-sum(log_sigmoid(labels * logits)) / n over an [n, m] block, in
    fp32 (the features promote against the fp32 scale, as in JAX; TF32
    stays off)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        logits = (logit_scale.float() * image_features.float()) \
            @ text_features.float().t()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if logit_bias is not None:
        logits = logits + logit_bias.float()
    n, m = logits.shape
    labels = -torch.ones((n, m), device=logits.device)
    if not negative_only:
        labels = labels + 2 * torch.eye(n, m, device=logits.device)
    return -F.logsigmoid(labels * logits).sum() / n


def siglip_loss(image_features, text_features, logit_scale, logit_bias,
                dist_impl: str = "shift"):
    """The SigLIP loss of the local batch (module doc); ``logit_bias`` may
    be None (a model without one)."""
    if dist_impl not in DIST_IMPLS:
        raise ValueError(f"unknown SigLIP dist_impl {dist_impl!r}; one of "
                         f"{DIST_IMPLS}")
    return _sigmoid_block_loss(image_features, text_features, logit_scale,
                               logit_bias)


class SigLipLoss:
    """The reference constructor surface: ``dist_impl`` (default
    ``bidir``) is kept and checked; on one process every variant is the
    local loss."""

    def __init__(self, cache_labels: bool = False, rank: int = 0,
                 world_size: int = 1, dist_impl: Optional[str] = None):
        if world_size > 1:
            raise NotImplementedError(
                "the SigLIP ring across processes is not ported yet "
                "(ROADMAP Queue 1 item 7: multi-process)")
        self.dist_impl = dist_impl or "bidir"
        if self.dist_impl not in DIST_IMPLS:
            raise ValueError(f"unknown SigLIP dist_impl {self.dist_impl!r}")

    def __call__(self, image_features, text_features, logit_scale,
                 logit_bias, output_dict: bool = False, **unused):
        loss = siglip_loss(image_features, text_features, logit_scale,
                           logit_bias, self.dist_impl)
        return {"contrastive_loss": loss} if output_dict else loss
