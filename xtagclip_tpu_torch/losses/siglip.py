"""SigLIP's sigmoid contrastive loss (port of
xtagclip_tpu/losses/siglip.py:20-103 and of the step's ring,
xtagclip_tpu/train/loop.py:95-140; reference loss.py:226-448).

The loss of a block of image rows against a block of text rows is the
mean over the image rows of the summed ``-log_sigmoid(label * logit)``,
with fp32 logits ``scale * img @ txt^T + bias`` and labels +1 on the
diagonal and -1 off it (-1 everywhere with ``negative_only``). At world
size W > 1 a rank adds to its own block the negative-only blocks of its
image rows against every other rank's texts, which reach it by
``dist_impl``: ``shift`` passes them around the ring ``r -> r + 1`` W - 1
times; ``bidir`` passes them both ways at once (the reference's
neighbour exchange: the ranks at distance 1, 2, ... on either side, and
one last one-way step when W - 1 is odd); ``reduce`` and ``gather``
all-gather them, as JAX maps ``reduce`` to ``gather``. Each exchange
carries its gradient back to the sender (parallel/collectives.py). The
mean over ranks of the ranks' losses is the loss of the [W b, W b]
matrix of the concatenated batch, as JAX's ``pmean`` of its ring is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from xtagclip_tpu_torch.losses.clip_loss import scaled_logits
from xtagclip_tpu_torch.parallel.collectives import gather_rows, ring_shift

DIST_IMPLS = ("bidir", "shift", "reduce", "gather")


def _sigmoid_block_loss(image_features, text_features, logit_scale,
                        logit_bias, negative_only: bool = False):
    """-sum(log_sigmoid(labels * logits)) / n over an [n, m] block, in
    fp32."""
    logits = scaled_logits(image_features, text_features, logit_scale)
    if logit_bias is not None:
        logits = logits + logit_bias.float()
    n, m = logits.shape
    labels = -torch.ones((n, m), device=logits.device)
    if not negative_only:
        labels = labels + 2 * torch.eye(n, m, device=logits.device)
    return -F.logsigmoid(labels * logits).sum() / n


def siglip_loss(image_features, text_features, logit_scale, logit_bias,
                dist_impl: str = "shift", world_size: int = 1,
                rank: int = 0):
    """This rank's SigLIP loss (module doc); ``logit_bias`` may be None
    (a model without one)."""
    if dist_impl not in DIST_IMPLS:
        raise ValueError(f"unknown SigLIP dist_impl {dist_impl!r}; one of "
                         f"{DIST_IMPLS}")
    loss = _sigmoid_block_loss(image_features, text_features, logit_scale,
                               logit_bias)
    if world_size == 1:
        return loss

    def negatives(txt):
        return _sigmoid_block_loss(image_features, txt, logit_scale,
                                   logit_bias, negative_only=True)

    if dist_impl in ("reduce", "gather"):
        b = text_features.shape[0]
        all_txt = gather_rows(text_features)
        for i in range(world_size):
            if i != rank:
                loss = loss + negatives(all_txt[i * b:(i + 1) * b])
    elif dist_impl == "shift":
        txt = text_features
        for _ in range(world_size - 1):
            txt = ring_shift(txt, 1)
            loss = loss + negatives(txt)
    else:  # bidir
        to_left = to_right = text_features
        steps, odd = divmod(world_size - 1, 2)
        for _ in range(steps):
            from_right, from_left = ring_shift(to_left, -1), ring_shift(
                to_right, 1)
            loss = loss + negatives(from_right) + negatives(from_left)
            to_left, to_right = from_right, from_left
        if odd:
            loss = loss + negatives(ring_shift(to_right, 1))
    return loss


class SigLipLoss:
    """The reference constructor surface: ``dist_impl`` (default
    ``bidir``) is kept and checked."""

    def __init__(self, cache_labels: bool = False, rank: int = 0,
                 world_size: int = 1, dist_impl: Optional[str] = None):
        self.dist_impl = dist_impl or "bidir"
        if self.dist_impl not in DIST_IMPLS:
            raise ValueError(f"unknown SigLIP dist_impl {self.dist_impl!r}")
        self.rank = rank
        self.world_size = world_size

    def __call__(self, image_features, text_features, logit_scale,
                 logit_bias, output_dict: bool = False, **unused):
        loss = siglip_loss(image_features, text_features, logit_scale,
                           logit_bias, self.dist_impl, self.world_size,
                           self.rank)
        return {"contrastive_loss": loss} if output_dict else loss
