"""InfoNCE contrastive loss, with the features gathered across ranks
(port of xtagclip_tpu/losses/clip_loss.py:22-104).

At world size W > 1 every rank gathers the image and text features of
all ranks with their gradient (parallel/collectives.py): JAX's gathers
always differentiate, so ``gather_with_grad`` is accepted and, as there,
changes nothing (ROADMAP Queue 3). With ``local_loss`` a rank's logits
are its own rows against every rank's columns, labelled ``arange(b) + b
rank``; without it every rank computes the whole [W b, W b] matrix. Either
way the mean over ranks of the ranks' losses is the loss of the
one-process step on the concatenated batch, and so, with DDP's mean of
the gradients, is the update.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xtagclip_tpu_torch.parallel.collectives import gather_rows


def scaled_logits(features_a, features_b, scale):
    """fp32 ``scale * a @ b^T`` with TF32 off: the features promote
    against the fp32 scale, as in JAX."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return (scale.float() * features_a.float()) @ features_b.float().t()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def contrastive_logits(image_features, text_features, logit_scale,
                       local_loss: bool = False, world_size: int = 1,
                       rank: int = 0):
    """(logits per image, logits per text, labels) of this rank (module
    doc)."""
    b = image_features.shape[0]
    if world_size > 1:
        all_img = gather_rows(image_features)
        all_txt = gather_rows(text_features)
        if local_loss:
            labels = torch.arange(b, device=image_features.device) + b * rank
            return (scaled_logits(image_features, all_txt, logit_scale),
                    scaled_logits(text_features, all_img, logit_scale),
                    labels)
        image_features, text_features = all_img, all_txt
    labels = torch.arange(image_features.shape[0],
                          device=image_features.device)
    logits_per_image = scaled_logits(image_features, text_features,
                                     logit_scale)
    return logits_per_image, logits_per_image.t(), labels


def clip_loss(image_features, text_features, logit_scale,
              local_loss: bool = False, world_size: int = 1, rank: int = 0):
    """Symmetric InfoNCE over [B, E] features and the scalar logit scale
    (already exponentiated), in fp32 (module doc for the ranks)."""
    lpi, lpt, labels = contrastive_logits(image_features, text_features,
                                          logit_scale, local_loss,
                                          world_size, rank)
    return (F.cross_entropy(lpi, labels) + F.cross_entropy(lpt, labels)) / 2


class ClipLoss:
    """The reference constructor surface (JAX losses/clip_loss.py:79-105):
    ``gather_with_grad`` is accepted and ignored (module doc)."""

    def __init__(self, local_loss: bool = False,
                 gather_with_grad: bool = False, cache_labels: bool = False,
                 rank: int = 0, world_size: int = 1,
                 use_horovod: bool = False):
        self.local_loss = local_loss
        self.gather_with_grad = gather_with_grad
        self.rank = rank
        self.world_size = world_size

    def __call__(self, image_features, text_features, logit_scale,
                 output_dict: bool = False, **unused):
        loss = clip_loss(image_features, text_features, logit_scale,
                         self.local_loss, self.world_size, self.rank)
        return {"contrastive_loss": loss} if output_dict else loss
