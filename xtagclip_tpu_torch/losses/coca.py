"""CoCa's loss: weighted contrastive + pad-masked caption cross-entropy
(port of xtagclip_tpu/losses/coca.py:14-45; reference loss.py:142-184).
At world size W > 1 the contrastive term gathers the features as
losses/clip_loss.py does, and a rank's caption term is W times its masked
sum over the token count of every rank, so that the mean over ranks is
the masked mean of the concatenated batch."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xtagclip_tpu_torch.losses.clip_loss import ClipLoss, clip_loss
from xtagclip_tpu_torch.parallel.collectives import all_reduce_sum


def caption_loss(logits, labels, pad_id: int = 0, world_size: int = 1):
    """Mean cross-entropy over the vocabulary in fp32 of the [B, L, V]
    logits against the [B, L] labels, over the positions whose label is
    not ``pad_id``: the masked sum over ``max(mask.sum(), 1)`` (module
    doc for the ranks)."""
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         labels.reshape(-1).long(), reduction="none")
    mask = (labels.reshape(-1) != pad_id).float()
    if world_size > 1:
        count = all_reduce_sum(mask.sum())
        return world_size * (ce * mask).sum() / count.clamp_min(1.0)
    return (ce * mask).sum() / mask.sum().clamp_min(1.0)


class CoCaLoss(ClipLoss):
    """``clip_loss * clip_loss_weight`` (zero when the weight is 0, as in
    JAX) and ``caption_loss * caption_loss_weight``."""

    def __init__(self, caption_loss_weight: float, clip_loss_weight: float,
                 pad_id: int = 0, **kw):
        super().__init__(**kw)
        self.caption_loss_weight = caption_loss_weight
        self.clip_loss_weight = clip_loss_weight
        self.pad_id = pad_id

    def __call__(self, image_features, text_features, logits, labels,
                 logit_scale, output_dict: bool = False, **unused):
        if self.clip_loss_weight:
            closs = clip_loss(image_features, text_features, logit_scale,
                              self.local_loss, self.world_size,
                              self.rank) * self.clip_loss_weight
        else:
            closs = torch.zeros((), device=logits.device)
        caption = caption_loss(logits, labels, self.pad_id,
                               self.world_size) * self.caption_loss_weight
        if output_dict:
            return {"contrastive_loss": closs, "caption_loss": caption}
        return closs, caption
