"""The distillation CLIP loss (port of xtagclip_tpu/losses/distill.py:13-77;
reference loss.py:187-223): the soft cross-entropy between the teacher's
and the student's contrastive logit distributions, averaged over both
directions. Softmax and log-softmax are taken in fp32; the logits are
fp32, as the features promote against the fp32 scales in JAX (TF32 off).
The caller stops the teacher's gradient (train/loop.py runs the teacher
under ``torch.no_grad``). At world size > 1 both models' features are
gathered across ranks as the contrastive loss gathers them
(losses/clip_loss.py): ``local_loss`` keeps this rank's rows, and the
mean over ranks is the loss of the concatenated batch."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xtagclip_tpu_torch.losses.clip_loss import ClipLoss, contrastive_logits


def _dist_loss(teacher_logits, student_logits):
    t = torch.softmax(teacher_logits.float(), dim=1)
    s = torch.log_softmax(student_logits.float(), dim=1)
    return -(t * s).sum(dim=1).mean(dim=0)


def distill_loss(image_features, text_features, logit_scale,
                 dist_image_features, dist_text_features, dist_logit_scale,
                 local_loss: bool = False, world_size: int = 1,
                 rank: int = 0):
    """The distillation term alone (JAX ``distill_loss``)."""
    lpi, lpt, _ = contrastive_logits(image_features, text_features,
                                     logit_scale, local_loss, world_size,
                                     rank)
    dlpi, dlpt, _ = contrastive_logits(
        dist_image_features, dist_text_features, dist_logit_scale,
        local_loss, world_size, rank)
    return (_dist_loss(dlpi, lpi) + _dist_loss(dlpt, lpt)) / 2


class DistillClipLoss(ClipLoss):
    """(contrastive, distill) of the student against the teacher, as JAX's
    ``DistillClipLoss``."""

    def __call__(self, image_features, text_features, logit_scale,
                 dist_image_features, dist_text_features, dist_logit_scale,
                 output_dict: bool = False, **unused):
        lpi, lpt, labels = contrastive_logits(
            image_features, text_features, logit_scale, self.local_loss,
            self.world_size, self.rank)
        dlpi, dlpt, _ = contrastive_logits(
            dist_image_features, dist_text_features, dist_logit_scale,
            self.local_loss, self.world_size, self.rank)
        contrastive = (F.cross_entropy(lpi, labels)
                       + F.cross_entropy(lpt, labels)) / 2
        distill = (_dist_loss(dlpi, lpi) + _dist_loss(dlpt, lpt)) / 2
        if output_dict:
            return {"contrastive_loss": contrastive, "distill_loss": distill}
        return contrastive, distill
