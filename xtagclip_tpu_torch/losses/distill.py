"""The distillation CLIP loss on one process (port of
xtagclip_tpu/losses/distill.py:13-77; reference loss.py:187-223): the soft
cross-entropy between the teacher's and the student's contrastive logit
distributions, averaged over both directions. Softmax and log-softmax are
taken in fp32; the logits are fp32, as the features promote against the
fp32 scales in JAX (TF32 off). The caller stops the teacher's gradient
(train/loop.py runs the teacher under ``torch.no_grad``)."""

from __future__ import annotations

import torch

from xtagclip_tpu_torch.losses.clip_loss import ClipLoss, clip_loss


def _logits(features_a, features_b, scale):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return (scale.float() * features_a.float()) @ features_b.float().t()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _dist_loss(teacher_logits, student_logits):
    t = torch.softmax(teacher_logits.float(), dim=1)
    s = torch.log_softmax(student_logits.float(), dim=1)
    return -(t * s).sum(dim=1).mean(dim=0)


def distill_loss(image_features, text_features, logit_scale,
                 dist_image_features, dist_text_features, dist_logit_scale):
    """The distillation term alone (JAX ``distill_loss``)."""
    lpi = _logits(image_features, text_features, logit_scale)
    dlpi = _logits(dist_image_features, dist_text_features, dist_logit_scale)
    return (_dist_loss(dlpi, lpi) + _dist_loss(dlpi.t(), lpi.t())) / 2


class DistillClipLoss(ClipLoss):
    """(contrastive, distill) of the student against the teacher, as JAX's
    ``DistillClipLoss`` on one process."""

    def __call__(self, image_features, text_features, logit_scale,
                 dist_image_features, dist_text_features, dist_logit_scale,
                 output_dict: bool = False, **unused):
        contrastive = clip_loss(image_features, text_features, logit_scale)
        distill = distill_loss(image_features, text_features, logit_scale,
                               dist_image_features, dist_text_features,
                               dist_logit_scale)
        if output_dict:
            return {"contrastive_loss": contrastive, "distill_loss": distill}
        return contrastive, distill
