"""Asymmetric multi-label loss (port of xtagclip_tpu/losses/asl.py): the
function (:16-44; SUM reduction, no gradient through the focal weight)
and ``AsymmetricLoss``, its callable with the reference's defaults
(:47-60)."""

from __future__ import annotations

import torch


def asymmetric_loss(logits, targets, gamma_neg: float = 4.0,
                    gamma_pos: float = 1.0, clip: float = 0.05,
                    eps: float = 1e-8, disable_grad_focal: bool = True):
    x = logits.float()
    y = targets.float()
    xs_pos = torch.sigmoid(x)
    xs_neg = 1.0 - xs_pos
    if clip is not None and clip > 0:
        xs_neg = (xs_neg + clip).clamp(max=1.0)
    los_pos = y * torch.log(xs_pos.clamp(min=eps))
    los_neg = (1.0 - y) * torch.log(xs_neg.clamp(min=eps))
    loss = los_pos + los_neg
    if gamma_neg > 0 or gamma_pos > 0:
        pt = xs_pos * y + xs_neg * (1.0 - y)
        gamma = gamma_pos * y + gamma_neg * (1.0 - y)
        w = torch.pow(1.0 - pt, gamma)
        if disable_grad_focal:
            w = w.detach()
        loss = loss * w
    return -loss.sum()


class AsymmetricLoss:
    """``asymmetric_loss`` with fixed hyperparameters, called as
    ``loss(logits, targets)`` (JAX asl.py:47-60; the reference's
    ``disable_torch_grad_focal_loss`` names the focal weight's stop)."""

    def __init__(self, gamma_neg=4, gamma_pos=1, clip=0.05, eps=1e-8,
                 disable_torch_grad_focal_loss=True):
        self.gamma_neg = gamma_neg
        self.gamma_pos = gamma_pos
        self.clip = clip
        self.eps = eps
        self.disable_grad_focal = disable_torch_grad_focal_loss

    def __call__(self, logits, targets):
        return asymmetric_loss(logits, targets, self.gamma_neg,
                               self.gamma_pos, self.clip, self.eps,
                               self.disable_grad_focal)
