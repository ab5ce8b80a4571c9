"""The train objectives' losses (port of xtagclip_tpu/losses): XTag's,
CoCa's, SigLIP's and the distillation loss."""

from xtagclip_tpu_torch.losses.asl import AsymmetricLoss, asymmetric_loss
from xtagclip_tpu_torch.losses.clip_loss import ClipLoss, clip_loss
from xtagclip_tpu_torch.losses.coca import CoCaLoss, caption_loss
from xtagclip_tpu_torch.losses.distill import DistillClipLoss, distill_loss
from xtagclip_tpu_torch.losses.dqncos import DQNCOSLoss, dqncos_loss
from xtagclip_tpu_torch.losses.siglip import SigLipLoss, siglip_loss

__all__ = ["AsymmetricLoss", "ClipLoss", "CoCaLoss", "DQNCOSLoss",
           "DistillClipLoss", "SigLipLoss", "asymmetric_loss", "caption_loss",
           "clip_loss", "distill_loss", "dqncos_loss", "siglip_loss"]
