"""The train objectives' losses (port of xtagclip_tpu/losses): XTag's and
CoCa's."""

from xtagclip_tpu_torch.losses.asl import asymmetric_loss
from xtagclip_tpu_torch.losses.clip_loss import clip_loss
from xtagclip_tpu_torch.losses.coca import CoCaLoss, caption_loss
from xtagclip_tpu_torch.losses.dqncos import dqncos_loss

__all__ = ["CoCaLoss", "asymmetric_loss", "caption_loss", "clip_loss",
           "dqncos_loss"]
