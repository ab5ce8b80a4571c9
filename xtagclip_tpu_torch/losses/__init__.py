"""The XTag train objective's losses (port of xtagclip_tpu/losses)."""

from xtagclip_tpu_torch.losses.asl import asymmetric_loss
from xtagclip_tpu_torch.losses.clip_loss import clip_loss
from xtagclip_tpu_torch.losses.dqncos import dqncos_loss

__all__ = ["asymmetric_loss", "clip_loss", "dqncos_loss"]
