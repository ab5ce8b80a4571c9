"""Image normalization on the device: uint8 NHWC -> compute dtype.

Counterpart of xtagclip_tpu/ops/preprocess.py:31-44 ``normalize_images``.
The host ships uint8 bytes; the (x/255 - mean)/std conversion runs where
the images are, as one fused multiply-add with folded scale and bias.
"""

from __future__ import annotations

import numpy as np
import torch

from xtagclip_tpu_torch.utils.constants import (
    OPENAI_DATASET_MEAN,
    OPENAI_DATASET_STD,
)


def normalize_images(images_u8: torch.Tensor, mean=OPENAI_DATASET_MEAN,
                     std=OPENAI_DATASET_STD,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B,H,W,3] uint8 -> normalized ``dtype`` on the tensor's device."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    scale = torch.tensor((1.0 / (255.0 * std)).astype(np.float32),
                         device=images_u8.device)
    bias = torch.tensor((-mean / std).astype(np.float32),
                        device=images_u8.device)
    x = images_u8.to(torch.float32) * scale + bias
    return x.to(dtype)
