"""Image normalization on the device: uint8 NHWC -> compute dtype.

Counterpart of xtagclip_tpu/ops/preprocess.py: ``normalize_images``
(:31-44) and the Pallas kernel ``normalize_images_pallas`` (:47-94). The
host ships uint8 bytes; the (x/255 - mean)/std conversion runs where the
images are, as one multiply-add with folded scale and bias.

- ``normalize_images``: the wrapper. On a CUDA tensor it launches the
  sm_90a kernel of ``csrc/normalize_images.cu`` (built on first use,
  ops/cuda_build.py) or raises: a wrong dtype or layout, a build or launch
  failure all raise, none switches to the plain version. On a CPU tensor
  it runs the plain version, because there is no kernel to run there. It
  counts its kernel launches in ``normalize_images.launches``.
- ``normalize_images_reference``: the plain version, a multiply and then
  an add in fp32. The kernel fuses them into one FMA, so the two may
  differ by one fp32 ulp before the downcast, which moves a bf16 result by
  one ULP only where it sits at a rounding tie.

The wrapper calls the custom op ``xtagclip_tpu_torch::normalize_images``
(the launcher above; a fake implementation for ``torch.export``), so an
exported serving program holds it as one node (convert/serving.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from xtagclip_tpu_torch.ops import cuda_build
from xtagclip_tpu_torch.ops.fused_attn_block import check_device
from xtagclip_tpu_torch.utils.constants import (
    OPENAI_DATASET_MEAN,
    OPENAI_DATASET_STD,
)

_OUT_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def _scale_bias(mean, std):
    """Folded per-channel fp32 scale 1/(255 std) and bias -mean/std."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return ((1.0 / (255.0 * std)).astype(np.float32),
            (-mean / std).astype(np.float32))


def normalize_images_reference(images_u8: torch.Tensor,
                               mean=OPENAI_DATASET_MEAN,
                               std=OPENAI_DATASET_STD,
                               dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """[B,H,W,3] uint8 -> normalized ``dtype`` on the tensor's device."""
    scale, bias = _scale_bias(mean, std)
    scale = torch.tensor(scale, device=images_u8.device)
    bias = torch.tensor(bias, device=images_u8.device)
    x = images_u8.to(torch.float32) * scale + bias
    return x.to(dtype)


def normalize_images(images_u8: torch.Tensor, mean=OPENAI_DATASET_MEAN,
                     std=OPENAI_DATASET_STD,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B,H,W,3] uint8 -> normalized ``dtype``: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor (see the module doc)."""
    check_device("normalize_images", images_u8)
    return normalize_images_op(images_u8, [float(v) for v in mean],
                               [float(v) for v in std], dtype)


normalize_images.launches = 0


@torch.library.custom_op("xtagclip_tpu_torch::normalize_images",
                         mutates_args=())
def normalize_images_op(images_u8: torch.Tensor, mean: Sequence[float],
                        std: Sequence[float],
                        dtype: torch.dtype) -> torch.Tensor:
    """The normalize as a custom op (``normalize_images``)."""
    if images_u8.device.type == "cpu":
        return normalize_images_reference(images_u8, mean, std, dtype)
    what = "normalize_images"
    if images_u8.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {images_u8.device}")
    if images_u8.dtype != torch.uint8:
        raise ValueError(f"{what}: images must be uint8, got "
                         f"{images_u8.dtype}")
    if images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"{what}: images must be [B, H, W, 3], got "
                         f"{tuple(images_u8.shape)}")
    if not images_u8.is_contiguous():
        raise ValueError(f"{what}: images must be contiguous")
    if dtype not in _OUT_DTYPES:
        raise ValueError(f"{what}: no kernel for output dtype {dtype} "
                         "(bfloat16 or float32)")
    scale, bias = _scale_bias(mean, std)
    out = torch.empty(images_u8.shape, dtype=dtype, device=images_u8.device)
    lib = cuda_build.load("normalize_images")
    err = lib.xtag_normalize_images(
        images_u8.data_ptr(), out.data_ptr(), images_u8.numel(),
        _OUT_DTYPES[dtype], *(float(v) for v in scale),
        *(float(v) for v in bias),
        torch.cuda.current_stream(images_u8.device).cuda_stream)
    cuda_build.check(lib, err, what)
    normalize_images.launches += 1
    return out


@normalize_images_op.register_fake
def _normalize_images_fake(images_u8, mean, std, dtype):
    return torch.empty(images_u8.shape, dtype=dtype, device=images_u8.device)
