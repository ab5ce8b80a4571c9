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

``resize_crop_normalize`` (with ``pad_images_for_device``) runs the whole
eval resize, crop and normalize on the device as two matrix products per
image; JAX computes it in XLA, not Pallas, so it is plain PyTorch here.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from xtagclip_tpu_torch.ops import cuda_build
from xtagclip_tpu_torch.ops.fused_attn_block import (
    _full_fp32_matmul,
    check_device,
)
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


# ---------------------------------------------------------------------------
# The eval resize + center crop + normalize on the device (JAX
# ops/preprocess.py:99-246). JAX computes it in XLA as two matrix products
# per image, outside Pallas, so here it is plain PyTorch (two batched
# matmuls) and no kernel.

_FILTER_SUPPORT = {"bicubic": 2.0, "bilinear": 1.0}


def _filter_kernel(x: torch.Tensor, interpolation: str) -> torch.Tensor:
    """PIL's resample filters (Resample.c): bicubic = Keys a=-0.5, support
    2; bilinear = triangle, support 1; fp32, elementwise."""
    ax = x.abs()
    if interpolation == "bicubic":
        a = -0.5
        return torch.where(
            ax < 1.0, ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
            torch.where(ax < 2.0, (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a,
                        torch.zeros_like(ax)))
    if interpolation == "bilinear":
        return (1.0 - ax).clamp_min(0.0)
    raise ValueError(f"unsupported device interpolation: {interpolation}")


def _resample_matrix(out_size: int, in_pad: int, true_size: torch.Tensor,
                     resized_size: torch.Tensor, crop_offset: torch.Tensor,
                     interpolation: str) -> torch.Tensor:
    """[B, out_size, in_pad] fp32 weights of one axis of a PIL-style resize
    composed with a crop, per image of the batch (true_size, resized_size,
    crop_offset: [B]): output index i samples resized index i + offset,
    whose source centre is (i + offset + 0.5) * true / resized; a
    downscale widens the filter by the scale (PIL always antialiases);
    taps at k >= true_size are zeroed and each row renormalized, PIL's
    window clamp at the image's edge."""
    if interpolation not in _FILTER_SUPPORT:
        raise ValueError(interpolation)
    dev = true_size.device
    scale = (true_size.float() / resized_size.float())[:, None, None]
    filterscale = scale.clamp_min(1.0)
    i = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :, None]
    k = torch.arange(in_pad, dtype=torch.float32, device=dev)[None, None, :]
    center = (i + crop_offset.float()[:, None, None] + 0.5) * scale
    w = _filter_kernel((k + 0.5 - center) / filterscale, interpolation)
    w = torch.where(k < true_size.float()[:, None, None], w,
                    torch.zeros_like(w))
    denom = w.sum(dim=2, keepdim=True)
    return w / torch.where(denom == 0.0, torch.ones_like(denom), denom)


def _resized_geometry(h: torch.Tensor, w: torch.Tensor, out_hw,
                      resize_mode: str):
    """(nh, nw) [B] of the host sizing rules (data/transforms.py): shortest
    is torchvision's Resize(int), the short edge to the target and the
    long edge truncated; squash goes straight to (th, tw)."""
    th, tw = out_hw
    if resize_mode == "squash":
        return torch.full_like(h, th), torch.full_like(w, tw)
    if resize_mode != "shortest" or th != tw:
        raise ValueError(
            f"device path supports shortest/squash square targets, got "
            f"{resize_mode} {out_hw}")
    long_new = (th * torch.maximum(h, w)) // torch.minimum(h, w)
    nh = torch.where(h <= w, torch.full_like(h, th), long_new)
    nw = torch.where(h <= w, long_new, torch.full_like(w, tw))
    return nh, nw


def resize_crop_normalize(images_u8: torch.Tensor, sizes: torch.Tensor,
                          out_size: int = 224, resize_mode: str = "shortest",
                          interpolation: str = "bicubic",
                          mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD,
                          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[B, Hp, Wp, 3] uint8 (zero-padded to a bucket) + [B, 2] true (h, w)
    -> [B, out_size, out_size, 3] normalized ``dtype``: the reference's
    eval chain (transform.py:360-383) on the images' device.

    Per image out = Wy @ img @ Wx^T with separable [out, in] filter
    matrices from the true size (``_resample_matrix``), rounded and
    clamped to [0, 255] after each pass as PIL rounds to uint8 (the
    horizontal pass first), then the folded (x/255 - mean)/std. The crop
    offset is torchvision's int(round(d / 2)), half to even. Within
    quantization of PIL's chain (tests/test_torch_wds.py holds it to the
    goldens of tests/fixtures/preprocess/ and to JAX's function)."""
    if images_u8.dtype != torch.uint8:
        raise ValueError("resize_crop_normalize takes uint8 images")
    scale, bias = _scale_bias(mean, std)
    dev = images_u8.device
    scale = torch.tensor(scale, device=dev)
    bias = torch.tensor(bias, device=dev)
    _, hp, wp, _ = images_u8.shape
    sizes = sizes.to(device=dev, dtype=torch.int64)
    h, w = sizes[:, 0], sizes[:, 1]
    nh, nw = _resized_geometry(h, w, (out_size, out_size), resize_mode)
    top = torch.round((nh - out_size).float() / 2.0)
    left = torch.round((nw - out_size).float() / 2.0)
    wy = _resample_matrix(out_size, hp, h, nh, top, interpolation)
    wx = _resample_matrix(out_size, wp, w, nw, left, interpolation)
    x = images_u8.float()
    with _full_fp32_matmul():
        t = torch.einsum("btw,bhwc->bhtc", wx, x)
        t = torch.round(t).clamp(0.0, 255.0)
        u = torch.einsum("bsh,bhtc->bstc", wy, t)
    u = torch.round(u).clamp(0.0, 255.0)
    return (u * scale + bias).to(dtype)


def pad_images_for_device(arrs, bucket: int = 64, max_side: int = 1024):
    """Host collate for ``resize_crop_normalize``: native [h, w, 3] uint8
    arrays -> (padded [B, Hp, Wp, 3] uint8, [B, 2] int32 sizes), Hp and Wp
    the batch's maxima rounded up to ``bucket``; a side above
    ``max_side`` raises (shrink it at decode)."""
    if not arrs:
        raise ValueError("empty batch")
    hs = [a.shape[0] for a in arrs]
    ws = [a.shape[1] for a in arrs]
    if max(hs) > max_side or max(ws) > max_side:
        raise ValueError(
            f"image exceeds max_side={max_side}; shrink at decode time")
    hp = -(-max(hs) // bucket) * bucket
    wp = -(-max(ws) // bucket) * bucket
    out = np.zeros((len(arrs), hp, wp, 3), np.uint8)
    sizes = np.empty((len(arrs), 2), np.int32)
    for i, a in enumerate(arrs):
        if a.ndim != 3 or a.shape[2] != 3 or a.dtype != np.uint8:
            raise ValueError(f"batch item {i}: expected uint8 [h, w, 3]")
        out[i, : a.shape[0], : a.shape[1]] = a
        sizes[i] = (a.shape[0], a.shape[1])
    return out, sizes


@register_flop_formula(torch.ops.xtagclip_tpu_torch.normalize_images)
def _normalize_flops(*args, out_shape=None, **kwargs) -> int:
    """No matmul: FlopCounterMode counts the plain version's elementwise
    work as 0 too."""
    return 0
