"""Host-side eval preprocessing: PIL decode/resize/crop -> uint8 HWC numpy.

Port of the eval half of xtagclip_tpu/data/transforms.py (``PreprocessCfg``,
``EvalTransform``). PIL is imported inside the functions that use it, so
importing the package needs no PIL; only the predict CLI's file-input path
does. Normalization runs on the device (ops/preprocess.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np

from xtagclip_tpu_torch.utils.constants import (
    OPENAI_DATASET_MEAN,
    OPENAI_DATASET_STD,
)


@dataclass
class PreprocessCfg:
    size: Union[int, Tuple[int, int]] = 224
    mean: Optional[Tuple[float, ...]] = None
    std: Optional[Tuple[float, ...]] = None
    interpolation: str = "bicubic"
    resize_mode: str = "shortest"
    fill_color: int = 0

    def __post_init__(self):
        self.mean = tuple(self.mean or OPENAI_DATASET_MEAN)
        self.std = tuple(self.std or OPENAI_DATASET_STD)

    @property
    def size_hw(self) -> Tuple[int, int]:
        s = self.size
        return tuple(s) if isinstance(s, (tuple, list)) else (s, s)


def _resample(name: str):
    from PIL import Image

    return {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR,
            "random": Image.BICUBIC, "nearest": Image.NEAREST}[name]


def _resize_shortest(img, target_hw, resample):
    th, tw = target_hw
    w, h = img.size
    if th == tw:
        # torchvision Resize(int): shortest edge -> target, long edge
        # TRUNCATED: int(target * long / short)
        short, long = (w, h) if w <= h else (h, w)
        if short == th:
            return img
        new_short, new_long = th, int(th * long / short)
        nw, nh = (new_short, new_long) if w <= h else (new_long, new_short)
    else:
        # non-square target: ResizeKeepRatio (longest=0)
        ratio = min(h / th, w / tw)
        nh, nw = round(h / ratio), round(w / ratio)
    return img.resize((nw, nh), resample)


def _resize_longest(img, target_hw, resample):
    th, tw = target_hw
    w, h = img.size
    ratio = max(h / th, w / tw)
    return img.resize((round(w / ratio), round(h / ratio)), resample)


def _center_crop_or_pad(img, target_hw, fill=0):
    from PIL import ImageOps

    th, tw = target_hw
    w, h = img.size
    if w < tw or h < th:
        pad_l = max(0, (tw - w) // 2)
        pad_t = max(0, (th - h) // 2)
        img = ImageOps.expand(
            img, (pad_l, pad_t, max(0, tw - w - pad_l), max(0, th - h - pad_t)),
            fill=fill,
        )
        w, h = img.size
    # torchvision center_crop: int(round(diff / 2)), banker's rounding at .5
    left = int(round((w - tw) / 2.0))
    top = int(round((h - th) / 2.0))
    return img.crop((left, top, left + tw, top + th))


class EvalTransform:
    """Deterministic eval preprocessing -> uint8 HWC numpy. ``cfg.mean`` and
    ``cfg.std`` are for the device-side normalize."""

    def __init__(self, cfg: PreprocessCfg):
        self.cfg = cfg

    def __call__(self, img) -> np.ndarray:
        cfg = self.cfg
        resample = _resample(cfg.interpolation)
        th, tw = cfg.size_hw
        img = img.convert("RGB")
        if cfg.resize_mode == "squash":
            img = img.resize((tw, th), resample)
        elif cfg.resize_mode == "longest":
            img = _resize_longest(img, (th, tw), resample)
            img = _center_crop_or_pad(img, (th, tw), fill=cfg.fill_color)
        else:  # shortest
            img = _resize_shortest(img, (th, tw), resample)
            img = _center_crop_or_pad(img, (th, tw), fill=cfg.fill_color)
        return np.asarray(img, dtype=np.uint8)
