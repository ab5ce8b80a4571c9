"""Host-side image preprocessing: PIL resize/crop -> uint8 HWC numpy.

Port of xtagclip_tpu/data/transforms.py (``PreprocessCfg``,
``AugmentationCfg``, ``EvalTransform``, ``TrainTransform`` and the
``image_transform*`` constructors). PIL is imported inside the functions
that use it, so importing the package needs no PIL. Every transform yields
uint8 crops: normalization runs on the device (ops/preprocess.py), so the
JAX package's ``normalize_host`` is not carried over. The train transform
draws from a Python ``random.Random`` in the JAX package's order, so one
seed gives the same crops in both.
"""

from __future__ import annotations

import random
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

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


@dataclass
class AugmentationCfg:
    """Reference transform.py:61-72."""

    scale: Tuple[float, float] = (0.9, 1.0)
    ratio: Optional[Tuple[float, float]] = None
    color_jitter: Optional[Union[float, Tuple[float, ...]]] = None
    re_prob: Optional[float] = None
    re_count: Optional[int] = None
    use_timm: bool = False
    color_jitter_prob: Optional[float] = None
    gray_scale_prob: Optional[float] = None


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


class TrainTransform:
    """RandomResizedCrop(scale, bicubic) + optional jitter/grayscale ->
    uint8 HWC numpy."""

    def __init__(self, cfg: PreprocessCfg,
                 aug_cfg: Optional[Union[Dict[str, Any], AugmentationCfg]] = None,
                 rng: Optional[random.Random] = None):
        if isinstance(aug_cfg, dict):
            aug_cfg = AugmentationCfg(**aug_cfg)
        self.aug = aug_cfg or AugmentationCfg()
        if self.aug.use_timm:
            warnings.warn("use_timm augmentation not available; using native path")
        self.cfg = cfg
        self.rng = rng or random.Random()

    def _random_resized_crop(self, img):
        from PIL import Image

        th, tw = self.cfg.size_hw
        scale = self.aug.scale
        ratio = self.aug.ratio or (3.0 / 4.0, 4.0 / 3.0)
        w, h = img.size
        area = w * h
        for _ in range(10):
            target_area = area * self.rng.uniform(*scale)
            log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
            aspect = np.exp(self.rng.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = self.rng.randint(0, w - cw)
                top = self.rng.randint(0, h - ch)
                return img.resize((tw, th), Image.BICUBIC,
                                  box=(left, top, left + cw, top + ch))
        # fallback: center crop at clamped aspect (torchvision semantics)
        in_ratio = w / h
        if in_ratio < ratio[0]:
            cw, ch = w, int(round(w / ratio[0]))
        elif in_ratio > ratio[1]:
            ch, cw = h, int(round(h * ratio[1]))
        else:
            cw, ch = w, h
        left, top = (w - cw) // 2, (h - ch) // 2
        return img.resize((tw, th), Image.BICUBIC,
                          box=(left, top, left + cw, top + ch))

    def _color_jitter(self, img):
        from PIL import Image, ImageEnhance

        cj = self.aug.color_jitter
        if cj is None:
            return img
        if not isinstance(cj, (tuple, list)):
            cj = (cj,) * 3 + (0.0,)
        brightness, contrast, saturation, hue = (list(cj) + [0.0] * 4)[:4]
        ops = []
        if brightness:
            ops.append(lambda im: ImageEnhance.Brightness(im).enhance(
                self.rng.uniform(max(0, 1 - brightness), 1 + brightness)))
        if contrast:
            ops.append(lambda im: ImageEnhance.Contrast(im).enhance(
                self.rng.uniform(max(0, 1 - contrast), 1 + contrast)))
        if saturation:
            ops.append(lambda im: ImageEnhance.Color(im).enhance(
                self.rng.uniform(max(0, 1 - saturation), 1 + saturation)))
        if hue:
            def _hue(im):
                h, s, v = im.convert("HSV").split()
                shift = int(self.rng.uniform(-hue, hue) * 255)
                h = h.point(lambda p: (p + shift) % 256)
                return Image.merge("HSV", (h, s, v)).convert("RGB")
            ops.append(_hue)
        self.rng.shuffle(ops)
        for op in ops:
            img = op(img)
        return img

    def __call__(self, img) -> np.ndarray:
        from PIL import ImageOps

        img = self._random_resized_crop(img.convert("RGB"))
        aug = self.aug
        if aug.color_jitter_prob and self.rng.random() < aug.color_jitter_prob:
            img = self._color_jitter(img)
        elif aug.color_jitter is not None and not aug.color_jitter_prob:
            img = self._color_jitter(img)
        if aug.gray_scale_prob and self.rng.random() < aug.gray_scale_prob:
            img = ImageOps.grayscale(img).convert("RGB")
        return np.asarray(img, dtype=np.uint8)


def image_transform_eval(cfg: PreprocessCfg) -> EvalTransform:
    return EvalTransform(cfg)


def image_transform_train(cfg: PreprocessCfg, aug_cfg=None) -> TrainTransform:
    return TrainTransform(cfg, aug_cfg=aug_cfg)


def image_transform(image_size, is_train: bool, mean=None, std=None,
                    resize_mode=None, interpolation=None, fill_color: int = 0,
                    aug_cfg=None):
    """Reference-compatible convenience constructor (transform.py:274)."""
    cfg = PreprocessCfg(
        size=image_size, mean=mean, std=std,
        interpolation=interpolation or "bicubic",
        resize_mode=resize_mode or "shortest", fill_color=fill_color,
    )
    if is_train:
        return image_transform_train(cfg, aug_cfg)
    return image_transform_eval(cfg)
