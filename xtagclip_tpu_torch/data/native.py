"""ctypes bindings for the native data plane (native/xtag_data.cpp):
JPEG decode + resize + center crop, or + a random resized crop, to uint8
RGB.

From xtagclip_tpu/data/native.py (numpy only): the entry points the
webdataset loader (data/wds.py) calls, on the same library,
``native/libxtagdata.so`` at the repository root, built from ``native/``
with ``make -C native`` (g++ and libjpeg) the first time it is missing. Where it cannot be built or loaded, every entry point
decodes with PIL instead, as the JAX binding does; that is the host's
decode, not a device path. ``decode_route()`` says which one runs and why.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from functools import lru_cache
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libxtagdata.so")
_WHY_NOT = []  # why the library is not in use, once _load has failed


@lru_cache()
def _load(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    if not os.path.exists(_LIB_PATH) and build_if_missing:
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True)
        except (OSError, subprocess.CalledProcessError) as e:
            err = getattr(e, "stderr", b"") or b""
            _WHY_NOT.append(f"make -C native failed: {e} "
                            f"{err.decode(errors='replace')[-300:]}".strip())
            logging.info("native build failed (%s); using PIL", e)
            return None
    if not os.path.exists(_LIB_PATH):
        _WHY_NOT.append(f"{_LIB_PATH} is missing")
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:  # built elsewhere, or its libjpeg is missing here
        _WHY_NOT.append(f"cannot load {_LIB_PATH}: {e}")
        logging.info("native library does not load (%s); using PIL", e)
        return None
    lib.xtag_decode_resize.restype = ctypes.c_int
    lib.xtag_decode_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.xtag_decode_rrc.restype = ctypes.c_int
    lib.xtag_decode_rrc.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def native_available() -> bool:
    return _load() is not None


def decode_route() -> str:
    """"native" where the library loads, else "PIL (<why>)"."""
    if _load() is not None:
        return "native"
    return f"PIL ({'; '.join(_WHY_NOT) or 'native library unavailable'})"


def decode_resize(jpeg_bytes: bytes, target: int) -> Optional[np.ndarray]:
    """One JPEG -> [target, target, 3] uint8 center crop (None on failure)."""
    lib = _load()
    if lib is None:
        return _pil_decode_resize(jpeg_bytes, target)
    out = np.empty((target, target, 3), np.uint8)
    rc = lib.xtag_decode_resize(
        jpeg_bytes, len(jpeg_bytes), target,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out if rc == 0 else None


def sample_rrc_boxes(rng: np.random.Generator, n: int,
                     scale=(0.9, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                     aspect_hw=None) -> np.ndarray:
    """Fractional RandomResizedCrop boxes [n, 4] = (fx, fy, fw, fh)
    (torchvision RandomResizedCrop.get_params semantics, the reference's
    train transform at transform.py:334-355, scale=(0.9, 1.0)).

    aspect_hw: optional [n, 2] (h, w) source sizes; crop aspect is computed in
    PIXELS like torchvision when given, else in fractional units (square-ish
    images only drift slightly)."""
    boxes = np.empty((n, 4), np.float32)
    log_ratio = np.log(np.asarray(ratio))
    for i in range(n):
        h, w = (aspect_hw[i] if aspect_hw is not None else (1.0, 1.0))
        area = float(h) * float(w)
        for _ in range(10):
            target_area = area * rng.uniform(*scale)
            ar = float(np.exp(rng.uniform(*log_ratio)))
            cw = float(np.sqrt(target_area * ar))
            ch = float(np.sqrt(target_area / ar))
            if cw <= w and ch <= h:
                fx = rng.uniform(0, (w - cw) / w) if w > cw else 0.0
                fy = rng.uniform(0, (h - ch) / h) if h > ch else 0.0
                boxes[i] = (fx, fy, cw / w, ch / h)
                break
        else:  # torchvision center-crop fallback
            frac = min(float(np.sqrt(scale[0])), 1.0)
            boxes[i] = ((1 - frac) / 2, (1 - frac) / 2, frac, frac)
    return boxes


def decode_rrc(jpeg_bytes: bytes, target: int, box,
               flip: bool = False) -> Optional[np.ndarray]:
    """One JPEG -> RandomResizedCrop [target, target, 3] uint8."""
    lib = _load()
    if lib is None:
        return _pil_decode_rrc(jpeg_bytes, target, box, flip)
    out = np.empty((target, target, 3), np.uint8)
    rc = lib.xtag_decode_rrc(
        jpeg_bytes, len(jpeg_bytes), target,
        float(box[0]), float(box[1]), float(box[2]), float(box[3]),
        int(bool(flip)), out.ctypes.data_as(ctypes.c_void_p),
    )
    return out if rc == 0 else None


def _pil_decode_rrc(jpeg_bytes: bytes, target: int, box,
                    flip: bool) -> Optional[np.ndarray]:
    import io

    from PIL import Image

    try:
        img = Image.open(io.BytesIO(jpeg_bytes)).convert("RGB")
        w, h = img.size
        fx, fy, fw, fh = [float(v) for v in box]
        img = img.crop((int(fx * w), int(fy * h),
                        int((fx + fw) * w), int((fy + fh) * h)))
        img = img.resize((target, target), Image.BILINEAR)
        if flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return np.asarray(img, np.uint8)
    except Exception:  # noqa: BLE001
        return None


def _pil_decode_resize(jpeg_bytes: bytes, target: int) -> Optional[np.ndarray]:
    import io

    from PIL import Image

    try:
        img = Image.open(io.BytesIO(jpeg_bytes))
        img.draft("RGB", (target, target))  # PIL's DCT-scale analogue
        img = img.convert("RGB")
        w, h = img.size
        scale = max(target / w, target / h)
        img = img.resize((max(target, round(w * scale)),
                          max(target, round(h * scale))), Image.BILINEAR)
        w, h = img.size
        left, top = (w - target) // 2, (h - target) // 2
        return np.asarray(
            img.crop((left, top, left + target, top + target)), np.uint8
        )
    except OSError:
        return None
