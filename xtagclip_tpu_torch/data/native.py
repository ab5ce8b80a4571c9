"""ctypes bindings for the native data plane (native/xtag_data.cpp):
JPEG decode + resize + center crop, or + a random resized crop, to uint8
RGB, one image or a batch on the library's threads; and the decode-only
host stages of the device-preprocess path (``decode_native_batch``,
``decode_square_batch``), whose sizes feed
ops/preprocess.py ``resize_crop_normalize`` on the images' device.

From xtagclip_tpu/data/native.py (numpy only), every entry point with
JAX's signature and semantics, on the same library,
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
from typing import List, Optional

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
    ptrs, lens = ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(
        ctypes.c_size_t)
    lib.xtag_decode_batch.restype = ctypes.c_int
    lib.xtag_decode_batch.argtypes = [
        ptrs, lens, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.xtag_decode_rrc_batch.restype = ctypes.c_int
    lib.xtag_decode_rrc_batch.argtypes = [
        ptrs, lens, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    try:  # absent from a library built before the device-preprocess path
        lib.xtag_decode_native_batch.restype = ctypes.c_int
        lib.xtag_decode_native_batch.argtypes = [
            ptrs, lens, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.xtag_jpeg_dims.restype = ctypes.c_int
        lib.xtag_jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.xtag_decode_square_batch.restype = ctypes.c_int
        lib.xtag_decode_square_batch.argtypes = [
            ptrs, lens, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
    except AttributeError:
        logging.info("libxtagdata.so lacks the device-preprocess decoders; "
                     "rebuild with `make -C native`")
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


def _batch_args(jpegs: List[bytes], n_threads: Optional[int]):
    """The C arrays of pointers and lengths of ``jpegs``, and the thread
    count (the CPU count by default)."""
    n = len(jpegs)
    ptrs = (ctypes.c_char_p * n)(*jpegs)
    lens = (ctypes.c_size_t * n)(*[len(j) for j in jpegs])
    if n_threads is None:
        n_threads = max(1, os.cpu_count() or 1)
    return ptrs, lens, n_threads


def decode_batch(jpegs: List[bytes], target: int,
                 n_threads: Optional[int] = None) -> np.ndarray:
    """JPEG list -> [N, target, target, 3] uint8 (``decode_resize`` of
    each, on ``n_threads`` threads); corrupt entries are zeros."""
    lib = _load()
    n = len(jpegs)
    out = np.zeros((n, target, target, 3), np.uint8)
    if lib is None:
        for i, j in enumerate(jpegs):
            d = _pil_decode_resize(j, target)
            if d is not None:
                out[i] = d
        return out
    ptrs, lens, n_threads = _batch_args(jpegs, n_threads)
    lib.xtag_decode_batch(ptrs, lens, n, target,
                          out.ctypes.data_as(ctypes.c_void_p), n_threads)
    return out


def decode_native_batch(jpegs: List[bytes], needed_short: int = 224,
                        cap_hw=(640, 640),
                        n_threads: Optional[int] = None):
    """Decode-only host stage of the device-preprocess path: JPEGs ->
    (padded [N, cap_h, cap_w, 3] uint8, [N, 2] int32 true (h, w)), which
    ``resize_crop_normalize`` takes as they are. The decode is DCT-scaled
    toward ``needed_short`` (libjpeg's scale-on-decode; PIL's ``draft``
    on its route), and an image larger than the cap shrinks to fit it,
    keeping its aspect. Corrupt entries come back as zeros with size
    (0, 0)."""
    n = len(jpegs)
    cap_h, cap_w = cap_hw
    out = np.zeros((n, cap_h, cap_w, 3), np.uint8)
    sizes = np.zeros((n, 2), np.int32)
    lib = _load()
    if lib is None or not hasattr(lib, "xtag_decode_native_batch"):
        import io

        from PIL import Image

        for i, j in enumerate(jpegs):
            try:
                img = Image.open(io.BytesIO(j))
                img.draft("RGB", (needed_short, needed_short))
                arr = np.asarray(img.convert("RGB"), np.uint8)
            except OSError:
                continue
            h, w = arr.shape[:2]
            if h > cap_h or w > cap_w:
                fit = min(cap_h / h, cap_w / w)
                nh, nw = max(1, int(h * fit)), max(1, int(w * fit))
                arr = np.asarray(
                    Image.fromarray(arr).resize((nw, nh), Image.BILINEAR),
                    np.uint8)
                h, w = nh, nw
            out[i, :h, :w] = arr
            sizes[i] = (h, w)
        return out, sizes
    ptrs, lens, n_threads = _batch_args(jpegs, n_threads)
    lib.xtag_decode_native_batch(
        ptrs, lens, n, needed_short, cap_h, cap_w,
        out.ctypes.data_as(ctypes.c_void_p),
        sizes.ctypes.data_as(ctypes.c_void_p), n_threads)
    return out, sizes


def jpeg_dims(jpeg_bytes: bytes):
    """Header-only (h, w) of an encoded JPEG, or None where it does not
    parse."""
    lib = _load()
    if lib is None or not hasattr(lib, "xtag_jpeg_dims"):
        import io

        from PIL import Image

        try:
            img = Image.open(io.BytesIO(jpeg_bytes))
            return img.height, img.width
        except OSError:
            return None
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.xtag_jpeg_dims(jpeg_bytes, len(jpeg_bytes),
                            ctypes.byref(h), ctypes.byref(w))
    return (h.value, w.value) if rc == 0 else None


def scaled_square_side(h: int, w: int, target: int) -> int:
    """The square side ``decode_square_batch`` gives an (h, w) source on
    the library route: the shortest side after the smallest M/8 DCT scale
    that keeps it >= target (libjpeg rounds scaled dims up)."""
    short = min(int(h), int(w))
    if short <= target:
        return short
    m = min(8, -(-8 * target // short))
    return -(-short * m // 8)


def decode_square_batch(jpegs: List[bytes], target: int,
                        cap: Optional[int] = None, bucket: int = 32,
                        n_threads: Optional[int] = None):
    """The fewest-bytes host stage of the device-preprocess path: JPEGs ->
    (padded [N, cap, cap, 3] uint8 square center crops, [N] int32 true
    sides). The decode runs at the smallest M/8 DCT scale whose shortest
    side is >= target, and the crop to a square is a copy of rows, so the
    bytes a shortest-side resize and center crop would discard never
    leave the decoder; ``resize_crop_normalize`` with sizes
    ``np.stack([sides, sides], 1)`` makes the final crops on the device.

    cap: the slab's side; by default the batch's largest side from a
    header-only scan, rounded up to ``bucket`` (so that batches of
    similar sources share one shape). Corrupt entries come back as zeros
    with side 0."""
    n = len(jpegs)
    if cap is None:
        sides = (scaled_square_side(*d, target) for d in
                 (jpeg_dims(j) for j in jpegs) if d is not None)
        cap = max(sides, default=target)
        cap = -(-cap // bucket) * bucket
    out = np.zeros((n, cap, cap, 3), np.uint8)
    sides = np.zeros((n,), np.int32)
    lib = _load()
    if lib is None or not hasattr(lib, "xtag_decode_square_batch"):
        import io

        from PIL import Image

        for i, j in enumerate(jpegs):
            try:
                img = Image.open(io.BytesIO(j))
                img.draft("RGB", (target, target))
                arr = np.asarray(img.convert("RGB"), np.uint8)
            except OSError:
                continue
            h, w = arr.shape[:2]
            side = min(h, w)
            top, left = (h - side) // 2, (w - side) // 2
            sq = arr[top:top + side, left:left + side]
            if side > cap:
                sq = np.asarray(Image.fromarray(sq).resize(
                    (cap, cap), Image.BILINEAR), np.uint8)
                side = cap
            out[i, :side, :side] = sq
            sides[i] = side
        return out, sides
    ptrs, lens, n_threads = _batch_args(jpegs, n_threads)
    lib.xtag_decode_square_batch(
        ptrs, lens, n, target, cap, out.ctypes.data_as(ctypes.c_void_p),
        sides.ctypes.data_as(ctypes.c_void_p), n_threads)
    return out, sides


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


def decode_rrc_batch(jpegs: List[bytes], target: int, boxes: np.ndarray,
                     flips: Optional[np.ndarray] = None,
                     n_threads: Optional[int] = None) -> np.ndarray:
    """Train-time decode: JPEGs -> [N, target, target, 3] uint8 with each
    image's RandomResizedCrop box (fractional (fx, fy, fw, fh), [N, 4])
    and optional horizontal flips; corrupt entries are zeros."""
    n = len(jpegs)
    out = np.zeros((n, target, target, 3), np.uint8)
    boxes = np.ascontiguousarray(boxes, np.float32)
    if boxes.shape != (n, 4):
        raise ValueError(f"boxes must be [{n}, 4], got {boxes.shape}")
    flips_arr = (np.ascontiguousarray(flips, np.uint8)
                 if flips is not None else np.zeros(n, np.uint8))
    lib = _load()
    if lib is None:
        for i, j in enumerate(jpegs):
            d = _pil_decode_rrc(j, target, boxes[i], bool(flips_arr[i]))
            if d is not None:
                out[i] = d
        return out
    ptrs, lens, n_threads = _batch_args(jpegs, n_threads)
    lib.xtag_decode_rrc_batch(
        ptrs, lens, n, target, boxes.ctypes.data_as(ctypes.c_void_p),
        flips_arr.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), n_threads)
    return out


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
