"""The port's batch decoders (data/native.py: ``decode_batch``,
``decode_native_batch``, ``jpeg_dims``, ``scaled_square_side``,
``decode_square_batch``, ``decode_rrc_batch``) against the JAX package's
on the same synthesized JPEGs, bit for bit, on the library route
(``native/libxtagdata.so``, which both bindings load) and on the PIL
route (both packages' ``_load`` answering None, as on a machine without
libjpeg's headers); and their device chains through ops/preprocess.py
``resize_crop_normalize`` at tests/test_torch_native.py's bars.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from xtagclip_tpu.data import native as jnative
from xtagclip_tpu.ops.preprocess import resize_crop_normalize as j_rcn
from xtagclip_tpu_torch.data import native
from xtagclip_tpu_torch.data.transforms import EvalTransform, PreprocessCfg
from xtagclip_tpu_torch.ops.preprocess import (
    normalize_images_reference,
    resize_crop_normalize,
)

sys.path.insert(0, os.path.dirname(__file__))
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

ROUTES = ("library", "pil")


def _jpeg(h=96, w=128, seed=0, quality=95):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((h // 8, w // 8, 3))
    img = np.asarray(Image.fromarray(
        ((x - x.min()) / (np.ptp(x) + 1e-9) * 255).astype("uint8")
    ).resize((w, h), Image.BILINEAR))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _batch():
    """Sources of several shapes, a corrupt entry and a 100 x 2000 one."""
    return [_jpeg(480, 640, seed=1), _jpeg(400, 300, seed=2), b"corrupt",
            _jpeg(96, 128, seed=4), _jpeg(100, 2000, seed=3, quality=90),
            _jpeg(224, 224, seed=5)]


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """Both packages on the library route (skipped where it does not
    load; decided when the test runs) or on the PIL route."""
    if request.param == "library":
        if not native.native_available():
            pytest.skip(f"native library: {native.decode_route()}")
    else:
        monkeypatch.setattr(native, "_load", lambda *a, **k: None)
        monkeypatch.setattr(jnative, "_load", lambda *a, **k: None)
    return request.param


def _equal(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("target", [64, 224])
def test_decode_batch_matches_jax(route, target):
    jpegs = _batch()
    got = native.decode_batch(jpegs, target, n_threads=2)
    _equal(got, jnative.decode_batch(jpegs, target, n_threads=2))
    assert got.shape == (6, target, target, 3)
    assert got[2].sum() == 0 and got[4].mean() > 10  # corrupt; oversize
    # the batch is each image's single decode
    np.testing.assert_array_equal(got[0], native.decode_resize(jpegs[0],
                                                               target))
    np.testing.assert_array_equal(got, native.decode_batch(jpegs, target))


@pytest.mark.parametrize("cap_hw", [(640, 640), (448, 512)])
def test_decode_native_batch_matches_jax(route, cap_hw):
    jpegs = _batch()
    got = native.decode_native_batch(jpegs, 224, cap_hw, n_threads=3)
    _equal(got, jnative.decode_native_batch(jpegs, 224, cap_hw,
                                            n_threads=3))
    out, sizes = got
    assert out.shape == (6, *cap_hw, 3) and sizes.dtype == np.int32
    assert (sizes[2] == 0).all() and out[2].sum() == 0
    h, w = sizes[4]  # 100 x 2000 shrinks to fit the cap, keeping its aspect
    assert w == cap_hw[1] and out[4, h:, :].sum() == 0


def test_jpeg_dims_and_scaled_square_side_match_jax(route):
    for j in _batch():
        assert native.jpeg_dims(j) == jnative.jpeg_dims(j)
    assert native.jpeg_dims(b"corrupt") is None
    assert native.jpeg_dims(_jpeg(100, 2000, seed=3)) == (100, 2000)
    for h, w in [(480, 640), (400, 300), (96, 128), (100, 2000), (224, 224),
                 (200, 150), (4000, 3000)]:
        for target in (64, 224):
            assert native.scaled_square_side(h, w, target) == \
                jnative.scaled_square_side(h, w, target)
    # 480x640: M = ceil(8 224 / 480) = 4 -> 240; 400x300: M = 6 -> 225
    assert native.scaled_square_side(480, 640, 224) == 240
    assert native.scaled_square_side(400, 300, 224) == 225


@pytest.mark.parametrize("cap,bucket", [(None, 32), (None, 64), (160, 32)])
def test_decode_square_batch_matches_jax(route, cap, bucket):
    jpegs = _batch()
    got = native.decode_square_batch(jpegs, 224, cap=cap, bucket=bucket,
                                     n_threads=2)
    _equal(got, jnative.decode_square_batch(jpegs, 224, cap=cap,
                                            bucket=bucket, n_threads=2))
    out, sides = got
    assert sides[2] == 0 and out[2].sum() == 0
    side = out.shape[1]
    if cap is None:  # the largest side, rounded up to the bucket
        assert side % bucket == 0 and side >= max(sides)
        if route == "library":
            assert list(sides[:2]) == [240, 225]
            assert side == -(-240 // bucket) * bucket
    else:
        assert side == cap and max(sides) <= cap


@pytest.mark.parametrize("flips", [None, [0, 1, 0, 1, 1, 0]])
def test_decode_rrc_batch_matches_jax(route, flips):
    jpegs = _batch()
    boxes = native.sample_rrc_boxes(np.random.default_rng(0), len(jpegs))
    flips = None if flips is None else np.asarray(flips, np.uint8)
    got = native.decode_rrc_batch(jpegs, 64, boxes, flips, n_threads=2)
    _equal(got, jnative.decode_rrc_batch(jpegs, 64, boxes, flips,
                                         n_threads=2))
    assert got[2].sum() == 0 and got[0].mean() > 10
    with pytest.raises(ValueError, match="boxes"):
        native.decode_rrc_batch(jpegs, 64, boxes[:2])


def test_thread_count_defaults_to_the_cpu_count(monkeypatch):
    seen = []
    real = native._batch_args

    def spy(jpegs, n_threads):
        out = real(jpegs, n_threads)
        seen.append(out[2])
        return out

    monkeypatch.setattr(native, "_batch_args", spy)
    if not native.native_available():
        pytest.skip(f"native library: {native.decode_route()}")
    native.decode_batch([_jpeg()], 32)
    native.decode_batch([_jpeg()], 32, n_threads=3)
    assert seen == [max(1, os.cpu_count() or 1), 3]


def _err01(got, want, cfg):
    return np.abs(got - want) * np.asarray(cfg.std, np.float32)


def _host(img, cfg):
    crop = torch.from_numpy(np.array(EvalTransform(cfg)(img)))[None]
    return normalize_images_reference(crop, cfg.mean, cfg.std)[0].numpy()


@pytest.mark.parametrize("stage", ["square", "native"])
def test_device_chain_meets_the_goldens_bars(route, stage):
    """decode_square_batch with sizes ``np.stack([sides, sides], 1)`` (as
    bench.py feeds it) and decode_native_batch with its sizes, through
    the port's ``resize_crop_normalize``: within 3.5/255 at most and
    0.35/255 on average of the host chain on the same decoded pixels, and
    within 2 uint8 steps (0.01 on average) of JAX's function on JAX's
    decode (tests/test_torch_native.py's bars)."""
    import jax.numpy as jnp

    jpegs = [j for j in _batch() if j != b"corrupt"]
    if stage == "square":
        out, sides = native.decode_square_batch(jpegs, 224)
        j_out, j_sides = jnative.decode_square_batch(jpegs, 224)
        sizes, j_sizes = (np.stack([s, s], 1) for s in (sides, j_sides))
    else:
        out, sizes = native.decode_native_batch(jpegs, 224, (640, 640))
        j_out, j_sizes = jnative.decode_native_batch(jpegs, 224, (640, 640))
    got = resize_crop_normalize(torch.from_numpy(out),
                                torch.from_numpy(sizes),
                                dtype=torch.float32).numpy()
    cfg = PreprocessCfg(size=224)
    for i in range(len(jpegs)):
        h, w = sizes[i]
        err = _err01(got[i], _host(Image.fromarray(out[i, :h, :w]), cfg),
                     cfg)
        assert err.max() <= 3.5 / 255 and err.mean() <= 0.35 / 255, i
    jax_got = np.asarray(j_rcn(jnp.asarray(j_out), jnp.asarray(j_sizes),
                               dtype=jnp.float32))
    steps = _err01(got, jax_got, cfg) * 255
    assert steps.max() <= 2.0 + 1e-3 and steps.mean() <= 0.01
