"""The port's binding to the native data plane (data/native.py) and its
device resize (ops/preprocess.py ``resize_crop_normalize``) against the JAX
package's, on the CPU: tests/test_native.py's decode checks, each run
through both bindings on the same JPEGs (the port binds only what the
webdataset loader calls), and
tests/test_preprocess_goldens.py's device-resize cases.

Both bindings load ``native/libxtagdata.so``, so every decode is uint8
equal to JAX's. The device resize is held to the goldens of
tests/fixtures/preprocess/ and to the host transform (which reproduces
them bit for bit) at JAX's bar, 3.5/255 at most and 0.35/255 on average on
the 0..1 scale; and to JAX's ``resize_crop_normalize`` on the same padded
batch within 2 uint8 steps on any element and 0.01 on average: both
compute the two resampling passes in fp32 and round each to uint8, and a
pass that lands within float rounding of .5 may round the other way when
the sums run in another order (bilinear upscales give exact halves).
"""

import io
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from xtagclip_tpu.data import native as jnative
from xtagclip_tpu_torch.data import native
from xtagclip_tpu_torch.data.transforms import EvalTransform, PreprocessCfg
from xtagclip_tpu_torch.ops.preprocess import (
    normalize_images_reference,
    pad_images_for_device,
    resize_crop_normalize,
)

@pytest.fixture
def native_lib():
    """Skip where the native library does not load. Decided when the test
    runs, not when the module is imported: every xdist worker imports the
    module, and a decision at import builds the library (``make -C
    native``) in all of them at once."""
    if not native.native_available():
        pytest.skip(f"native library: {native.decode_route()}")


needs_lib = pytest.mark.usefixtures("native_lib")


def _jpeg(h=96, w=128, seed=0, quality=95):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((h // 8, w // 8, 3))
    img = np.asarray(Image.fromarray(
        ((x - x.min()) / (np.ptp(x) + 1e-9) * 255).astype("uint8")
    ).resize((w, h), Image.BILINEAR))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _host_normalized(img, cfg):
    """The port's host eval crop, normalized in fp32 as on the device."""
    crop = torch.from_numpy(np.array(EvalTransform(cfg)(img)))[None]
    return normalize_images_reference(crop, cfg.mean, cfg.std)[0].numpy()


@needs_lib
def test_same_library_and_route():
    assert native._LIB_PATH == jnative._LIB_PATH
    assert native.decode_route() == "native"


@needs_lib
@pytest.mark.parametrize("target", [48, 64, 224])
def test_decode_resize_matches_jax_and_pil(target):
    data = _jpeg()
    got = native.decode_resize(data, target)
    np.testing.assert_array_equal(got, jnative.decode_resize(data, target))
    want = native._pil_decode_resize(data, target)
    assert got.shape == want.shape == (target, target, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert np.median(diff) <= 3, float(np.median(diff))
    np.testing.assert_array_equal(want, jnative._pil_decode_resize(data,
                                                                   target))


@needs_lib
def test_decode_rrc_matches_jax():
    data = _jpeg(h=128, w=128, seed=3)
    full = native.decode_rrc(data, 64, (0.0, 0.0, 1.0, 1.0))
    np.testing.assert_array_equal(
        full, jnative.decode_rrc(data, 64, (0.0, 0.0, 1.0, 1.0)))
    crop = native.decode_rrc(data, 64, (0.25, 0.25, 0.5, 0.5))
    np.testing.assert_array_equal(
        crop, jnative.decode_rrc(data, 64, (0.25, 0.25, 0.5, 0.5)))
    assert np.abs(full.astype(int) - crop.astype(int)).mean() > 1.0
    flipped = native.decode_rrc(data, 64, (0.0, 0.0, 1.0, 1.0), flip=True)
    np.testing.assert_array_equal(flipped, full[:, ::-1])


@needs_lib
def test_decode_rrc_batch_and_boxes_match_jax():
    """The boxes and the loader's per-sample crops equal JAX's batch
    decode of the same boxes and flips."""
    jpegs = [_jpeg(h=100, w=140, seed=i) for i in range(6)]
    boxes = native.sample_rrc_boxes(np.random.default_rng(0), 6)
    np.testing.assert_array_equal(
        boxes, jnative.sample_rrc_boxes(np.random.default_rng(0), 6))
    assert (boxes[:, 0] + boxes[:, 2] <= 1.0001).all()
    flips = np.array([0, 1, 0, 1, 1, 0], np.uint8)
    out = np.stack([native.decode_rrc(j, 64, b, bool(f))
                    for j, b, f in zip(jpegs, boxes, flips)])
    np.testing.assert_array_equal(
        out, jnative.decode_rrc_batch(jpegs, 64, boxes, flips, n_threads=2))
    assert out.any(axis=(1, 2, 3)).all()
    pil = native._pil_decode_rrc(jpegs[0], 64, boxes[0], False)
    assert np.abs(out[0].astype(float) - pil.astype(float)).mean() < 16.0


@needs_lib
def test_rrc_box_scale_distribution():
    boxes = native.sample_rrc_boxes(np.random.default_rng(1), 500)
    areas = boxes[:, 2] * boxes[:, 3]
    assert areas.min() > 0.85 and areas.max() <= 1.0001
    ratios = boxes[:, 2] / boxes[:, 3]
    assert ratios.min() > 0.70 and ratios.max() < 1.40


@needs_lib
def test_corrupt_and_oversize_match_jax():
    """A corrupt JPEG decodes to None on both routes and both bindings; a
    100 x 2000 one to JAX's crop."""
    for route in ("decode_resize", "_pil_decode_resize"):
        assert getattr(native, route)(b"corrupt", 64) is None
        assert getattr(jnative, route)(b"corrupt", 64) is None
    box = (0.0, 0.0, 1.0, 1.0)
    assert native.decode_rrc(b"corrupt", 64, box) is None
    assert native._pil_decode_rrc(b"corrupt", 64, box, False) is None
    wide = _jpeg(100, 2000, seed=3, quality=90)
    for target in (64, 224):
        got = native.decode_resize(wide, target)
        np.testing.assert_array_equal(got, jnative.decode_resize(wide,
                                                                 target))
        assert got.shape == (target, target, 3) and got.mean() > 10
    np.testing.assert_array_equal(native.decode_rrc(wide, 64, box),
                                  jnative.decode_rrc(wide, 64, box))


# -- the device resize: tests/test_preprocess_goldens.py's cases ------------

FIXTURES = Path(__file__).parent / "fixtures" / "preprocess"
IMAGES = sorted(FIXTURES.glob("img_*.png"))
DEVICE_SIZES = [(320, 480), (500, 375), (224, 224), (100, 80), (513, 511),
                (224, 931)]
MODES = [("shortest", "bicubic"), ("shortest", "bilinear"),
         ("squash", "bicubic"), ("squash", "bilinear")]


def _rand_img(h, w, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=(h, w, 3)).astype(np.uint8)


def _err01(got, want, cfg):
    return np.abs(got - want) * np.asarray(cfg.std, np.float32)


def _device(arrs, mode, interp, size=224):
    padded, sizes = pad_images_for_device(arrs)
    return resize_crop_normalize(
        torch.from_numpy(padded), torch.from_numpy(sizes), out_size=size,
        resize_mode=mode, interpolation=interp,
        dtype=torch.float32).numpy(), padded, sizes


@pytest.mark.parametrize("mode,interp", MODES)
def test_device_resize_crop_matches_host_chain_and_jax(mode, interp):
    import jax.numpy as jnp

    from xtagclip_tpu.ops.preprocess import resize_crop_normalize as j_rcn

    cfg = PreprocessCfg(size=224, resize_mode=mode, interpolation=interp)
    arrs = [_rand_img(h, w, 7 * i) for i, (h, w) in enumerate(DEVICE_SIZES)]
    want = np.stack([_host_normalized(Image.fromarray(a), cfg)
                     for a in arrs])
    got, padded, sizes = _device(arrs, mode, interp)
    assert got.shape == want.shape == (len(arrs), 224, 224, 3)
    err = _err01(got, want, cfg)
    assert err.max() <= 3.5 / 255 and err.mean() <= 0.35 / 255
    jax_got = np.asarray(j_rcn(jnp.asarray(padded), jnp.asarray(sizes),
                               out_size=224, resize_mode=mode,
                               interpolation=interp, dtype=jnp.float32))
    steps = _err01(got, jax_got, cfg) * 255
    assert steps.max() <= 2.0 + 1e-3 and steps.mean() <= 0.01


@pytest.mark.parametrize("i", range(len(IMAGES)))
@pytest.mark.parametrize("key,mode,interp", [
    ("shortest_bicubic", "shortest", "bicubic"),
    ("squash_bicubic", "squash", "bicubic"),
    ("shortest_bilinear", "shortest", "bilinear")])
def test_device_resize_meets_the_goldens(i, key, mode, interp):
    img = np.asarray(Image.open(IMAGES[i]).convert("RGB"))
    cfg = PreprocessCfg(size=224, resize_mode=mode, interpolation=interp)
    golden = np.load(FIXTURES / f"golden_{i}.npz")[key]
    want = normalize_images_reference(torch.from_numpy(golden)[None],
                                      cfg.mean, cfg.std)[0].numpy()
    got = _device([img], mode, interp)[0][0]
    err = _err01(got, want, cfg)
    assert err.max() <= 3.5 / 255 and err.mean() <= 0.35 / 255


def test_device_resize_identity_is_exact():
    a = _rand_img(224, 224, 3)
    cfg = PreprocessCfg(size=224)
    want = _host_normalized(Image.fromarray(a), cfg)
    got = _device([a], "shortest", "bicubic")[0][0]
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_device_resize_padding_invariant_and_bf16():
    a = _rand_img(300, 260, 11)
    outs = []
    for hp, wp in [(320, 320), (448, 512)]:
        padded = np.zeros((1, hp, wp, 3), np.uint8)
        padded[0, :300, :260] = a
        outs.append(resize_crop_normalize(
            torch.from_numpy(padded), torch.tensor([[300, 260]]),
            dtype=torch.float32))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    bf = resize_crop_normalize(torch.from_numpy(padded),
                               torch.tensor([[300, 260]]))
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf, outs[1].to(torch.bfloat16), rtol=0, atol=0)
    with pytest.raises(ValueError, match="uint8"):
        resize_crop_normalize(torch.zeros((1, 8, 8, 3)),
                              torch.tensor([[8, 8]]))
    with pytest.raises(ValueError, match="shortest/squash"):
        resize_crop_normalize(torch.zeros((1, 8, 8, 3), dtype=torch.uint8),
                              torch.tensor([[8, 8]]), resize_mode="longest")


def test_pad_images_for_device_contract():
    from xtagclip_tpu.ops.preprocess import pad_images_for_device as j_pad

    arrs = [_rand_img(100, 130, 0), _rand_img(65, 64, 1)]
    padded, sizes = pad_images_for_device(arrs)
    j_padded, j_sizes = j_pad(arrs)
    np.testing.assert_array_equal(padded, j_padded)
    np.testing.assert_array_equal(sizes, j_sizes)
    assert padded.shape == (2, 128, 192, 3)
    assert sizes.tolist() == [[100, 130], [65, 64]]
    with pytest.raises(ValueError):
        pad_images_for_device([_rand_img(8, 2000, 2)])
    with pytest.raises(ValueError):
        pad_images_for_device([])
