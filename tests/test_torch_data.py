"""The PyTorch port's input path against the JAX package, on the CPU.

The image normalize (the CUDA kernel's plain version; the kernel itself
is held to it on the card by tests/test_torch_kernels.py), the scar
dataset, the train and eval transforms and the loader's order, on the
same files, seeds and inputs in both packages. The JAX side runs as the
JAX package's own tests run it: the Pallas normalize in interpret mode,
the rest on the CPU.

Bars: the uint8 crops, labels, tags, tokens, class words and indices and
the loader's order exactly; the normalize in fp32 within one fp32 ulp at
the operands' scale (2^-22: the plain version multiplies and then adds,
an FMA or XLA may not round between), in bf16 equal but for one bf16 ULP
where the fp32 values straddle a rounding tie.
"""

import json
import os
import random
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(__file__))
from scar_fixtures import make_scar_dataset  # noqa: E402

from xtagclip_tpu.data import loader as jloader  # noqa: E402
from xtagclip_tpu.data import transforms as jtransforms  # noqa: E402
from xtagclip_tpu.data.scar import ScarDataset as JScarDataset  # noqa: E402
from xtagclip_tpu.ops.preprocess import normalize_images as jnormalize  # noqa: E402
from xtagclip_tpu.ops.preprocess import normalize_images_pallas  # noqa: E402
from xtagclip_tpu.tokenize.bpe import SimpleTokenizer as JTokenizer  # noqa: E402
from xtagclip_tpu_torch.data import loader, registry, transforms  # noqa: E402
from xtagclip_tpu_torch.data.datasets import SyntheticDataset  # noqa: E402
from xtagclip_tpu_torch.data.scar import ScarDataset  # noqa: E402
from xtagclip_tpu_torch.ops.preprocess import (  # noqa: E402
    normalize_images,
    normalize_images_reference,
)
from xtagclip_tpu_torch.tokenize.bpe import SimpleTokenizer  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)


# -- normalize ---------------------------------------------------------------

def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _assert_bf16_within_tie(out, ref_f32):
    """out (bf16) equals ref_f32 rounded to bf16, except one ULP off where
    ref_f32 lies within 2^-22 of a bf16 rounding tie."""
    rounded = ref_f32.to(torch.bfloat16)
    diff = out != rounded
    if diff.any():
        near = (out.float() - rounded.float()).abs()
        ulp = (rounded.float().abs() * 2.0**-7).clamp_min(2.0**-133)
        assert (near[diff] <= ulp[diff] * 1.0001).all()
        half = (out.float()[diff] + rounded.float()[diff]) / 2
        assert ((ref_f32[diff] - half).abs() <= 2.0**-22).all()


@pytest.mark.parametrize("shape", [(4, 32, 32, 3), (5, 33, 47, 3)])
def test_normalize_plain_matches_jax(shape):
    u8 = _u8(shape, seed=shape[1])
    ref = np.asarray(jnormalize(jnp.asarray(u8), dtype=jnp.float32))
    out = normalize_images_reference(torch.from_numpy(u8))
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    assert np.abs(out.numpy() - ref).max() <= 2.0**-22
    bf = normalize_images_reference(torch.from_numpy(u8), dtype=torch.bfloat16)
    jbf = np.array(jnormalize(jnp.asarray(u8), dtype=jnp.bfloat16)
                   .astype(jnp.float32))
    assert bf.dtype == torch.bfloat16
    _assert_bf16_within_tie(bf, torch.from_numpy(ref.copy()))
    _assert_bf16_within_tie(torch.from_numpy(jbf).to(torch.bfloat16),
                            out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_plain_matches_pallas_interpret(dtype):
    u8 = _u8((4, 32, 32, 3), seed=0)
    # jitted: an eager call of an interpreted Pallas kernel can deadlock in
    # the interpreter's callbacks (ROADMAP Ground rules)
    ref = np.array(jax.jit(lambda u: normalize_images_pallas(
        u, dtype=getattr(jnp, dtype), interpret=True))(jnp.asarray(u8))
        .astype(jnp.float32))
    out = normalize_images_reference(torch.from_numpy(u8),
                                     dtype=getattr(torch, dtype))
    if dtype == "float32":
        assert np.abs(out.numpy() - ref).max() <= 2.0**-22
    else:
        f32 = normalize_images_reference(torch.from_numpy(u8))
        _assert_bf16_within_tie(torch.from_numpy(ref).to(torch.bfloat16), f32)
        _assert_bf16_within_tie(out, f32)


def test_normalize_wrapper_runs_plain_version_on_cpu():
    u8 = torch.from_numpy(_u8((2, 8, 8, 3), seed=1))
    before = normalize_images.launches
    for dt in (torch.float32, torch.bfloat16):
        torch.testing.assert_close(normalize_images(u8, dtype=dt),
                                   normalize_images_reference(u8, dtype=dt),
                                   rtol=0, atol=0)
    assert normalize_images.launches == before


# -- the scar dataset --------------------------------------------------------

def _extra_rows(csv_path):
    """Rows the fixture lacks: an empty attribute cell (pandas' dropna
    drops it), an NA word, an unmapped attribute (-1, the caption quirk),
    and the class spellings "2." and "1,3"."""
    with open(csv_path, "a") as f:
        f.write("scar_000.png,2,yes,Linear,,Normal,Flat,no,no\n")
        f.write("scar_001.png,3,yes,Linear,Pink,NaN,Flat,no,no\n")
        f.write("scar_002.png,1,yes,Linear,Pink,Normal,Flat,sometimes,mild\n")
        f.write("scar_003.png,2.,yes,Widened,Red,Pigmented,Keloid,mild,no\n")
        f.write('scar_004.png,"1,3",yes,Linear bulging,Purple,Hypopigmented,'
                'Atrophic,severe,moderate\n')


@pytest.fixture(scope="module")
def scar_roots(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scar_data"))
    csv = make_scar_dataset(root, n=10, image_size=48)
    _extra_rows(csv)
    boxed = str(tmp_path_factory.mktemp("scar_boxed"))
    shutil.copytree(root, boxed, dirs_exist_ok=True)
    with open(os.path.join(boxed, "bounding_box.json"), "w") as f:
        json.dump({"shapes": [{"label": "other", "points": [[0, 0], [1, 1]]},
                             {"label": "scar",
                              "points": [[40.7, 3.2], [5.5, 37.9]]}]}, f)
    return root, boxed, os.path.basename(csv)


def _pair(root, csv_name, size=32):
    cfg_j = jtransforms.PreprocessCfg(size=size)
    cfg_p = transforms.PreprocessCfg(size=size)
    j = JScarDataset(root, csv_file=os.path.join(root, csv_name),
                     transform=jtransforms.EvalTransform(cfg_j,
                                                         normalize_host=False),
                     tokenizer=JTokenizer())
    p = ScarDataset(root, csv_file=os.path.join(root, csv_name),
                    transform=transforms.image_transform_eval(cfg_p),
                    tokenizer=SimpleTokenizer())
    return j, p


@pytest.mark.parametrize("boxed", [False, True])
def test_scar_items_match_jax(scar_roots, boxed):
    root, boxed_root, csv_name = scar_roots
    j, p = _pair(boxed_root if boxed else root, csv_name)
    # 10 fixture rows + "2." + "1,3" + the unmapped one; the Use=no row,
    # the empty cell and the NaN cell are dropped
    assert len(p) == len(j) == 13
    assert p.imgs == j.imgs and p.labels == j.labels
    assert p.bounding_box == j.bounding_box == (
        None if not boxed else (5, 3, 40, 37))
    for i in range(len(p)):
        got, want = p[i], j[i]
        assert got[0].dtype == np.uint8 and got[0].shape == (32, 32, 3)
        for a, b in zip(got[:4], want[:4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[4:] == want[4:]
    assert p[12][4] == "Others , Keloid scar" and p[12][5] == 0
    np.testing.assert_array_equal(p[11][1], [0, 1, 0])  # "2." is class 2
    unmapped = p[10]  # Irregular_color "sometimes" maps to -1
    assert unmapped[2][14:18].sum() == 0  # its group stays empty


def test_scar_loader_needs_no_pil_with_a_loader(scar_roots):
    """The dataset's loader= and transform=None path: what a machine
    without an image decoder feeds the trainer."""
    root, _, csv_name = scar_roots
    crop = np.full((32, 32, 3), 7, np.uint8)
    ds = ScarDataset(root, csv_file=os.path.join(root, csv_name),
                     transform=None, loader=lambda path: crop,
                     tokenizer=SimpleTokenizer())
    assert ds[0][0] is crop


# -- transforms and the loader ----------------------------------------------

@pytest.mark.parametrize("aug", [
    None,
    {"scale": (0.5, 1.0), "color_jitter": (0.4, 0.4, 0.4, 0.1),
     "color_jitter_prob": 0.8, "gray_scale_prob": 0.3},
    {"color_jitter": 0.3},
])
def test_train_transform_crops_match_jax(aug):
    rng = np.random.default_rng(3)
    imgs = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            for h, w in ((48, 64), (64, 40), (30, 30))]
    j = jtransforms.TrainTransform(jtransforms.PreprocessCfg(size=32),
                                   aug_cfg=aug, normalize_host=False,
                                   rng=random.Random(11))
    p = transforms.TrainTransform(transforms.PreprocessCfg(size=32),
                                  aug_cfg=aug, rng=random.Random(11))
    for _ in range(4):
        for img in imgs:
            got, want = p(img), j(img)
            assert got.dtype == np.uint8 and got.shape == (32, 32, 3)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("is_train", [False, True])
def test_image_transform_constructor_matches_jax(is_train):
    j = jtransforms.image_transform(32, is_train, normalize_host=False)
    p = transforms.image_transform(32, is_train)
    assert type(p).__name__ == type(j).__name__
    img = Image.fromarray(np.random.default_rng(4).integers(
        0, 256, (40, 50, 3), dtype=np.uint8))
    if is_train:
        p.rng, j.rng = random.Random(2), random.Random(2)
    np.testing.assert_array_equal(p(img), j(img))


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((2,), i, np.float32), int(i), f"w{i}")


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_order_and_collate_match_jax(shuffle, drop_last):
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last,
              num_workers=3, seed=5)
    p = loader.DataLoader(_Items(11), **kw)
    j = jloader.DataLoader(_Items(11), **kw)
    assert len(p) == len(j) == (2 if drop_last else 3)
    for epoch in (0, 1):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        got, want = list(p), list(j)
        assert len(got) == len(want) == len(p)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1].dtype == b[1].dtype == np.int32
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2] == b[2]


def test_loader_raises_a_worker_error():
    class Broken(_Items):
        def __getitem__(self, i):
            if i == 5:
                raise OSError("truncated image")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="truncated"):
        list(loader.DataLoader(Broken(8), batch_size=2, num_workers=2))


def test_to_device_keeps_uint8_and_widens_ints():
    batch = (np.zeros((2, 4, 4, 3), np.uint8), np.array([1, 2], np.int32),
             np.ones((2, 3), np.float32), ["a", "b"])
    out = loader.to_device(batch, "cpu")
    assert [t.dtype for t in out[:3]] == [torch.uint8, torch.int64,
                                          torch.float32]
    assert out[3] == ["a", "b"]
    assert [b[1].tolist() for b in loader.device_prefetch([batch] * 3,
                                                          "cpu")] == [[1, 2]] * 3


def test_get_data_other_dispatches_scar(scar_roots, tmp_path):
    root, _, csv_name = scar_roots
    scar = tmp_path / "scar_train"
    shutil.copytree(root, scar)
    args = type("A", (), dict(
        train_data=str(scar), val_data=str(scar), batch_size=4, workers=2,
        seed=0, scar_train_csv=str(scar / csv_name),
        scar_val_csv=str(scar / csv_name), prompt_template_setting=None))()
    pp = transforms.PreprocessCfg(size=32)
    data = registry.get_data_other(
        args, (transforms.image_transform_train(pp),
               transforms.image_transform_eval(pp)),
        tokenizer=SimpleTokenizer())
    assert sorted(data) == ["scar_train", "scar_val"]
    assert len(data["scar_train"].dataloader) == 13 // 4
    assert len(data["scar_val"].dataloader) == 4
    images = next(iter(data["scar_train"].dataloader))[0]
    assert images.dtype == np.uint8 and images.shape == (4, 32, 32, 3)


def test_synthetic_dataset_without_a_transform_needs_no_pil():
    ds = SyntheticDataset(image_size=(8, 8), dataset_size=3,
                          tokenizer=SimpleTokenizer(context_length=8))
    img, tok = ds[2]
    assert img.dtype == np.uint8 and img.shape == (8, 8, 3) and not img.any()
    assert tok.shape == (8,) and len(ds) == 3
