"""The port's profiler CLI (``cli/profiler.py``) against JAX's
(tests/test_profiler_cli.py's toy config), and the flop formulas of the
kernels' custom ops.

Rows and CSV: JAX's columns in JAX's order and JAX's values, but for the
FLOP columns (JAX's are XLA's cost analysis, elementwise work included);
the port's FLOPs equal an analytic count of the toy towers' matmuls,
convolution and attention. Each custom op counts, under
``FlopCounterMode``, exactly what its plain version counts, and so does a
bf16 tower through the fused halves against the same tower with the
kernels off.
"""

import csv
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: F401
from xtagclip_tpu.cli import profiler as jax_profiler
from xtagclip_tpu.factory import add_model_config as jax_add_model_config
from xtagclip_tpu_torch import factory
from xtagclip_tpu_torch.cli import profiler
from xtagclip_tpu_torch.models.layers import set_use_kernels
from xtagclip_tpu_torch.ops import flash_attn, fused_mlp, preprocess
from xtagclip_tpu_torch.ops import fused_attn_block as fab

torch.set_num_threads(1)

# tests/test_profiler_cli.py's
CFG = dict(
    embed_dim=64,
    vision_cfg=dict(layers=4, width=256, head_width=64, patch_size=8,
                    image_size=64),
    text_cfg=dict(context_length=16, vocab_size=300, width=64, heads=2,
                  layers=2),
)
FLOP_COLUMNS = ("gflops", "image_gflops", "image_gmacs", "text_gflops",
                "text_gmacs")


@pytest.fixture(scope="module")
def name(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "torchtinyprof.json"
    path.write_text(json.dumps(CFG))
    jax_add_model_config(str(path))
    factory.add_model_config(path)
    return path.stem


@pytest.fixture(scope="module")
def rows(name, tmp_path_factory):
    out = tmp_path_factory.mktemp("csv") / "profile.csv"
    port = profiler.main(["--model", name, "--device", "cpu",
                          "--results-file", str(out)])
    return port, jax_profiler.profile_model(name), out


def test_columns_are_jax_columns_in_order(rows):
    port, want, _ = rows
    assert len(port) == 1 and list(port[0]) == list(want)


@pytest.mark.parametrize("column", [
    "model", "image_size", "image_width", "text_width", "embed_dim",
    "mparams", "image_mparams", "text_mparams", "train_state_gb",
    "fsdp8_gb_per_chip"])
def test_column_equals_jax(rows, column):
    port, want, _ = rows
    assert port[0][column] == want[column]


def test_csv_holds_the_rows(rows, name):
    port, _, path = rows
    with open(path) as f:
        got = list(csv.DictReader(f))
    assert len(got) == 1 and got[0]["model"] == name
    assert list(got[0]) == list(port[0])


def _analytic():
    """Matmul, conv and attention FLOPs of one image and one text."""
    d, e, lv = 256, 64, 65  # 64 patches + the class token
    block = 2 * lv * d * 3 * d + 4 * lv * lv * d + 2 * lv * d * d \
        + 2 * 2 * lv * d * 4 * d
    image = (2 * 64 * (3 * 8 * 8) * d + 4 * block
             + 2 * d * e + 2 * lv * d * e)  # pooled and token projections
    dt, lt = 64, 16
    block_t = 2 * lt * dt * 3 * dt + 4 * lt * lt * dt + 2 * lt * dt * dt \
        + 2 * 2 * lt * dt * 4 * dt
    return image, 2 * block_t


def test_flops_equal_the_analytic_count(name, rows):
    model = factory.create_model(name, device="cpu")
    image, text_blocks = _analytic()
    img = torch.zeros(1, 64, 64, 3)
    txt = torch.zeros(1, 16, dtype=torch.long)
    assert profiler._flops_of(model.encode_image, img) == image
    # the blocks, then the projection of the pooled token
    assert profiler._flops_of(model.encode_text, txt) == \
        text_blocks + 2 * 64 * 64
    port = rows[0][0]
    assert port["image_gflops"] == round(image / 1e9, 2)
    assert port["image_gmacs"] == round(image / 2e9, 2)


def _count(fn, *args):
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    return counter.get_total_flops(), counter.get_flop_counts()["Global"]


def _bf16(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * 0.1).to(torch.bfloat16)


def _attn_half_args():
    d = 128
    return (_bf16(2, 17, d), torch.ones(d), torch.zeros(d), _bf16(d, 3 * d),
            torch.zeros(3 * d), _bf16(d, d), torch.zeros(d), None, 2, 1e-5)


def _mlp_half_args():
    d = 128
    return (_bf16(2, 17, d), torch.ones(d), torch.zeros(d), _bf16(d, 4 * d),
            torch.zeros(4 * d), _bf16(4 * d, d), torch.zeros(d), "gelu",
            1e-5)


CASES = {
    "fused_attn_half": (fab.fused_attn_half, fab.reference_attn_half,
                        _attn_half_args),
    "fused_mlp_half": (fab.fused_mlp_half, fab.reference_mlp_half,
                       _mlp_half_args),
    "fused_mlp": (fused_mlp.fused_mlp, fused_mlp.reference_fused_mlp,
                  lambda: (_bf16(34, 128), _bf16(128, 512),
                           torch.zeros(512), _bf16(512, 128),
                           torch.zeros(128), "gelu")),
    "flash_mha": (flash_attn.flash_mha, flash_attn.reference_flash_mha,
                  lambda: (_bf16(2, 33, 2, 64), _bf16(2, 33, 2, 64, seed=1),
                           _bf16(2, 33, 2, 64, seed=2), "blhd")),
    "normalize_images": (
        preprocess.normalize_images, preprocess.normalize_images_reference,
        lambda: (torch.randint(0, 256, (2, 8, 8, 3), dtype=torch.uint8),
                 (0.5, 0.4, 0.3), (0.2, 0.3, 0.4), torch.bfloat16)),
}


@pytest.mark.parametrize("op", sorted(CASES))
def test_custom_op_counts_its_plain_versions_flops(op):
    wrapper, plain, make = CASES[op]
    args = make()
    got, by_op = _count(wrapper, *args)
    want, _ = _count(plain, *args)
    assert got == want
    assert any(op in str(k) for k in by_op) or got == 0


def test_tower_through_the_fused_halves_counts_the_plain_tower(name):
    model = factory.create_model(name, device="cpu", precision="bf16")
    factory.cast_for_compute(model, torch.bfloat16)
    x = torch.zeros(2, 64, 64, 3, dtype=torch.bfloat16)
    set_use_kernels(model, True)
    on, by_op = _count(model.encode_image, x)
    set_use_kernels(model, False)
    off, _ = _count(model.encode_image, x)
    assert on == off
    assert any("fused_attn_half" in str(k) for k in by_op)


def test_profiler_keeps_going_on_a_bad_model(name, capsys):
    rows = profiler.main(["--model", f"no-such-model,{name}", "--device",
                          "cpu"])
    assert len(rows) == 1 and rows[0]["model"] == name
    assert "profile failed" in capsys.readouterr().out
