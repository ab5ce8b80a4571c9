"""The port's predict CLI with weights, its serving artifact and its
custom ops, on the CPU, against the JAX package.

A toy XTag-CLIP (width 64, one head of 64 in each tower, 2 layers, the
real vocabulary so the CLIs' tokenizer and prompt table apply) is built
once in JAX and written as an open_clip ``.pt`` by the JAX exporter; both
predict CLIs read that file and must agree (fp32: classes and tags equal,
every prob within 1e-3, BASELINE.md:18). The serving artifact
(``torch.export``) is held to the live model at two batch sizes of one
symbolic export: bf16 tags equal, features within 5e-3 and logits within
5e-2 (JAX's bars, tests/test_serving_export.py); fp32 within 1e-5.
"""

import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from torch._subclasses.fake_tensor import FakeTensorMode

from xtagclip_tpu.cli.predict import main as jax_predict
from xtagclip_tpu.convert.export import (
    save_open_clip_checkpoint as jax_save_open_clip_checkpoint,
)
from xtagclip_tpu.factory import add_model_config as jax_add_model_config
from xtagclip_tpu.factory import create_model as jax_create_model
from xtagclip_tpu_torch import factory
from xtagclip_tpu_torch.cli import main_other
from xtagclip_tpu_torch.cli import predict
from xtagclip_tpu_torch.convert import serving as cs
from xtagclip_tpu_torch.convert.export import (
    save_open_clip_checkpoint,
    to_openclip_state_dict,
)
from xtagclip_tpu_torch.convert.from_jax import load_jax_params
from xtagclip_tpu_torch.models.clip import num_combos
from xtagclip_tpu_torch.ops import flash_attn, fused_mlp, preprocess
from xtagclip_tpu_torch.ops import fused_attn_block as fab
from xtagclip_tpu_torch.serving import CudaGraphRunner, make_serve_classify
from xtagclip_tpu_torch.train.logger import close_logging

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CLI_CFG = dict(
    embed_dim=64, fusion_dim=64,
    vision_cfg=dict(layers=2, width=64, head_width=64, patch_size=16,
                    image_size=32),
    text_cfg=dict(context_length=77, vocab_size=49408, width=64, heads=1,
                  layers=2),
)
EXPORT_CFG = dict(
    embed_dim=64, fusion_dim=64,
    vision_cfg=dict(layers=2, width=64, head_width=64, patch_size=8,
                    image_size=32),
    text_cfg=dict(context_length=16, vocab_size=1024, width=64, heads=1,
                  layers=2),
)


def _register(tmp_path_factory, name, cfg):
    path = tmp_path_factory.mktemp("cfg") / f"{name}.json"
    path.write_text(json.dumps(cfg))
    jax_add_model_config(str(path))
    factory.add_model_config(path)
    return name


@pytest.fixture(scope="module")
def cli_cfg(tmp_path_factory):
    return _register(tmp_path_factory, "torchtinyserve", CLI_CFG)


@pytest.fixture(scope="module")
def export_cfg(tmp_path_factory):
    return _register(tmp_path_factory, "torchtinyexport", EXPORT_CFG)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
                        ).save(d / f"im{i}.png")
    return d


@pytest.fixture(scope="module")
def jax_pt(cli_cfg, tmp_path_factory):
    """The toy model in JAX, written by the JAX exporter."""
    bundle = jax_create_model(cli_cfg, precision="fp32", use_tagging=True,
                              use_fusion=True)
    path = tmp_path_factory.mktemp("pt") / "xtag.pt"
    jax_save_open_clip_checkpoint(bundle, str(path))
    return str(path)


def _records(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _port_predict(argv):
    predict.main(argv + ["--device", "cpu"])


# -- (a) the port's predict against JAX's predict on one .pt ------------------

@pytest.mark.parametrize("flags", [
    ["--use-tagging"],
    ["--fusion-scoring", "--dataset", "pathmnist"],
    ["--classnames", "cat,dog", "--template", "a photo of a {}.",
     "--use-tagging"],
    ["--fusion-classify"],
], ids=["zero_shot", "fusion_scoring", "template", "fusion_classify"])
def test_predict_matches_jax(flags, cli_cfg, jax_pt, image_dir, tmp_path):
    common = ["--model", cli_cfg, "--precision", "fp32", "--pretrained",
              jax_pt, "--input", str(image_dir), "--batch-size", "4", *flags]
    jax_predict(common + ["--output", str(tmp_path / "jax.jsonl")])
    _port_predict(common + ["--output", str(tmp_path / "port.jsonl")])
    want, got = _records(tmp_path / "jax.jsonl"), _records(
        tmp_path / "port.jsonl")
    assert len(got) == len(want) == 5  # 4 + a padded last batch of 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["image"] == w["image"] and g["class"] == w["class"]
        assert g.get("tags") == w.get("tags")
        assert g["probs"].keys() == w["probs"].keys()
        for c, p in w["probs"].items():
            assert abs(g["probs"][c] - p) <= 1e-3, (c, g["probs"][c], p)
    assert ("tags" in got[0]) == ("--use-tagging" in flags
                                  or "--fusion-classify" in flags)


# -- (b) the port's exporter read back by JAX's loader ------------------------

def test_port_export_reads_back_in_jax(cli_cfg, tmp_path):
    model = factory.create_model(cli_cfg, device="cpu", use_tagging=True,
                                 use_fusion=True, init_seed=5)
    path = tmp_path / "port.pt"
    save_open_clip_checkpoint(model, str(path))
    bundle = jax_create_model(cli_cfg, pretrained=str(path),
                              precision="fp32", use_tagging=True,
                              use_fusion=True)
    back = factory.create_model(cli_cfg, device="cpu", use_tagging=True,
                                use_fusion=True, init_seed=6)
    load_jax_params(back, jax.tree.map(np.asarray, bundle.params))
    theirs = dict(back.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, theirs[name]), name


def test_port_export_round_trips_through_the_port_loader(cli_cfg, tmp_path):
    model = factory.create_model(cli_cfg, device="cpu", use_tagging=True,
                                 use_fusion=True, init_seed=7)
    sd = to_openclip_state_dict(model)
    assert sd["visual.conv1.weight"].shape == (64, 3, 16, 16)
    assert np.array_equal(sd["fusion_model.decoder.norm.weight"],
                          sd["fusion_model.decoder_norm.weight"])
    path = tmp_path / "port.pt"
    save_open_clip_checkpoint(model, str(path))
    back = factory.create_model(cli_cfg, device="cpu", use_tagging=True,
                                use_fusion=True, init_seed=8)
    factory.load_checkpoint(back, str(path))
    theirs = dict(back.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, theirs[name]), name


# -- (c) the serving artifact against the live model --------------------------

def _live_and_artifact(cfg_name, precision, out_dir):
    model = factory.create_model(cfg_name, device="cpu", precision=precision,
                                 use_tagging=True, use_fusion=True,
                                 init_seed=2)
    dtype = factory.get_cast_dtype(precision)
    factory.cast_for_compute(model, dtype)
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal(
        (3, num_combos(), 64)).astype(np.float32)).to(dtype)
    manifest = cs.save_serving(model, str(out_dir), model_name=cfg_name,
                               serve_classify_table=table,
                               classnames=["a", "b", "c"])
    return model, table, manifest


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_artifact_matches_live_model(precision, export_cfg, tmp_path):
    model, table, manifest = _live_and_artifact(export_cfg, precision,
                                                tmp_path / "art")
    assert set(manifest["entries"]) == {"encode_image", "encode_text",
                                        "forward", "serve_classify"}
    assert manifest["classnames"] == ["a", "b", "c"]
    assert manifest["preprocess"]["size"] == 32
    image, ids = "uint8[b, 32, 32, 3]", "int64[b, 16]"
    assert {k: v["in_avals"] for k, v in manifest["entries"].items()} == {
        "encode_image": [image], "encode_text": [ids],
        "forward": [image, ids], "serve_classify": [image]}
    for meta in manifest["entries"].values():
        assert meta["bytes"] > 0
        assert (tmp_path / "art" / meta["file"]).is_file()
    fns = cs.load_serving(str(tmp_path / "art"))
    live = make_serve_classify(model, table)
    dtype = factory.get_cast_dtype(precision)
    feat_tol, logit_tol = (5e-3, 5e-2) if precision == "bf16" else (1e-5,
                                                                     1e-5)
    rng = np.random.default_rng(4)
    for b in (2, 5):  # one symbolic export, two batch sizes
        img = torch.from_numpy(rng.integers(0, 256, (b, 32, 32, 3),
                                            dtype=np.uint8))
        ids = torch.from_numpy(rng.integers(1, 1023, (b, 16)))
        a_feat, a_tags, a_logits = fns["serve_classify"](img)
        w_feat, w_tags, w_logits = live(img)
        assert torch.equal(a_tags, w_tags)
        torch.testing.assert_close(a_feat.float(), w_feat.float(), rtol=0,
                                   atol=feat_tol)
        torch.testing.assert_close(a_logits.float(), w_logits.float(),
                                   rtol=0, atol=logit_tol)
        with torch.no_grad():
            want_img = model.encode_image(preprocess.normalize_images(
                img, dtype=dtype), normalize=True)[0]
            want_txt = model.encode_text(ids, normalize=True)[0]
        got_img = fns["encode_image"](img)
        got_txt = fns["encode_text"](ids)
        f_img, f_txt, scale = fns["forward"](img, ids)
        for got, want in ((got_img, want_img), (got_txt, want_txt),
                          (f_img, want_img), (f_txt, want_txt)):
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=feat_tol)
        assert scale.item() == pytest.approx(np.exp(np.log(1 / 0.07)))
    if precision == "bf16":
        # one node per block half and one normalize: the vision tower's 2
        # blocks through the fused halves' custom ops
        ep = torch.export.load(str(tmp_path / "art" / "serve_classify.pt2"))
        ops = Counter(str(n.target) for n in ep.graph.nodes
                      if n.op == "call_function"
                      and str(n.target).startswith("xtagclip_tpu_torch."))
        assert ops == {"xtagclip_tpu_torch.fused_attn_half.default": 2,
                       "xtagclip_tpu_torch.fused_mlp_half.default": 2,
                       "xtagclip_tpu_torch.normalize_images.default": 1}
        assert not any(k.startswith("model.text.") for k in ep.state_dict)


def test_pinned_batch_refuses_another_size(export_cfg):
    model = factory.create_model(export_cfg, device="cpu", init_seed=2)
    (ep,) = cs.export_serving(model, batch_size=3,
                              entries=("encode_image",)).values()
    fn = ep.module()
    img = torch.zeros((3, 32, 32, 3), dtype=torch.uint8)
    with torch.no_grad():
        assert tuple(fn(img).shape) == (3, 64)
        with pytest.raises((AssertionError, RuntimeError, ValueError),
                           match="3"):
            fn(img[:2])


def test_load_serving_needs_no_model_code(export_cfg, tmp_path):
    """(d): a fresh process loads and runs the artifact with only the
    port's ops registered; no xtagclip_tpu_torch.models module loads."""
    model = factory.create_model(export_cfg, device="cpu", init_seed=2)
    cs.save_serving(model, str(tmp_path / "art"), entries=("encode_image",))
    code = (
        "import json, sys, torch\n"
        "from xtagclip_tpu_torch.convert.serving import load_serving\n"
        f"fns = load_serving({str(tmp_path / 'art')!r})\n"
        "out = fns['encode_image'](torch.zeros((2, 32, 32, 3), "
        "dtype=torch.uint8))\n"
        "print(json.dumps([list(out.shape), sorted(m for m in sys.modules "
        "if m.startswith('xtagclip_tpu_torch.models'))]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    shape, models = json.loads(res.stdout.strip().splitlines()[-1])
    assert shape == [2, 64] and models == []


def test_predict_from_artifact_matches_live(cli_cfg, jax_pt, image_dir,
                                            tmp_path):
    common = ["--input", str(image_dir), "--fusion-classify",
              "--batch-size", "4"]
    art = tmp_path / "artifact"
    _port_predict(common + ["--model", cli_cfg, "--precision", "fp32",
                            "--pretrained", jax_pt, "--export-serving",
                            str(art), "--output", str(tmp_path / "live.jsonl")])
    assert (art / "serving_manifest.json").is_file()
    assert (art / "serve_classify.pt2").is_file()
    _port_predict(common + ["--serving-artifact", str(art), "--output",
                            str(tmp_path / "art.jsonl")])
    live, from_art = (_records(tmp_path / n) for n in ("live.jsonl",
                                                        "art.jsonl"))
    assert len(from_art) == len(live) == 5
    for a, b in zip(from_art, live):
        assert (a["image"], a["class"], a["tags"]) == (b["image"], b["class"],
                                                       b["tags"])
        for c, p in b["probs"].items():
            assert abs(a["probs"][c] - p) < 0.05


# -- (e) --resume on the port's own training checkpoint ----------------------

def test_train_checkpoint_predict_roundtrip(cli_cfg, image_dir, tmp_path,
                                            capsys):
    """main_other trains on synthetic data -> the port's checkpoint tag ->
    predict --resume serves it (tests/test_predict_cli.py:100-124)."""
    try:
        out = main_other.main([
            "--model", cli_cfg, "--dataset-type", "synthetic",
            "--train-num-samples", "8", "--batch-size", "4", "--epochs",
            "1", "--warmup", "1", "--precision", "fp32", "--lr", "1e-4",
            "--logs", str(tmp_path / "logs"), "--name", "lifecycle",
            "--val-frequency", "0", "--workers", "1", "--device", "cpu"])
    finally:
        close_logging()
    ckpt = tmp_path / "logs" / "lifecycle" / "checkpoints" / "last"
    assert (ckpt / "state.pt").is_file()
    trained = out["state"].model.state_dict()
    model = factory.create_model(cli_cfg, device="cpu", init_seed=9)
    factory.load_checkpoint(model, str(ckpt))
    for name, p in model.named_parameters():
        assert torch.equal(p, trained[name]), name
    capsys.readouterr()
    _port_predict(["--model", cli_cfg, "--precision", "fp32", "--input",
                   str(image_dir / "im0.png"), "--resume", str(ckpt),
                   "--classnames", "cat,dog"])
    rec = json.loads(capsys.readouterr().out.splitlines()[0])
    assert set(rec["probs"]) == {"cat", "dog"} and "tags" not in rec
    assert all(np.isfinite(p) for p in rec["probs"].values())


# -- (f) the custom ops' fake implementations --------------------------------

def _op_cases():
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    bf = torch.bfloat16
    b, l, d, h = 2, 16, 128, 2
    mask = torch.triu(torch.full((l, l), float("-inf")), 1)
    qkv = rnd(b, l, 3 * d, dtype=bf)
    q, k, v = (t.reshape(b, l, h, 64) for t in qkv.split(d, dim=-1))
    return {
        "fused_attn_half": (fab.fused_attn_half_op, fab.reference_attn_half, (
            rnd(b, l, d, dtype=bf), 1 + rnd(d), rnd(d), rnd(d, 3 * d, dtype=bf),
            rnd(3 * d), rnd(d, d, dtype=bf), rnd(d), mask, h, 1e-5)),
        "fused_mlp_half": (fab.fused_mlp_half_op, fab.reference_mlp_half, (
            rnd(b, l, d, dtype=bf), 1 + rnd(d), rnd(d),
            rnd(d, 4 * d, dtype=bf), rnd(4 * d), rnd(4 * d, d, dtype=bf),
            rnd(d), "quick_gelu", 1e-5)),
        "fused_mlp": (fused_mlp.fused_mlp_op, fused_mlp.reference_fused_mlp, (
            rnd(b * l, d, dtype=bf), rnd(d, 4 * d, dtype=bf), rnd(4 * d),
            rnd(4 * d, d, dtype=bf), rnd(d), "gelu")),
        "flash_mha": (flash_attn.flash_mha_op, flash_attn.reference_flash_mha,
                      (q, k, v, "blhd")),
        "normalize_images": (
            preprocess.normalize_images_op,
            preprocess.normalize_images_reference,
            (torch.randint(0, 256, (2, 8, 8, 3), dtype=torch.uint8,
                           generator=g), [0.5, 0.4, 0.3], [0.2, 0.25, 0.3],
             bf)),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_custom_op_fake_gives_plain_shapes(name):
    op, plain, args = _op_cases()[name]
    want = plain(*args)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
        got = op(*fake_args)
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    assert got.is_contiguous() and want.is_contiguous()
    # on the CPU the op runs the plain version
    assert torch.equal(op(*args), want)


def test_graph_runner_calls_through_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(torch.is_inference_mode_enabled())
        return x * 2

    runner = CudaGraphRunner(fn)
    x = torch.arange(4.0)
    assert torch.equal(runner(x), x * 2) and runner.graphs == {}
    assert calls == [True]
