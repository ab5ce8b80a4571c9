"""The port's examples (xtagclip_tpu_torch/examples/) run as documented,
``python -m xtagclip_tpu_torch.examples.<name> --device cpu``, against
what JAX's examples/ compute, on the CPU.

A toy config (tests/test_examples.py's) reaches the port's process through
XTAGCLIP_EXTRA_CONFIGS; both packages load one ``.pt`` that the JAX
exporter writes (``--pretrained``), in bf16 as both examples run, on the
same seeded synthetic inputs. The JAX side runs in this process through
the calls its examples make. Bars (chip_smoke.py's serve bars, bf16):
image and text features at cosine >= 0.999 a row; the six tag picks and
the printed shapes equal; the zero-shot probabilities within 0.05 and
the same top class.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

import xtagclip_tpu as xc  # noqa: E402
from xtagclip_tpu.convert.export import save_open_clip_checkpoint  # noqa: E402
from xtagclip_tpu.tokenize.prompts import PromptTable  # noqa: E402
from xtagclip_tpu.train.metadata import (  # noqa: E402
    SCAR_CLASSNAMES,
    SIMPLE_SCAR_TEMPLATES,
)
from xtagclip_tpu.train.zero_shot import build_zero_shot_classifier  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "torch-ex-tiny"
TINY = dict(
    embed_dim=64,
    fusion_dim=64,
    vision_cfg=dict(layers=2, width=64, head_width=32, patch_size=16,
                    image_size=32),
    text_cfg=dict(context_length=77, vocab_size=49408, width=64, heads=2,
                  layers=2),
)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The config directory, and the ``.pt`` of a JAX toy XTag model."""
    d = tmp_path_factory.mktemp("excfg")
    (d / f"{NAME}.json").write_text(json.dumps(TINY))
    xc.add_model_config(str(d / f"{NAME}.json"))
    bundle = xc.create_model(NAME, use_tagging=True, use_fusion=True,
                             init_seed=4)
    pt = str(d / "toy.pt")
    save_open_clip_checkpoint(bundle, pt)
    return str(d), pt


def _run(name, args, cfg_dir, cwd):
    env = dict(os.environ, XTAGCLIP_EXTRA_CONFIGS=cfg_dir, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", f"xtagclip_tpu_torch.examples.{name}",
         "--model", NAME, "--device", "cpu", *args],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def _jax_bundle(pt, **kw):
    bundle, _, _ = xc.create_model_and_transforms(NAME, pretrained=pt,
                                                  precision="bf16", **kw)
    return bundle


def _synthetic(b):
    return np.random.default_rng(0).normal(size=(b, 32, 32, 3)).astype(
        np.float32)


def _cosines(a, b):
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                * np.linalg.norm(b, axis=-1))


def test_feature_extraction(setup, tmp_path):
    cfg_dir, pt = setup
    out = tmp_path / "emb.npz"
    stdout = _run("feature_extraction", ["--pretrained", pt,
                                         "--batch-size", "8", "--out",
                                         str(out)], cfg_dir, str(tmp_path))
    assert "image (8, 64), text (2, 64)" in stdout
    got = np.load(out)
    assert got["image_features"].dtype == np.float32
    bundle = _jax_bundle(pt)
    img = np.asarray(bundle.encode_image(jnp.asarray(_synthetic(8)))[0],
                     np.float32)
    tok = xc.get_tokenizer(NAME)(list(got["texts"]))
    txt = np.asarray(bundle.encode_text(jnp.asarray(tok))[0], np.float32)
    assert _cosines(got["image_features"], img).min() >= 0.999
    assert _cosines(got["text_features"], txt).min() >= 0.999
    assert list(got["image_names"]) == [f"synthetic_{i}" for i in range(8)]


def test_xtag_inference(setup, tmp_path):
    cfg_dir, pt = setup
    stdout = _run("xtag_inference", ["--pretrained", pt, "--batch-size",
                                     "2"], cfg_dir, str(tmp_path))
    bundle = _jax_bundle(pt, use_tagging=True, use_fusion=True)
    table = jnp.asarray(PromptTable(list(SCAR_CLASSNAMES),
                                    tokenizer=xc.get_tokenizer(NAME)).table)
    want = jax.jit(lambda p, i, t, c: bundle.apply(i, None, t, c, 0, True,
                                                   params=p))(
        bundle.params, jnp.asarray(_synthetic(2)), table,
        jnp.zeros((2,), jnp.int32))
    assert f"prompt table: {table.shape} (2304 tag combos)" in stdout
    assert f"tag_logits: {want['tag_logits'].shape}" in stdout
    assert (f"fusion i2t: {want['i2t_cls'].shape} "
            f"t2i: {want['t2i_cls'].shape}") in stdout
    picks = re.search(r"tag_indices: \[([^\]]*)\]", stdout).group(1).split()
    assert [int(p) for p in picks] == np.asarray(
        want["tag_indices"])[0].tolist()


def test_zero_shot_classification(setup, tmp_path):
    cfg_dir, pt = setup
    stdout = _run("zero_shot_classification", ["--pretrained", pt], cfg_dir,
                  str(tmp_path))
    lines = [ln.split(None, 1) for ln in stdout.splitlines() if ln.strip()]
    assert len(lines) == 3
    got = {name: float(p) for p, name in lines}
    bundle = _jax_bundle(pt)
    classifier = build_zero_shot_classifier(
        bundle.module, bundle.params, xc.get_tokenizer(NAME),
        classnames=SCAR_CLASSNAMES, templates=SIMPLE_SCAR_TEMPLATES)
    feats = bundle.encode_image(jnp.asarray(_synthetic(1)))[0]
    probs = np.asarray(jax.nn.softmax(100.0 * feats @ classifier, axis=-1))[0]
    want = dict(zip(SCAR_CLASSNAMES, probs.tolist()))
    assert set(got) == set(want)
    assert max(got, key=got.get) == max(want, key=want.get)
    for name in want:
        assert abs(got[name] - want[name]) <= 0.05, (name, got, want)
