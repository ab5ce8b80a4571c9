"""The PyTorch port's XTag model and serving path against the JAX package.

A toy XTag-CLIP (the tests/test_serving.py geometry: 2 layers, width 64,
image 32, patch 8, ctx 16, vocab 1024; one head of 64 in each tower, so
its blocks take the fused halves) is built once in JAX; its flax
params are loaded into the port with convert/from_jax.load_jax_params and
both run in fp32 on the CPU on the same numpy inputs. Bar: 1e-3 (the
repo's parity contract, BASELINE.md:18); tag picks exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtagclip_tpu.factory import add_model_config as jax_add_model_config
from xtagclip_tpu.factory import create_model as jax_create_model
from xtagclip_tpu.serving import make_xtag_serve_step as jax_serve_step
from xtagclip_tpu.serving import (
    precompute_prompt_features as jax_precompute,
)
from xtagclip_tpu_torch import factory
from xtagclip_tpu_torch.convert.from_jax import load_jax_params, port_name
from xtagclip_tpu_torch.models.clip import num_combos
from xtagclip_tpu_torch.models.layers import set_use_kernels
from xtagclip_tpu_torch.ops import fused_attn_block as fab
from xtagclip_tpu_torch.serving import (
    make_xtag_serve_step,
    precompute_prompt_features,
)

torch.set_num_threads(1)

CFG = dict(
    embed_dim=64,
    fusion_dim=64,
    # head dim 64 in both towers: the fused halves take their streams
    vision_cfg=dict(layers=2, width=64, head_width=64, patch_size=8,
                    image_size=32),
    text_cfg=dict(context_length=16, vocab_size=1024, width=64, heads=1,
                  layers=2),
)
TOL = dict(rtol=1e-3, atol=1e-3)
B = 4


@pytest.fixture(scope="module")
def cfg_name(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "torchtiny.json"
    path.write_text(json.dumps(CFG))
    jax_add_model_config(str(path))
    factory.add_model_config(path)
    return path.stem


@pytest.fixture(scope="module")
def pair(cfg_name):
    """(JAX bundle, port model with the bundle's weights), both fp32."""
    bundle = jax_create_model(cfg_name, use_tagging=True, use_fusion=True)
    model = factory.create_model(cfg_name, device="cpu", use_tagging=True,
                                 use_fusion=True, init_seed=1)
    load_jax_params(model, jax.tree.map(np.asarray, bundle.params))
    return bundle, model


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    text = rng.integers(1, 1000, (B, 16)).astype(np.int32)
    table = rng.integers(1, 1000, (2, 3, num_combos(), 16)).astype(np.int32)
    return images, text, table


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def test_image_features_match(pair, inputs):
    bundle, model = pair
    images = inputs[0]
    j_pooled, j_tokens = bundle.encode_image(jnp.asarray(images),
                                             normalize=False)
    with torch.inference_mode():
        pooled, tokens = model.encode_image(torch.from_numpy(images))
    assert tokens.shape == (B, 17, 64)
    np.testing.assert_allclose(_np(pooled), _np(j_pooled), **TOL)
    np.testing.assert_allclose(_np(tokens), _np(j_tokens), **TOL)


def test_text_features_match(pair, inputs):
    bundle, model = pair
    text = inputs[1]
    j_proj, j_seq = bundle.encode_text(text, normalize=True)
    with torch.inference_mode():
        proj, seq = model.encode_text(torch.from_numpy(text).long(),
                                      normalize=True)
    np.testing.assert_allclose(_np(proj), _np(j_proj), **TOL)
    np.testing.assert_allclose(_np(seq), _np(j_seq), **TOL)


def test_tag_logits_and_picks_match(pair, inputs):
    bundle, model = pair
    _, j_tokens = bundle.encode_image(jnp.asarray(inputs[0]), normalize=False)
    j_logits = bundle.apply(j_tokens, method=bundle.module.tag_forward)
    j_local, j_global = bundle.apply(
        j_logits, method=bundle.module.prepare_tag_indices)
    with torch.inference_mode():
        _, tokens = model.encode_image(torch.from_numpy(inputs[0]))
        logits = model.tag_forward(tokens)
        local, glob = model.prepare_tag_indices(logits)
    np.testing.assert_allclose(_np(logits), _np(j_logits), **TOL)
    np.testing.assert_array_equal(local.numpy(), np.asarray(j_local))
    np.testing.assert_array_equal(glob.numpy(), np.asarray(j_global))


def test_tag_picks_take_first_index_on_ties(pair):
    """Equal scores in a category pick its first tag, as jnp.argmax does."""
    _, model = pair
    local, glob = model.prepare_tag_indices(torch.zeros(2, 44))
    assert local.tolist() == [[0] * 6] * 2
    assert glob.tolist() == [[0, 3, 7, 10, 14, 18]] * 2


@pytest.mark.parametrize("mode", ["text", "prompt_table"])
def test_full_forward_matches(pair, inputs, mode):
    bundle, model = pair
    images, text, table = inputs
    class_ids = np.array([0, 2, 1, 2], np.int32)
    if mode == "text":
        j_out = bundle.apply(jnp.asarray(images), jnp.asarray(text), None,
                             None, 0, True)
        kw = dict(text=torch.from_numpy(text).long())
    else:
        j_out = bundle.apply(jnp.asarray(images), None, jnp.asarray(table),
                             jnp.asarray(class_ids), 1, True)
        kw = dict(prompt_table=torch.from_numpy(table).long(),
                  class_ids=torch.from_numpy(class_ids).long(),
                  template_id=1)
    with torch.inference_mode():
        out = model(torch.from_numpy(images), **kw)
    for key in ("image_features", "text_features", "tag_logits", "i2t_cls",
                "t2i_cls", "logit_scale"):
        np.testing.assert_allclose(_np(out[key]), _np(j_out[key]), **TOL,
                                   err_msg=key)
    np.testing.assert_array_equal(out["tag_indices"].numpy(),
                                  np.asarray(j_out["tag_indices"]))
    assert out["i2t_cls"].shape == (B, B)


def test_serve_matches_jax_serve_body(pair, inputs):
    bundle, model = pair
    images, _, table = inputs
    j_table = jax_precompute(bundle, table, template_id=1, batch_size=1024)
    j_feat, j_tags, j_logits = jax_serve_step(bundle, j_table)(
        bundle.params, jnp.asarray(images))
    p_table = precompute_prompt_features(model, table, template_id=1,
                                         batch_size=1000)
    np.testing.assert_allclose(_np(p_table), _np(j_table), **TOL)
    feat, tags, logits = make_xtag_serve_step(model, p_table)(
        torch.from_numpy(images))
    assert logits.shape == (B, 3) and tags.shape == (B, 6)
    np.testing.assert_allclose(_np(logits), _np(j_logits), **TOL)
    np.testing.assert_allclose(_np(feat), _np(j_feat), **TOL)
    np.testing.assert_array_equal(tags.numpy(), np.asarray(j_tags))


def test_serve_requires_fusion_model(cfg_name):
    model = factory.create_model(cfg_name, device="cpu")
    assert model.fusion_model is None
    with pytest.raises(ValueError, match="use_fusion"):
        make_xtag_serve_step(model, torch.zeros(3, num_combos(), 64))


def test_load_jax_params_is_strict(pair):
    bundle, _ = pair
    params = jax.tree.map(np.asarray, bundle.params)
    fresh = factory.create_model(bundle.model_name, device="cpu",
                                 use_tagging=True, use_fusion=True)
    missing = dict(params)
    del missing["tag_fc"]
    with pytest.raises(ValueError, match="tag_fc"):
        load_jax_params(fresh, missing)
    extra = dict(params, surplus={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="surplus"):
        load_jax_params(fresh, extra)
    bad = jax.tree.map(lambda a: a, params)
    bad["visual"] = dict(bad["visual"], proj=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="visual.proj"):
        load_jax_params(fresh, bad)


@pytest.mark.parametrize("path,name", [
    ("visual.transformer.resblocks_1.attn.in_proj.kernel",
     "visual.transformer.resblocks.1.attn.in_proj.kernel"),
    ("fusion_model.decoder_layer_3.norm2.scale",
     "fusion_model.decoder_layers.3.norm2.scale"),
    ("tag_head.layer_0_crossattention.key.bias",
     "tag_head.layers.0.crossattention.key.bias"),
    ("tag_head.layer_1_ffn.output_ln.scale",
     "tag_head.layers.1.ffn.output_ln.scale"),
    ("fusion_model.mlp_0.kernel", "fusion_model.mlp_0.kernel"),
])
def test_port_name(path, name):
    assert port_name(path) == name


def test_bf16_model_on_cpu_runs_plain_halves(cfg_name, pair, inputs):
    """bf16 on the CPU: the model keeps fp32 masters until the serving
    cast; then every block takes the plain halves (no launch is counted),
    close to the fp32 model, and the explicit plain switch gives the same
    numbers on the CPU."""
    bundle, fp32_model = pair
    model = factory.create_model(cfg_name, device="cpu", precision="bf16",
                                 use_tagging=True, use_fusion=True)
    load_jax_params(model, jax.tree.map(np.asarray, bundle.params))
    assert model.visual.conv1.kernel.dtype == torch.float32
    assert all(p.requires_grad for p in model.parameters())
    factory.cast_for_compute(model, torch.bfloat16)
    assert model.visual.conv1.kernel.dtype == torch.bfloat16
    blk = model.visual.transformer.resblocks[0]
    assert blk.attn.in_proj.bias.dtype == torch.float32
    assert blk.ln_1.scale.dtype == torch.float32
    before = (fab.fused_attn_half.launches, fab.fused_mlp_half.launches)
    images = torch.from_numpy(inputs[0])
    with torch.inference_mode():
        pooled, _ = model.encode_image(images, normalize=True)
        ref, _ = fp32_model.encode_image(images, normalize=True)
        set_use_kernels(model, False)
        plain, _ = model.encode_image(images, normalize=True)
        set_use_kernels(model, True)
    assert (fab.fused_attn_half.launches,
            fab.fused_mlp_half.launches) == before
    assert pooled.dtype == torch.bfloat16
    torch.testing.assert_close(pooled, plain, rtol=0, atol=0)
    cos = torch.nn.functional.cosine_similarity(pooled.float(), ref, dim=-1)
    assert cos.min().item() > 0.99


def test_seeded_init_is_deterministic(cfg_name):
    a = factory.create_model(cfg_name, device="cpu", init_seed=3)
    b = factory.create_model(cfg_name, device="cpu", init_seed=3)
    c = factory.create_model(cfg_name, device="cpu", init_seed=4)
    ka, kb, kc = (m.visual.conv1.kernel for m in (a, b, c))
    assert torch.equal(ka, kb) and not torch.equal(ka, kc)
    # lecun-normal: std sqrt(1 / fan_in), truncated at 2 std
    fan_in = ka.shape[0]
    assert abs(ka.std().item() * fan_in**0.5 - 1.0) < 0.1
    assert a.logit_scale.item() == pytest.approx(np.log(1 / 0.07))


def test_predict_cli_fusion_classify_on_cpu(tmp_path):
    from PIL import Image

    from xtagclip_tpu_torch.cli import predict

    cfg = dict(CFG, text_cfg=dict(CFG["text_cfg"], vocab_size=49408))
    path = tmp_path / "torchtinycli.json"
    path.write_text(json.dumps(cfg))
    factory.add_model_config(path)
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
                        ).save(tmp_path / f"img{i}.png")
    out = tmp_path / "preds.jsonl"
    predict.main(["--model", path.stem, "--fusion-classify", "--input",
                  str(tmp_path), "--device", "cpu", "--precision", "fp32",
                  "--batch-size", "2", "--output", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["image"].rsplit("/", 1)[-1] for r in recs] == [
        "img0.png", "img1.png", "img2.png"]
    for r in recs:
        assert r["class"] in ("Others", "Hypertrophic scar", "Keloid scar")
        assert sum(r["probs"].values()) == pytest.approx(1.0, abs=1e-3)
        assert len(r["tags"]) == 6


@pytest.mark.parametrize("case", [
    "named_pretrained_tag",
    "artifact_without_fusion_classify",
    "artifact_without_serve_classify",
    "big_vision_npz",
])
def test_predict_cli_unported_paths_fail_clearly(case, tmp_path):
    """What the predict CLI still refuses, each with a clear error: a named
    --pretrained tag (pretrained.py is not ported), --serving-artifact
    without --fusion-classify (as JAX's CLI), an artifact without a
    serve_classify entry, and a big_vision .npz."""
    from xtagclip_tpu_torch.cli import predict

    path = tmp_path / "torchtinyrefuse.json"
    path.write_text(json.dumps(CFG))
    factory.add_model_config(path)
    art = tmp_path / "art"
    art.mkdir()
    (art / "serving_manifest.json").write_text(json.dumps(
        {"model": path.stem, "entries": {}, "preprocess": {"size": 32}}))
    npz = tmp_path / "big_vision.npz"
    np.savez(npz, x=np.zeros(1))
    flags, err, match = {
        "named_pretrained_tag": (["--pretrained", "openai"],
                                 NotImplementedError, "named tags"),
        "artifact_without_fusion_classify": (
            ["--serving-artifact", str(art)], SystemExit,
            "--serving-artifact requires --fusion-classify"),
        "artifact_without_serve_classify": (
            ["--serving-artifact", str(art), "--fusion-classify"],
            SystemExit, "no serve_classify entry"),
        "big_vision_npz": (["--pretrained", str(npz)], NotImplementedError,
                           "big_vision .npz checkpoints are not ported"),
    }[case]
    with pytest.raises(err, match=match):
        predict.main(["--model", path.stem, "--input", "x.png", "--device",
                      "cpu", "--precision", "fp32", *flags])
