"""The port's CLIPA slice against the JAX package, on the CPU: the CLIPA
ViT-H/14 GAP recipe's path (BASELINE config 5) at toy geometry, the tower
options it and the rest of the zoo set, flash attention's plain versions
at the head dims the kernels gained, per-block checkpointing, patch
dropout, the vanilla training CLI (``cli/main.py``) and its ``evaluate``.

Toy geometry: vision width 160 with 2 heads of 80 (ViT-H's head dim), 2
layers, patch 8, 64 px (L = 65 with the class token), avg pool with
``final_ln_after_pool``; text width 64, one head, 2 layers, context 32,
the real vocabulary. Weights cross through ``load_jax_params`` (strict:
every parameter name of every option must match JAX's tree) or an
open_clip ``.pt`` written by JAX's exporter.

Bars (BASELINE.md:18, fp32): features and logits within 1e-3; the loss
within 1e-5 relative and each gradient within 1e-3 normalized by its
largest JAX value; the plain flash attention against JAX's XLA attention
within 1e-5 in fp32 and one bf16 ULP at output scale in bf16 (atol =
max|ref| / 128, rtol = 1e-2); checkpointing on vs off bit for bit; the
evaluate metrics of both CLIs within 1e-3.
"""

import json
import logging
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtagclip_tpu.cli import main as jax_main
from xtagclip_tpu.convert.export import save_open_clip_checkpoint
from xtagclip_tpu.factory import add_model_config as jax_add_model_config
from xtagclip_tpu.factory import create_model as jax_create_model
from xtagclip_tpu.losses import clip_loss as j_clip_loss
from xtagclip_tpu.models.layers import dot_product_attention as j_attention
from xtagclip_tpu_torch import factory
from xtagclip_tpu_torch.cli import main as port_main
from xtagclip_tpu_torch.cli import main_other
from xtagclip_tpu_torch.convert.from_jax import load_jax_params, port_name
from xtagclip_tpu_torch.models.layers import (
    patch_dropout,
    set_grad_checkpointing,
)
from xtagclip_tpu_torch.models.pos_embed import resize_vision_pos_embed
from xtagclip_tpu_torch.ops import flash_attn
from xtagclip_tpu_torch.train.logger import close_logging
from xtagclip_tpu_torch.train.loop import _model_losses
from xtagclip_tpu_torch.train.params import parse_args, unported
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
VISION = dict(layers=2, width=160, head_width=80, patch_size=8, image_size=64,
              pool_type="avg", final_ln_after_pool=True)
TEXT = dict(context_length=32, vocab_size=49408, width=64, heads=1, layers=2)
CL32 = dict(embed_dim=64, vision_cfg=VISION, text_cfg=TEXT)
TOL = dict(rtol=1e-3, atol=1e-3)
B = 2


def _register(tmp_path_factory, name, cfg):
    path = tmp_path_factory.mktemp("cfg") / f"{name}.json"
    path.write_text(json.dumps(cfg))
    jax_add_model_config(str(path))
    factory.add_model_config(path)
    return name


def _pair(name):
    """(JAX bundle, port model with the bundle's weights), both fp32."""
    bundle = jax_create_model(name)
    model = factory.create_model(name, device="cpu", init_seed=1)
    load_jax_params(model, jax.tree.map(np.asarray, bundle.params))
    return bundle, model


def _pair_from_port(name):
    """(JAX module, its params, port model): the port's seeded init as the
    JAX module's parameters, after a strict match of every name and shape
    against the tree JAX's init would make (``jax.eval_shape``: traced,
    not compiled, which keeps a test per option cheap)."""
    bundle = jax_create_model(name, skip_init=True)
    cfg = bundle.model_cfg
    side = cfg["vision_cfg"]["image_size"]
    shapes = jax.eval_shape(
        lambda: bundle.module.init(
            jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)),
            jnp.zeros((1, cfg["text_cfg"]["context_length"]), jnp.int32),
            deterministic=True))["params"]
    model = factory.create_model(name, device="cpu", init_seed=1)
    ours = {n: p.detach().numpy() for n, p in model.named_parameters()}
    paths = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        paths[port_name(".".join(keys))] = (keys, tuple(leaf.shape))
    assert sorted(paths) == sorted(ours)
    params = {}
    for n, (keys, shape) in paths.items():
        assert ours[n].shape == shape, n
        node = params
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(ours[n])
    return bundle.module, params, model


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    texts = np.zeros((B, 32), np.int32)
    texts[:, 0] = 49406
    texts[:, 1:12] = rng.integers(1, 49000, (B, 11))
    texts[0, 12], texts[1, 9] = 49407, 49407  # EOTs at different places
    return images, texts


def _features(module, params, model, images, texts):
    """((JAX image, tokens, text, sequence), (the port's)) features."""
    variables = {"params": params}
    j_img, j_tok = module.apply(variables, jnp.asarray(images), False,
                                method=module.encode_image)
    j_txt, j_seq = module.apply(variables, jnp.asarray(texts), False,
                                method=module.encode_text)
    with torch.inference_mode():
        p_img, p_tok = model.encode_image(torch.from_numpy(images))
        p_txt, p_seq = model.encode_text(torch.from_numpy(texts).long())
    return (j_img, j_tok, j_txt, j_seq), (p_img, p_tok, p_txt, p_seq)


@pytest.fixture(scope="module")
def cl32(tmp_path_factory):
    return _pair(_register(tmp_path_factory, "toy-clipa-cl32", CL32))


# -- (a) the toy CL32-GAP model ----------------------------------------------

def test_cl32_gap_model_matches_jax(cl32):
    """Image and text features, all tokens, and the logits."""
    bundle, model = cl32
    images, texts = _batch()
    jax_out, port_out = _features(bundle.module, bundle.params, model,
                                  images, texts)
    assert port_out[1].shape == (B, 65, 64)
    for j, p in zip(jax_out, port_out):
        np.testing.assert_allclose(_np(p), _np(j), **TOL)
    with torch.inference_mode():
        out = model(torch.from_numpy(images),
                    text=torch.from_numpy(texts).long())
    j_full = bundle.module.apply({"params": bundle.params},
                                 jnp.asarray(images), jnp.asarray(texts))
    for key in ("image_features", "text_features", "logit_scale"):
        np.testing.assert_allclose(_np(out[key]), _np(j_full[key]), **TOL)
    logits = out["logit_scale"] * out["image_features"] @ \
        out["text_features"].T
    j_logits = j_full["logit_scale"] * j_full["image_features"] @ \
        j_full["text_features"].T
    np.testing.assert_allclose(_np(logits), _np(j_logits), **TOL)


# -- (b) each tower option ----------------------------------------------------

OPTIONS = {
    "vision_layer_scale": ({"ls_init_value": 0.1}, {}),
    "no_ln_pre": ({"no_ln_pre": True}, {}),
    "sin_cos_2d": ({"pos_embed_type": "sin_cos_2d"}, {}),
    "learnable_tokens": ({"n_learnable_tokens": 2, "insert_position": 1}, {}),
    "cls_pool_learnable_tokens": ({"pool_type": "tok",
                                   "n_learnable_tokens": 3,
                                   "insert_position": 2}, {}),
    "text_pool_last": ({}, {"pool_type": "last"}),
    "text_pool_first": ({}, {"pool_type": "first"}),
    "no_causal_mask": ({}, {"no_causal_mask": True}),
    "proj_type_none": ({}, {"proj_type": "none"}),
    "proj_bias": ({}, {"proj_bias": True}),
    "text_layer_scale": ({}, {"ls_init_value": 0.1}),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_tower_option_matches_jax(option, tmp_path_factory):
    vision, text = OPTIONS[option]
    cfg = dict(embed_dim=64, vision_cfg={**VISION, "layers": 1, **vision},
               text_cfg={**TEXT, "layers": 1, **text})
    module, params, model = _pair_from_port(
        _register(tmp_path_factory, f"toy-{option}", cfg))
    images, texts = _batch(1)
    jax_out, port_out = _features(module, params, model, images, texts)
    for j, p in zip(jax_out, port_out):
        assert tuple(p.shape) == tuple(np.shape(j))
        np.testing.assert_allclose(_np(p), _np(j), **TOL)


# configs whose new parameters both weight routes must carry: LayerScale
# in both towers, learnable tokens, no ln_pre, a Dense text projection;
# and a text tower without a projection
CARRIED = {
    "carried-options": ({"ls_init_value": 0.1, "n_learnable_tokens": 2,
                         "no_ln_pre": True, "pos_embed_type": "sin_cos_2d"},
                        {"ls_init_value": 0.1, "proj_bias": True}),
    "carried-no-proj": ({}, {"proj_type": "none"}),
}


@pytest.mark.parametrize("name", sorted(CARRIED))
def test_new_parameters_cross_both_weight_routes(name, tmp_path,
                                                 tmp_path_factory):
    """The JAX tree (load_jax_params, strict) and the open_clip ``.pt``
    JAX's exporter writes give the port the same parameters, except the
    learnable tokens, which JAX's exporter leaves out; the port's own
    ``.pt`` (convert/export.py) carries every one, the tokens included.
    A sin_cos_2d table's own init in the port is JAX's table."""
    from xtagclip_tpu_torch.convert.export import (
        save_open_clip_checkpoint as port_save,
    )
    from xtagclip_tpu_torch.convert.loader import load_checkpoint_into

    vision, text = CARRIED[name]
    cfg = dict(embed_dim=64, vision_cfg={**VISION, "layers": 1, **vision},
               text_cfg={**TEXT, "layers": 1, **text})
    name = _register(tmp_path_factory, name, cfg)
    bundle, want = _pair(name)
    pt = str(tmp_path / "jax.pt")
    save_open_clip_checkpoint(bundle, pt)
    got = factory.create_model(name, device="cpu", init_seed=2)
    if vision.get("pos_embed_type") == "sin_cos_2d":
        np.testing.assert_allclose(
            _np(got.visual.positional_embedding),
            np.asarray(bundle.params["visual"]["positional_embedding"]),
            atol=1e-7)
    load_checkpoint_into(got, pt)
    ours = dict(got.named_parameters())
    for n, p in want.named_parameters():
        if n == "visual.learnable_tokens":
            assert not torch.equal(ours[n], p)  # not in JAX's .pt
        else:
            assert torch.equal(ours[n], p), n
    mine = str(tmp_path / "port.pt")
    port_save(want, mine)
    again = factory.create_model(name, device="cpu", init_seed=3)
    load_checkpoint_into(again, mine)
    for n, p in again.named_parameters():
        assert torch.equal(p, dict(want.named_parameters())[n]), n
    names = {n for n, _ in want.named_parameters()}
    if vision:
        assert {"visual.learnable_tokens", "text.text_projection.bias",
                "visual.transformer.resblocks.0.ls_2.gamma"} <= names
        assert not any(n.startswith("visual.ln_pre") for n in names)
    else:
        assert not any(n.startswith("text.text_projection") for n in names)


def test_final_ln_after_pool_changes_nothing(cl32, tmp_path_factory):
    """JAX follows the pool with ln_post whatever the flag says
    (vit.py:225-236); the port keeps that meaning."""
    bundle, model = cl32
    cfg = dict(CL32, vision_cfg={**VISION, "final_ln_after_pool": False})
    other = factory.create_model(
        _register(tmp_path_factory, "toy-no-final-ln", cfg), device="cpu")
    load_jax_params(other, jax.tree.map(np.asarray, bundle.params))
    images, _ = _batch(2)
    with torch.inference_mode():
        a = model.encode_image(torch.from_numpy(images))
        b = other.encode_image(torch.from_numpy(images))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_vit_h_configs_and_learnable_tokens_build():
    """ViT-H-14-CL32-GAP, ViT-H-14-CL8-SyntaxMask-GAP (~986M parameters)
    and ViT-B-32-learnable build as the port's towers (on the meta device:
    shapes only)."""
    want = {"ViT-H-14-CL32-GAP": 986.06, "ViT-H-14-CL8-SyntaxMask-GAP": 986.04}
    for name in (*want, "ViT-B-32-learnable"):
        cfg = factory.get_model_config(name)
        with torch.device("meta"):
            visual = factory._vision_tower(cfg["embed_dim"],
                                           cfg["vision_cfg"], "gelu",
                                           torch.bfloat16)
            text = factory._text_tower(cfg["embed_dim"], cfg["text_cfg"],
                                       "gelu", torch.bfloat16)
        n = sum(p.numel() for m in (visual, text) for p in m.parameters())
        if name in want:
            assert abs(n / 1e6 - want[name]) < 0.01, (name, n)
            assert visual.transformer.resblocks[0].heads == 16
            assert visual.final_ln_after_pool and visual.pool_type == "avg"
        else:
            assert tuple(visual.learnable_tokens.shape) == (2, 768)


# -- (c) the plain flash attention at the kernels' new head dims -------------

@pytest.mark.parametrize("dh", [72, 80, 88, 104, 112])
@pytest.mark.parametrize("bf16", [False, True])
def test_reference_flash_matches_jax_xla_attention(dh, bf16):
    """The plain forward against JAX's XLA attention, jitted: fp32 within
    1e-5 under "highest" precision, bf16 within one bf16 ULP at output
    scale."""
    rng = np.random.default_rng(dh)
    b, h, l = 2, 3, 37
    arrs = [rng.standard_normal((b, h, l, dh)).astype(np.float32)
            for _ in range(3)]
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda q, k, v: j_attention(q, k, v)[0])(
            *(jnp.asarray(a, jdt) for a in arrs))
    got = flash_attn.reference_flash_mha(
        *(torch.from_numpy(a).to(tdt) for a in arrs), layout="bhld")
    got, want = _np(got), _np(want)
    if bf16:
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=float(np.abs(want).max()) / 128)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dh", [72, 80, 88, 104, 112])
def test_flash_supports_the_new_head_dims(dh):
    assert flash_attn.supported(257, 257, None, dh)
    assert not flash_attn.supported(257, 257, None, dh + 4)
    assert not flash_attn.supported(257, 257, None, 256)


# -- (d) loss and gradients, checkpointing -------------------------------------

def _port_loss_and_grads(model, images, texts):
    model.zero_grad(set_to_none=True)
    batch = {"images": torch.from_numpy(images),
             "texts": torch.from_numpy(texts).long()}
    total, _ = _model_losses(model, batch, {"use_tagging_loss": False},
                             deterministic=True)
    total.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return total.detach(), grads


def test_clip_loss_and_grads_match_jax(cl32):
    bundle, model = cl32
    images, texts = _batch(3)

    def j_total(params):
        out = bundle.module.apply({"params": params}, jnp.asarray(images),
                                  jnp.asarray(texts), deterministic=True)
        return j_clip_loss(out["image_features"], out["text_features"],
                           out["logit_scale"])

    with jax.default_matmul_precision("highest"):
        j_val, j_grads = jax.jit(jax.value_and_grad(j_total))(
            jax.tree.map(jnp.asarray, bundle.params))
    total, grads = _port_loss_and_grads(model, images, texts)
    assert abs(total.item() - float(j_val)) <= 1e-5 * abs(float(j_val))
    n = 0
    for path, g in jax.tree_util.tree_leaves_with_path(j_grads):
        name = port_name(".".join(str(getattr(k, "key", k)) for k in path))
        g = np.asarray(g)
        if not np.any(g):
            continue
        err = np.abs(_np(grads[name]) - g).max() / max(1.0, np.abs(g).max())
        assert err <= 1e-3, name
        n += name.startswith(("visual.transformer", "text.transformer"))
    assert n == 2 * 2 * 12  # every block parameter of both towers


def test_grad_checkpointing_gives_the_same_bits(cl32, tmp_path_factory):
    """Per-block checkpointing recomputes each block's forward in the
    backward: the loss and every gradient equal bit for bit; a model built
    with ``grad_checkpointing`` checkpoints both towers."""
    _, model = cl32
    images, texts = _batch(4)
    plain = _port_loss_and_grads(model, images, texts)
    set_grad_checkpointing(model, True)
    try:
        remat = _port_loss_and_grads(model, images, texts)
    finally:
        set_grad_checkpointing(model, False)
    assert torch.equal(plain[0], remat[0])
    assert plain[1].keys() == remat[1].keys()
    for name in plain[1]:
        assert torch.equal(plain[1][name], remat[1][name]), name
    built = factory.create_model("toy-clipa-cl32", device="cpu",
                                 grad_checkpointing=True)
    assert built.visual.transformer.grad_checkpointing
    assert built.text.transformer.grad_checkpointing


# -- (e) patch dropout ----------------------------------------------------------

@pytest.mark.parametrize("n,prob", [(64, 0.5), (64, 0.25), (10, 0.99),
                                    (37, 0.5)])
def test_patch_dropout_keeps_token_zero_and_the_top_k(n, prob):
    x = torch.arange(2 * (n + 1) * 3, dtype=torch.float32).reshape(2, n + 1, 3)
    out = patch_dropout(x, torch.Generator().manual_seed(7), prob)
    again = patch_dropout(x, torch.Generator().manual_seed(7), prob)
    keep = max(1, int(n * (1.0 - prob)))
    assert out.shape == (2, 1 + keep, 3)
    assert torch.equal(out, again)  # seeded
    assert torch.equal(out[:, 0], x[:, 0])  # the first token, always
    # the kept rows are the top-k of the generator's normal scores, in
    # top-k order, as jax.lax.top_k orders them
    scores = torch.randn((2, n), generator=torch.Generator().manual_seed(7))
    idx = scores.topk(keep, dim=1).indices
    for i in range(2):
        assert torch.equal(out[i, 1:], x[i, 1:][idx[i]])
    assert torch.equal(patch_dropout(x, None, 0.0), x)


def test_patch_dropout_runs_in_training_only(cl32, tmp_path_factory):
    """``--force-patch-dropout``: training forwards (a generator) see
    1 + max(1, int(64 * 0.5)) tokens, eval forwards all 65."""
    _, model = cl32
    dropped = factory.create_model("toy-clipa-cl32", device="cpu",
                                   force_patch_dropout=0.5)
    dropped.load_state_dict(model.state_dict())
    images = torch.from_numpy(_batch(5)[0])
    with torch.inference_mode():
        _, tokens = dropped.encode_image(images,
                                         generator=torch.Generator())
        _, eval_tokens = dropped.encode_image(images)
    assert tokens.shape[1] == 33 and eval_tokens.shape[1] == 65


# -- unported flags name existing ROADMAP items --------------------------------

def _queue1_items():
    text = (ROOT / "ROADMAP.md").read_text()
    section = text.split("### Queue 1", 1)[1].split("\n### ", 1)[0]
    return {int(m) for m in re.findall(r"^(\d+)\. ", section, re.M)}


def test_unported_messages_name_existing_roadmap_items():
    args = parse_args(["--siglip", "--distill-model", "RN50", "--fsdp",
                       "--remote-sync", "s3://x", "--pretrained",
                       "laion2b_s32b_b79k", "--model", "coca_ViT-B-32",
                       "--model-parallel", "2"])
    # --model coca_* (CoCa's slice), --siglip and --distill-model (SigLIP's
    # and distillation's), --remote-sync and named --pretrained tags
    # (item 9's slice), --fsdp (item 7's) and --model-parallel over
    # ResidualAttentionBlock towers (item 10's) are ported: nothing is
    # left for coca_ViT-B-32; --model-parallel with a timm tower (SigLIP's
    # ViT) is item 11's
    assert unported(args) == []
    timm = parse_args(["--model", "ViT-B-16-SigLIP", "--siglip",
                       "--model-parallel", "2"])
    messages = unported(timm)
    assert len(messages) == 1 and messages[0].startswith("--model-parallel")
    assert "Queue 1 item 11" in messages[0]
    items = _queue1_items()
    for msg in messages:
        named = [int(n) for n in re.findall(r"Queue 1 item (\d+)", msg)]
        assert named and set(named) <= items, msg
    # what this slice ported is no longer refused
    ported = parse_args(["--image-mean", "0.5", "0.5", "0.5", "--image-std",
                         "0.5", "0.5", "0.5", "--torchscript", "--trace",
                         "--grad-checkpointing", "--model", "ViT-B-32"])
    assert unported(ported) == []
    coca = parse_args(["--model", "coca_ViT-L-14", "--coca-caption-loss-"
                       "weight", "1", "--coca-contrastive-loss-weight", "0"])
    assert unported(coca) == []
    siglip = parse_args(["--model", "ViT-B-16-SigLIP", "--siglip",
                         "--loss-dist-impl", "bidir", "--distill-model",
                         "ViT-L-14", "--precision", "pure_bf16"])
    assert unported(siglip) == []


# -- (g) the CLI's two stages (tests/test_clipa_path.py, in the port) --------

CLIPAH = dict(
    embed_dim=64,
    vision_cfg=dict(layers=4, width=64, head_width=32, patch_size=8,
                    image_size=128, pool_type="avg",
                    final_ln_after_pool=True),
    text_cfg=dict(context_length=32, vocab_size=49408, width=64, heads=2,
                  layers=2, pool_type="last", no_causal_mask=True),
)
BASE, BIG = 128, 192  # grids 16 -> 24, the ViT-H/14 224 -> 336 transition
IMAGENET = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.fixture
def cli_logging():
    yield
    close_logging()


def test_cli_two_stage_resolution_change(tmp_path, tmp_path_factory,
                                         cli_logging):
    _register(tmp_path_factory, "torch-clipah", CLIPAH)
    logs = str(tmp_path / "logs")
    common = ["--model", "torch-clipah", "--dataset-type", "synthetic",
              "--train-num-samples", "16", "--batch-size", "4", "--epochs",
              "1", "--warmup", "1", "--precision", "fp32", "--workers", "1",
              "--device", "cpu", "--logs", logs]
    stage_a = port_main.main([
        *common, "--lr", "1e-4", "--force-image-size", str(BASE),
        "--grad-checkpointing", "--local-loss", "--gather-with-grad",
        "--name", "stageA", "--val-frequency", "0"])
    ckpt = tmp_path / "logs" / "stageA" / "checkpoints" / "epoch_1"
    assert ckpt.is_dir()
    assert stage_a["state"].model.visual.transformer.grad_checkpointing
    assert np.isfinite(stage_a["epochs"][0]["train"]["loss"])

    stage_b = port_main.main([
        *common, "--lr", "1e-5", "--pretrained", str(ckpt),
        "--force-image-size", str(BIG), "--image-resize-mode", "squash",
        "--image-interpolation", "bilinear",
        "--image-mean", *map(str, IMAGENET[0]),
        "--image-std", *map(str, IMAGENET[1]),
        "--val-data", "synthetic", "--val-num-samples", "8",
        "--name", "stageB", "--val-frequency", "1"])
    assert (tmp_path / "logs" / "stageB" / "checkpoints" / "epoch_1").is_dir()
    model = stage_b["state"].model
    assert tuple(model.preprocess_cfg["mean"]) == IMAGENET[0]
    assert model.preprocess_cfg["resize_mode"] == "squash"
    assert model.visual.positional_embedding.shape[0] == (BIG // 8) ** 2 + 1
    metrics = stage_b["epochs"][0]["eval"]
    assert metrics["num_samples"] == 16 and np.isfinite(
        metrics["clip_val_loss"])
    assert "image_to_text_R@1" in metrics
    results = (tmp_path / "logs" / "stageB" / "results.jsonl").read_text()
    assert json.loads(results.splitlines()[-1])["epoch"] == 1

    # the load under --force-image-size 1.5x resizes the vision table as
    # JAX does, and the stage-A table is what it resized
    fresh = factory.create_model("torch-clipah", device="cpu",
                                 vision_cfg={"image_size": BIG})
    factory.load_checkpoint(fresh, str(ckpt))
    src = stage_a["state"].model.visual.positional_embedding
    np.testing.assert_allclose(
        _np(fresh.visual.positional_embedding),
        resize_vision_pos_embed(_np(src), (BIG // 8, BIG // 8)), atol=1e-6)


def test_cli_accum_freq_lock_and_resume_latest(tmp_path, tmp_path_factory,
                                               cli_logging):
    """cli.main's accumulation step under --lock-image, then --resume
    latest: the second call restores the epoch-1 state and runs epoch 2
    only; the locked vision stem keeps its values."""
    cfg = dict(CLIPAH, vision_cfg={**CLIPAH["vision_cfg"], "layers": 1,
                                   "image_size": 32},
               text_cfg={**CLIPAH["text_cfg"], "layers": 1})
    _register(tmp_path_factory, "torch-clipah-accum", cfg)
    common = ["--model", "torch-clipah-accum", "--dataset-type", "synthetic",
              "--train-num-samples", "8", "--batch-size", "4", "--precision",
              "fp32", "--workers", "1", "--device", "cpu", "--logs",
              str(tmp_path), "--name", "acc", "--val-frequency", "0",
              "--lock-image", "--lock-image-unlocked-groups", "1"]
    first = port_main.main([*common, "--epochs", "1", "--accum-freq", "2"])
    model = first["state"].model
    init = factory.create_model("torch-clipah-accum", device="cpu")
    assert torch.equal(model.visual.conv1.kernel, init.visual.conv1.kernel)
    assert not torch.equal(model.text.positional_embedding,
                           init.text.positional_embedding)
    assert np.isfinite(first["epochs"][0]["train"]["loss"])
    second = port_main.main([*common, "--epochs", "2", "--resume", "latest"])
    assert [e["epoch"] for e in second["epochs"]] == [2]
    assert (tmp_path / "acc" / "checkpoints" / "epoch_2").is_dir()


def test_main_other_add_learnable_tokens(tmp_path, tmp_path_factory,
                                         cli_logging):
    """--add-learnable-tokens (ViT-B-32-learnable's option) trains through
    the XTag CLI."""
    _register(tmp_path_factory, "torch-clipah-lt", CLIPAH)
    out = main_other.main([
        "--model", "torch-clipah-lt", "--add-learnable-tokens",
        "--n-learnable-tokens", "2", "--dataset-type", "synthetic",
        "--train-num-samples", "8", "--batch-size", "4", "--epochs", "1",
        "--precision", "fp32", "--workers", "1", "--device", "cpu",
        "--logs", str(tmp_path), "--name", "lt", "--val-frequency", "0"])
    model = out["state"].model
    assert tuple(model.visual.learnable_tokens.shape) == (2, 64)
    assert np.isfinite(out["epochs"][0]["train"]["loss"])


# -- (h) evaluate: the port's CLI against JAX's on one .pt ---------------------

def _val_csv(root: Path, n: int = 8) -> str:
    from PIL import Image

    rng = np.random.default_rng(11)
    words = ["red", "small", "dog", "cat", "tree", "house", "blue", "car",
             "on", "grass", "near", "water"]
    rows = ["filepath\ttitle"]
    for i in range(n):
        path = root / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
                        ).save(path)
        caption = " ".join(rng.choice(words, 5))
        rows.append(f"{path}\t{caption}")
    csv = root / "val.csv"
    csv.write_text("\n".join(rows) + "\n")
    return str(csv)


def test_evaluate_metrics_match_jax_cli(cl32, tmp_path, cli_logging,
                                       monkeypatch):
    """Eval-only (no train data): JAX's CLI and the port's on one
    JAX-exported ``.pt`` and one val CSV give the same metrics. The port's
    run also takes ``--torchscript``, which hands the built model to
    convert/serving.py's save_serving (recorded here; the artifact itself
    is held to the live model by tests/test_torch_serving.py)."""
    from xtagclip_tpu_torch.convert import serving

    saved = []
    monkeypatch.setattr(serving, "save_serving", lambda model, out_dir,
                        model_name="": saved.append((model, out_dir,
                                                     model_name))
                        or {"entries": {}})
    bundle, _ = cl32
    pt = str(tmp_path / "init.pt")
    save_open_clip_checkpoint(bundle, pt)
    csv = _val_csv(tmp_path)
    args = ["--model", "toy-clipa-cl32", "--pretrained", pt, "--val-data",
            csv, "--dataset-type", "csv", "--batch-size", "4",
            "--precision", "fp32", "--workers", "1", "--logs",
            str(tmp_path / "logs")]
    # JAX's setup_logging adds root handlers and sets every logger's level:
    # both are put back
    root = logging.getLogger()
    handlers = list(root.handlers)
    levels = {name: logging.getLogger(name).level
              for name in [None, *root.manager.loggerDict]}
    try:
        jax_main.main([*args, "--name", "jax"])
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                root.removeHandler(h)
                h.close()
        for name, level in levels.items():
            logging.getLogger(name).setLevel(level)
    port = port_main.main([*args, "--name", "port", "--device", "cpu",
                           "--torchscript"])
    assert len(saved) == 1 and saved[0][2] == "toy-clipa-cl32"
    assert saved[0][1] == str(tmp_path / "logs" / "port" / "checkpoints"
                              / "serving")

    def last(name):
        text = (tmp_path / "logs" / name / "results.jsonl").read_text()
        return json.loads(text.splitlines()[-1])

    want = last("jax")
    assert port == last("port")
    assert port.keys() == want.keys() and port["num_samples"] == 8
    for key, value in want.items():
        np.testing.assert_allclose(port[key], value, **TOL, err_msg=key)


# -- (i) a multi-process launch joins the process group ---------------------

WORLD_VARS = ("WORLD_SIZE", "PMI_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")
LAUNCH_VARS = WORLD_VARS + (
    "LOCAL_RANK", "MPI_LOCALRANKID", "SLURM_LOCALID",
    "OMPI_COMM_WORLD_LOCAL_RANK", "RANK", "PMI_RANK", "SLURM_PROCID",
    "OMPI_COMM_WORLD_RANK", "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
    "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def clean_launch_env(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


class _Built(Exception):
    """Raised where a CLI would build its model."""


def _stop_at_model(monkeypatch):
    def stop(*args, **kwargs):
        raise _Built

    for module in (port_main, main_other):
        monkeypatch.setattr(module, "create_model_and_transforms", stop)


RANK_OF = {"WORLD_SIZE": "RANK", "PMI_SIZE": "PMI_RANK",
           "SLURM_NTASKS": "SLURM_PROCID",
           "OMPI_COMM_WORLD_SIZE": "OMPI_COMM_WORLD_RANK"}


@pytest.mark.parametrize("cli", ["main", "main_other", "main_other_simple"])
@pytest.mark.parametrize("var", WORLD_VARS)
def test_multi_process_launch_joins_the_process_group(clean_launch_env,
                                                      tmp_path, cli, var):
    """WORLD_SIZE (or PMI_SIZE, SLURM_NTASKS, OMPI_COMM_WORLD_SIZE) = 2
    with that family's rank makes every train CLI join the process group
    (gloo on the CPU, the coordinator's init method, the family's rank and
    world size) before it builds its model."""
    from xtagclip_tpu_torch.cli import main_other_simple
    from xtagclip_tpu_torch.core import mesh

    entry = {"main": port_main.main, "main_other": main_other.main,
             "main_other_simple": main_other_simple.main}[cli]
    _stop_at_model(clean_launch_env)
    calls = []
    clean_launch_env.setattr(mesh.dist, "init_process_group",
                             lambda *a, **k: calls.append((a, k)))
    argv = ["--model", "ViT-B-32", "--dataset-type", "synthetic",
            "--train-num-samples", "8", "--batch-size", "4", "--device",
            "cpu", "--logs", str(tmp_path), "--name", "run"]
    clean_launch_env.setenv(var, "2")
    clean_launch_env.setenv(RANK_OF[var], "1")
    clean_launch_env.setenv("MASTER_ADDR", "10.0.0.1")
    clean_launch_env.setenv("MASTER_PORT", "1357")
    with pytest.raises(_Built):
        entry(argv)
    assert len(calls) == 1
    args, kwargs = calls[0]
    assert args == ("gloo",)
    assert kwargs["init_method"] == "tcp://10.0.0.1:1357"
    assert (kwargs["rank"], kwargs["world_size"]) == (1, 2)


@pytest.mark.parametrize("family", [
    {"LOCAL_RANK": "1", "RANK": "3", "WORLD_SIZE": "8"},
    {"MPI_LOCALRANKID": "1", "PMI_RANK": "3", "PMI_SIZE": "8"},
    {"SLURM_LOCALID": "1", "SLURM_PROCID": "3", "SLURM_NTASKS": "8"},
    {"OMPI_COMM_WORLD_LOCAL_RANK": "1", "OMPI_COMM_WORLD_RANK": "3",
     "OMPI_COMM_WORLD_SIZE": "8"},
    {"RANK": "2", "WORLD_SIZE": "4", "SLURM_PROCID": "7",
     "SLURM_NTASKS": "16", "SLURM_LOCALID": "5"},
    {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1357"},
    {"JAX_COORDINATOR_ADDRESS": "10.0.0.2:999", "MASTER_ADDR": "10.0.0.1"},
    {}])
def test_world_info_matches_jax(clean_launch_env, family):
    from xtagclip_tpu.core import mesh as jax_mesh
    from xtagclip_tpu_torch.core import mesh

    for key, value in family.items():
        clean_launch_env.setenv(key, value)
    assert mesh.world_info_from_env() == jax_mesh.world_info_from_env()
    assert mesh.coordinator_from_env() == jax_mesh.coordinator_from_env()


# -- (j) the 336 px BigVision evaluation script through cli.main --------------

def _bert_vocab(root: Path) -> str:
    """A WordPiece vocab.txt with BERT's special ids ([PAD] 0, [UNK] 100,
    [CLS] 101, [SEP] 102) and the words of the ImageNet prompts' first
    letters, so the templates tokenize to pieces and [UNK]s."""
    root.mkdir(parents=True)
    tokens = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
              + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "photo", "of",
                 "the", "itap", "."] + [chr(c) for c in range(97, 123)]
              + ["##" + chr(c) for c in range(97, 123)])
    (root / "vocab.txt").write_text("\n".join(tokens) + "\n")
    (root / "tokenizer_config.json").write_text('{"do_lower_case": true}')
    return str(root)


def _imagenet_folder(root: Path, classes=3, per_class=2) -> str:
    from PIL import Image

    rng = np.random.default_rng(12)
    for c in range(classes):
        (root / f"n{c:08d}").mkdir(parents=True)
        for i in range(per_class):
            Image.fromarray(rng.integers(0, 256, (20, 28, 3), dtype=np.uint8)
                            ).save(root / f"n{c:08d}" / f"img{i}.png")
    return str(root)


def test_bigvision_eval_script_matches_jax_cli(tmp_path, tmp_path_factory,
                                               cli_logging):
    """scripts/clipav2_vit_h14_i84_224_336_cl32_gap_datacomp1b.sh's flags
    at toy geometry (the BigVision layout: a class token, text without a
    causal mask or projection bias, a BERT WordPiece tokenizer with
    strip_sep_token): --pretrained a big_vision .npz whose 4 x 4 table is
    resized to 6 x 6 by --force-image-size 24, squash, bilinear, ImageNet
    mean/std, --imagenet-val an image folder. The port's cli.main and
    JAX's give the same zero-shot metrics within 1e-3 (fp32)."""
    from test_big_vision_convert import _make_npz

    vocab = _bert_vocab(tmp_path / "bert")
    cfg = dict(
        embed_dim=24,
        vision_cfg=dict(layers=2, width=32, head_width=8, patch_size=4,
                        image_size=16, mlp_ratio=2.0, pool_type="avg",
                        final_ln_after_pool=True),
        text_cfg=dict(context_length=16, vocab_size=200, width=32, heads=4,
                      layers=3, mlp_ratio=2.0, hf_tokenizer_name=vocab,
                      tokenizer_kwargs={"strip_sep_token": True},
                      pool_type="last", no_causal_mask=True))
    _register(tmp_path_factory, "torch-bv-eval", cfg)
    npz, w = _make_npz(tmp_path)
    w = dict(w)
    w["txt/Embed_0/embedding"] = np.random.default_rng(1).standard_normal(
        (200, 32)).astype(np.float32)
    np.savez(npz, **w)
    args = ["--model", "torch-bv-eval", "--pretrained", npz,
            "--force-image-size", "24", "--image-resize-mode", "squash",
            "--image-interpolation", "bilinear",
            "--image-mean", *map(str, IMAGENET[0]),
            "--image-std", *map(str, IMAGENET[1]), "--seed", "0",
            "--imagenet-val", _imagenet_folder(tmp_path / "val"),
            "--batch-size", "4", "--precision", "fp32", "--workers", "1",
            "--logs", str(tmp_path / "logs")]
    root = logging.getLogger()
    handlers = list(root.handlers)
    levels = {name: logging.getLogger(name).level
              for name in [None, *root.manager.loggerDict]}
    try:
        jax_main.main([*args, "--name", "jax"])
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                root.removeHandler(h)
                h.close()
        for name, level in levels.items():
            logging.getLogger(name).setLevel(level)
    port = port_main.main([*args, "--name", "port", "--device", "cpu"])

    def last(name):
        text = (tmp_path / "logs" / name / "results.jsonl").read_text()
        return json.loads(text.splitlines()[-1])

    want = last("jax")
    assert port == last("port")
    assert sorted(port) == sorted(want)
    assert {"imagenet-val-top1", "imagenet-val-top5"} <= set(port)
    for key, value in want.items():
        np.testing.assert_allclose(port[key], value, **TOL, err_msg=key)
