"""The port's fourth slice against the JAX package, on the CPU: flash
attention (kernel #6, forward and backward), the fused MLP (kernel #4), the
non-fused residual block they serve, and the cls-free GAP XTag model.

The JAX side runs its flash and fused-MLP paths as the JAX package's own
tests run them here: ``XTAG_FLASH_ATTN=1`` and ``XTAG_FUSED_MLP=1`` with
the Pallas kernels in TPU interpret mode (``maybe_fused_mlp`` takes its
plain chain on the CPU; the fused block stays off). The port's wrappers
run their plain versions on CPU tensors, and its autograd Functions their
plain backwards. Inputs come from numpy seeds.

Bars: fp32 against the Pallas kernels 2e-5 (forward) and 5e-5 (gradients),
as tests/test_flash_attn.py; bf16 one bf16 ULP at output scale (atol =
max|ref|/128, rtol = 1e-2), as tests/test_fused_attn_block.py; the whole
GAP model in fp32 within 1e-3 (BASELINE.md:18) with exact tag picks, and
its loss within 1e-5 relative and every gradient within 1e-3 normalized
(tests/test_torch_train.py). Toy geometry: vision width 128, 2 heads of
64, 2 layers, 32 px images with patch 2, so L = 256 (the JAX flash gate
needs L % 128 == 0).
"""

import contextlib
import json
import math
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from scar_fixtures import make_scar_dataset  # noqa: E402

from xtagclip_tpu.factory import add_model_config as jax_add_model_config  # noqa: E402
from xtagclip_tpu.factory import create_model as jax_create_model  # noqa: E402
from xtagclip_tpu.losses import asymmetric_loss as j_asl  # noqa: E402
from xtagclip_tpu.losses import clip_loss as j_clip_loss  # noqa: E402
from xtagclip_tpu.losses import dqncos_loss as j_dqncos  # noqa: E402
from xtagclip_tpu.models.layers import (  # noqa: E402
    ResidualAttentionBlock as JBlock,
)
from xtagclip_tpu.ops import flash_attn as jflash  # noqa: E402
from xtagclip_tpu.ops import fused_mlp as jmlp  # noqa: E402
from xtagclip_tpu.serving import make_xtag_serve_step as jax_serve_step  # noqa: E402
from xtagclip_tpu.serving import precompute_prompt_features as jax_precompute  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.cli import main_other  # noqa: E402
from xtagclip_tpu_torch.convert.from_jax import load_jax_params, port_name  # noqa: E402
from xtagclip_tpu_torch.models.clip import num_combos  # noqa: E402
from xtagclip_tpu_torch.models.layers import (  # noqa: E402
    ResidualAttentionBlock,
    attention,
)
from xtagclip_tpu_torch.models.vit import VisionTransformer  # noqa: E402
from xtagclip_tpu_torch.ops import flash_attn, fused_mlp  # noqa: E402
from xtagclip_tpu_torch.ops import fused_attn_block as fab  # noqa: E402
from xtagclip_tpu_torch.serving import (  # noqa: E402
    make_xtag_serve_step,
    precompute_prompt_features,
)
from xtagclip_tpu_torch.train.logger import close_logging  # noqa: E402
from xtagclip_tpu_torch.train.loop import _model_losses  # noqa: E402

torch.set_num_threads(1)

GAP = dict(pool_type="avg", no_class_token=True)
CFG = dict(
    embed_dim=64,
    fusion_dim=64,
    vision_cfg=dict(layers=2, width=128, head_width=64, patch_size=2,
                    image_size=32, **GAP),
    text_cfg=dict(context_length=16, vocab_size=1024, width=64, heads=2,
                  layers=2),
)
B = 2
TOL = dict(rtol=1e-3, atol=1e-3)


@contextlib.contextmanager
def _jax_flash_paths():
    """JAX's flash attention and fused-MLP paths, Pallas interpreted."""
    from jax.experimental.pallas import tpu as pltpu

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XTAG_FLASH_ATTN", "1")
        mp.setenv("XTAG_FUSED_MLP", "1")
        mp.setenv("XTAG_FUSED_BLOCK", "0")
        with pltpu.force_tpu_interpret_mode():
            yield


def _rng_arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _assert_ulp_bar(out, ref):
    """One bf16 ULP at output scale."""
    out, ref = _np(out), _np(ref)
    np.testing.assert_allclose(out, ref, atol=float(np.abs(ref).max()) / 128,
                               rtol=1e-2)


def _normalized_err(a, r):
    a, r = _np(a), _np(r)
    return float(np.abs(a - r).max()) / max(1.0, float(np.abs(r).max()))


def _to(a, bf16):
    return (jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32),
            torch.from_numpy(a).to(torch.bfloat16 if bf16 else torch.float32))


# -- flash attention (kernel #6) ---------------------------------------------

def _qkv(shape, seed, bf16):
    pairs = [_to(a, bf16) for a in _rng_arrays(seed, shape, shape, shape)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("layout", ["blhd", "bhld"])
@pytest.mark.parametrize("bf16", [False, True])
def test_reference_flash_matches_pallas_flash(layout, bf16):
    """The plain forward against JAX flash_mha (the stock Pallas kernel,
    interpreted): fp32 at 2e-5 under "highest" matmul precision, bf16 at
    one ULP (the kernel rounds unnormalized probabilities)."""
    shape = (1, 128, 2, 64) if layout == "blhd" else (1, 2, 128, 64)
    (jq, jk, jv), (q, k, v) = _qkv(shape, 1 + bf16, bf16)
    with jax.default_matmul_precision("highest"), _jax_flash_paths():
        ref = jflash.flash_mha(jq, jk, jv, layout=layout)
    out = flash_attn.flash_mha(q, k, v, layout=layout)
    assert out.shape == shape and out.dtype == q.dtype
    if bf16:
        _assert_ulp_bar(out, ref)
    else:
        np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_reference_flash_at_ragged_length_matches_plain_attention(bf16):
    """L = 197 (the ViT-B-16 class-token tower): the JAX gate refuses it,
    the port's takes it; its plain version is the model's attention (fp32
    at 1e-6; bf16 at one ULP, for P V there is a bf16 matmul)."""
    (_, _, _), (q, k, v) = _qkv((2, 197, 3, 64), 3, bf16)
    out = flash_attn.reference_flash_mha(q, k, v).reshape(2, 197, 192)
    ref = attention(*(t.reshape(2, 197, 192) for t in (q, k, v)), 3)
    if bf16:
        _assert_ulp_bar(out, ref)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    assert flash_attn.supported(197, 197, None, 64)
    assert flash_attn.supported(257, 257, None, 128)


@pytest.mark.parametrize("bf16", [False, True])
def test_flash_grads_match_pallas_bwd_kernels(bf16):
    """Gradients through ``_FlashMHA`` (on the CPU: the plain backward)
    against jax.vjp through flash_mha (the Pallas dq and dkv kernels,
    interpreted): fp32 at 5e-5, bf16 at one ULP. bf16 runs at the slice's
    L = 256."""
    shape = (1, 256, 2, 64) if bf16 else (1, 128, 2, 64)
    (jq, jk, jv), (q, k, v) = _qkv(shape, 5 + bf16, bf16)
    ct = _rng_arrays(7, shape)[0]
    with jax.default_matmul_precision("highest"), _jax_flash_paths():
        out, vjp = jax.vjp(lambda *a: jflash.flash_mha(*a), jq, jk, jv)
        ref = vjp(jnp.asarray(ct, out.dtype))
    ins = [t.requires_grad_(True) for t in (q, k, v)]
    o = flash_attn.flash_mha(*ins)
    got = torch.autograd.grad(o, ins, torch.from_numpy(ct).to(o.dtype))
    for a, r in zip(got, ref):
        assert a.dtype == q.dtype
        if bf16:
            _assert_ulp_bar(a, r)
        else:
            np.testing.assert_allclose(_np(a), _np(r), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("layout", ["blhd", "bhld"])
def test_flash_plain_bwd_matches_autograd_at_ragged_length(layout):
    """fp32, L = 197: the plain backward the Function runs on the CPU
    against autograd of the plain forward."""
    shape = (2, 197, 2, 64) if layout == "blhd" else (2, 2, 197, 64)
    (_, _, _), (q, k, v) = _qkv(shape, 9, False)
    ct = torch.from_numpy(_rng_arrays(10, shape)[0])
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(flash_attn.flash_mha(*ins, layout=layout), ins,
                              ct)
    ins2 = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(
        flash_attn.reference_flash_mha(*ins2, layout=layout), ins2, ct)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


# -- the fused MLP (kernel #4) -----------------------------------------------

def _mlp_arrays(seed, n=256, d=128, h=512):
    x, w1, b1, w2, b2, ct = _rng_arrays(seed, (n, d), (d, h), h, (h, d), d,
                                        (n, d))
    return x, 0.2 * w1, 0.1 * b1, 0.1 * w2, 0.1 * b2, ct


_MLP_BF16 = (True, True, False, True, False)  # x, w1, b1, w2, b2


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_reference_fused_mlp_matches_pallas_kernel(act):
    """bf16: the plain version against the Pallas kernel (interpreted; its
    gelu is a rational erf, 1.5e-7 from the exact one) at one ULP, and
    against ``maybe_fused_mlp``'s chain at one ULP."""
    *ins, _ = _mlp_arrays(20 + len(act))
    pairs = [_to(a, m) for a, m in zip(ins, _MLP_BF16)]
    j_ins, t_ins = [p[0] for p in pairs], [p[1] for p in pairs]
    with _jax_flash_paths():
        ref = jmlp._fused_mlp_fwd(*j_ins, act)
    chain = jmlp.maybe_fused_mlp(*j_ins, act)
    out = fused_mlp.fused_mlp(*t_ins, act)
    assert out.dtype == torch.bfloat16 and out.shape == (256, 128)
    _assert_ulp_bar(out, ref)
    _assert_ulp_bar(out, chain)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("bf16", [False, True])
def test_fused_mlp_grads_match_jax_vjp(act, bf16):
    """Gradients through ``_FusedMLP`` (its PyTorch backward) against
    jax.vjp of fused_mlp (its ``_bwd``; the forward kernel interpreted):
    fp32 at 1e-4 normalized, bf16 at one ULP."""
    *ins, ct = _mlp_arrays(30 + bf16 + len(act))
    pairs = [_to(a, bf16 and m) for a, m in zip(ins, _MLP_BF16)]
    j_ins = [p[0] for p in pairs]
    t_ins = [p[1].requires_grad_(True) for p in pairs]
    with _jax_flash_paths():
        out, vjp = jax.vjp(lambda *a: jmlp.fused_mlp(*a, act), *j_ins)
        ref = vjp(jnp.asarray(ct, out.dtype))
    y = fused_mlp.fused_mlp(*t_ins, act)
    got = torch.autograd.grad(y, t_ins, torch.from_numpy(ct).to(y.dtype))
    for a, r, t in zip(got, ref, t_ins):
        assert a.dtype == t.dtype
        if bf16:
            _assert_ulp_bar(a, r)
        else:
            assert _normalized_err(a, r) <= 1e-4


def test_fused_mlp_function_matches_autograd_of_plain():
    """fp32: the Function's backward against autograd through the plain
    version (the kernels-off route of a train step)."""
    *ins, ct = _mlp_arrays(35, n=40)
    a = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    b = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    got = torch.autograd.grad(fused_mlp.fused_mlp(*a, "gelu"), a,
                              torch.from_numpy(ct))
    ref = torch.autograd.grad(fused_mlp.reference_fused_mlp(*b, "gelu"), b,
                              torch.from_numpy(ct))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


# -- the non-fused block -----------------------------------------------------

def _block_pair(x, jax_paths):
    """(JAX ResidualAttentionBlock's bf16 output on x, the port's block
    with the same seeded weights) at width 128, 2 heads; ``jax_paths``
    is the context the JAX side runs under."""
    d, h = x.shape[-1], 2
    xb = jnp.asarray(x, jnp.bfloat16)
    # jitted, as the GAP model's JAX side is: an eager call of the
    # interpreted Pallas kernels can deadlock in the interpreter's callbacks
    with jax_paths:
        jblk = JBlock(num_heads=h, dtype=jnp.bfloat16)
        params = jax.jit(jblk.init)(jax.random.PRNGKey(0), xb)["params"]
        rng = np.random.default_rng(41)
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: (1.0 if p[-1].key == "scale" else 0.0)
            + (rng.standard_normal(a.shape) * 0.1).astype(np.float32),
            params)
        ref = jax.jit(jblk.apply)({"params": params}, xb)
    blk = ResidualAttentionBlock(d, h)
    load_jax_params(blk, jax.tree.map(np.asarray, params))
    assert not blk.takes_fused_halves(x.shape)
    return ref, blk


def test_non_fused_block_matches_jax_bf16():
    """One bf16 block at L = 256 off the fused halves: the port's route
    (flash attention and the fused MLP, their plain versions on the CPU)
    against JAX's ResidualAttentionBlock on its non-fused branch with the
    flash and fused-MLP paths on: one ULP at output scale."""
    x = _rng_arrays(40, (B, 256, 128))[0]
    ref, blk = _block_pair(x, _jax_flash_paths())
    with torch.inference_mode():
        out = blk(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    _assert_ulp_bar(out, ref)


@contextlib.contextmanager
def _jax_default_paths():
    """JAX's defaults off a TPU: no XTAG_* variable, so XLA attention and
    the nn.Dense MLP chain (c_fc, the bias add and the activation each
    rounded to bf16)."""
    with pytest.MonkeyPatch.context() as mp:
        for var in [v for v in os.environ if v.startswith("XTAG_")]:
            mp.delenv(var)
        yield


def test_non_fused_block_matches_jax_defaults_bf16():
    """The same block against JAX under its default flags. Measured: max
    abs diff 0.0625 at an output scale of 9.06 (0.88 of max|ref|/128: one
    bf16 ULP, 2^-4 in [8, 16)); the port rounds the MLP hidden once where
    the Dense chain rounds three times, and both land within one ULP. Bar:
    one ULP at output scale."""
    x = _rng_arrays(40, (B, 256, 128))[0]
    ref, blk = _block_pair(x, _jax_default_paths())
    with torch.inference_mode():
        out = blk(torch.from_numpy(x).bfloat16())
    _assert_ulp_bar(out, ref)


@pytest.mark.parametrize("l,masked,fused", [
    (50, False, True),     # ViT-B-32 vision blocks
    (77, True, True),      # text blocks, causal
    (128, False, True),    # the longest stream the fused halves take
    (197, False, False),   # ViT-B-16 at 224 px, class token
    (256, False, False),   # the cls-free GAP tower
])
def test_block_route_is_chosen_by_shape(l, masked, fused, monkeypatch):
    """bf16 streams up to L = 128 keep the fused halves; longer ones take
    flash attention and the fused MLP (counted through spies)."""
    calls = []

    def spy(mod, name):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **k: (
            calls.append(name), real(*a, **k))[1])

    for mod, name in ((fab, "fused_attn_half"), (fab, "fused_mlp_half"),
                      (flash_attn, "flash_mha"), (fused_mlp, "fused_mlp")):
        spy(mod, name)
    blk = ResidualAttentionBlock(128, 2)
    factory.init_params(blk, torch.Generator().manual_seed(l))
    x = torch.from_numpy(_rng_arrays(l, (1, l, 128))[0]).bfloat16()
    mask = (torch.triu(torch.full((l, l), float("-inf")), 1) if masked
            else None)
    with torch.inference_mode():
        out = blk(x, attn_mask=mask)
    assert torch.isfinite(out.float()).all()
    assert blk.takes_fused_halves(x.shape, mask) == fused
    want = (["fused_attn_half", "fused_mlp_half"] if fused
            else ["flash_mha", "fused_mlp"])
    assert calls == want


def test_masked_long_stream_raises_off_the_cpu():
    """A bf16 stream that neither route's kernels take raises on a device
    that is not the CPU (a meta tensor stands in for the card) before
    anything runs; nothing falls back to a plain version."""
    blk = ResidualAttentionBlock(128, 2)
    x = torch.empty((1, 256, 128), dtype=torch.bfloat16, device="meta")
    mask = torch.zeros((256, 256), device="meta")
    with pytest.raises(ValueError, match="neither the fused attention half"):
        blk(x, attn_mask=mask)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attn.flash_mha(x.reshape(1, 256, 2, 64), x.reshape(1, 256, 2, 64),
                             x.reshape(1, 256, 2, 64))


# -- the vision tower's options ---------------------------------------------

def test_no_class_token_needs_avg_pool():
    with pytest.raises(ValueError, match="no_class_token requires"):
        VisionTransformer(image_size=32, patch_size=8, width=64, layers=1,
                          heads=1, no_class_token=True)
    vit = VisionTransformer(image_size=32, patch_size=8, width=64, layers=1,
                            heads=1, **GAP)
    assert not hasattr(vit, "class_embedding")
    assert tuple(vit.positional_embedding.shape) == (16, 64)


@pytest.mark.parametrize("option,value", [
    # at their JAX defaults: accepted
    ("pool_type", "tok"), ("no_class_token", False), ("patch_dropout", 0.0),
    ("attentional_pool", False), ("ls_init_value", None),
    ("pos_embed_type", "learnable"), ("no_ln_pre", False),
    ("final_ln_after_pool", False), ("n_learnable_tokens", 0),
    ("attn_pooler_heads", 8), ("output_tokens", True),
    # set and not ported: raise
    ("attentional_pool", True), ("ls_init_value", 1e-4),
    ("n_learnable_tokens", 2), ("patch_dropout", 0.5), ("no_ln_pre", True),
    ("final_ln_after_pool", True), ("pos_embed_type", "sin_cos_2d"),
])
def test_vision_options_raise_only_when_set_and_unported(option, value):
    kw = dict(image_size=32, patch_size=8, width=64, layers=1, heads=1)
    defaults = {"pool_type": "tok", "no_class_token": False,
                "patch_dropout": 0.0, "attentional_pool": False,
                "ls_init_value": None, "pos_embed_type": "learnable",
                "no_ln_pre": False, "final_ln_after_pool": False,
                "n_learnable_tokens": 0, "attn_pooler_heads": 8,
                "output_tokens": True}
    if value == defaults[option]:
        VisionTransformer(**kw, **{option: value})
    else:
        with pytest.raises(NotImplementedError, match=option):
            VisionTransformer(**kw, **{option: value})


# -- the GAP XTag model, fp32 -----------------------------------------------

@pytest.fixture(scope="module")
def cfg_name(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "torchtinygap.json"
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
def batch_np():
    rng = np.random.default_rng(50)
    images = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    table = rng.integers(1, 1000, (2, 3, num_combos(), 16)).astype(np.int32)
    additional = np.zeros((B, 22), np.float32)
    for off, size in zip((0, 3, 7, 10, 14, 18), (3, 4, 3, 4, 4, 4)):
        additional[np.arange(B), off + rng.integers(0, size, B)] = 1.0
    return dict(images=images, table=table, additional=additional,
                class_ids=np.array([2, 0], np.int32))


@pytest.fixture(scope="module")
def jax_outputs(pair, batch_np):
    """The JAX model's outputs on the batch, flash and fused MLP on (each
    call jitted: the interpreted kernels run far faster compiled)."""
    bundle, _ = pair
    module = bundle.module
    images = jnp.asarray(batch_np["images"])

    def forward(params, images, table, class_ids):
        pooled, tokens = module.apply({"params": params}, images, False,
                                      method=module.encode_image)
        full = module.apply({"params": params}, images, None, table,
                            class_ids, 1, True)
        return pooled, tokens, full

    with jax.default_matmul_precision("highest"), _jax_flash_paths():
        pooled, tokens, full = jax.jit(forward)(
            bundle.params, images, jnp.asarray(batch_np["table"]),
            jnp.asarray(batch_np["class_ids"]))
        table = jax_precompute(bundle, batch_np["table"], template_id=1,
                               batch_size=1024)
        serve = jax_serve_step(bundle, table)(bundle.params, images)
    return dict(pooled=pooled, tokens=tokens, full=full, table=table,
                serve=serve)


def test_gap_model_matches_jax(pair, batch_np, jax_outputs):
    """Image features and all 256 tokens, tag logits and picks, the fusion
    logits both ways, and the serve step."""
    _, model = pair
    images = torch.from_numpy(batch_np["images"])
    assert not hasattr(model.visual, "class_embedding")
    with torch.inference_mode():
        pooled, tokens = model.encode_image(images)
        out = model(images, prompt_table=torch.from_numpy(
            batch_np["table"]).long(), class_ids=torch.from_numpy(
            batch_np["class_ids"]).long(), template_id=1)
    assert tokens.shape == (B, 256, 64)
    np.testing.assert_allclose(_np(pooled), _np(jax_outputs["pooled"]), **TOL)
    np.testing.assert_allclose(_np(tokens), _np(jax_outputs["tokens"]), **TOL)
    full = jax_outputs["full"]
    for key in ("image_features", "text_features", "tag_logits", "i2t_cls",
                "t2i_cls"):
        np.testing.assert_allclose(_np(out[key]), _np(full[key]), **TOL,
                                   err_msg=key)
    np.testing.assert_array_equal(out["tag_indices"].numpy(),
                                  np.asarray(full["tag_indices"]))
    table = precompute_prompt_features(model, batch_np["table"],
                                       template_id=1, batch_size=1000)
    np.testing.assert_allclose(_np(table), _np(jax_outputs["table"]), **TOL)
    feat, tags, logits = make_xtag_serve_step(model, table)(images)
    j_feat, j_tags, j_logits = jax_outputs["serve"]
    np.testing.assert_allclose(_np(logits), _np(j_logits), **TOL)
    np.testing.assert_allclose(_np(feat), _np(j_feat), **TOL)
    np.testing.assert_array_equal(tags.numpy(), np.asarray(j_tags))


def test_gap_loss_and_grads_match_jax(pair, batch_np):
    """The plain step's loss (contrastive + 2 ASL + 2 DQNCOS) and every
    parameter gradient against jax.value_and_grad with flash attention
    (its Pallas backward kernels, interpreted)."""
    bundle, model = pair
    bn = batch_np
    jparams = jax.tree.map(jnp.asarray, bundle.params)

    def j_total(params):
        out = bundle.module.apply(
            {"params": params}, jnp.asarray(bn["images"]),
            prompt_table=jnp.asarray(bn["table"][:1]),
            class_ids=jnp.asarray(bn["class_ids"]), template_id=0,
            deterministic=True)
        total = j_clip_loss(out["image_features"], out["text_features"],
                            out["logit_scale"])
        total = total + 2.0 * j_asl(out["tag_logits"],
                                    jnp.tile(jnp.asarray(bn["additional"]),
                                             (1, 2)), 4, 1, 0.05)
        return total + 2.0 * (j_dqncos(out["i2t_cls"])
                              + j_dqncos(out["t2i_cls"]))

    with jax.default_matmul_precision("highest"), _jax_flash_paths():
        j_val, j_grads = jax.jit(jax.value_and_grad(j_total))(jparams)
    model.zero_grad(set_to_none=True)
    batch = {"images": torch.from_numpy(bn["images"]),
             "class_ids": torch.from_numpy(bn["class_ids"]).long(),
             "additional": torch.from_numpy(bn["additional"])}
    total, _ = _model_losses(model, batch, {}, prompt_table=torch.from_numpy(
        bn["table"][:1]).long(), deterministic=True)
    total.backward()
    assert abs(total.item() - float(j_val)) <= 1e-5 * abs(float(j_val))
    named = dict(model.named_parameters())
    leaves = jax.tree_util.tree_leaves_with_path(j_grads)
    n = 0
    for path, g in leaves:
        name = port_name(".".join(str(getattr(k, "key", k)) for k in path))
        g = np.asarray(g)
        if not np.any(g):
            continue
        assert named[name].grad is not None, name
        assert _normalized_err(named[name].grad, g) <= 1e-3, name
        n += name.startswith("visual.transformer")
    assert n == 2 * 12  # every vision block parameter got its gradient
    model.zero_grad(set_to_none=True)


_CATEGORIES = tuple(zip((0, 3, 7, 10, 14, 18), (3, 4, 3, 4, 4, 4)))


def _category_scores(scores):
    """[B, 22] tag scores -> per category [B, size] in fp32."""
    s = _np(scores)
    return [s[:, off:off + size] for off, size in _CATEGORIES]


def test_gap_serve_matches_jax_defaults_bf16(cfg_name, pair, batch_np):
    """The toy GAP model served in bf16 (the port's cast_for_compute)
    against JAX's bf16 model (precision "bf16", the same fp32 weights)
    under its default flags, on 8 seeded images. Measured: the prompt
    table within 0.0234 at a scale of 3.39 and the image features within
    0.00195 at 0.332 (each under one bf16 ULP at output scale); 45 of 48
    tag picks agree. The 5 images whose six picks all agree have fusion
    logits within 0.0039 at a scale of 0.613 (one ULP, 2^-8 in [0.5, 1)).
    The other 3 gather another prompt, and their logits differ by 0.207,
    0.273 and 0.219.

    Why the 3 picks flip, measured on the per-category tag scores
    sigmoid(l[i]) + sigmoid(l[22 + i]) (bf16 in both frameworks, as
    ``prepare_tag_indices`` forms them): the two frameworks' scores differ
    by at most 0.0078125 on every image (one bf16 ULP, 2^-7 in [1, 2)),
    and the JAX scores' top-2 margins of the flipped picks are 0.0078125
    (image 0, width), 0.0078125 (image 5, color) and 0.015625 (image 3,
    irregular color): one, one and two ULPs. 9 of the 48 picks have a
    margin of two ULPs or less; 6 of them agree. All 39 picks with a wider
    margin agree. So each flip is a near-tie that bf16 rounding decides,
    not a divergence of the port.

    Bars: table and features one ULP at output scale; logits of the images
    whose picks agree one ULP; at least the measured 45 of 48 picks agree;
    (a) every pick that differs has a JAX margin of at most 2 bf16 ULPs at
    the top score's scale (2^-6 for scores in [1, 2)); (b) every pick whose
    margin is above that bound agrees; and each framework's picks are the
    argmax of the scores measured here."""
    bundle, _ = pair
    jb = jax_create_model(cfg_name, precision="bf16", use_tagging=True,
                          use_fusion=True, skip_init=True)
    jb.params = bundle.params
    images = np.random.default_rng(51).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)
    with _jax_default_paths():
        j_table = jax_precompute(jb, batch_np["table"], template_id=1,
                                 batch_size=1024)
        j_feat, j_tags, j_logits = jax_serve_step(jb, j_table)(
            jb.params, jnp.asarray(images))
    model = factory.create_model(cfg_name, device="cpu", precision="bf16",
                                 use_tagging=True, use_fusion=True)
    load_jax_params(model, jax.tree.map(np.asarray, bundle.params))
    factory.cast_for_compute(model, torch.bfloat16)
    table = precompute_prompt_features(model, batch_np["table"],
                                       template_id=1, batch_size=1000)
    feat, tags, logits = make_xtag_serve_step(model, table)(
        torch.from_numpy(images))
    assert logits.dtype == torch.bfloat16
    _assert_ulp_bar(table, j_table)
    _assert_ulp_bar(feat, j_feat)
    agree = tags.numpy() == np.asarray(j_tags)
    assert agree.sum() >= 45
    # the margins behind the picks: per-category tag scores both ways
    def j_tag_scores(params, x):
        def body(m, x):
            logits = m.tag_forward(m.encode_image(x, normalize=True)[1])
            return (jax.nn.sigmoid(logits[:, :22])
                    + jax.nn.sigmoid(logits[:, 22:]))
        return jb.module.apply({"params": params}, x, method=body)

    with _jax_default_paths():
        j_scores = jax.jit(j_tag_scores)(jb.params, jnp.asarray(images))
    with torch.inference_mode():
        logits_t = model.tag_forward(
            model.encode_image(torch.from_numpy(images), normalize=True)[1])
        scores = torch.sigmoid(logits_t[:, :22]) + torch.sigmoid(
            logits_t[:, 22:])
    assert j_scores.dtype == jnp.bfloat16 and scores.dtype == torch.bfloat16
    offsets = np.array([off for off, _ in _CATEGORIES])
    j_cat, p_cat = _category_scores(j_scores), _category_scores(scores)
    np.testing.assert_array_equal(
        np.stack([c.argmax(1) for c in j_cat], 1) + offsets, np.asarray(j_tags))
    np.testing.assert_array_equal(
        np.stack([c.argmax(1) for c in p_cat], 1) + offsets, tags.numpy())
    for c, (js, ps) in enumerate(zip(j_cat, p_cat)):
        top2 = np.sort(js, axis=1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        # 2 bf16 ULPs (8 significant bits) at the top score's scale
        bound = 2.0 ** (np.floor(np.log2(top2[:, 1])) - 6)
        flipped = ~agree[:, c]
        assert (margin[flipped] <= bound[flipped]).all(), (c, margin, bound)   # (a)
        assert agree[margin > bound, c].all(), (c, margin, bound)              # (b)
    same = agree.all(axis=1)
    ref = _np(j_logits)
    np.testing.assert_allclose(_np(logits)[same], ref[same],
                               atol=float(np.abs(ref).max()) / 128, rtol=0)


# -- XTAGCLIP_EXTRA_CONFIGS --------------------------------------------------

CLI_CFG = dict(
    embed_dim=512,
    vision_cfg=dict(layers=1, width=64, head_width=32, patch_size=8,
                    image_size=32),
    text_cfg=dict(context_length=77, vocab_size=49408, width=512, heads=4,
                  layers=1),
)


def test_extra_config_dirs_match_overrides(tmp_path, monkeypatch):
    """A JSON in an XTAGCLIP_EXTRA_CONFIGS directory builds the model that
    the base config with the same vision_cfg overrides builds; a malformed
    file there warns and is skipped."""
    base = tmp_path / "torchgapbase.json"
    base.write_text(json.dumps(CFG | {"vision_cfg": {
        k: v for k, v in CFG["vision_cfg"].items() if k not in GAP}}))
    factory.add_model_config(base)
    user = tmp_path / "user"
    user.mkdir()
    (user / "torchgapuser.json").write_text(json.dumps(CFG))
    (user / "torchgapbroken.json").write_text("{not json")
    monkeypatch.setenv("XTAGCLIP_EXTRA_CONFIGS", f"{tmp_path / 'none'}:{user}")
    a = factory.create_model("torchgapuser", device="cpu", init_seed=4)
    b = factory.create_model("torchgapbase", device="cpu", init_seed=4,
                             vision_cfg=GAP)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() and "visual.class_embedding" not in sa
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert factory.get_model_config("torchgapbroken") is None
    assert any("torchgapbroken" in str(w.message) for w in caught)


def test_main_other_trains_a_config_from_extra_dirs(tmp_path, monkeypatch):
    """``main_other --device cpu`` reaches a cls-free GAP config through
    XTAGCLIP_EXTRA_CONFIGS and trains an epoch of it (2 steps)."""
    user = tmp_path / "cfgs"
    user.mkdir()
    cfg = json.loads(json.dumps(CLI_CFG))
    cfg["vision_cfg"].update(GAP)
    (user / "torchgapcli.json").write_text(json.dumps(cfg))
    monkeypatch.setenv("XTAGCLIP_EXTRA_CONFIGS", str(user))
    root = tmp_path / "scar"
    csv = make_scar_dataset(str(root), n=8, image_size=40)
    try:
        out = main_other.main([
            "--model", "torchgapcli", "--train-data", str(root),
            "--scar-train-csv", csv, "--dataset-type", "csv",
            "--batch-size", "4", "--warmup", "1", "--precision", "fp32",
            "--use-tagging", "--use-fusion", "--epochs", "1",
            "--zeroshot-frequency", "0", "--logs", str(tmp_path / "logs"),
            "--name", "gap", "--workers", "1", "--device", "cpu"])
    finally:
        close_logging()
    assert out["state"].step == 2
    assert math.isfinite(out["epochs"][0]["train"]["loss"])
    assert "visual.class_embedding" not in out["state"].model.state_dict()
