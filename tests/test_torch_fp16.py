"""``--precision pure_fp16`` (and ``fp16``) in the PyTorch port against the
JAX package's, on the CPU.

JAX builds the model in float16 (xtagclip_tpu/factory.py:105-110,
313-314). Its fused halves and fused MLP gate on bf16, so its float16
blocks take the non-fused route, XLA's MLP and, where its flash gate takes
the stream (no mask, L % 128 == 0), the Pallas flash kernel in float16.
The port routes float16 alike (models/layers.py ``ResidualAttentionBlock``):
the non-fused route, flash attention's wrapper (#6; its plain version on
the CPU, its float16 kernels on the card) for the unmasked cores, the
plain attention for the masked text cores, #4's plain version for the
MLPs, and never #1-#4.

The toy is a cls-free GAP vision tower at L = 128 (32 x 16 px images,
patch 2: the flash gate's length) beside a causal text tower, width 128,
2 heads of 64, 2 layers each. JAX's side runs jitted, its attention
through its own plain exact attention, ``layers.dot_product_attention``
(fp32 scores and softmax, P in the value dtype, fp32 accumulation) in
place of ``jax.nn.dot_product_attention``: XLA on the CPU refuses a
float16 dot with fp32 accumulation ('F16_F16_F32') in that call and in
the Pallas flash kernel's interpreter, so JAX's float16 attention runs on
no CPU path of its own. tests/test_torch_flash.py holds the port's flash
attention to the interpreted kernel in fp32 and bf16, and the card to
the plain version in float16 (chip_smoke.py). Bars,
tests/test_torch_public_api.py's ``pure_bf16`` ones (chip_smoke.py's serve and train-path bars): feature
cosine >= 0.999 a row; one train step's loss within 1e-2 and gradient norm
within 2% of JAX's, each nonzero gradient at cosine >= 0.99.
"""

import contextlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from xtagclip_tpu import factory as jfactory  # noqa: E402
from xtagclip_tpu.train import loop as jloop  # noqa: E402
from xtagclip_tpu.train import scheduler as jsched  # noqa: E402
from xtagclip_tpu.train import train_state as jts  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.convert.from_jax import load_jax_params, port_name  # noqa: E402
from xtagclip_tpu_torch.models import layers  # noqa: E402
from xtagclip_tpu_torch.models.layers import LayerNorm  # noqa: E402
from xtagclip_tpu_torch.ops import flash_attn, fused_mlp  # noqa: E402
from xtagclip_tpu_torch.ops import fused_attn_block as fab  # noqa: E402
from xtagclip_tpu_torch.ops import preprocess  # noqa: E402
from xtagclip_tpu_torch.train import scheduler  # noqa: E402
from xtagclip_tpu_torch.train import train_state as ts  # noqa: E402
from xtagclip_tpu_torch.train.loop import make_train_step  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

H, W = 32, 16
CFG = dict(
    embed_dim=64,
    vision_cfg=dict(layers=2, width=128, head_width=64, patch_size=2,
                    image_size=[H, W], pool_type="avg", no_class_token=True),
    text_cfg=dict(context_length=16, vocab_size=1000, width=128, heads=2,
                  layers=2),
)
B = 4
NAME = "torch-purefp16-gap"


@contextlib.contextmanager
def _jax_plain_attention():
    """JAX's attention cores through its own plain exact attention
    (module doc): ``jax.nn.dot_product_attention``'s [B, L, H, dh] call
    mapped onto ``layers.dot_product_attention``'s [B, H, L, dh] one."""
    from xtagclip_tpu.models import layers as jlayers

    def plain(q, k, v, bias=None, **_):
        heads = [t.transpose(0, 2, 1, 3) for t in (q, k, v)]
        out, _ = jlayers.dot_product_attention(*heads, mask=bias)
        return out.transpose(0, 2, 1, 3)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XTAG_FLASH_ATTN", "0")
        mp.setattr(jax.nn, "dot_product_attention", plain)
        yield


@pytest.fixture(scope="module")
def fp16_pair(tmp_path_factory):
    """(JAX pure_fp16 bundle, its float16 weights with non-trivial values,
    the port's pure_fp16 model holding them)."""
    path = tmp_path_factory.mktemp("cfg") / f"{NAME}.json"
    path.write_text(json.dumps(CFG))
    jfactory.add_model_config(str(path))
    factory.add_model_config(path)
    bundle = jfactory.create_model(NAME, precision="pure_fp16")
    rng = np.random.default_rng(37)
    params = jax.tree.map(
        lambda v: jnp.asarray(np.asarray(v, np.float32) + 0.05
                              * rng.standard_normal(v.shape), v.dtype),
        bundle.params)
    model = factory.create_model(NAME, precision="pure_fp16", device="cpu")
    load_jax_params(model, jax.tree.map(lambda v: np.asarray(v, np.float32),
                                        params))
    return bundle, params, model


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, 3)).astype(np.float32),
            rng.integers(1, 1000, (B, 16)).astype(np.int32))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _cosines(a, b):
    a, b = _np(a).reshape(len(a), -1), _np(b).reshape(len(b), -1)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def _flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {port_name(".".join(str(getattr(k, "key", k)) for k in path)):
            np.asarray(v, np.float32) for path, v in leaves}


def test_pure_fp16_dtypes_equal_jax(fp16_pair):
    """float16 parameters but the LayerNorms' (fp32, as JAX's
    ``LayerNorm`` keeps them), leaf for leaf JAX's dtypes."""
    bundle, _, model = fp16_pair
    got = {n: str(p.dtype).split(".")[-1]
           for n, p in model.named_parameters()}
    want = {port_name(".".join(str(k.key) for k in path)):
            jnp.dtype(v.dtype).name
            for path, v in jax.tree_util.tree_leaves_with_path(
                bundle.params)}
    assert got == want
    ln = {n for m_name, m in model.named_modules()
          if isinstance(m, LayerNorm)
          for n in (f"{m_name}.scale", f"{m_name}.bias")}
    assert {n for n, v in got.items() if v == "float32"} == ln
    assert model.dtype == torch.float16
    fp16 = factory.create_model(NAME, precision="fp16", device="cpu")
    assert {p.dtype for p in fp16.parameters()} == {torch.float32}
    assert fp16.dtype == torch.float16


def test_float16_streams_take_flash_and_the_plain_versions(fp16_pair,
                                                           monkeypatch):
    """The dispatch (models/layers.py): a float16 block is ``non_fused``
    (never the fused halves), its unmasked core goes to flash attention's
    wrapper (#6), the causal text core to the plain attention, its MLP to
    #4's plain version; #1-#4's wrappers are never called. A bf16 stream
    of the same shapes keeps its routes."""
    _, _, model = fp16_pair
    vblk = model.visual.transformer.resblocks[0]
    tblk = model.text.transformer.resblocks[0]
    mask = model.text.attn_mask[:16, :16]
    assert vblk.route((B, 128, 128), None, torch.float16) == "non_fused"
    assert tblk.route((B, 16, 128), mask, torch.float16) == "non_fused"
    assert vblk.route((B, 128, 128), None, torch.bfloat16) == "fused_halves"
    assert tblk.route((B, 16, 128), mask, torch.bfloat16) == "fused_halves"
    assert layers.flash_takes(128, None, 64, torch.float16)
    assert not layers.flash_takes(16, mask, 64, torch.float16)
    assert layers.flash_takes(16, mask, 64, torch.bfloat16)
    assert layers.flash_on(True, torch.float16)
    assert not layers.flash_on(True, torch.float32)
    assert flash_attn.takes_dtype(torch.float16, None)
    assert not flash_attn.takes_dtype(torch.float16, mask)
    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    for mod, name in ((flash_attn, "flash_mha"), (fab, "fused_attn_half"),
                      (fab, "fused_mlp_half"), (fused_mlp, "fused_mlp"),
                      (fused_mlp, "reference_fused_mlp"),
                      (layers, "attention")):
        spy(mod, name)
    images, texts = _batch(1)
    with torch.no_grad():
        model(torch.from_numpy(images).half(),
              text=torch.from_numpy(texts).long())
    # 2 vision cores on flash; 2 masked text cores, the tag head's and
    # TQN's on the plain attention; 4 MLPs on #4's plain version
    assert calls.get("flash_mha") == 2
    assert calls.get("reference_fused_mlp") == 4
    assert calls.get("attention", 0) >= 2
    for name in ("fused_attn_half", "fused_mlp_half", "fused_mlp"):
        assert name not in calls, calls


def test_normalize_to_float16_rounds_once():
    """#5's plain version to float16 equals its fp32 output rounded once
    (the kernel route on the card: fp32, then one cast)."""
    u8 = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 8, 8, 3), dtype=np.uint8))
    f16 = preprocess.normalize_images(u8, dtype=torch.float16)
    f32 = preprocess.normalize_images(u8, dtype=torch.float32)
    assert f16.dtype == torch.float16
    assert torch.equal(f16, f32.half())


def test_pure_fp16_forward_matches_jax(fp16_pair):
    """Image and text features against JAX's pure_fp16 forward (jitted)
    at the serve bar: cosine >= 0.999 a row; the logit scale equal."""
    bundle, params, model = fp16_pair
    images, texts = _batch(2)
    with _jax_plain_attention():
        j_out = jax.jit(lambda p, i, t: bundle.module.apply(
            {"params": p}, i, text=t))(params,
                                       jnp.asarray(images, jnp.float16),
                                       texts)
    with torch.no_grad():
        out = model(torch.from_numpy(images).half(),
                    text=torch.from_numpy(texts).long())
    for k in ("image_features", "text_features"):
        assert out[k].dtype == torch.float16, k
        assert np.isfinite(_np(out[k])).all(), k
        assert _cosines(out[k], j_out[k]).min() >= 0.999, k
    assert out["logit_scale"].item() == float(j_out["logit_scale"])


def test_pure_fp16_train_step_matches_jax(fp16_pair):
    """One contrastive step on the float16 parameters against JAX's
    pure_fp16 step (optax AdamW on float16 leaves, lr 1e-3), at the
    train-path bars: loss within 1e-2, gradient norm within 2%, each
    gradient at cosine >= 0.99 with jax.grad of JAX's ``_model_losses``
    where JAX's is nonzero; the parameters keep JAX's dtypes, and most
    move."""
    bundle, params, _ = fp16_pair
    images, texts = _batch(4)
    args = {"use_tagging_loss": False}
    j_batch = {"images": jnp.asarray(images, jnp.float16),
               "texts": jnp.asarray(texts)}
    j_tx = jts.make_optimizer(jsched.const_lr(1e-3, 0, 10), params=params)
    j_step = jloop.make_train_step(bundle.module, j_tx, args, donate=False)
    with _jax_plain_attention():
        _, j_metrics = j_step(jts.create_train_state(params, j_tx), j_batch,
                              jax.random.PRNGKey(0))
        j_grads = _flat(jax.jit(jax.grad(lambda p: jloop._model_losses(
            bundle.module, p, j_batch, {"dropout": jax.random.PRNGKey(0)},
            args, None)[0]))(params))
    model = factory.create_model(NAME, precision="pure_fp16", device="cpu")
    load_jax_params(model, jax.tree.map(lambda v: np.asarray(v, np.float32),
                                        params))
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    state = ts.create_train_state(model, ts.make_optimizer(
        scheduler.const_lr(1e-3, 0, 10), params=named))
    state, metrics = make_train_step(args)(
        state, {"images": torch.from_numpy(images).half(),
                "texts": torch.from_numpy(texts).long()},
        torch.Generator().manual_seed(0))
    for k, rel in (("loss", 1e-2), ("contrastive_loss", 1e-2),
                   ("grad_norm", 2e-2)):
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   rtol=rel, err_msg=k)
    compared = moved = 0
    for n, p in named.items():
        assert p.dtype == before[n].dtype, n
        moved += int(not torch.equal(p, before[n]))
        g = j_grads[n]
        if not np.any(g):
            continue
        compared += 1
        assert p.grad.dtype == p.dtype, n
        assert _cosines(p.grad[None], g[None])[0] >= 0.99, n
    assert compared > len(named) // 2 and moved > len(named) // 2
