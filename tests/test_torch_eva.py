"""The port's EVA trunks (models/eva.py) and their converters
(convert/timm_families.py) against the JAX package on the CPU.

EVA-01 (fused qkv, plain gelu MLP) and EVA-02 (separate q/k/v with a
bias-free k, rope on the patch tokens, SwiGLU with the sub-LN) are built
at toy geometry in JAX, under the ``TimmModel`` head with the ``token``
pool and the trunk's own head (EVA's configs), their params carried by
convert/from_jax.py, and both run on the same seeded images. Head dim 64,
so the port's attention core takes the flash route (its plain version on
the CPU), JAX's its XLA attention.

Bars: fp32 within 1e-3 (the module bar, BASELINE.md:18); the bf16 block
within one bf16 ULP at output scale (tests/test_torch_flash.py); the
converted trees exactly (tests/test_timm_family_convert.py's 1e-6).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtagclip_tpu.convert import timm_families as jfam
from xtagclip_tpu.models import eva as jeva
from xtagclip_tpu.models import timm_vit as jtimm
from xtagclip_tpu_torch.convert import timm_families
from xtagclip_tpu_torch.convert.from_jax import load_jax_params
from xtagclip_tpu_torch.models import eva, timm_vit
from xtagclip_tpu_torch.models.layers import (
    set_grad_checkpointing,
    set_use_kernels,
)
from xtagclip_tpu_torch.ops import flash_attn

sys.path.insert(0, os.path.dirname(__file__))
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401
from torch_zoo import loads_through_the_loader, randomize, tree_equal  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)
EMBED = 48
# toy EVA-01 and EVA-02 trunks at head dim 64 (2 heads of width 128)
TRUNKS = {
    "eva01": dict(patch_size=8, width=128, layers=2, heads=2, mlp_hidden=192,
                  qkv_fused=True),
    "eva02": dict(patch_size=8, width=128, layers=2, heads=2,
                  mlp_hidden=int(128 * 4 * 2 / 3), swiglu=True,
                  scale_mlp=True, qkv_fused=False, use_rope=True),
}
SIDE = 32


def _images(seed, b=2, side=SIDE):
    return np.random.default_rng(seed).standard_normal(
        (b, side, side, 3)).astype(np.float32)


def _pair(kind, dtype=torch.float32):
    kw = TRUNKS[kind]
    jmodel = jtimm.TimmModel(embed_dim=EMBED, width=kw["width"], pool="token",
                             proj=None, trunk=jeva.EvaTrunk(name="trunk", **kw))
    x = _images(1)
    params = randomize(jmodel.init(jax.random.PRNGKey(0),
                                   jnp.asarray(x))["params"], 2)
    model = timm_vit.TimmModel(eva.EvaTrunk(image_size=SIDE, dtype=dtype,
                                            **kw),
                               kw["width"], EMBED, pool="token", proj=None)
    load_jax_params(model, params)
    return jmodel, params, model, x


@pytest.mark.parametrize("kind", sorted(TRUNKS))
def test_eva_tower_matches_jax(kind):
    jmodel, params, model, x = _pair(kind)
    pooled, tokens = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        params, x)
    with torch.no_grad():
        got_pooled, got_tokens = model(torch.from_numpy(x))
    assert got_tokens.shape == tokens.shape == (2, 17, EMBED)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled), **TOL)
    np.testing.assert_allclose(got_tokens.numpy(), np.asarray(tokens), **TOL)


def test_rope_tables_and_rotation_match_jax():
    cos, sin = eva.axial_rope_tables(3, 5, 64)
    jcos, jsin = jeva.axial_rope_tables(3, 5, 64)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    x = np.random.default_rng(3).standard_normal((2, 15, 2, 64)).astype(
        np.float32)
    got = eva.apply_rope(torch.from_numpy(x), torch.from_numpy(cos),
                         torch.from_numpy(sin))
    want = jeva.apply_rope(jnp.asarray(x), jnp.asarray(jcos),
                           jnp.asarray(jsin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_eva02_block_matches_jax_bf16():
    """One bf16 EVA-02 block at L = 17 (rope, SwiGLU, sub-LN), its core the
    plain flash attention, against JAX's bf16 block (XLA attention): one
    bf16 ULP at output scale."""
    kw = TRUNKS["eva02"]
    jblock = jeva.EvaBlock(width=128, num_heads=2, mlp_hidden=kw["mlp_hidden"],
                           swiglu=True, scale_mlp=True, qkv_fused=False,
                           dtype=jnp.bfloat16)
    cos, sin = eva.axial_rope_tables(4, 4, 64)
    x = np.random.default_rng(4).standard_normal((2, 17, 128)).astype(
        np.float32)
    rope = (jnp.asarray(cos), jnp.asarray(sin))
    params = randomize(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   rope=rope)["params"], 5)
    ref = jax.jit(lambda p, x: jblock.apply({"params": p}, x, rope=rope))(
        params, jnp.asarray(x, jnp.bfloat16))
    block = eva.EvaBlock(128, 2, kw["mlp_hidden"], swiglu=True,
                         scale_mlp=True, qkv_fused=False)
    load_jax_params(block, params)
    with torch.no_grad():
        out = block(torch.from_numpy(x).bfloat16(),
                    (torch.from_numpy(cos), torch.from_numpy(sin)))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref,
                               atol=float(np.abs(ref).max()) / 128, rtol=1e-2)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_attention_core_takes_the_flash_route(use_kernels, monkeypatch):
    """A bf16 stream calls ``flash_mha`` (the kernel's wrapper, which runs
    its plain version on the CPU) in each block with the kernels on, and
    ``reference_flash_mha`` alone with them off."""
    calls = []
    for name in ("flash_mha", "reference_flash_mha"):
        real = getattr(flash_attn, name)
        monkeypatch.setattr(flash_attn, name, lambda *a, _n=name, _r=real, **k: (
            calls.append(_n), _r(*a, **k))[1])
    _, _, model, x = _pair("eva02", torch.bfloat16)
    set_use_kernels(model, use_kernels)
    with torch.no_grad():
        model(torch.from_numpy(x))
    assert calls.count("flash_mha") == (2 if use_kernels else 0)
    assert calls.count("reference_flash_mha") == 2


def test_grad_checkpointing_reaches_the_blocks_and_keeps_the_grads():
    _, _, model, x = _pair("eva02")
    grads = []
    for on in (False, True):
        set_grad_checkpointing(model, on)
        assert model.trunk.grad_checkpointing is on
        model.zero_grad()
        model(torch.from_numpy(x))[0].square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


# -- converters (tests/test_timm_family_convert.py's EVA cases) ------------


@pytest.mark.parametrize("fused", [True, False], ids=["eva01", "eva02"])
def test_eva_roundtrip(fused):
    trunk = jeva.EvaTrunk(patch_size=8, width=64, layers=2, heads=4,
                          mlp_hidden=86 if not fused else 128,
                          swiglu=not fused, scale_mlp=not fused,
                          qkv_fused=fused, use_rope=not fused)
    params = randomize(trunk.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 32, 32, 3)))["params"], 0)
    sd = timm_families.export_eva_sd(params, qkv_fused=fused)
    want_sd = jfam.export_eva_sd(params, qkv_fused=fused)
    tree_equal(sd, want_sd)
    assert ("blocks.0.attn.k_proj.bias" in sd) is False
    assert timm_families.detect_trunk_family(sd) == "eva"
    tree_equal(timm_families.convert_eva_sd(sd), jfam.convert_eva_sd(sd))
    prefixed = {f"visual.trunk.{k}": v for k, v in sd.items()}
    tree_equal(timm_families.convert_timm_trunk(prefixed),
                jfam.convert_timm_trunk(prefixed))


def test_eva_unknown_keys_raise():
    trunk = jeva.EvaTrunk(patch_size=8, width=32, layers=1, heads=2,
                          mlp_hidden=64)
    params = trunk.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 16, 16, 3)))["params"]
    sd = timm_families.export_eva_sd(params, qkv_fused=True)
    sd["blocks.0.gamma_1"] = np.ones(32, np.float32)
    with pytest.raises(timm_families.UnmappedKeysError, match="gamma_1"):
        timm_families.convert_eva_sd(sd)


@pytest.mark.parametrize("fused", [True, False], ids=["eva01", "eva02"])
def test_eva_ptloads_through_the_loader(fused, tmp_path):
    kw = dict(patch_size=8, width=64, layers=2, heads=4,
              mlp_hidden=86 if not fused else 128, swiglu=not fused,
              scale_mlp=not fused, qkv_fused=fused, use_rope=not fused)
    params = randomize(jeva.EvaTrunk(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"], 1)
    loads_through_the_loader(eva.EvaTrunk(image_size=32, **kw),
                              timm_families.export_eva_sd(params, fused),
                              tmp_path)
