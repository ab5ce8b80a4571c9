"""The port's ViTamin trunk (models/vitamin.py) and its converter
(convert/timm_families.py) against the JAX package on the CPU.

A toy ViTamin (MbConv-LN stem and stages, GeGLU ViT blocks at head dim 64,
so the port's core takes the flash route, its plain version here) under
the ``TimmModel`` head with the configs' mean pool and linear projection,
its params carried by convert/from_jax.py. Bars: fp32 within 1e-3 (the
module bar, BASELINE.md:18); converted trees exactly.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtagclip_tpu.convert import timm_families as jfam
from xtagclip_tpu.models import timm_vit as jtimm
from xtagclip_tpu.models import vitamin as jvitamin
from xtagclip_tpu_torch.convert import timm_families
from xtagclip_tpu_torch.convert.from_jax import load_jax_params
from xtagclip_tpu_torch.models import timm_vit, vitamin

sys.path.insert(0, os.path.dirname(__file__))
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401
from torch_zoo import loads_through_the_loader, randomize, tree_equal  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)
TRUNK = dict(conv_channels=(8, 16), conv_depths=(1, 2), width=128, depth=2,
             heads=2)
SIDE = 64


@pytest.fixture(scope="module")
def pair():
    jmodel = jtimm.TimmModel(embed_dim=48, width=128, pool="", proj="linear",
                             trunk=jvitamin.ViTaminTrunk(name="trunk",
                                                         **TRUNK))
    x = np.random.default_rng(1).standard_normal(
        (2, SIDE, SIDE, 3)).astype(np.float32)
    params = randomize(jmodel.init(jax.random.PRNGKey(0),
                                   jnp.asarray(x))["params"], 2)
    model = timm_vit.TimmModel(vitamin.ViTaminTrunk(image_size=SIDE, **TRUNK),
                               128, 48, pool="", proj="linear")
    load_jax_params(model, params)
    return jmodel, params, model, x


def test_vitamin_tower_matches_jax(pair):
    jmodel, params, model, x = pair
    pooled, tokens = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        params, x)
    with torch.no_grad():
        got_pooled, got_tokens = model(torch.from_numpy(x))
    assert got_tokens.shape == tokens.shape == (2, 16, 48)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled), **TOL)
    np.testing.assert_allclose(got_tokens.numpy(), np.asarray(tokens), **TOL)


def test_mbconv_stem_and_stages_match_jax(pair):
    """The conv half alone (stem, the strided and the residual MbConv-LN
    blocks), NHWC in JAX against NCHW here."""
    _, params, model, x = pair
    p = params["trunk"]
    conv = jvitamin.MbConvLN(channels=16, stride=1)
    h = np.random.default_rng(6).standard_normal((2, 8, 8, 16)).astype(
        np.float32)
    want = conv.apply({"params": p["stage2_1"]}, jnp.asarray(h))
    with torch.no_grad():
        got = model.trunk.stage2_1(torch.from_numpy(h).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)


def test_train_mode_forward_is_deterministic_given_the_generator(pair):
    """The configs' timm_drop_path (0.1) is applied by neither package:
    a train-mode forward (a generator given) draws nothing and equals the
    eval forward bit for bit, whatever the seed."""
    _, _, model, x = pair
    with torch.no_grad():
        outs = [model(torch.from_numpy(x), g)[0] for g in (
            None, torch.Generator().manual_seed(0),
            torch.Generator().manual_seed(1))]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("name", ["vitamin_small_224", "vitamin_base_256",
                                  "vitamin_large2_384", "vitamin_xlarge_256",
                                  "vitamin_huge_224"])
def test_vitamin_config_matches_jax(name):
    try:
        want = jvitamin.vitamin_config(name)
    except NotImplementedError:
        with pytest.raises(NotImplementedError, match="unknown ViTamin"):
            vitamin.vitamin_config(name)
        return
    assert vitamin.vitamin_config(name) == want


# -- converters (tests/test_timm_family_convert.py's ViTamin cases) --------

def _jax_vitamin_params(depths):
    trunk = jvitamin.ViTaminTrunk(conv_channels=(8, 16), conv_depths=depths,
                                  width=32, depth=len(depths), heads=2)
    return randomize(trunk.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3)))["params"], 0)


def test_vitamin_roundtrip():
    params = _jax_vitamin_params((1, 2))
    sd = timm_families.export_vitamin_sd(params)
    tree_equal(sd, jfam.export_vitamin_sd(params))
    assert "patch_embed.backbone.stages.1.blocks.1.conv2_kxk.weight" in sd
    assert timm_families.detect_trunk_family(sd) == "vitamin"
    back = timm_families.convert_vitamin_sd(sd)
    tree_equal(back, jfam.convert_vitamin_sd(sd))
    tree_equal(back, params)


def test_vitamin_accepts_w012_alias():
    params = _jax_vitamin_params((1, 1))
    aliased = {
        k.replace("mlp.fc1_g", "mlp.w0").replace("mlp.fc1_x", "mlp.w1")
         .replace("mlp.fc2", "mlp.w2"): v
        for k, v in timm_families.export_vitamin_sd(params).items()}
    back = timm_families.convert_vitamin_sd(aliased)
    tree_equal(back, jfam.convert_vitamin_sd(aliased))
    tree_equal(back, params)


def test_causal_text_at_head_dim_72_takes_the_plain_core_on_the_card():
    """ViTamin-XL's text tower (27 x 1152, 16 heads of 72, causal): no
    kernel of either package takes a masked stream at head dim 72 (JAX
    sends it to XLA), so its core is the plain attention off the CPU too
    and the block reaches the MLP kernel's wrapper (meta stands in for the
    card and raises there); a masked stream at head dim 64, which JAX's
    fused half takes, still raises."""
    from xtagclip_tpu_torch.models.layers import ResidualAttentionBlock
    from xtagclip_tpu_torch.models.text import build_causal_mask

    with torch.device("meta"):
        blk = ResidualAttentionBlock(1152, 16)
    x = torch.empty((2, 77, 1152), dtype=torch.bfloat16, device="meta")
    assert blk.route(x.shape, build_causal_mask(77, "meta")) == "non_fused"
    with pytest.raises(ValueError, match="no kernel for device meta"):
        blk(x, attn_mask=build_causal_mask(77, "meta"))
    with torch.device("meta"):
        blk = ResidualAttentionBlock(256, 4)
    x = torch.empty((1, 256, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="neither the fused attention half"):
        blk(x, attn_mask=torch.zeros((256, 256), device="meta"))


def test_vitamin_ptloads_through_the_loader(tmp_path):
    params = _jax_vitamin_params((1, 2))
    trunk = vitamin.ViTaminTrunk(conv_channels=(8, 16), conv_depths=(1, 2),
                                 width=32, depth=2, heads=2, image_size=32)
    loads_through_the_loader(trunk, timm_families.export_vitamin_sd(params),
                              tmp_path)
