"""The port's timm ViT tower (models/timm_vit.py) and its converters
(convert/timm_convert.py, convert/timm_families.py) against the JAX
package on the CPU.

Each ``TimmModel`` variant is built at toy geometry in JAX, its params are
carried by convert/from_jax.py, and both run in fp32 on the same seeded
images: class token with the cls and the avg pool (linear and mlp heads),
the cls-free GAP trunk with ``fc_norm``, the relative-position bias, the
conv stem, and SigLIP's MAP pool with the trunk's own head. The
converters run on a seeded timm state dict (chip_smoke.py's BiomedCLIP
writer at toy geometry, plus fc_norm and attn_pool keys).

Bars: fp32 outputs within 1e-3 (BASELINE.md:18); converted trees exactly.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtagclip_tpu.convert import timm_convert as jconvert
from xtagclip_tpu.models import timm_vit as jtimm
from xtagclip_tpu_torch.convert import timm_convert, timm_families
from xtagclip_tpu_torch.convert.from_jax import _flatten, load_jax_params
from xtagclip_tpu_torch.models import timm_vit

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=1e-3)

# (trunk kwargs, head kwargs, image side)
VARIANTS = {
    "cls_pool_linear": (dict(patch_size=8, width=64, layers=2, heads=4),
                        dict(pool="cls", proj="linear"), 32),
    "avg_pool_mlp": (dict(patch_size=8, width=64, layers=2, heads=4),
                     dict(pool="", proj="mlp", proj_bias=True), 32),
    "gap_fc_norm": (dict(patch_size=8, width=64, layers=2, heads=4,
                         use_cls_token=False, final_norm=False),
                    dict(pool="", proj="linear", fc_norm=True), 32),
    "relpos": (dict(patch_size=8, width=64, layers=2, heads=4,
                    use_abs_pos=False, relpos=True),
               dict(pool="", proj="linear"), 32),
    "conv_stem": (dict(patch_size=16, width=96, layers=2, heads=4,
                       conv_stem=True),
                  dict(pool="", proj="linear"), 64),
    "siglip_map": (dict(patch_size=8, width=64, layers=2, heads=4,
                        mlp_ratio=3.7362, use_cls_token=False),
                   dict(pool="map", proj="none", heads=4,
                        map_mlp_ratio=3.7362), 32),
}


def _pair(trunk_kw, head_kw, side, embed_dim=48):
    rng = np.random.default_rng(len(trunk_kw) + side)
    jtrunk = jtimm.TimmViT(name="trunk", **trunk_kw)
    jmodel = jtimm.TimmModel(embed_dim=embed_dim, width=trunk_kw["width"],
                             trunk=jtrunk, **head_kw)
    x = rng.standard_normal((2, side, side, 3)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # non-trivial values where the init is zeros or ones
    params = jax.tree.map(
        lambda v: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(
            np.float32), params)
    trunk = timm_vit.TimmViT(image_size=side, **trunk_kw)
    model = timm_vit.TimmModel(trunk, trunk_kw["width"], embed_dim,
                               **head_kw)
    load_jax_params(model, params)
    return jmodel, params, model, x


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_timm_model_matches_jax(variant):
    jmodel, params, model, x = _pair(*VARIANTS[variant])
    pooled, tokens = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        params, x)
    with torch.no_grad():
        got_pooled, got_tokens = model(torch.from_numpy(x))
    assert got_tokens.shape == tokens.shape
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled), **TOL)
    np.testing.assert_allclose(got_tokens.numpy(), np.asarray(tokens), **TOL)


@pytest.mark.parametrize("name", [
    "vit_base_patch16_224", "vit_base_patch32_clip_224",
    "vit_large_patch14_clip_336", "vit_medium_patch16_gap_256",
    "vit_relpos_medium_patch16_cls_224", "vit_base_mci_224",
    "vit_base_patch16_siglip_224", "vit_so400m_patch14_siglip_384"])
def test_build_matches_jax_parameter_shapes(name):
    """Every trunk kind builds with JAX's parameter names and shapes
    (on the meta device; conv kernels in torch's layout)."""
    cfg = {"timm_model_name": name, "timm_pool": "", "timm_proj": "linear",
           "image_size": int(name.rsplit("_", 1)[1])}
    if "siglip" in name:
        cfg.update(timm_pool="map", timm_proj="none")
    jmodel = jtimm.build_timm_vision_tower(512, cfg, jnp.float32, jnp.float32)
    side = cfg["image_size"]
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3))))["params"]
    with torch.device("meta"):
        model = timm_vit.build_timm_vision_tower(512, cfg)
    ours = {n: tuple(p.shape) for n, p in model.named_parameters()}
    from xtagclip_tpu_torch.convert.from_jax import port_name

    theirs = {port_name(k): v.shape for k, v in _flatten(shapes)}
    assert set(ours) == set(theirs)
    for n, t in theirs.items():
        assert ours[n] == (t if len(t) != 4 else (t[3], t[2], t[0], t[1])), n


@pytest.mark.parametrize("name", ["convnext_base", "eva02_base_patch14_224",
                                  "vitamin_small_224", "swin_base_patch4_window7_224",
                                  "fastvit_mci1"])
def test_other_timm_families_raise_and_name_item_8(name):
    """The zoo families no longer wait for ROADMAP Queue 1 item 8: each
    builds with JAX's parameter names and shapes, and a variant JAX does
    not know (``eva02_base_patch14_224``) raises as JAX's does."""
    cfg = {"timm_model_name": name, "image_size": 224}
    try:
        jmodel = jtimm.build_timm_vision_tower(512, cfg, jnp.float32,
                                               jnp.float32)
    except NotImplementedError as e:
        with pytest.raises(NotImplementedError, match="unknown EVA variant"):
            timm_vit.build_timm_vision_tower(512, cfg)
        assert "unknown EVA variant" in str(e)
        return
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    with torch.device("meta"):
        model = timm_vit.build_timm_vision_tower(512, cfg)
    from xtagclip_tpu_torch.convert.from_jax import port_name, stats_buffers

    theirs = {port_name(k): v.shape for k, v in _flatten(shapes["params"])}
    ours = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert set(ours) == set(theirs)
    for n, t in theirs.items():
        assert ours[n] == (t if len(t) != 4 else (t[3], t[2], t[0], t[1])), n
    assert set(stats_buffers(model)) == {
        port_name(k) for k, _ in _flatten(shapes.get("batch_stats", {}))}


def _timm_sd():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    rng = np.random.default_rng(5)
    sd = chip_smoke.biomedclip_state_dict(
        rng, width=64, layers=2, patch=8, image_size=32, embed_dim=48,
        vocab=100, hidden=32, text_layers=1, intermediate=64,
        max_positions=40)
    sd = {k: v for k, v in sd.items() if k.startswith("visual.trunk.")}
    sd["visual.trunk.fc_norm.weight"] = np.ones(64, np.float32)
    sd["visual.trunk.fc_norm.bias"] = np.zeros(64, np.float32)
    sd["visual.trunk.attn_pool.latent"] = rng.standard_normal(
        (1, 1, 64)).astype(np.float32)
    for name, out in (("q", 64), ("kv", 128), ("proj", 64)):
        sd[f"visual.trunk.attn_pool.{name}.weight"] = rng.standard_normal(
            (out, 64)).astype(np.float32)
        sd[f"visual.trunk.attn_pool.{name}.bias"] = np.zeros(out, np.float32)
    return sd


def test_timm_converter_matches_jax():
    sd = _timm_sd()
    got = dict(_flatten(timm_convert.convert_timm_vit_state_dict(
        sd, prefix="visual.trunk.")))
    want = dict(_flatten(jconvert.convert_timm_vit_state_dict(
        sd, prefix="visual.trunk.")))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got = dict(_flatten(timm_families.convert_timm_trunk(sd)))
    assert set(got) == set(want)


def test_timm_converter_refuses_unknown_keys():
    sd = _timm_sd()
    sd["visual.trunk.stem.0.weight"] = np.zeros((3, 3, 3, 3), np.float32)
    with pytest.raises(timm_families.UnmappedKeysError, match="stem"):
        timm_families.convert_timm_trunk(sd)


@pytest.mark.parametrize("family,key", [
    ("swin", "layers.0.blocks.0.attn.relative_position_bias_table"),
    ("vitamin", "patch_embed.backbone.stem.conv1.weight"),
    ("eva", "blocks.0.attn.q_proj.weight"),
    ("fastvit", "stem.0.reparam_conv.weight")])
def test_other_trunk_families_raise_and_name_item_8(family, key):
    """The zoo families' keys no longer raise: each is detected as JAX
    detects it and a one-key trunk converts to JAX's tree (the strict
    converters raise alike on what the single key leaves out)."""
    from xtagclip_tpu.convert import timm_families as jfam

    assert timm_families.detect_trunk_family([key]) == \
        jfam.detect_trunk_family([key]) == family
    val = np.arange(2 * 3 * 4 * 4, dtype=np.float32).reshape(2, 3, 4, 4)
    sd = {"visual.trunk." + key: val[0, 0] if family == "swin" else val}
    try:
        want = jfam.convert_timm_trunk(dict(sd))
    except Exception as e:  # noqa: BLE001 - the port must raise alike
        with pytest.raises(type(e)):
            timm_families.convert_timm_trunk(dict(sd))
        return
    got = dict(_flatten(timm_families.convert_timm_trunk(dict(sd))))
    want = dict(_flatten(want))
    assert set(got) == set(want) and got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
