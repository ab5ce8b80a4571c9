"""The port's registry sweep: every built-in config builds, the zoo's
towers have their published sizes, and one config of each tower family
has JAX's parameter names, shapes and ``pure_bf16`` dtypes.

Every config is built on the ``meta`` device (no memory, no init), as
tests/test_registry_sweep.py sweeps JAX's through ``jax.eval_shape``. The
sizes are the published image-tower sizes that test pins, at its
tolerances. One config per family (EVA-02, EVA-01, ViTamin, ConvNeXt,
Swin, FastViT, mT5, NLLB) is compared with JAX's ``eval_shape`` tree
through convert/from_jax.py's ``port_name``; its BatchNorm statistics too.
The LiT lock groups of a toy EVA-02 and a toy ConvNeXt tower equal JAX's
leaf for leaf. Every config's towers split at ``--model-parallel`` 2 and
4, a head count 4 does not divide in uneven whole heads.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from xtagclip_tpu.factory import create_model as jax_create_model
from xtagclip_tpu.models import convnext as jconvnext
from xtagclip_tpu.models import eva as jeva
from xtagclip_tpu.models import timm_vit as jtimm
from xtagclip_tpu.train import train_state as jts
from xtagclip_tpu_torch import factory
from xtagclip_tpu_torch.convert.from_jax import _flatten, port_name, stats_buffers
from xtagclip_tpu_torch.models import convnext, eva, timm_vit
from xtagclip_tpu_torch.parallel import sharding
from xtagclip_tpu_torch.train import train_state as ts

sys.path.insert(0, os.path.dirname(__file__))
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

BUILTIN = factory.list_builtin_models()


def test_registry_holds_the_117_builtin_configs():
    assert len(BUILTIN) == 117


@pytest.mark.parametrize("name", BUILTIN)
def test_every_builtin_config_builds_on_meta(name):
    model = factory.create_model(name, device="meta", skip_init=True)
    assert all(p.device.type == "meta" for p in model.parameters())


# the towers with a block --model-parallel 4 replicates whole, by config:
# none. A head count 4 does not divide (ViT-B-16-plus's 14 and 10, ViT-S's
# 6, RN50x4's text 10) splits into uneven whole heads (4, 4, 3, 3; 3, 3,
# 2, 2; 2, 2, 1, 1), as JAX's GSPMD rule runs them; only a block with
# fewer heads than the model size is replicated (Swin's first stage, 4
# heads, at 8). At 2 every config splits every block.
REPLICATED_AT_4 = {}


@pytest.mark.parametrize("name", BUILTIN)
def test_every_builtin_config_splits_at_model_parallel_2_and_4(name):
    """parallel/sharding.py's ``replicated_blocks`` on each tower of the
    config's meta build: every block splits at --model-parallel 2, and at
    4 every block of every tower but those of ``REPLICATED_AT_4`` (none),
    which would stay whole on each rank."""
    model = _meta(name)
    replicated = set()
    for tower in ("visual", "text"):
        assert sharding.replicated_blocks(getattr(model, tower), 2) == []
        if sharding.replicated_blocks(getattr(model, tower), 4):
            replicated.add(tower)
    assert replicated == REPLICATED_AT_4.get(name, set())


@functools.lru_cache(maxsize=None)
def _meta(name, precision="fp32"):
    return factory.create_model(name, precision=precision, device="meta",
                                skip_init=True)


def _vision_params_m(model):
    return sum(p.numel() for n, p in model.named_parameters()
               if n.startswith("visual.")) / 1e6


@pytest.mark.parametrize("name,expected_m,tol", [
    # tests/test_registry_sweep.py:70-90: published image-tower sizes
    ("EVA02-B-16", 86, 0.05),
    ("EVA02-L-14", 304, 0.05),
    ("EVA01-g-14", 1013, 0.05),
    ("ViTamin-S", 22, 0.10),
    ("ViTamin-B", 87, 0.10),
    ("swin_base_patch4_window7_224", 88, 0.05),
    ("MobileCLIP-S1", 21.5, 0.10),
    ("MobileCLIP-S2", 35.7, 0.10),
    ("vit_medium_patch16_gap_256", 39, 0.05),
])
def test_trunk_family_param_counts(name, expected_m, tol):
    got = _vision_params_m(_meta(name))
    assert abs(got - expected_m) / expected_m < tol, (name, got)


@functools.lru_cache(maxsize=None)
def _jax_shapes(name, precision="fp32"):
    bundle = jax_create_model(name, precision=precision, skip_init=True)
    cfg = bundle.model_cfg
    side = cfg["vision_cfg"].get("image_size", 224)
    ctx = cfg["text_cfg"].get("context_length", 77)
    return jax.eval_shape(lambda: bundle.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)),
        text=jnp.zeros((1, ctx), jnp.int32)))


FAMILIES = ["EVA02-B-16", "EVA01-g-14", "ViTamin-S", "convnext_base_w",
            "swin_base_patch4_window7_224", "MobileCLIP-S1",
            "mt5-base-ViT-B-32", "nllb-clip-base"]


def _port_tree(tree):
    return {port_name(k): v for k, v in _flatten(tree)}


@pytest.mark.parametrize("name", FAMILIES)
def test_family_matches_jax_parameter_names_and_shapes(name):
    variables = _jax_shapes(name)
    model = _meta(name)
    ours = {n: tuple(p.shape) for n, p in model.named_parameters()}
    theirs = {n: tuple(v.shape) for n, v in _port_tree(
        variables["params"]).items()}
    assert set(ours) == set(theirs)
    for n, t in theirs.items():
        assert ours[n] == (t if len(t) != 4 else (t[3], t[2], t[0], t[1])), n
    stats = {n: tuple(b.shape) for n, b in stats_buffers(model).items()}
    assert stats == {n: tuple(v.shape) for n, v in _port_tree(
        variables.get("batch_stats", {})).items()}


@pytest.mark.parametrize("name", ["EVA02-B-16", "MobileCLIP-S1",
                                  "mt5-base-ViT-B-32"])
def test_pure_bf16_dtypes_match_jax(name):
    """``pure_bf16`` makes every parameter bf16 but the LayerNorms', as
    JAX's param_dtype does; T5's RMSNorm scale is bf16 there too
    (models/t5.py takes JAX's ``param_dtype`` for it)."""
    theirs = {n: v.dtype for n, v in _port_tree(
        _jax_shapes(name, "pure_bf16")["params"]).items()}
    ours = {n: p.dtype for n, p in _meta(name, "pure_bf16").named_parameters()}
    assert set(ours) == set(theirs)
    for n, dt in theirs.items():
        want = torch.float32 if dt == jnp.float32 else torch.bfloat16
        assert ours[n] == want, n


# -- the LiT lock groups ---------------------------------------------------

def _toy_towers():
    """(JAX module, port module) pairs of a toy EVA-02 and a toy ConvNeXt
    visual tower."""
    kw = dict(patch_size=8, width=64, layers=3, heads=1, mlp_hidden=96,
              swiglu=True, scale_mlp=True, qkv_fused=False, use_rope=True)
    yield (jtimm.TimmModel(embed_dim=32, width=64, pool="token", proj=None,
                           trunk=jeva.EvaTrunk(name="trunk", **kw)),
           timm_vit.TimmModel(eva.EvaTrunk(image_size=32, **kw), 64, 32,
                              pool="token", proj=None))
    yield (jconvnext.ConvNeXtModel(embed_dim=32, depths=(1, 2), dims=(8, 16)),
           convnext.ConvNeXtModel(32, (1, 2), (8, 16)))


@pytest.mark.parametrize("tower", [0, 1], ids=["eva02", "convnext"])
@pytest.mark.parametrize("groups", [0, 2])
def test_lock_image_groups_equal_jax(tower, groups):
    jmodel, model = list(_toy_towers())[tower]
    params = {"visual": jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"]}
    want = jts.trainable_mask(params, lock_image=True,
                              lock_image_unlocked_groups=groups)
    want = {port_name(".".join(str(getattr(k, "key", k)) for k in path)): v
            for path, v in jax.tree_util.tree_leaves_with_path(want)}
    holder = torch.nn.Module()
    holder.visual = model
    got = ts.trainable_mask(dict(holder.named_parameters()), lock_image=True,
                            lock_image_unlocked_groups=groups)
    assert got == want
    assert any(got.values()) == (groups > 0)
