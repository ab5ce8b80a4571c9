"""The port's Swin trunk (models/swin.py) and its converter
(convert/timm_families.py) against the JAX package on the CPU.

A toy Swin whose first stage has a shifted-window block (side 8, window
4, shift 2) and whose second a window as wide as its map (no shift),
under the ``TimmModel`` head, its params carried by convert/from_jax.py.
Bars: fp32 within 1e-3 (the module bar, BASELINE.md:18); converted trees
exactly; the merge-order permutation leaves the forward unchanged (1e-5,
tests/test_timm_family_convert.py's bar).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtagclip_tpu.convert import timm_families as jfam
from xtagclip_tpu.models import swin as jswin
from xtagclip_tpu.models import timm_vit as jtimm
from xtagclip_tpu_torch.convert import timm_families
from xtagclip_tpu_torch.convert.from_jax import load_jax_params
from xtagclip_tpu_torch.models import swin, timm_vit

sys.path.insert(0, os.path.dirname(__file__))
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401
from torch_zoo import loads_through_the_loader, randomize, tree_equal  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)
TRUNK = dict(patch_size=4, embed_dim=16, depths=(2, 2), heads=(2, 4),
             window=4)


@pytest.fixture(scope="module")
def pair():
    jmodel = jtimm.TimmModel(embed_dim=24, width=32, pool="", proj="linear",
                             trunk=jswin.SwinTrunk(name="trunk", **TRUNK))
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    params = randomize(jmodel.init(jax.random.PRNGKey(0),
                                   jnp.asarray(x))["params"], 2)
    model = timm_vit.TimmModel(swin.SwinTrunk(image_size=32, **TRUNK), 32, 24,
                               pool="", proj="linear")
    load_jax_params(model, params)
    return jmodel, params, model, x


def test_swin_tower_matches_jax(pair):
    jmodel, params, model, x = pair
    assert model.trunk.stage0_block1.shift == 2
    assert model.trunk.stage1_block1.shift == 0
    pooled, tokens = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        params, x)
    with torch.no_grad():
        got_pooled, got_tokens = model(torch.from_numpy(x))
    assert got_tokens.shape == tokens.shape == (2, 16, 24)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled), **TOL)
    np.testing.assert_allclose(got_tokens.numpy(), np.asarray(tokens), **TOL)


@pytest.mark.parametrize("hw,window,shift", [(8, 4, 2), (14, 7, 3),
                                             (56, 7, 3)])
def test_window_index_and_shift_mask_match_jax(hw, window, shift):
    np.testing.assert_array_equal(swin._rel_pos_index(window),
                                  jswin._rel_pos_index(window))
    np.testing.assert_array_equal(swin._shift_attn_mask(hw, window, shift),
                                  jswin._shift_attn_mask(hw, window, shift))


def test_swin_roundtrip_and_forward(pair):
    _, params, model, x = pair
    trunk = params["trunk"]
    sd = timm_families.export_swin_sd(trunk)
    tree_equal(sd, jfam.export_swin_sd(trunk))
    assert "layers.0.downsample.reduction.weight" in sd
    assert timm_families.detect_trunk_family(sd) == "swin"
    back = timm_families.convert_swin_sd(sd)
    tree_equal(back, jfam.convert_swin_sd(sd))
    tree_equal(back, trunk)
    # the merge-order permutation must leave the forward invariant
    fresh = swin.SwinTrunk(image_size=32, **TRUNK)
    load_jax_params(fresh, back)
    with torch.no_grad():
        np.testing.assert_allclose(
            fresh(torch.from_numpy(x)).numpy(),
            model.trunk(torch.from_numpy(x)).numpy(), atol=1e-5)


def test_swin_ptloads_through_the_loader(pair, tmp_path):
    _, params, _, _ = pair
    loads_through_the_loader(swin.SwinTrunk(image_size=32, **TRUNK),
                              timm_families.export_swin_sd(params["trunk"]),
                              tmp_path)
