"""The port's FastViT / MobileCLIP trunk (models/fastvit.py) and its
converter (convert/timm_families.py) against the JAX package on the CPU.

A toy FastViT (a RepMixer stage, a downsample, an attention stage with its
conditional position conv, the final grouped conv) under the ``TimmModel``
head with the configs' mean pool and the trunk's own head. Eval form
(running statistics, perturbed) and train form (a generator given: batch
statistics, running ones moved) against JAX's ``deterministic`` True and
False, the latter with ``mutable=["batch_stats"]``. Bars: fp32 within
1e-3 (the module bar, BASELINE.md:18), the moved statistics within 1e-5;
the inference-form round trip at tests/test_timm_family_convert.py's
2e-4 on the forward.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtagclip_tpu.convert import timm_families as jfam
from xtagclip_tpu.models import fastvit as jfastvit
from xtagclip_tpu.models import timm_vit as jtimm
from xtagclip_tpu_torch.convert import timm_families
from xtagclip_tpu_torch.convert.from_jax import (
    _flatten,
    load_jax_params,
    port_name,
    stats_buffers,
)
from xtagclip_tpu_torch.convert.loader import load_checkpoint_into
from xtagclip_tpu_torch.models import fastvit, timm_vit

sys.path.insert(0, os.path.dirname(__file__))
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)
TRUNK = dict(dims=(8, 16), depths=(1, 2))


@pytest.fixture(scope="module")
def pair():
    jmodel = jtimm.TimmModel(embed_dim=24, width=32, pool="avg", proj=None,
                             trunk=jfastvit.FastVitTrunk(name="trunk",
                                                         **TRUNK))
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda v: np.asarray(v) + 0.05 * rng.standard_normal(
        v.shape).astype(np.float32), variables["params"])
    stats = jax.tree.map(lambda v: (np.abs(rng.standard_normal(v.shape))
                                    + 0.5).astype(np.float32),
                         variables["batch_stats"])
    return jmodel, params, stats, x


def _port(params, stats):
    model = timm_vit.TimmModel(fastvit.FastVitTrunk(**TRUNK), 32, 24,
                               pool="avg", proj=None)
    load_jax_params(model, params, stats)
    return model


def test_fastvit_eval_matches_jax(pair):
    jmodel, params, stats, x = pair
    pooled, tokens = jax.jit(lambda p, s, x: jmodel.apply(
        {"params": p, "batch_stats": s}, x, deterministic=True))(
            params, stats, x)
    model = _port(params, stats)
    with torch.no_grad():
        got_pooled, got_tokens = model(torch.from_numpy(x))
    assert got_tokens.shape == tokens.shape == (2, 64, 24)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled), **TOL)
    np.testing.assert_allclose(got_tokens.numpy(), np.asarray(tokens), **TOL)


def test_fastvit_train_matches_jax_and_moves_the_same_statistics(pair):
    jmodel, params, stats, x = pair
    (pooled, tokens), new = jax.jit(lambda p, s, x: jmodel.apply(
        {"params": p, "batch_stats": s}, x, deterministic=False,
        mutable=["batch_stats"]))(params, stats, x)
    model = _port(params, stats)
    with torch.no_grad():
        got_pooled, got_tokens = model(torch.from_numpy(x),
                                       torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled), **TOL)
    np.testing.assert_allclose(got_tokens.numpy(), np.asarray(tokens), **TOL)
    want = {port_name(k): np.asarray(v)
            for k, v in _flatten(new["batch_stats"])}
    got = stats_buffers(model)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_attention_stage_core_is_plain_at_head_dim_32():
    block = fastvit.AttnBlock(64)
    assert block.heads == 2  # head dim 32: not a flash head dim


# -- converters (tests/test_timm_family_convert.py's FastViT cases) --------

def test_fastvit_roundtrip_forward(pair, tmp_path):
    """Export the JAX trunk to the reparameterized timm layout, convert it
    with the port's converter (equal to JAX's), load it through
    convert/loader.py's ``.pt`` path and run the eval forward."""
    jmodel, params, stats, x = pair
    trunk = jfastvit.FastVitTrunk(**TRUNK)
    ref = trunk.apply({"params": params["trunk"],
                       "batch_stats": stats["trunk"]}, x, deterministic=True)
    sd = timm_families.export_fastvit_sd(params["trunk"], stats["trunk"])
    want_sd = jfam.export_fastvit_sd(params["trunk"], stats["trunk"])
    assert set(sd) == set(want_sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], want_sd[k], err_msg=k)
    assert timm_families.detect_trunk_family(sd) == "fastvit"
    back = timm_families.convert_fastvit_sd(sd)
    want = jfam.convert_fastvit_sd(sd)
    got_flat, want_flat = dict(_flatten(back)), dict(_flatten(want))
    assert set(got_flat) == set(want_flat)
    for k in want_flat:
        np.testing.assert_array_equal(got_flat[k], want_flat[k], err_msg=k)
    path = tmp_path / "mobileclip.pt"
    torch.save({f"visual.trunk.{k}": torch.from_numpy(np.asarray(v))
                for k, v in sd.items()}, path)
    holder = torch.nn.Module()
    holder.visual = timm_vit.TimmModel(fastvit.FastVitTrunk(**TRUNK), 32, 24,
                                       pool="avg", proj=None)
    from xtagclip_tpu_torch.factory import init_params

    init_params(holder, torch.Generator().manual_seed(0))
    load_checkpoint_into(holder, str(path))
    with torch.no_grad():
        out = holder.visual.trunk(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_fastvit_train_form_rejected():
    with pytest.raises(timm_families.UnmappedKeysError, match="reparameterize"):
        timm_families.detect_trunk_family(["stem.0.rbr_conv.0.conv.weight"])


def test_dispatcher_routes_by_signature(pair):
    _, params, stats, _ = pair
    sd = {f"visual.trunk.{k}": v for k, v in timm_families.export_fastvit_sd(
        params["trunk"], stats["trunk"]).items()}
    tree = timm_families.convert_timm_trunk(sd)
    assert "__batch_stats__" in tree
    assert set(dict(_flatten(tree))) == set(dict(_flatten(
        jfam.convert_timm_trunk(sd))))


def test_unrecognized_family_raises():
    with pytest.raises(timm_families.UnmappedKeysError, match="unrecognized"):
        timm_families.detect_trunk_family(["stages.0.blocks.0.conv_dw.weight"])
