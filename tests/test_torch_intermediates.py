"""``forward_intermediates`` and ``feature_take_indices`` in the PyTorch
port against the JAX package's (xtagclip_tpu/models/clip.py:166-230,
vit.py:187-270, text.py:70-177, layers.py:64-80), on the CPU.

Two toys on the same weights (``load_jax_params``), fp32: a class-token
ViT with a text tower (tests/test_intermediates.py's geometry: 3 blocks
each, width 64, patch 8, 32 px), and a cls-free GAP tower (NCHW without a
prefix). Every option is held to JAX's output (jitted) within 1e-3
(BASELINE.md:18), key for key; the final features equal ``encode_image``
/ ``encode_text`` bit for bit; the port raises where JAX raises.
"""

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
from xtagclip_tpu.models.layers import (  # noqa: E402
    feature_take_indices as j_take,
)
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.convert.from_jax import load_jax_params  # noqa: E402
from xtagclip_tpu_torch.models.layers import feature_take_indices  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

TEXT = dict(context_length=16, vocab_size=1000, width=64, heads=4, layers=3)
CFGS = {
    "torch-int-cls": dict(embed_dim=64, vision_cfg=dict(
        layers=3, width=64, head_width=32, patch_size=8, image_size=32),
        text_cfg=TEXT),
    "torch-int-gap": dict(embed_dim=64, vision_cfg=dict(
        layers=3, width=64, head_width=32, patch_size=8, image_size=32,
        pool_type="avg", no_class_token=True), text_cfg=TEXT),
    "torch-int-tokens": dict(embed_dim=64, vision_cfg=dict(
        layers=2, width=64, head_width=32, patch_size=8, image_size=32,
        n_learnable_tokens=2), text_cfg=TEXT),
    "torch-int-attnpool": dict(embed_dim=64, vision_cfg=dict(
        layers=2, width=64, head_width=32, patch_size=8, image_size=32,
        attentional_pool=True, attn_pooler_queries=4, attn_pooler_heads=2),
        text_cfg=TEXT),
    "torch-int-seqpool": dict(embed_dim=64, vision_cfg=dict(
        layers=2, width=64, head_width=32, patch_size=8, image_size=32,
        pool_type="none"), text_cfg=TEXT),
}
B = 2
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """{name: (JAX bundle, port model on its weights)} of every toy."""
    d = tmp_path_factory.mktemp("cfg")
    out = {}
    for name, cfg in CFGS.items():
        path = d / f"{name}.json"
        path.write_text(json.dumps(cfg))
        jfactory.add_model_config(str(path))
        factory.add_model_config(path)
        bundle = jfactory.create_model(name, init_seed=3)
        model = factory.create_model(name, device="cpu")
        load_jax_params(model, jax.tree.map(np.asarray, bundle.params))
        out[name] = (bundle, model.eval())
    return out


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            rng.integers(1, 999, (B, 16)).astype(np.int32))


def _jax(bundle, image, text, **kw):
    def run(params, image, text):
        return bundle.module.apply(
            {"params": params}, image=image, text=text,
            method=bundle.module.forward_intermediates, **kw)

    return jax.jit(run)(bundle.params,
                        None if image is None else jnp.asarray(image),
                        None if text is None else jnp.asarray(text))


def _port(model, image, text, **kw):
    with torch.no_grad():
        return model.forward_intermediates(
            image=None if image is None else torch.from_numpy(image),
            text=None if text is None else torch.from_numpy(text).long(),
            **kw)


def _assert_same(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, v in want.items():
        g = got[k]
        if isinstance(v, list):
            assert len(g) == len(v), k
            for i, (a, b) in enumerate(zip(g, v)):
                assert tuple(a.shape) == tuple(b.shape), (k, i)
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                           err_msg=f"{k}[{i}]")
        else:
            assert tuple(g.shape) == tuple(v.shape), k
            np.testing.assert_allclose(g.numpy(), np.asarray(v), **TOL,
                                       err_msg=k)


OPTIONS = {
    "defaults": dict(),
    "last_n_nlc_extra_normalized": dict(
        image_indices=2, text_indices=[0, -1], image_output_fmt="NLC",
        image_output_extra_tokens=True, text_output_extra_tokens=True,
        normalize_intermediates=True),
    "list_nchw_extra_unnormalized": dict(
        image_indices=[-1, 0], text_indices=1, normalize=False,
        image_output_extra_tokens=True),
    "intermediates_only": dict(image_indices=[1], text_indices=2,
                               intermediates_only=True, output_logits=True),
    "logits_scale_bias": dict(output_logits=True,
                              output_logit_scale_bias=True,
                              image_indices=1, text_indices=1),
}


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("name", ["torch-int-cls", "torch-int-gap"])
def test_forward_intermediates_matches_jax(pairs, name, option):
    bundle, model = pairs[name]
    image, text = _inputs()
    kw = OPTIONS[option]
    _assert_same(_port(model, image, text, **kw),
                 _jax(bundle, image, text, **kw))


@pytest.mark.parametrize("tower", ["image", "text"])
def test_one_tower_alone_matches_jax(pairs, tower):
    bundle, model = pairs["torch-int-cls"]
    image, text = _inputs(6)
    args = (image, None) if tower == "image" else (None, text)
    _assert_same(_port(model, *args, output_logit_scale_bias=True),
                 _jax(bundle, *args, output_logit_scale_bias=True))


@pytest.mark.parametrize("name", ["torch-int-cls", "torch-int-gap",
                                  "torch-int-seqpool"])
def test_final_features_equal_encode(pairs, name):
    """The final features are those of ``encode_image`` /
    ``encode_text`` (normalized or not) bit for bit: the same blocks and
    routes compute them."""
    _, model = pairs[name]
    image, text = _inputs(7)
    for normalize in (True, False):
        out = _port(model, image, text, normalize=normalize)
        with torch.no_grad():
            img, _ = model.encode_image(torch.from_numpy(image),
                                        normalize=normalize)
            txt, _ = model.encode_text(torch.from_numpy(text).long(),
                                       normalize=normalize)
        assert torch.equal(out["image_features"], img)
        assert torch.equal(out["text_features"], txt)


def test_gap_nchw_has_no_prefix(pairs):
    """The cls-free tower's NCHW grid is all its tokens, and its prefix
    holds none."""
    _, model = pairs["torch-int-gap"]
    image, _ = _inputs()
    out = _port(model, image, None, image_output_extra_tokens=True)
    assert out["image_intermediates"][0].shape == (B, 64, 4, 4)
    assert out["image_intermediates_prefix"][0].shape == (B, 0, 64)


def test_sequence_pool_matches_jax(pairs):
    """A vision ``pool_type`` other than tok / avg: the token sequence is
    the pooled output, [B, L, output_dim], as JAX's (vit.py:226-235)."""
    bundle, model = pairs["torch-int-seqpool"]
    image, _ = _inputs(8)
    j_pooled, j_tokens = jax.jit(lambda p, i: bundle.module.apply(
        {"params": p}, i, method=bundle.module.encode_image))(
            bundle.params, jnp.asarray(image))
    with torch.no_grad():
        pooled, tokens = model.encode_image(torch.from_numpy(image))
    assert pooled.shape == (B, 17, 64)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(j_pooled), **TOL)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(j_tokens), **TOL)


def test_raises_where_jax_raises(pairs):
    """An attentional-pool tower (NotImplementedError in both), NCHW with
    learnable tokens and logits without both inputs (JAX's assertions,
    ValueError here)."""
    image, text = _inputs()
    bundle, model = pairs["torch-int-attnpool"]
    with pytest.raises(NotImplementedError, match="attentional_pool"):
        _jax(bundle, image, None)
    with pytest.raises(NotImplementedError, match="attentional_pool"):
        _port(model, image, None)
    bundle, model = pairs["torch-int-tokens"]
    with pytest.raises(AssertionError, match="pure spatial"):
        _jax(bundle, image, None, image_output_fmt="NCHW")
    with pytest.raises(ValueError, match="pure spatial"):
        _port(model, image, None, image_output_fmt="NCHW")
    _assert_same(_port(model, image, None, image_output_fmt="NLC"),
                 _jax(bundle, image, None, image_output_fmt="NLC"))
    bundle, model = pairs["torch-int-cls"]
    with pytest.raises(AssertionError, match="both image and text"):
        _jax(bundle, image, None, output_logits=True)
    with pytest.raises(ValueError, match="both image and text"):
        _port(model, image, None, output_logits=True)
    with pytest.raises(ValueError, match="out of range"):
        _port(model, image, None, image_indices=4)


@pytest.mark.parametrize("n,indices", [
    (12, None), (12, 3), (12, 12), (12, [0, -1]), (3, [-3, 2, 0]), (1, 1)])
def test_feature_take_indices_matches_jax(n, indices):
    assert feature_take_indices(n, indices) == j_take(n, indices)


@pytest.mark.parametrize("n,indices", [(12, 13), (12, 0), (12, [12]),
                                       (12, [-13])])
def test_feature_take_indices_raises_where_jax_raises(n, indices):
    with pytest.raises(AssertionError):
        j_take(n, indices)
    with pytest.raises(ValueError, match="out of range"):
        feature_take_indices(n, indices)
