"""``train/loop.py::make_multi_step``: K optimizer steps over stacked
[K, B, ...] batches in one call, against K sequential ``make_train_step``
calls (bit for bit, dropout on, one generator drawn in turn) and against
JAX's ``make_multi_step`` (jitted) on tests/test_multi_step.py's toy CLIP
with ``use_tagging_loss`` off and no dropout: the per-step losses within
1e-5 relative and every parameter within 1e-3 of JAX's.
"""

import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtagclip_tpu.factory import add_model_config as jax_add_model_config
from xtagclip_tpu.factory import create_model as jax_create_model
from xtagclip_tpu.train import loop as jloop
from xtagclip_tpu.train import scheduler as jsched
from xtagclip_tpu.train import train_state as jts
from xtagclip_tpu_torch import factory
from xtagclip_tpu_torch.convert.from_jax import (
    load_jax_params,
    port_name,
    port_value,
)
from xtagclip_tpu_torch.train import scheduler
from xtagclip_tpu_torch.train import train_state as ts
from xtagclip_tpu_torch.train.loop import make_multi_step, make_train_step

sys.path.insert(0, os.path.dirname(__file__))
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

K, B = 3, 4
# tests/test_torch_train.py's XTag toy (TQN's dropout 0.1 is on in a step)
XTAG_CFG = dict(
    embed_dim=64, fusion_dim=64,
    vision_cfg=dict(layers=2, width=64, head_width=64, patch_size=8,
                    image_size=32),
    text_cfg=dict(context_length=16, vocab_size=1024, width=64, heads=1,
                  layers=2))
# tests/test_multi_step.py's toy
JAX_CFG = dict(
    embed_dim=64,
    vision_cfg=dict(layers=2, width=64, head_width=32, patch_size=16,
                    image_size=32),
    text_cfg=dict(context_length=8, vocab_size=100, width=64, heads=2,
                  layers=2))


@pytest.fixture(scope="module")
def names(tmp_path_factory):
    d = tmp_path_factory.mktemp("multistep")
    out = {}
    for name, cfg in (("torchtinymultixtag", XTAG_CFG),
                      ("torchtinymulti", JAX_CFG)):
        path = d / f"{name}.json"
        path.write_text(json.dumps(cfg))
        jax_add_model_config(str(path))
        factory.add_model_config(path)
        out[name] = name
    return out


def _xtag_batches(seed=3):
    rng = np.random.default_rng(seed)
    additional = np.zeros((K, B, 22), np.float32)
    for off, size in zip((0, 3, 7, 10, 14, 18), (3, 4, 3, 4, 4, 4)):
        for k in range(K):
            additional[k, np.arange(B), off + rng.integers(0, size, B)] = 1.0
    return {"images": torch.from_numpy(rng.standard_normal(
                (K, B, 32, 32, 3)).astype(np.float32)),
            "texts": torch.from_numpy(rng.integers(1, 1000, (K, B, 16))),
            "additional": torch.from_numpy(additional)}


def _state(model):
    named = dict(model.named_parameters())
    return ts.create_train_state(model, ts.make_optimizer(
        scheduler.cosine_lr(1e-3, 1, 100), weight_decay=0.1, params=named))


def test_multi_step_equals_sequential_steps_bit_for_bit(names):
    """The same state after K steps in one call as after K calls of the
    step, and the same metrics, stacked [K]: each step drew its dropout
    masks from the one generator in turn."""
    model = factory.create_model("torchtinymultixtag", device="cpu",
                                 use_tagging=True, use_fusion=True)
    twin = copy.deepcopy(model)
    batches = _xtag_batches()
    state, metrics = make_multi_step({}, K)(
        _state(model), batches, torch.Generator().manual_seed(7))
    seq, one, gen = _state(twin), make_train_step({}), \
        torch.Generator().manual_seed(7)
    want = []
    for k in range(K):
        seq, m = one(seq, {key: v[k] for key, v in batches.items()}, gen)
        want.append(m)
    assert state.step == seq.step == K
    assert set(metrics) == set(want[0]) == {
        "contrastive_loss", "tagging_loss", "ce_loss", "loss", "logit_scale",
        "grad_norm"}
    for key, v in metrics.items():
        assert v.shape == (K,)
        assert torch.equal(v, torch.stack([m[key] for m in want])), key
    for (n, a), b in zip(model.state_dict().items(),
                         twin.state_dict().values()):
        assert torch.equal(a, b), n
    # dropout was on: a deterministic run of the same steps differs
    other = copy.deepcopy(twin)
    _, det = make_multi_step({}, K, deterministic=True)(
        _state(other), batches, None)
    assert not torch.equal(det["loss"], metrics["loss"])


def test_batches_must_be_stacked(names):
    model = factory.create_model("torchtinymulti", device="cpu")
    rng = np.random.default_rng(0)
    bad = {"images": torch.from_numpy(rng.standard_normal(
        (2, B, 32, 32, 3)).astype(np.float32)),
        "texts": torch.from_numpy(rng.integers(1, 99, (K, B, 8)))}
    with pytest.raises(ValueError, match=r"stacked \[3, \.\.\.\]"):
        make_multi_step({}, K)(_state(model), bad, None)
    with pytest.raises(ValueError, match="num_steps"):
        make_multi_step({}, 0)


def test_multi_step_matches_jax(names):
    """tests/test_multi_step.py's toy CLIP and batches through JAX's
    ``make_multi_step`` (jitted, AdamW on cosine_lr(1e-3, 1, 100)) and the
    port's on the same weights."""
    bundle = jax_create_model("torchtinymulti")
    params = jax.tree.map(np.asarray, bundle.params)
    rng = np.random.default_rng(17)
    images = rng.standard_normal((K, B, 32, 32, 3), dtype=np.float32)
    texts = rng.integers(1, 99, size=(K, B, 8)).astype(np.int32)
    cfg = {"use_tagging_loss": False}

    tx = jts.make_optimizer(jsched.cosine_lr(1e-3, 1, 100), params=params)
    j_state = jts.create_train_state(jax.tree.map(jnp.asarray, params), tx)
    multi = jloop.make_multi_step(bundle.module, tx, cfg, K, donate=False)
    j_state, j_metrics = multi(j_state, {"images": jnp.asarray(images),
                                         "texts": jnp.asarray(texts)},
                               jax.random.PRNGKey(0))

    model = factory.create_model("torchtinymulti", device="cpu")
    load_jax_params(model, params)
    named = dict(model.named_parameters())
    state = ts.create_train_state(model, ts.make_optimizer(
        scheduler.cosine_lr(1e-3, 1, 100), params=named))
    state, metrics = make_multi_step(cfg, K, deterministic=True)(
        state, {"images": torch.from_numpy(images),
                "texts": torch.from_numpy(texts).long()}, None)
    assert state.step == int(j_state.step) == K
    want = np.asarray(j_metrics["loss"])
    got = metrics["loss"].numpy()
    assert want.shape == got.shape == (K,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    leaves = jax.tree_util.tree_leaves_with_path(j_state.params)
    for path, v in leaves:
        name = port_name(".".join(str(getattr(k, "key", k)) for k in path))
        np.testing.assert_allclose(named[name].detach().numpy(),
                                   port_value(np.asarray(v)), rtol=0,
                                   atol=1e-3, err_msg=name)
