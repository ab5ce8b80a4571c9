"""The port's ResNets and their BatchNorm against the JAX package on the
CPU: models/layers.py ``BatchNorm`` against flax's ``nn.BatchNorm`` (and
``torch.nn.BatchNorm2d``'s different running variance), the standard
ResNet of the ResNet-50 baseline (models/standard_resnet.py) in train and
eval mode with its new running statistics, the CLIP ModifiedResNet
(models/resnet.py, tests/test_towers.py's geometry) and the torchvision
converter, on the same seeded inputs and weights (convert/from_jax.py
carries JAX's params and batch_stats).

Bars: fp32 outputs, and a tower's new running statistics, within 1e-3
(the repo's parity bar, BASELINE.md:18; deep in a tower the statistics
carry the forward's rounding, ~1e-5); one BatchNorm's running statistics
within 1e-6; converted trees exactly.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from xtagclip_tpu.models import resnet as jresnet
from xtagclip_tpu.models import standard_resnet as jstd
from xtagclip_tpu_torch.convert.from_jax import (
    _flatten,
    load_jax_params,
    port_name,
    stats_buffers,
)
from xtagclip_tpu_torch.models import resnet, standard_resnet
from xtagclip_tpu_torch.models.layers import BatchNorm
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke():
    """chip_smoke.py, whose seeded stand-in writers the tests share."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


TOL = dict(rtol=1e-3, atol=1e-3)
STATS_TOL = dict(rtol=1e-6, atol=1e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_stats_equal_jax(model, jax_stats, **tol):
    ours = stats_buffers(model)
    theirs = {port_name(k): v for k, v in _flatten(_np(jax_stats))}
    assert set(ours) == set(theirs)
    for name, buf in ours.items():
        np.testing.assert_allclose(buf.numpy(), theirs[name], **tol,
                                   err_msg=name)


# -- BatchNorm ---------------------------------------------------------------

@pytest.fixture(scope="module")
def bn_batch():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((4, 3, 3, 2)) * 1.3 + 0.4).astype(np.float32)


def _flax_bn_step(x):
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x)
    y, new = bn.apply(variables, x, mutable=["batch_stats"])
    return np.asarray(y), _np(new["batch_stats"])


def test_batchnorm_train_step_matches_flax(bn_batch):
    y_jax, stats = _flax_bn_step(jnp.asarray(bn_batch))
    bn = BatchNorm(2)
    x = torch.from_numpy(bn_batch).permute(0, 3, 1, 2)  # NHWC -> NCHW
    y = bn(x, train=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.detach().numpy(), y_jax, **TOL)
    np.testing.assert_allclose(bn.mean.numpy(), stats["mean"], **STATS_TOL)
    np.testing.assert_allclose(bn.var.numpy(), stats["var"], **STATS_TOL)
    # eval mode reads the running statistics it just moved
    y_eval = bn(x, train=False).permute(0, 2, 3, 1).detach().numpy()
    want = ((bn_batch - stats["mean"]) / np.sqrt(stats["var"] + 1e-5))
    np.testing.assert_allclose(y_eval, want, **TOL)


def test_torch_batchnorm2d_differs_from_flax(bn_batch):
    """torch's running variance takes the unbiased batch variance: on
    this 4 x 3 x 3 batch (n = 36 per channel) it is n / (n - 1) of the
    biased one flax (and the port) take, so the running values differ."""
    _, stats = _flax_bn_step(jnp.asarray(bn_batch))
    tbn = torch.nn.BatchNorm2d(2, momentum=0.1, eps=1e-5)
    tbn.train()
    tbn(torch.from_numpy(bn_batch).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tbn.running_mean.numpy(), stats["mean"],
                               **STATS_TOL)
    n = bn_batch.size // bn_batch.shape[-1]
    batch_var = bn_batch.reshape(-1, 2).var(axis=0)
    np.testing.assert_allclose(
        tbn.running_var.numpy() - stats["var"],
        0.1 * batch_var * (n / (n - 1) - 1.0), rtol=1e-4, atol=1e-7)
    assert np.abs(tbn.running_var.numpy() - stats["var"]).min() > 1e-4


# -- the standard ResNet -----------------------------------------------------

@pytest.fixture(scope="module")
def std_pair():
    rng = np.random.default_rng(1)
    jmodel = jstd.ResNet(layers=(1, 1, 1, 1), num_classes=5)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # non-trivial running statistics, so eval mode reads them
    stats = jax.tree.map(
        lambda v: np.asarray(v) + rng.uniform(0.1, 0.5, v.shape).astype(
            np.float32), variables["batch_stats"])
    params = _np(variables["params"])
    model = standard_resnet.ResNet((1, 1, 1, 1), num_classes=5)
    load_jax_params(model, params, stats)
    return jmodel, params, stats, model, x


@pytest.mark.parametrize("train", [False, True])
def test_standard_resnet_matches_jax(std_pair, train):
    jmodel, params, stats, model, x = std_pair
    state = {k: v.clone() for k, v in model.state_dict().items()}
    variables = {"params": params, "batch_stats": stats}
    if train:
        want, new = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, x)
    else:
        want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
            variables, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if train:  # the running statistics the step moved, as flax moves them
        _assert_stats_equal_jax(model, new["batch_stats"], **TOL)
    else:
        _assert_stats_equal_jax(model, stats, rtol=0, atol=0)
    model.load_state_dict(state)


def test_resnet50_geometry_matches_jax():
    """resnet50(): the same parameter and statistic shapes as JAX's."""
    shapes = jax.eval_shape(
        lambda: jstd.resnet50().init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 64, 3))))
    model = standard_resnet.resnet50()
    ours = {n: tuple(p.shape) for n, p in model.named_parameters()}
    theirs = {port_name(k): v.shape for k, v in _flatten(shapes["params"])}
    assert set(ours) == set(theirs)
    for n, shape in ours.items():
        t = theirs[n]
        assert shape == (t if len(t) != 4 else (t[3], t[2], t[0], t[1])), n
    assert model.feature_dim == 2048
    assert len(stats_buffers(model)) == len(list(
        _flatten(shapes["batch_stats"])))


def test_convert_torchvision_resnet_matches_jax():
    sd = chip_smoke().torchvision_resnet_state_dict(
        np.random.default_rng(2), layers=(1, 2, 1, 1), num_classes=7)
    got_p, got_s = standard_resnet.convert_torchvision_resnet(sd)
    want_p, want_s = jstd.convert_torchvision_resnet(sd)
    for got, want in ((got_p, want_p), (got_s, want_s)):
        g, w = dict(_flatten(got)), dict(_flatten(want))
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # and the trees load: the torchvision weights reproduce torch's layout
    model = standard_resnet.ResNet((1, 2, 1, 1), num_classes=7)
    load_jax_params(model, got_p, got_s)
    np.testing.assert_array_equal(
        model.layer2_0.downsample_conv.kernel.detach().numpy(),
        sd["layer2.0.downsample.0.weight"])
    np.testing.assert_array_equal(model.layer1_0.bn2.var.numpy(),
                                  sd["layer1.0.bn2.running_var"])


# -- ModifiedResNet ----------------------------------------------------------

@pytest.fixture(scope="module")
def rn_pair():
    rng = np.random.default_rng(3)
    kw = dict(layers=(1, 1, 1, 1), output_dim=32, heads=4, image_size=64,
              width=16)
    jmodel = jresnet.ModifiedResNet(**kw)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    stats = jax.tree.map(
        lambda v: np.asarray(v) + rng.uniform(0.1, 0.5, v.shape).astype(
            np.float32), variables["batch_stats"])
    params = _np(variables["params"])
    model = resnet.ModifiedResNet(**kw)
    load_jax_params(model, params, stats)
    return jmodel, params, stats, model, x


@pytest.mark.parametrize("train", [False, True])
def test_modified_resnet_matches_jax(rn_pair, train):
    jmodel, params, stats, model, x = rn_pair
    state = {k: v.clone() for k, v in model.state_dict().items()}
    variables = {"params": params, "batch_stats": stats}
    if train:
        (pooled, tokens), new = jax.jit(lambda v, x: jmodel.apply(
            v, x, deterministic=False, mutable=["batch_stats"]))(variables, x)
    else:
        pooled, tokens = jax.jit(lambda v, x: jmodel.apply(v, x))(variables, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x),
                    torch.Generator().manual_seed(0) if train else None)
    assert got[0].shape == (2, 32) and got[1].shape == (2, 4, 32)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(pooled), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(tokens), **TOL)
    if train:
        _assert_stats_equal_jax(model, new["batch_stats"], **TOL)
    model.load_state_dict(state)


def test_modified_resnet_grads_match_jax(rn_pair):
    """The train-mode backward (through the batch statistics) against
    JAX's autodiff: the input gradient within 1e-3."""
    jmodel, params, stats, model, x = rn_pair
    state = {k: v.clone() for k, v in model.state_dict().items()}
    variables = {"params": params, "batch_stats": stats}

    def jloss(x):
        (p, t), _ = jmodel.apply(variables, x, deterministic=False,
                                 mutable=["batch_stats"])
        return (p ** 2).sum() + t.sum()

    want = jax.jit(jax.grad(jloss))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    p, t = model(xt, torch.Generator().manual_seed(0))
    ((p ** 2).sum() + t.sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)
    model.load_state_dict(state)


# -- the open_clip ModifiedResNet layout -------------------------------------

def test_openclip_modified_resnet_loads_as_jax(tmp_path):
    """A seeded open_clip ``visual.*`` ModifiedResNet state dict through the
    port's loader and JAX's: the same parameters, and the BN running
    statistics in the buffers JAX puts in ``batch_stats``."""
    import json

    from xtagclip_tpu.convert.loader import load_checkpoint_into as jax_load
    from xtagclip_tpu.factory import add_model_config as jax_add
    from xtagclip_tpu.factory import create_model as jax_create
    from xtagclip_tpu_torch import factory
    from xtagclip_tpu_torch.convert.loader import load_checkpoint_into

    cfg = dict(embed_dim=32,
               vision_cfg=dict(layers=[1, 2, 1, 1], width=16, image_size=64),
               text_cfg=dict(context_length=16, vocab_size=1000, width=64,
                             heads=1, layers=1))
    path = tmp_path / "torchtinyrn.json"
    path.write_text(json.dumps(cfg))
    jax_add(str(path))
    factory.add_model_config(path)
    cs = chip_smoke()
    sd = cs.modified_resnet_state_dict(np.random.default_rng(8),
                                       (1, 2, 1, 1), 16, 32, 64)
    ckpt = cs.save_state_dict(sd, str(tmp_path / "rn.pt"))
    bundle = jax_create("torchtinyrn")
    jax_load(bundle, ckpt)
    model = factory.create_model("torchtinyrn", device="cpu")
    load_checkpoint_into(model, ckpt)
    want = {port_name(k): v for k, v in _flatten(_np(bundle.params))
            if k.startswith("visual.")}
    ours = {n: p for n, p in model.named_parameters()
            if n.startswith("visual.")}
    assert set(ours) == set(want)
    for n, p in ours.items():
        w = want[n]
        w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w
        np.testing.assert_array_equal(p.detach().numpy(), w, err_msg=n)
    _assert_stats_equal_jax(model, bundle.extra_variables["batch_stats"],
                            rtol=0, atol=0)
    np.testing.assert_array_equal(model.visual.layer2_0.downsample_bn.var,
                                  sd["visual.layer2.0.downsample.1.running_var"])


# -- BatchNorm in the train steps --------------------------------------------

@pytest.fixture(scope="module")
def rn_clip(tmp_path_factory):
    """A toy RN CLIP in both packages on the same params and statistics."""
    import json

    from xtagclip_tpu.factory import add_model_config as jax_add
    from xtagclip_tpu.factory import create_model as jax_create
    from xtagclip_tpu_torch import factory

    cfg = dict(embed_dim=32,
               vision_cfg=dict(layers=[1, 1, 1, 1], width=16, image_size=64),
               text_cfg=dict(context_length=16, vocab_size=1000, width=64,
                             heads=1, layers=1))
    path = tmp_path_factory.mktemp("cfg") / "torchtinyrnclip.json"
    path.write_text(json.dumps(cfg))
    jax_add(str(path))
    factory.add_model_config(path)
    bundle = jax_create("torchtinyrnclip")
    rng = np.random.default_rng(14)
    stats = jax.tree.map(lambda v: np.asarray(v) + rng.uniform(
        0.1, 0.5, v.shape).astype(np.float32),
        bundle.extra_variables["batch_stats"])
    params = _np(bundle.params)
    model = factory.create_model("torchtinyrnclip", device="cpu")
    load_jax_params(model, params, stats)
    b = 4
    batch = dict(images=rng.standard_normal((2, b, 64, 64, 3)).astype(
        np.float32), texts=rng.integers(1, 1000, (2, b, 16)).astype(np.int32))
    return bundle.module, params, stats, model, batch


def _port_batch(batch, i=None):
    out = {"images": torch.from_numpy(batch["images"]),
           "texts": torch.from_numpy(batch["texts"]).long()}
    return out if i is None else {k: v[i] for k, v in out.items()}


@pytest.mark.parametrize("freeze", [False, True])
def test_train_step_moves_bn_statistics_as_jax(rn_clip, freeze):
    """The train-mode step normalizes with batch statistics and moves the
    running ones as JAX's ``mutable=["batch_stats"]`` step does; with
    ``lock_image_freeze_bn_stats`` the vision tower runs in eval mode
    and keeps them. Contrastive loss only: the tag head's dropout (masks
    from different generators) reaches no term of it."""
    from xtagclip_tpu.train import loop as jloop
    from xtagclip_tpu_torch.train import loop

    module, params, stats, model, batch = rn_clip
    state = {k: v.clone() for k, v in model.state_dict().items()}
    args_cfg = {"lock_image_freeze_bn_stats": freeze}
    jbatch = {k: v[0] for k, v in batch.items()}
    total, (_, new) = jax.jit(lambda p, s: jloop._model_losses(
        module, p, jbatch, {"dropout": jax.random.PRNGKey(0)}, args_cfg,
        None, extra_vars={"batch_stats": s}))(params, stats)
    got, _ = loop._model_losses(model, _port_batch(batch, 0), args_cfg,
                                generator=torch.Generator().manual_seed(0))
    assert abs(got.item() - float(total)) <= 1e-5 * abs(float(total))
    _assert_stats_equal_jax(model, new["batch_stats"], **TOL)
    if freeze:
        _assert_stats_equal_jax(model, stats, rtol=0, atol=0)
    model.load_state_dict(state)


def test_accum_step_keeps_the_last_microbatch_statistics(rn_clip):
    """The accumulation step's BatchNorm statistics: each forward starts
    from the step's, and the last microbatch's pass-2 update is kept, as
    JAX's step keeps it (loop.py:380-383)."""
    from xtagclip_tpu.train import loop as jloop
    from xtagclip_tpu.train import scheduler as jsched
    from xtagclip_tpu.train import train_state as jts
    from xtagclip_tpu_torch.train import scheduler
    from xtagclip_tpu_torch.train import train_state as ts
    from xtagclip_tpu_torch.train.loop import make_accum_train_step

    module, params, stats, model, batch = rn_clip
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    tx = jts.make_optimizer(jsched.const_lr(1e-4, 0, 10), params=params)
    jstate = jts.create_train_state(jax.tree.map(jnp.asarray, params), tx,
                                    {"batch_stats": stats})
    jstep = jloop.make_accum_train_step(module, tx, {}, 2, donate=False)
    jnew, jm = jstep(jstate, {**batch, "template_id": 0},
                     jax.random.PRNGKey(0))
    state = ts.create_train_state(model, ts.make_optimizer(
        scheduler.const_lr(1e-4, 0, 10),
        params=dict(model.named_parameters())))
    step = make_accum_train_step({}, 2)
    _, m = step(state, _port_batch(batch), torch.Generator().manual_seed(0))
    assert abs(m["loss"].item() - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    _assert_stats_equal_jax(model, jnew.extra_vars["batch_stats"], **TOL)
    model.load_state_dict(state0)
