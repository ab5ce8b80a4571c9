"""The port's ``--opt`` optimizers against optax through JAX's
``make_optimizer``, on the CPU.

A toy parameter tree in JAX's layout (a conv kernel [kh, kw, in, out] and
a dense kernel whose two axes are both >= 128, so that adafactor factors
them; smaller kernels, vectors and the logit scale; one frozen leaf)
takes five updates from fixed seeded gradients through JAX's
``make_optimizer`` (optax, inside ``multi_transform``) and through the
port's on the same values in the port's layout (the conv kernel
transposed to [out, in, kh, kw]), with the global-norm clip on and a
warmup-cosine schedule. Bar: every parameter within 1e-6 of optax's after
five steps (the AdamW test's bar); lion's sign may differ only where
optax's argument is below 1e-6 in magnitude, and such elements are
counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src.factorized import FactoredState

from xtagclip_tpu.train import scheduler as jsched
from xtagclip_tpu.train import train_state as jts
from xtagclip_tpu_torch.convert.from_jax import _flatten, port_name, port_value
from xtagclip_tpu_torch.train import scheduler
from xtagclip_tpu_torch.train import train_state as ts
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

SHAPES = {
    "visual": {
        "conv1": {"kernel": (3, 3, 160, 128)},   # factored over in and out
        "proj": (256, 128),                      # factored
        "ln_pre": {"scale": (128,), "bias": (128,)},
        "transformer": {"resblocks_0": {"mlp": {"c_fc": {
            "kernel": (64, 96), "bias": (96,)}}}},
    },
    "text": {"token_embedding": {"embedding": (100, 64)}},
    "logit_scale": (),
}
FROZEN = "text.token_embedding.embedding"
STEPS, CLIP, WD, LR = 5, 5.0, 0.1, 1e-2


def _tree(fn, shapes=SHAPES, prefix=""):
    out = {}
    for k, v in shapes.items():
        name = f"{prefix}.{k}" if prefix else k
        out[k] = _tree(fn, v, name) if isinstance(v, dict) else fn(name, v)
    return out


def _params():
    rng = np.random.default_rng(7)
    return _tree(lambda n, s: (0.05 * rng.standard_normal(s)).astype(
        np.float32))


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return _tree(lambda n, s: rng.standard_normal(s).astype(np.float32))


def _flat(tree):
    return {port_name(k): np.asarray(v) for k, v in _flatten(tree)}


def _run_jax(opt, momentum):
    params = _params()
    mask = _tree(lambda n, s: n != FROZEN)
    tx = jts.make_optimizer(jsched.cosine_lr(LR, 2, 10), weight_decay=WD,
                            grad_clip_norm=CLIP, params=params,
                            train_mask=mask, opt=opt, momentum=momentum)
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    update = jax.jit(tx.update)
    for i in range(STEPS):
        updates, state = update(jax.tree.map(jnp.asarray, _grads(i)), state,
                                p)
        p = optax.apply_updates(p, updates)
    return _flat(p), state


def _run_port(opt, momentum, steps=STEPS, tx=None, named=None):
    if named is None:
        named = {name: torch.nn.Parameter(torch.from_numpy(port_value(v)))
                 for name, v in _flat(_params()).items()}
    if tx is None:
        mask = {n: n != FROZEN for n in named}
        tx = ts.make_optimizer(scheduler.cosine_lr(LR, 2, 10),
                               weight_decay=WD, grad_clip_norm=CLIP,
                               params=named, train_mask=mask, opt=opt,
                               momentum=momentum)
    for i in range(steps):
        for name, g in _flat(_grads(i)).items():
            named[name].grad = torch.from_numpy(port_value(g).copy())
        tx.update(i)
    return named, tx


def _lion_near_zero(flat_shape):
    """Per leaf, the elements where optax's sign argument (1 - b1) g +
    b1 m on the clipped gradients is below 1e-6 in magnitude at some
    step (float64 from the same gradients)."""
    b1, b2 = 0.9, 0.98
    mu = {n: np.zeros(s, np.float64) for n, s in flat_shape.items()}
    near = {n: np.zeros(s, bool) for n, s in flat_shape.items()}
    for i in range(STEPS):
        g = {n: v.astype(np.float64) for n, v in _flat(_grads(i)).items()
             if n != FROZEN}
        norm = np.sqrt(sum(np.sum(v * v) for v in g.values()))
        scale = 1.0 if norm < CLIP else CLIP / norm
        for n, v in g.items():
            arg = (1 - b1) * v * scale + b1 * mu[n]
            near[n] |= np.abs(arg) < 1e-6
            mu[n] = (1 - b2) * v * scale + b2 * mu[n]
    return near


@pytest.mark.parametrize("opt,momentum", [
    ("adamw", None), ("adam", None), ("sgd", None), ("sgd", 0.5),
    ("lion", None), ("adafactor", None)],
    ids=["adamw", "adam", "sgd", "sgd-momentum-0.5", "lion", "adafactor"])
def test_five_steps_match_optax(opt, momentum):
    want, _ = _run_jax(opt, momentum)
    got, _ = _run_port(opt, momentum)
    start = _flat(_params())
    near = _lion_near_zero({n: v.shape for n, v in want.items()}) \
        if opt == "lion" else {}
    flipped = 0
    for name, p in got.items():
        ours = p.detach().numpy()
        if ours.ndim == 4:  # back to JAX's [kh, kw, in, out]
            ours = ours.transpose(2, 3, 1, 0)
        diff = np.abs(ours - want[name])
        if name in near:
            flipped += int(np.sum((diff > 1e-6) & near[name]))
            diff = np.where(near[name], 0.0, diff)
        assert diff.max() <= 1e-6, (opt, name, float(diff.max()))
        if name == FROZEN:
            assert np.array_equal(ours, start[name])
        else:
            assert not np.array_equal(ours, start[name]), name
    assert flipped <= 8, flipped


def _factored_state(state):
    """JAX's FactoredState inside the multi_transform state."""
    found = []

    def walk(node):
        if isinstance(node, FactoredState):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for x in node:
                walk(x)
        elif isinstance(node, dict):
            for x in node.values():
                walk(x)
        elif hasattr(node, "__dict__") and not isinstance(node, jax.Array):
            for x in vars(node).values():
                walk(x)

    walk(state)
    assert len(found) == 1
    return found[0]


def test_adafactor_factors_the_dense_and_the_conv_kernel_as_jax():
    """Both the dense kernel and the transposed conv kernel take the
    factored branch over the same physical axes as JAX: the row and
    column statistics equal JAX's, up to the conv's transpose."""
    _, j_state = _run_jax("adafactor", None)
    fs = _factored_state(j_state)
    v_row, v_col = _flat(fs.v_row), _flat(fs.v_col)
    named, tx = _run_port("adafactor", None)
    state = tx.optimizer.state
    dense = state[named["visual.proj"]]
    assert set(dense) == {"step", "v_row", "v_col"}
    np.testing.assert_allclose(dense["v_row"].numpy(), v_row["visual.proj"],
                               rtol=1e-5)
    np.testing.assert_allclose(dense["v_col"].numpy(), v_col["visual.proj"],
                               rtol=1e-5)
    conv = state[named["visual.conv1.kernel"]]
    # JAX: [kh, kw, in, out], rows without `in`, columns without `out`;
    # the port: [out, in, kh, kw], the same axes dropped
    assert ts.factored_dims(named["visual.conv1.kernel"]) == (0, 1)
    np.testing.assert_allclose(
        conv["v_row"].numpy(),
        v_row["visual.conv1.kernel"].transpose(2, 0, 1), rtol=1e-5)
    np.testing.assert_allclose(
        conv["v_col"].numpy(),
        v_col["visual.conv1.kernel"].transpose(2, 0, 1), rtol=1e-5)
    small = state[named["visual.transformer.resblocks.0.mlp.c_fc.kernel"]]
    assert set(small) == {"step", "v"}


@pytest.mark.parametrize("opt", ["sgd", "lion", "adafactor"])
def test_state_dict_resumes_bit_for_bit(opt):
    """Two updates, the optimizer state through ``state_dict`` into a fresh
    optimizer (as a checkpoint resume loads it), three more: the same bits
    as five updates in one run."""
    straight, _ = _run_port(opt, None)
    named, tx = _run_port(opt, None, steps=2)
    saved = tx.optimizer.state_dict()
    mask = {n: n != FROZEN for n in named}
    fresh = ts.make_optimizer(scheduler.cosine_lr(LR, 2, 10),
                              weight_decay=WD, grad_clip_norm=CLIP,
                              params=named, train_mask=mask, opt=opt)
    fresh.optimizer.load_state_dict(saved)
    for i in range(2, STEPS):
        for name, g in _flat(_grads(i)).items():
            named[name].grad = torch.from_numpy(port_value(g).copy())
        fresh.update(i)
    for name, p in named.items():
        assert torch.equal(p, straight[name]), name


def test_unknown_optimizer_raises_value_error():
    named = {"w": torch.nn.Parameter(torch.zeros(4, 4))}
    with pytest.raises(ValueError, match="unknown optimizer 'rmsprop'"):
        ts.make_optimizer(lambda s: 1e-3, params=named, opt="rmsprop")
    with pytest.raises(ValueError, match="unknown optimizer"):
        jts.make_optimizer(lambda s: 1e-3, params={"w": jnp.zeros((4, 4))},
                           opt="rmsprop")
