"""The PyTorch port's train slice against the JAX package, on the CPU.

The attention half's backward (the plain version of the CUDA kernel and
the autograd Function around it), the MLP half's backward, the losses,
the schedules, the decay/lock masks, the optimizer step and the whole XTag
loss with its gradients, on the same numpy inputs and weights in both
packages. The JAX side runs as the JAX package's own tests run it: the
Pallas backward kernel in TPU interpret mode, the rest on the CPU. The
toy model is the tests/test_torch_model.py geometry (2 layers, width 64,
head dim 64).

Bars: fp32 gradients 1e-4 normalized per tensor (the backward tests of
tests/test_fused_attn_block.py), the Function against autograd of the
plain forward 1e-5, losses 1e-5, schedules 1e-7, optimizer step 1e-6,
the whole loss 1e-5 relative and its gradients 1e-3 normalized (the
repo's parity contract, BASELINE.md:18); bf16 against the Pallas kernel:
one bf16 ULP at output scale (atol max|ref|/128, rtol 1e-2).
"""

import copy
import json
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xtagclip_tpu.factory import add_model_config as jax_add_model_config
from xtagclip_tpu.factory import create_model as jax_create_model
from xtagclip_tpu.losses import asymmetric_loss as j_asl
from xtagclip_tpu.losses import clip_loss as j_clip_loss
from xtagclip_tpu.losses import dqncos_loss as j_dqncos
from xtagclip_tpu.ops import fused_attn_block as jfab
from xtagclip_tpu.train import scheduler as jsched
from xtagclip_tpu.train import train_state as jts
from xtagclip_tpu_torch import factory
from xtagclip_tpu_torch.convert.from_jax import load_jax_params, port_name
from xtagclip_tpu_torch.losses import asymmetric_loss, clip_loss, dqncos_loss
from xtagclip_tpu_torch.models.clip import num_combos
from xtagclip_tpu_torch.models.layers import set_use_kernels
from xtagclip_tpu_torch.ops import fused_attn_block as fab
from xtagclip_tpu_torch.train import scheduler
from xtagclip_tpu_torch.train import train_state as ts
from xtagclip_tpu_torch.train.loop import _model_losses, make_train_step
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

CFG = dict(
    embed_dim=64,
    fusion_dim=64,
    # head dim 64 in both towers: the fused halves take their streams
    vision_cfg=dict(layers=2, width=64, head_width=64, patch_size=8,
                    image_size=32),
    text_cfg=dict(context_length=16, vocab_size=1024, width=64, heads=1,
                  layers=2),
)
B = 4


def _rng_arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _normalized_err(a, r):
    a = np.asarray(a, np.float32)
    r = np.asarray(r, np.float32)
    return float(np.abs(a - r).max()) / max(1.0, float(np.abs(r).max()))


def _assert_grads_close(got, ref, tol):
    for i, (a, r) in enumerate(zip(got, ref)):
        err = _normalized_err(a, r)
        assert err <= tol, (i, err)


def _assert_kernel_bar(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out, ref, atol=float(np.abs(ref).max()) / 128,
                               rtol=1e-2)


def _np(t):
    return t.detach().float().numpy()


# -- the attention half's backward -------------------------------------------

def _attn_arrays(b, l, d, seed):
    x, g, lb, wqkv, bqkv, wout, bout, ct = _rng_arrays(
        seed, (b, l, d), d, d, (d, 3 * d), 3 * d, (d, d), d, (b, l, d))
    return x, 1 + 0.1 * g, 0.1 * lb, 0.2 * wqkv, bqkv, 0.2 * wout, bout, ct


_BF16 = (True, False, False, True, False, True, False)  # x, ln, ln, w, b, w, b


def _causal(l):
    return np.triu(np.full((l, l), -np.inf, np.float32), k=1)


def _jax_attn_grads(arrs, mask, h, fused, bf16):
    """JAX gradients of the 7 inputs under the cotangent ct: through
    ``_reference_chain`` or through the custom_vjp ``fused_attn_half``."""
    *ins, ct = arrs
    ins = [jnp.asarray(a, jnp.bfloat16 if bf16 and m else jnp.float32)
           for a, m in zip(ins, _BF16)]
    jmask = None if mask is None else jnp.asarray(mask)
    if fused:
        fn = lambda *a: jfab.fused_attn_half(*a, jmask, h, 1e-5)  # noqa: E731
    else:
        fn = lambda *a: jfab._reference_chain(*a, h, 1e-5, mask=jmask)  # noqa: E731

    def grads(*a):
        out, vjp = jax.vjp(fn, *a)
        return vjp(jnp.asarray(ct, out.dtype))

    # jitted: an eager call of the interpreted Pallas kernel can deadlock
    # in the interpreter's callbacks (ROADMAP Ground rules)
    return jax.jit(grads)(*ins)


def _port_attn_grads(arrs, mask, h, bf16):
    """Port gradients of the 7 inputs through ``fused_attn_half`` (the
    autograd Function; on the CPU its backward is the plain version)."""
    *ins, ct = arrs
    ins = [torch.from_numpy(a).to(torch.bfloat16 if bf16 and m
                                  else torch.float32).requires_grad_(True)
           for a, m in zip(ins, _BF16)]
    tmask = None if mask is None else torch.from_numpy(mask)
    y = fab.fused_attn_half(*ins, tmask, h, 1e-5)
    return torch.autograd.grad(y, ins, torch.from_numpy(ct).to(y.dtype))


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attn_half_bwd_matches_jax_fp32(causal):
    """The kernel's plain version (plus dwqkv = xn^T dqkv, dbqkv) against
    jax.vjp of the composed chain, fp32."""
    arrs = _attn_arrays(3, 16, 128, seed=30 + causal)
    mask = _causal(16) if causal else None
    ref = _jax_attn_grads(arrs, mask, 4, fused=False, bf16=False)
    x, ln_g, ln_b, wqkv, bqkv, wout, _, ct = (torch.from_numpy(a)
                                              for a in arrs)
    dx, dqkv, dwout, dbout, dls, dlb = fab.reference_attn_half_bwd(
        x, ct, ln_g, ln_b, wqkv, bqkv, wout,
        None if mask is None else torch.from_numpy(mask), 4, 1e-5)
    xn = fab._layer_norm_rounded(x, ln_g, ln_b, 1e-5, x.dtype).reshape(-1, 128)
    dq2 = dqkv.reshape(-1, 384)
    got = (dx, dls, dlb, xn.t() @ dq2, dq2.sum(0), dwout, dbout)
    _assert_grads_close([_np(t) for t in got], ref, 1e-4)


@pytest.mark.parametrize("b,l,d,h,causal", [(1, 16, 128, 2, False),
                                            (3, 16, 128, 4, False),
                                            (2, 16, 128, 2, True)])
def test_attn_half_grads_match_pallas_bwd_kernel_bf16(b, l, d, h, causal,
                                                      monkeypatch):
    """bf16: the Function's backward (the kernel's plain version) against
    the JAX train pairing, the Pallas backward kernel, interpreted."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("XTAG_FUSED_TRAIN", "0")
    monkeypatch.setenv("XTAG_FUSED_TRAIN_BWD", "1")
    arrs = _attn_arrays(b, l, d, seed=40 + b + causal)
    mask = _causal(l) if causal else None
    with pltpu.force_tpu_interpret_mode():
        ref = _jax_attn_grads(arrs, mask, h, fused=True, bf16=True)
    got = _port_attn_grads(arrs, mask, h, bf16=True)
    for a, r in zip(got, ref):
        assert a.dtype == (torch.bfloat16 if r.dtype == jnp.bfloat16
                           else torch.float32)
        _assert_kernel_bar(_np(a), r)


@pytest.mark.parametrize("causal", [False, True])
def test_attn_function_matches_autograd_of_plain_forward(causal):
    arrs = _attn_arrays(2, 16, 64, seed=50 + causal)
    mask = _causal(16) if causal else None
    got = _port_attn_grads(arrs, mask, 2, bf16=False)
    *ins, ct = arrs
    ins = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y = fab.reference_attn_half(*ins, None if mask is None
                                else torch.from_numpy(mask), 2, 1e-5)
    ref = torch.autograd.grad(y, ins, torch.from_numpy(ct))
    _assert_grads_close([_np(t) for t in got], [_np(t) for t in ref], 1e-5)


# -- the MLP half's backward -------------------------------------------------

@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("bf16", [False, True])
def test_mlp_half_bwd_matches_jax_vjp(act, bf16):
    """The MLP Function's backward against jax.vjp of JAX fused_mlp_half
    (its chain fallback) under one cotangent: fp32 at 1e-4, bf16 at the
    ULP bar."""
    x, g, lb, w1, b1, w2, b2, ct = _rng_arrays(
        60 + bf16, (2, 16, 128), 128, 128, (128, 512), 512, (512, 128), 128,
        (2, 16, 128))
    ins = (x, 1 + 0.1 * g, 0.1 * lb, 0.2 * w1, b1, 0.1 * w2, b2)
    j_ins = [jnp.asarray(a, jnp.bfloat16 if bf16 and m else jnp.float32)
             for a, m in zip(ins, _BF16)]
    out, vjp = jax.vjp(lambda *a: jfab.fused_mlp_half(*a, act, 1e-5), *j_ins)
    ref = vjp(jnp.asarray(ct, out.dtype))
    t_ins = [torch.from_numpy(a).to(torch.bfloat16 if bf16 and m
                                    else torch.float32).requires_grad_(True)
             for a, m in zip(ins, _BF16)]
    y = fab.fused_mlp_half(*t_ins, act, 1e-5)
    got = torch.autograd.grad(y, t_ins, torch.from_numpy(ct).to(y.dtype))
    if bf16:
        for a, r in zip(got, ref):
            _assert_kernel_bar(_np(a), r)
    else:
        _assert_grads_close([_np(t) for t in got], ref, 1e-4)


# -- losses and schedules ----------------------------------------------------

def _loss_grads(fn, arrays):
    ts_ = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    val = fn(*ts_)
    return val.item(), [_np(g) for g in torch.autograd.grad(val, ts_)]


@pytest.mark.parametrize("name", ["clip", "asl", "dqncos"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(70)
    if name == "clip":
        img, txt = _rng_arrays(71, (8, 16), (8, 16))
        arrays = (img, txt, np.float32(math.log(1 / 0.07)))
        port, jfn = clip_loss, j_clip_loss
    elif name == "asl":
        logits = _rng_arrays(72, (8, 44), scale=2.0)[0]
        target = (rng.random((8, 44)) < 0.3).astype(np.float32)
        arrays = (logits,)
        port = lambda x: asymmetric_loss(x, torch.from_numpy(target))  # noqa: E731
        jfn = lambda x: j_asl(x, jnp.asarray(target))  # noqa: E731
    else:
        arrays = tuple(_rng_arrays(73, (8, 8), scale=3.0))
        port, jfn = dqncos_loss, j_dqncos
    arrays = tuple(np.asarray(a, np.float32) for a in arrays)
    val, grads = _loss_grads(port, arrays)
    j_val, j_grads = jax.value_and_grad(
        jfn, argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))
    assert abs(val - float(j_val)) <= 1e-5 * max(1.0, abs(float(j_val)))
    _assert_grads_close(grads, j_grads, 1e-5)


@pytest.mark.parametrize("name,args", [
    ("cosine_lr", (5e-5, 50, 1000)),
    ("cosine_lr", (1.0, 50, 1000)),
    ("const_lr", (1.0, 50, 1000)),
    ("const_lr_cooldown", (1.0, 50, 1000, 300, 1.5, 1e-3)),
])
def test_schedules_match_jax(name, args):
    port, jfn = getattr(scheduler, name)(*args), getattr(jsched, name)(*args)
    warmup, end = args[1], args[2]
    for step in (0, warmup - 1, warmup, (warmup + end) // 2, end - 1, end):
        assert abs(port(step) - float(jfn(step))) <= 1e-7, step


def test_create_scheduler_matches_jax():
    args = SimpleNamespace(skip_scheduler=False, lr_scheduler="const-cooldown",
                           lr=1e-3, warmup=10, epochs=10, epochs_cooldown=3,
                           lr_cooldown_power=1.0, lr_cooldown_end=0.0)
    port = scheduler.create_scheduler(args, 100)
    jfn = jsched.create_scheduler(args, 100)
    for step in (0, 9, 10, 70, 85, 100):
        assert abs(port(step) - float(jfn(step))) <= 1e-7, step


# -- the toy model pair ------------------------------------------------------

@pytest.fixture(scope="module")
def cfg_name(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "torchtinytrain.json"
    path.write_text(json.dumps(CFG))
    jax_add_model_config(str(path))
    factory.add_model_config(path)
    return path.stem


@pytest.fixture(scope="module")
def bundle(cfg_name):
    return jax_create_model(cfg_name, use_tagging=True, use_fusion=True)


@pytest.fixture(scope="module")
def jparams(bundle):
    return jax.tree.map(np.asarray, bundle.params)


def _port_model(cfg_name, jparams, precision="fp32"):
    model = factory.create_model(cfg_name, device="cpu", precision=precision,
                                 use_tagging=True, use_fusion=True)
    load_jax_params(model, jparams)
    return model


def _flat(tree):
    """{port name: leaf} of a flax tree."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {port_name(".".join(str(getattr(k, "key", k)) for k in path)): v
            for path, v in leaves}


def test_decay_mask_matches_jax(cfg_name, jparams):
    model = _port_model(cfg_name, jparams)
    assert ts.decay_mask(dict(model.named_parameters())) == _flat(
        jts.decay_mask(jparams))


@pytest.mark.parametrize("kw", [
    dict(lock_image=True, lock_image_unlocked_groups=0),
    dict(lock_image=True, lock_image_unlocked_groups=1),
    dict(lock_image=True, lock_image_unlocked_groups=3),
    dict(lock_text=True, lock_text_unlocked_layers=0),
    dict(lock_text=True, lock_text_unlocked_layers=2),
    dict(lock_text=True, lock_text_unlocked_layers=2,
         lock_text_freeze_layer_norm=True),
    dict(lock_image=True, lock_image_unlocked_groups=1, lock_text=True,
         lock_text_freeze_layer_norm=True),
])
def test_trainable_mask_matches_jax(cfg_name, jparams, kw):
    model = _port_model(cfg_name, jparams)
    got = ts.trainable_mask(dict(model.named_parameters()), **kw)
    want = _flat(jts.trainable_mask(jparams, **kw))
    assert got == want
    assert not all(got.values())


def test_optimizer_steps_match_optax(cfg_name, jparams):
    """Three AdamW steps on fixed gradients, weight decay masked, the image
    tower frozen but for its last group, logit_scale pushed past ln 100 and
    clamped back, the global-norm clip on."""
    params = jax.tree.map(np.array, jparams)
    params["logit_scale"] = np.float32(4.8)
    lock = dict(lock_image=True, lock_image_unlocked_groups=1)
    sched = jsched.cosine_lr(1e-2, 2, 10)
    j_tx = jts.make_optimizer(sched, weight_decay=0.2, grad_clip_norm=5.0,
                              params=params,
                              train_mask=jts.trainable_mask(params, **lock))
    j_state = jts.create_train_state(jax.tree.map(jnp.asarray, params), j_tx)

    model = _port_model(cfg_name, params)
    named = dict(model.named_parameters())
    tx = ts.make_optimizer(scheduler.cosine_lr(1e-2, 2, 10), weight_decay=0.2,
                           grad_clip_norm=5.0, params=named,
                           train_mask=ts.trainable_mask(named, **lock))
    state = ts.create_train_state(model, tx)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    j_apply = jax.jit(lambda st, g: jts.apply_gradients(st, g, j_tx))
    for i in range(3):
        rng = np.random.default_rng(80 + i)
        g_leaves = [rng.standard_normal(np.shape(a)).astype(np.float32)
                    for a in leaves]
        grads = jax.tree_util.tree_unflatten(treedef, g_leaves)
        j_state = j_apply(j_state, jax.tree.map(jnp.asarray, grads))
        for name, g in _flat(grads).items():  # a copy: the clip scales in place
            named[name].grad = torch.from_numpy(np.array(g))
        state = ts.apply_gradients(state)
    assert state.step == 3 and model.logit_scale.item() == pytest.approx(
        math.log(100.0))
    want = _flat(j_state.params)
    frozen = ts.trainable_mask(named, **lock)
    for name, p in named.items():
        np.testing.assert_allclose(_np(p), np.asarray(want[name]), rtol=0,
                                   atol=1e-6, err_msg=name)
        if not frozen[name]:
            assert np.array_equal(_np(p), _flat(params)[name]), name


def test_unported_optimizers_and_branches_raise(cfg_name, jparams):
    model = _port_model(cfg_name, jparams)
    # every --opt of JAX's make_optimizer is ported (tests/
    # test_torch_optimizers.py); an unknown name raises as JAX's does
    with pytest.raises(ValueError, match="unknown optimizer 'lamb'"):
        ts.make_optimizer(lambda s: 1e-3, params=dict(model.named_parameters()),
                          opt="lamb")
    # the SigLIP branch is ported: its loss is finite on a model without a
    # logit bias (JAX's siglip_loss takes bias None)
    total, metrics = _model_losses(
        model, {"images": torch.zeros(2, 32, 32, 3),
                "texts": torch.ones(2, 16, dtype=torch.long)},
        {"siglip": True, "use_tagging_loss": False}, deterministic=True)
    assert torch.isfinite(total)
    assert torch.isfinite(metrics["contrastive_loss"])


# -- the whole XTag loss -----------------------------------------------------

@pytest.fixture(scope="module")
def batch_np():
    # seed 90 puts one ReLU of TQN's MLP head within fp32 rounding of 0
    # (1.2e-7): summation order then flips its gradient (ROADMAP Queue 3)
    rng = np.random.default_rng(91)
    images = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    table = rng.integers(1, 1000, (1, 3, num_combos(), 16)).astype(np.int32)
    class_ids = np.array([0, 2, 1, 2], np.int32)
    additional = np.zeros((B, 22), np.float32)
    for off, size in zip((0, 3, 7, 10, 14, 18), (3, 4, 3, 4, 4, 4)):
        additional[np.arange(B), off + rng.integers(0, size, B)] = 1.0
    texts = rng.integers(1, 1000, (B, 16)).astype(np.int32)
    return dict(images=images, table=table, class_ids=class_ids,
                additional=additional, texts=texts)


def _torch_batch(bn, *keys):
    out = {"images": torch.from_numpy(bn["images"])}
    for k in keys:
        t = torch.from_numpy(bn[k])
        out[k] = t.long() if t.dtype == torch.int32 else t
    return out


def test_xtag_loss_and_grads_match_jax(cfg_name, bundle, jparams, batch_np):
    bn = batch_np

    def j_total(params):
        out = bundle.module.apply(
            {"params": params}, jnp.asarray(bn["images"]),
            prompt_table=jnp.asarray(bn["table"]),
            class_ids=jnp.asarray(bn["class_ids"]), template_id=0,
            deterministic=True)
        total = j_clip_loss(out["image_features"], out["text_features"],
                            out["logit_scale"])
        total = total + 2.0 * j_asl(out["tag_logits"],
                                    jnp.tile(jnp.asarray(bn["additional"]),
                                             (1, 2)), 4, 1, 0.05)
        return total + 2.0 * (j_dqncos(out["i2t_cls"])
                              + j_dqncos(out["t2i_cls"]))

    j_val, j_grads = jax.jit(jax.value_and_grad(j_total))(
        jax.tree.map(jnp.asarray, jparams))
    model = _port_model(cfg_name, jparams)
    total, metrics = _model_losses(
        model, _torch_batch(bn, "class_ids", "additional"), {},
        prompt_table=torch.from_numpy(bn["table"]).long(), deterministic=True)
    total.backward()
    assert set(metrics) == {"contrastive_loss", "tagging_loss", "ce_loss",
                            "loss", "logit_scale"}
    assert abs(total.item() - float(j_val)) <= 1e-5 * abs(float(j_val))
    named = dict(model.named_parameters())
    for name, g in _flat(j_grads).items():
        g = np.asarray(g)
        if not np.any(g):
            continue
        assert named[name].grad is not None, name
        assert _normalized_err(_np(named[name].grad), g) <= 1e-3, name


def _one_step(model, bn, deterministic=False, seed=0):
    named = dict(model.named_parameters())
    state = ts.create_train_state(model, ts.make_optimizer(
        scheduler.cosine_lr(5e-5, 50, 1000), weight_decay=0.1, params=named))
    batch = _torch_batch(bn, "texts", "additional")
    if deterministic:
        total, _ = _model_losses(model, batch, {}, deterministic=True)
        return total.item(), None
    gen = torch.Generator().manual_seed(seed)
    _, metrics = make_train_step({})(state, batch, gen)
    return metrics, {n: p.grad for n, p in named.items()}


def test_bf16_step_functions_match_plain_halves(cfg_name, jparams, batch_np):
    """One bf16 train step on the CPU through the two autograd Functions
    against the same step through the plain halves (set_use_kernels
    False): the chip smoke's train-path bars."""
    model = _port_model(cfg_name, jparams, precision="bf16")
    plain = copy.deepcopy(model)
    set_use_kernels(plain, False)
    mk, gk = _one_step(model, batch_np)
    mp, gp = _one_step(plain, batch_np)
    for m in (mk, mp):
        assert set(m) == {"contrastive_loss", "tagging_loss", "ce_loss",
                          "loss", "logit_scale", "grad_norm"}
        assert all(math.isfinite(v.item()) for v in m.values())
    assert abs(mk["loss"] - mp["loss"]).item() <= 1e-2 * abs(mp["loss"].item())
    assert abs(mk["grad_norm"] - mp["grad_norm"]).item() <= (
        2e-2 * mp["grad_norm"].item())
    for name, g in gp.items():
        if g is None or not g.abs().max().item() > 0:
            continue
        a, r = gk[name].float().flatten(), g.float().flatten()
        assert (a @ r / (a.norm() * r.norm())).item() >= 0.99, name


def test_dropout_is_seeded_and_on_only_in_train_mode(cfg_name, jparams,
                                                     batch_np):
    model = _port_model(cfg_name, jparams)
    start = copy.deepcopy(model.state_dict())
    first, _ = _one_step(model, batch_np, seed=5)
    model.load_state_dict(start)
    again, _ = _one_step(model, batch_np, seed=5)
    model.load_state_dict(start)
    other, _ = _one_step(model, batch_np, seed=6)
    model.load_state_dict(start)
    det, _ = _one_step(model, batch_np, deterministic=True)
    assert first["loss"].item() == again["loss"].item()
    assert first["loss"].item() != other["loss"].item()
    assert first["loss"].item() != det
    with pytest.raises(ValueError, match="Generator"):
        model(torch.from_numpy(batch_np["images"]), deterministic=False)
