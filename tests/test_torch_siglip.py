"""SigLIP in the PyTorch port against the JAX package (CPU, toy geometry).

- ``siglip_loss``: value and gradients with respect to the features, the
  scale and the bias against JAX's, fp32, at 1e-5: with a bias, without
  one, and the negative-only block.
- A toy SigLIP-shaped CLIP (a timm ``map``-pool tower without class token;
  a text tower without causal mask, ``pool_type: last``, ``proj_bias``, eps
  1e-6, head dim 72 and an MLP hidden width of 360, a multiple of 8 and not
  of 64, as ViT-SO400M-14-SigLIP's 4304): its forward and ``get_logits``
  with the bias against JAX's, the plain step's loss and gradients against
  JAX's ``_model_losses`` and one step of ``make_train_step(args_cfg=
  {"siglip": True})``, and the accumulation step against JAX's, fp32, at
  1e-3; ``logit_bias`` gets a gradient and moves.
- The text block at that MLP width: its route (flash attention and the
  fused MLP, kernel #4) against JAX's block, fp32 and bf16 (one bf16 ULP
  at output scale); #4 takes a hidden width of 4304 and refuses 4300.
- ``create_loss`` and ``cli.main --siglip --device cpu`` on synthetic data;
  the shipped SigLIP configs' sizes and routes.

JAX runs every function jitted (ROADMAP Ground rules).
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from xtagclip_tpu.factory import add_model_config as jax_add_model_config  # noqa: E402
from xtagclip_tpu.factory import create_model as jax_create_model  # noqa: E402
from xtagclip_tpu.losses import siglip as jsiglip  # noqa: E402
from xtagclip_tpu.models.layers import ResidualAttentionBlock as JBlock  # noqa: E402
from xtagclip_tpu.train import loop as jloop  # noqa: E402
from xtagclip_tpu.train import scheduler as jsched  # noqa: E402
from xtagclip_tpu.train import train_state as jts  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.cli import main as port_main  # noqa: E402
from xtagclip_tpu_torch.convert.from_jax import load_jax_params, port_name  # noqa: E402
from xtagclip_tpu_torch.losses import SigLipLoss, siglip  # noqa: E402
from xtagclip_tpu_torch.models.layers import ResidualAttentionBlock  # noqa: E402
from xtagclip_tpu_torch.ops import fused_mlp  # noqa: E402
from xtagclip_tpu_torch.train import scheduler  # noqa: E402
from xtagclip_tpu_torch.train import train_state as ts  # noqa: E402
from xtagclip_tpu_torch.train.logger import close_logging  # noqa: E402
from xtagclip_tpu_torch.train.loop import (  # noqa: E402
    _model_losses,
    make_accum_train_step,
    make_train_step,
)
from xtagclip_tpu_torch.train.params import parse_args  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)
SIGLIP = {"siglip": True, "use_tagging_loss": False}
CTX, VOCAB, SIDE = 16, 1000, 32
# ViT-B-16-SigLIP's layout at toy size: the timm tiny trunk (192 wide, 3
# heads, no class token, MAP head) at 32 px (16 patches), and a text tower
# of head dim 72 (SO400M's) whose MLP is 360 wide (8 x 45)
TOY = dict(
    embed_dim=192, init_logit_bias=-10,
    vision_cfg=dict(image_size=SIDE, timm_model_name="vit_tiny_patch8_siglip_32",
                    timm_model_pretrained=False, timm_pool="map",
                    timm_proj="none"),
    text_cfg=dict(context_length=CTX, vocab_size=VOCAB, width=144, heads=2,
                  layers=2, mlp_ratio=2.5, no_causal_mask=True,
                  proj_bias=True, pool_type="last",
                  norm_kwargs={"eps": 1e-6}),
)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {port_name(".".join(str(getattr(k, "key", k)) for k in path)):
            np.asarray(v) for path, v in leaves}


def _register(tmp_path_factory, name, cfg):
    path = tmp_path_factory.mktemp("cfg") / f"{name}.json"
    path.write_text(json.dumps(cfg))
    jax_add_model_config(str(path))
    factory.add_model_config(path)
    return name


# -- the loss ------------------------------------------------------------------

def _loss_inputs(seed, n=6, m=6, e=16):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, e)).astype(np.float32)
    txt = rng.standard_normal((m, e)).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    return img, txt, np.float32(math.exp(2.3)), np.float32(-4.0)


@pytest.mark.parametrize("case", ["bias", "no_bias", "negative_only"])
def test_siglip_loss_and_grads_match_jax(case):
    img, txt, scale, bias = _loss_inputs(3 + len(case),
                                         m=4 if case == "negative_only" else 6)
    use_bias = case != "no_bias"
    neg = case == "negative_only"

    def j_loss(i, t, s, b):
        return jsiglip._sigmoid_block_loss(i, t, s, b if use_bias else None,
                                           negative_only=neg)

    j_val, j_grads = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3)))(
        img, txt, scale, bias)
    ins = [torch.tensor(a, requires_grad=True) for a in (img, txt, scale,
                                                         bias)]
    if neg:
        val = siglip._sigmoid_block_loss(*ins, negative_only=True)
    else:
        val = siglip.siglip_loss(*ins[:3], ins[3] if use_bias else None)
        j_full = jax.jit(lambda *a: jsiglip.siglip_loss(
            *a[:3], a[3] if use_bias else None))(img, txt, scale, bias)
        np.testing.assert_allclose(val.item(), float(j_full), rtol=1e-5)
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-5,
                               atol=1e-5)
    val.backward()
    for t, g in zip(ins, j_grads):
        got = np.zeros_like(np.asarray(g)) if t.grad is None else _np(t.grad)
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-5, atol=1e-5)
    if not use_bias:
        assert ins[3].grad is None


def test_siglip_loss_surface_is_the_local_loss():
    img, txt, scale, bias = (torch.from_numpy(np.asarray(a))
                             for a in _loss_inputs(9))
    want = siglip.siglip_loss(img, txt, scale, bias)
    for impl in siglip.DIST_IMPLS:
        loss = SigLipLoss(dist_impl=impl)
        assert torch.equal(loss(img, txt, scale, bias), want)
        assert torch.equal(loss(img, txt, scale, bias, output_dict=True)[
            "contrastive_loss"], want)
    assert SigLipLoss().dist_impl == "bidir"
    with pytest.raises(ValueError, match="dist_impl"):
        SigLipLoss(dist_impl="ring")
    # across ranks the ring runs (tests/test_torch_siglip_ring.py)
    ring = SigLipLoss(world_size=2, rank=1)
    assert (ring.world_size, ring.rank) == (2, 1)


def test_create_loss_picks_siglip_in_jax_order():
    from xtagclip_tpu.factory import create_loss as j_create_loss
    from xtagclip_tpu_torch.losses import ClipLoss, DistillClipLoss

    for flags, kind in ((["--siglip"], SigLipLoss),
                        (["--siglip", "--distill-model", "RN50"],
                         DistillClipLoss),
                        ([], ClipLoss)):
        args = parse_args(["--model", "ViT-B-32", *flags])
        loss = factory.create_loss(args)
        assert type(loss) is kind
        assert type(j_create_loss(args)).__name__ == kind.__name__
    loss = factory.create_loss(parse_args(["--siglip", "--loss-dist-impl",
                                           "gather"]))
    assert loss.dist_impl == "gather"


# -- the toy SigLIP model --------------------------------------------------------

@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    name = _register(tmp_path_factory, "torch-tinysiglip", TOY)
    bundle = jax_create_model(name)
    rng = np.random.default_rng(11)
    # non-trivial values where the init is zeros or ones, the bias as SigLIP's
    params = jax.tree.map(
        lambda v: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(
            np.float32), bundle.params)
    params["logit_bias"] = np.float32(-3.0)
    return name, bundle, params


def _port(name, params):
    model = factory.create_model(name, device="cpu", init_seed=1)
    load_jax_params(model, params)
    return model


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((b, SIDE, SIDE, 3)).astype(
                np.float32),
            "texts": rng.integers(1, VOCAB, (b, CTX)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def test_forward_and_logits_with_bias_match_jax(toy):
    name, bundle, params = toy
    model = _port(name, params)
    assert model.logit_bias is not None
    assert model.text.transformer.resblocks[0].route((4, CTX, 144)) == \
        "non_fused"
    batch = _batch(1)
    j_out = jax.jit(lambda p, i, t: bundle.module.apply(
        {"params": p}, i, text=t))(params, batch["images"], batch["texts"])
    j_logits = jax.jit(lambda p, i, t: bundle.module.apply(
        {"params": p}, i, t, method=bundle.module.get_logits))(
            params, batch["images"], batch["texts"])
    b = _torch_batch(batch)
    with torch.no_grad():
        out = model(b["images"], text=b["texts"])
        logits = model.get_logits(b["images"], b["texts"])
    for k in ("image_features", "text_features", "logit_scale", "logit_bias"):
        np.testing.assert_allclose(_np(out[k]), np.asarray(j_out[k]), **TOL,
                                   err_msg=k)
    for got, want in zip(logits, j_logits):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # the bias enters the logits
    np.testing.assert_allclose(
        _np(logits[0]) - _np(logits[1]).T, 0.0, atol=0.0)
    assert float(np.asarray(j_logits[0]).mean()) < 0


def test_plain_step_loss_and_grads_match_jax(toy):
    """The SigLIP branch of the plain step: loss and every gradient
    against jax.grad of JAX's ``_model_losses``; logit_bias's gradient is
    nonzero."""
    name, bundle, params = toy
    model = _port(name, params)
    batch = _batch(2)

    def j_total(p):
        return jloop._model_losses(
            bundle.module, p, {k: jnp.asarray(v) for k, v in batch.items()},
            {"dropout": jax.random.PRNGKey(0)}, SIGLIP, None)

    (j_val, (j_metrics, _)), j_grads = jax.jit(
        jax.value_and_grad(j_total, has_aux=True))(params)
    model.zero_grad(set_to_none=True)
    total, metrics = _model_losses(model, _torch_batch(batch), SIGLIP,
                                   generator=torch.Generator().manual_seed(0))
    total.backward()
    np.testing.assert_allclose(total.item(), float(j_val), **TOL)
    for k in ("contrastive_loss", "logit_scale"):
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   **TOL, err_msg=k)
    grads = {n: p.grad for n, p in model.named_parameters()}
    for n, g in _flat(j_grads).items():
        got = np.zeros_like(g) if grads[n] is None else _np(grads[n])
        err = np.abs(got - g).max() / max(1.0, np.abs(g).max())
        assert err <= 1e-3, (n, err)
    assert abs(model.logit_bias.grad.item()) > 1e-3


def _steps(toy, accum):
    """One step of JAX's and of the port's step (accumulation with
    ``accum`` > 0) from the same weights and batch: AdamW at eps 1e3, so
    that each update is the gradient scaled; dropout off in the port (the
    toy model's dropout-free towers make JAX's masks irrelevant)."""
    name, bundle, params = toy
    lr, eps = 1.0, 1e3
    batch = _batch(3, b=6)
    j_tx = jts.make_optimizer(jsched.const_lr(lr, 0, 10), eps=eps,
                              weight_decay=0.0, params=params)
    j_state = jts.create_train_state(jax.tree.map(jnp.asarray, params), j_tx)
    model = _port(name, params)
    named = dict(model.named_parameters())
    state = ts.create_train_state(model, ts.make_optimizer(
        scheduler.const_lr(lr, 0, 10), eps=eps, weight_decay=0.0,
        params=named))
    if accum:
        split = {k: v.reshape((accum, -1) + v.shape[1:])
                 for k, v in batch.items()}
        j_step = jloop.make_accum_train_step(bundle.module, j_tx, SIGLIP,
                                             accum, donate=False)
        j_new, j_metrics = j_step(j_state, {k: jnp.asarray(v) for k, v
                                            in split.items()},
                                  jax.random.PRNGKey(0))
        step = make_accum_train_step(SIGLIP, accum, deterministic=True)
        state, metrics = step(state, _torch_batch(split), None)
    else:
        j_step = jloop.make_train_step(bundle.module, j_tx, SIGLIP,
                                       donate=False)
        j_new, j_metrics = j_step(j_state, {k: jnp.asarray(v) for k, v
                                            in batch.items()},
                                  jax.random.PRNGKey(0))
        state, metrics = make_train_step(SIGLIP)(
            state, _torch_batch(batch), torch.Generator().manual_seed(0))
    return params, _flat(j_new.params), j_metrics, named, metrics


@pytest.mark.parametrize("accum", [0, 2], ids=["plain", "accum"])
def test_step_matches_jax(toy, accum):
    """``make_train_step`` / ``make_accum_train_step`` with
    ``{"siglip": True}`` against JAX's: the metrics, and each parameter's
    update (the gradient, scaled) at 1e-3; logit_bias moves."""
    params, after, j_metrics, named, metrics = _steps(toy, accum)
    for k in ("contrastive_loss", "loss", "logit_scale"):
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   **TOL, err_msg=k)
    before = _flat(params)
    for n, p in named.items():
        d_jax = after[n] - before[n]
        d_port = p.detach().numpy() - before[n]
        if not np.any(d_jax):
            assert not np.any(d_port), n
            continue
        err = np.linalg.norm(d_port - d_jax) / np.linalg.norm(d_jax)
        assert err <= 1e-3, (n, err)
    assert named["logit_bias"].item() != before["logit_bias"]


# -- kernel #4 at a hidden width that is a multiple of 8 -------------------------

def test_fused_mlp_takes_multiples_of_eight():
    """#4 takes SO400M's text MLP (1152 -> 4304) and any hidden width that
    is a multiple of 8; a width that is not (4300) or a D that is not has
    no kernel, and on the card raises."""
    assert fused_mlp.supported((4, 16, 1152), 4304, "gelu")
    assert fused_mlp.supported((4, 16, 144), 360, "quick_gelu")
    assert not fused_mlp.supported((4, 16, 1152), 4300, "gelu")
    assert not fused_mlp.supported((4, 16, 1150), 4304, "gelu")
    assert not fused_mlp.supported((4, 16, 1152), 4304, "gelu",
                                   torch.float16)
    from xtagclip_tpu_torch.ops import fused_attn_block as fab

    assert not fab.supported_mlp((4, 16, 1152), 4304, "gelu")  # #2 keeps 64
    blk = ResidualAttentionBlock(1152, 16, mlp_ratio=3.7362)
    assert blk.mlp.c_fc.kernel.shape[1] == 4304
    assert blk.route((4, 16, 1152)) == "non_fused"


@pytest.mark.parametrize("bf16", [False, True])
def test_text_block_at_ragged_mlp_width_matches_jax(bf16):
    """A SigLIP text block (no mask, head dim 72, eps 1e-6) whose MLP is
    360 wide: the port's non-fused route (flash attention and #4, their
    plain versions on the CPU) against JAX's block: fp32 at 1e-5 of the
    output scale, bf16 at one ULP at output scale."""
    d, h, ratio = 144, 2, 2.5
    rng = np.random.default_rng(21 + bf16)
    x = rng.standard_normal((3, CTX, d)).astype(np.float32)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    jblk = JBlock(num_heads=h, mlp_ratio=ratio, norm_eps=1e-6, dtype=dt)
    xj = jnp.asarray(x, dt)
    params = jax.jit(jblk.init)(jax.random.PRNGKey(0), xj)["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
            np.float32), params)
    ref = np.asarray(jax.jit(jblk.apply)({"params": params}, xj), np.float32)
    blk = ResidualAttentionBlock(d, h, mlp_ratio=ratio, norm_eps=1e-6)
    load_jax_params(blk, params)
    assert blk.mlp.c_fc.kernel.shape[1] == 360
    assert blk.route(x.shape) == "non_fused"
    with torch.no_grad():
        out = blk(torch.from_numpy(x).to(torch.bfloat16 if bf16
                                         else torch.float32))
    if bf16:
        np.testing.assert_allclose(_np(out), ref, rtol=1e-2,
                                   atol=float(np.abs(ref).max()) / 128)
    else:
        np.testing.assert_allclose(_np(out), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))


# -- the shipped configs and the CLI ------------------------------------------------

@pytest.mark.parametrize("name,params_m,text_route", [
    ("ViT-B-16-SigLIP", 217.37, ("fused_halves", (256, 64, 768))),
    ("ViT-SO400M-14-SigLIP", 892.75, ("non_fused", (64, 16, 1152)))])
def test_shipped_siglip_configs(name, params_m, text_route):
    """Both SigLIP configs build (meta device) at JAX's sizes, with a
    logit bias of -10; the B-16 text tower takes the fused halves (#1, #2,
    #3), SO400M's flash attention (dh 72) and #4 at 1152 -> 4304."""
    model = factory.create_model(name, device="meta", skip_init=True)
    n = sum(p.numel() for p in model.parameters())
    assert round(n / 1e6, 2) == params_m
    assert model.logit_bias is not None
    assert model.model_cfg["init_logit_bias"] == -10
    route, shape = text_route
    blk = model.text.transformer.resblocks[0]
    assert blk.route(shape) == route
    assert fused_mlp.supported(shape, blk.mlp.c_fc.kernel.shape[1],
                               blk.act)


def test_cli_main_trains_siglip(tmp_path, tmp_path_factory):
    """``cli.main --siglip --device cpu`` on synthetic data (the toy
    config with the BPE vocabulary: the synthetic captions are BPE ids):
    finite losses, the bias trained; ``--loss-dist-impl`` accepted."""
    cfg = json.loads(json.dumps(TOY))
    cfg["text_cfg"]["vocab_size"] = 49408
    name = _register(tmp_path_factory, "torch-tinysiglip-cli", cfg)
    try:
        out = port_main.main([
            "--model", name, "--siglip", "--loss-dist-impl", "bidir",
            "--dataset-type", "synthetic", "--train-num-samples", "8",
            "--batch-size", "4", "--epochs", "1", "--warmup", "1",
            "--lr", "1e-3", "--precision", "fp32", "--workers", "1",
            "--device", "cpu", "--logs", str(tmp_path / "logs"),
            "--name", "siglip", "--log-every-n-steps", "1"])
    finally:
        close_logging()
    train = out["epochs"][0]["train"]
    assert math.isfinite(train["loss"]) and math.isfinite(train["grad_norm"])
    bias = out["state"].model.logit_bias.item()
    assert bias != -10.0
