"""Distillation in the PyTorch port against the JAX package (CPU, toy
geometry).

- ``distill_loss`` and ``DistillClipLoss``: values and the gradients with
  respect to the student's features and scale against JAX's, fp32.
- The plain step with a teacher: the loss (contrastive + distillation),
  ``distill_loss`` and every student gradient against jax.grad of JAX's
  ``_model_losses(teacher=...)``, and one step against JAX's
  ``make_train_step(teacher=...)`` (metrics and each parameter's update),
  at 1e-3; the teacher gets no gradient and does not move.
- ``cli.main --device cpu --distill-model ... --distill-pretrained <.pt>``
  on synthetic data, the teacher loaded from a ``.pt`` the port's exporter
  wrote in the test; ``--accum-freq 2`` drops the distillation with JAX's
  warning; a named ``--distill-pretrained`` tag the registry lacks for the
  teacher raises as JAX's resolver does.

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
from xtagclip_tpu.losses import distill as jdistill  # noqa: E402
from xtagclip_tpu.train import loop as jloop  # noqa: E402
from xtagclip_tpu.train import scheduler as jsched  # noqa: E402
from xtagclip_tpu.train import train_state as jts  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.cli import main as port_main  # noqa: E402
from xtagclip_tpu_torch.convert.export import save_open_clip_checkpoint  # noqa: E402
from xtagclip_tpu_torch.convert.from_jax import load_jax_params, port_name  # noqa: E402
from xtagclip_tpu_torch.losses import DistillClipLoss, distill_loss  # noqa: E402
from xtagclip_tpu_torch.train import scheduler  # noqa: E402
from xtagclip_tpu_torch.train import train_state as ts  # noqa: E402
from xtagclip_tpu_torch.train.logger import close_logging  # noqa: E402
from xtagclip_tpu_torch.train.loop import _model_losses, make_train_step  # noqa: E402
from xtagclip_tpu_torch.train.params import parse_args, unported  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)
ARGS = {"use_tagging_loss": False}
CTX, SIDE = 16, 16
# the vanilla CLI's distillation test geometry (tests/test_cli_distill.py):
# a one-block student, and a wider two-block teacher of another embed dim
STUDENT = dict(
    embed_dim=64,
    vision_cfg=dict(layers=1, width=64, head_width=32, patch_size=8,
                    image_size=SIDE),
    text_cfg=dict(context_length=CTX, vocab_size=49408, width=64, heads=2,
                  layers=1),
)
TEACHER = dict(
    embed_dim=48,
    vision_cfg=dict(layers=2, width=96, head_width=32, patch_size=8,
                    image_size=SIDE),
    text_cfg=dict(context_length=CTX, vocab_size=49408, width=96, heads=2,
                  layers=2),
)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {port_name(".".join(str(getattr(k, "key", k)) for k in path)):
            np.asarray(v) for path, v in leaves}


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(
            np.float32), params)


# -- the loss ------------------------------------------------------------------

def _features(seed, b=5):
    rng = np.random.default_rng(seed)
    out = []
    for e in (16, 16, 12, 12):
        f = rng.standard_normal((b, e)).astype(np.float32)
        out.append(f / np.linalg.norm(f, axis=1, keepdims=True))
    return out[0], out[1], np.float32(14.0), out[2], out[3], np.float32(20.0)


def test_distill_loss_matches_jax():
    ins = _features(1)
    j_val, j_grads = jax.jit(jax.value_and_grad(
        jdistill.distill_loss, argnums=(0, 1, 2)))(*ins)
    t_ins = [torch.tensor(a, requires_grad=i < 3) for i, a in enumerate(ins)]
    val = distill_loss(*t_ins)
    val.backward()
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-5)
    for t, g in zip(t_ins[:3], j_grads):
        np.testing.assert_allclose(_np(t.grad), np.asarray(g), rtol=1e-5,
                                   atol=1e-6)
    assert all(t.grad is None for t in t_ins[3:])


def test_distill_clip_loss_matches_jax():
    ins = _features(2)
    j_out = jax.jit(lambda *a: jdistill.DistillClipLoss()(
        *a, output_dict=True))(*ins)
    t_ins = [torch.from_numpy(np.asarray(a)) for a in ins]
    out = DistillClipLoss()(*t_ins, output_dict=True)
    pair = DistillClipLoss()(*t_ins)
    assert set(out) == set(j_out) == {"contrastive_loss", "distill_loss"}
    for k in out:
        np.testing.assert_allclose(out[k].item(), float(j_out[k]),
                                   rtol=1e-5, err_msg=k)
    assert torch.equal(pair[0], out["contrastive_loss"])
    assert torch.equal(pair[1], out["distill_loss"])
    # across ranks the features are gathered (tests/test_torch_dist.py)
    gathered = DistillClipLoss(world_size=2, rank=1)
    assert (gathered.world_size, gathered.rank) == (2, 1)


# -- the step with a teacher ----------------------------------------------------

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(student name, JAX student bundle and weights, teacher name, JAX
    teacher bundle and weights)."""
    out = []
    for name, cfg, seed in (("torch-distill-student", STUDENT, 1),
                            ("torch-distill-teacher", TEACHER, 2)):
        path = tmp_path_factory.mktemp("cfg") / f"{name}.json"
        path.write_text(json.dumps(cfg))
        jax_add_model_config(str(path))
        factory.add_model_config(path)
        bundle = jax_create_model(name, init_seed=seed)
        out += [name, bundle, _perturbed(bundle.params, seed)]
    return out


def _batch(seed, b=6):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((b, SIDE, SIDE, 3)).astype(
                np.float32),
            "texts": rng.integers(1, 1000, (b, CTX)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _port(name, params):
    model = factory.create_model(name, device="cpu")
    load_jax_params(model, params)
    return model


def _port_teacher(name, params):
    teacher = _port(name, params)
    teacher.requires_grad_(False)
    return teacher


def test_losses_and_student_grads_match_jax(models):
    s_name, s_bundle, s_params, t_name, t_bundle, t_params = models
    batch = _batch(3)

    def j_total(p):
        return jloop._model_losses(
            s_bundle.module, p, {k: jnp.asarray(v) for k, v in batch.items()},
            {"dropout": jax.random.PRNGKey(0)}, ARGS, None,
            teacher=(t_bundle.module, {"params": t_params}))

    (j_val, (j_metrics, _)), j_grads = jax.jit(
        jax.value_and_grad(j_total, has_aux=True))(s_params)
    student = _port(s_name, s_params)
    teacher = _port(t_name, t_params)  # trainable: no_grad alone keeps it
    total, metrics = _model_losses(student, _torch_batch(batch), ARGS,
                                   generator=torch.Generator().manual_seed(0),
                                   teacher=teacher)
    total.backward()
    np.testing.assert_allclose(total.item(), float(j_val), **TOL)
    for k in ("contrastive_loss", "distill_loss", "loss", "logit_scale"):
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   **TOL, err_msg=k)
    assert metrics["loss"].item() == pytest.approx(
        metrics["contrastive_loss"].item() + metrics["distill_loss"].item(),
        rel=1e-6)
    grads = {n: p.grad for n, p in student.named_parameters()}
    for n, g in _flat(j_grads).items():
        got = np.zeros_like(g) if grads[n] is None else _np(grads[n])
        err = np.abs(got - g).max() / max(1.0, np.abs(g).max())
        assert err <= 1e-3, (n, err)
    assert all(p.grad is None for p in teacher.parameters())


def test_train_step_with_teacher_matches_jax(models):
    """One step of ``make_train_step(teacher=...)`` against JAX's, AdamW
    at eps 1e3 (each update the gradient, scaled): the metrics and every
    student parameter's update at 1e-3; the teacher's weights unchanged
    and without gradient."""
    s_name, s_bundle, s_params, t_name, t_bundle, t_params = models
    lr, eps = 1.0, 1e3
    batch = _batch(4)
    j_tx = jts.make_optimizer(jsched.const_lr(lr, 0, 10), eps=eps,
                              weight_decay=0.0, params=s_params)
    j_step = jloop.make_train_step(
        s_bundle.module, j_tx, ARGS, donate=False,
        teacher=(t_bundle.module, {"params": t_params}))
    j_new, j_metrics = j_step(
        jts.create_train_state(jax.tree.map(jnp.asarray, s_params), j_tx),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    student = _port(s_name, s_params)
    teacher = _port_teacher(t_name, t_params)
    t_before = {n: p.clone() for n, p in teacher.named_parameters()}
    named = dict(student.named_parameters())
    state = ts.create_train_state(student, ts.make_optimizer(
        scheduler.const_lr(lr, 0, 10), eps=eps, weight_decay=0.0,
        params=named))
    state, metrics = make_train_step(ARGS, teacher=teacher)(
        state, _torch_batch(batch), torch.Generator().manual_seed(0))
    for k in ("contrastive_loss", "distill_loss", "loss", "logit_scale",
              "grad_norm"):
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   **TOL, err_msg=k)
    before, after = _flat(s_params), _flat(j_new.params)
    for n, p in named.items():
        d_jax = after[n] - before[n]
        d_port = p.detach().numpy() - before[n]
        if not np.any(d_jax):
            assert not np.any(d_port), n
            continue
        err = np.linalg.norm(d_port - d_jax) / np.linalg.norm(d_jax)
        assert err <= 1e-3, (n, err)
    for n, p in teacher.named_parameters():
        assert p.grad is None and torch.equal(p, t_before[n]), n


# -- the CLI ------------------------------------------------------------------------

def _cli(tmp_path, s_name, t_name, pt, *extra):
    try:
        return port_main.main([
            "--model", s_name, "--distill-model", t_name,
            "--distill-pretrained", pt, "--dataset-type", "synthetic",
            "--train-num-samples", "16", "--batch-size", "4", "--epochs",
            "1", "--warmup", "1", "--lr", "1e-4", "--precision", "fp32",
            "--workers", "1", "--device", "cpu", "--logs",
            str(tmp_path / "logs"), "--name", "distill",
            "--log-every-n-steps", "1", *extra])
    finally:
        close_logging()


@pytest.fixture
def teacher_pt(models, tmp_path):
    """The teacher's weights as an open_clip .pt from the port's exporter."""
    _, _, _, t_name, _, t_params = models
    teacher = _port(t_name, t_params)
    return teacher, save_open_clip_checkpoint(teacher,
                                              str(tmp_path / "teacher.pt"))


def test_cli_main_distills_from_an_exported_teacher(models, teacher_pt,
                                                    tmp_path):
    s_name, _, _, t_name, _, _ = models
    teacher, pt = teacher_pt
    args = parse_args(["--model", s_name, "--distill-model", t_name,
                       "--distill-pretrained", pt, "--precision", "fp32",
                       "--device", "cpu"], include_xtag=False)
    assert unported(args) == []
    loaded = port_main._teacher(args, None)
    want = dict(teacher.named_parameters())
    for n, p in loaded.named_parameters():
        assert not p.requires_grad and torch.equal(p, want[n]), n
    out = _cli(tmp_path, s_name, t_name, pt)
    train = out["epochs"][0]["train"]
    assert math.isfinite(train["distill_loss"])
    assert train["loss"] > train["contrastive_loss"]


def test_cli_accum_freq_drops_the_distillation(models, teacher_pt, tmp_path):
    s_name, _, _, t_name, _, _ = models
    _, pt = teacher_pt
    out = _cli(tmp_path, s_name, t_name, pt, "--accum-freq", "2")
    assert "distill_loss" not in out["epochs"][0]["train"]
    log = (tmp_path / "logs" / "distill" / "out.log").read_text()
    assert ("--distill-model is not supported with --accum-freq > 1 "
            "(feature-cache replay path); distillation disabled.") in log


def test_named_distill_pretrained_tag_raises_before_the_model(models,
                                                             tmp_path):
    """A named ``--distill-pretrained`` tag resolves through the registry,
    as ``--pretrained`` does (ROADMAP Queue 1 item 9, ported); the toy
    teacher has no ``openai`` tag there, so the CLI raises as JAX's
    resolver does, naming the tag and the model, before the first step."""
    s_name, _, _, t_name, _, _ = models
    with pytest.raises(FileNotFoundError,
                       match=f"no pretrained tag 'openai' for model "
                             f"'{t_name}'"):
        _cli(tmp_path, s_name, t_name, "openai")
    assert not list((tmp_path / "logs").rglob("state.pt"))
