"""The port's data-parallel XTag step across 2 ranks (DDP over gloo, on
the CPU) against the one-process step on the concatenated batch, and
against JAX's loss on that batch.

The 2 ranks run in one spawn of tests/torch_dist_worker.py (torch and the
port only); the one-process step runs here. The model is the
tests/test_torch_train.py geometry with tagging and fusion, on JAX's
initial weights (``load_jax_params``), deterministic (dropout off), so
that the step's DQNCOS over the global [B, B] fusion matrices, ASL's sum
over the global batch and the contrastive loss over gathered features
are all held. Bars, as JAX's tests/test_multiprocess.py holds its
2-process step: loss, contrastive loss and gradient norm within 1e-5
relative, the updated parameters' fingerprint (sum |p|) within 1e-6
relative; each gradient within 1e-6 of the one-process one in cosine
(or, zero in exact arithmetic, below 1e-6 of the global norm in both);
JAX's loss within 1e-3. At world size 1 the DDP step is the step without
a process group, bit for bit.
"""

import datetime
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(__file__))

import torch_dist_worker as w  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401
from xtagclip_tpu.factory import add_model_config as jax_add_model_config
from xtagclip_tpu.factory import create_model as jax_create_model
from xtagclip_tpu.losses import asymmetric_loss as j_asl
from xtagclip_tpu.losses import clip_loss as j_clip_loss
from xtagclip_tpu.losses import dqncos_loss as j_dqncos
from xtagclip_tpu_torch import factory
from xtagclip_tpu_torch.convert.from_jax import load_jax_params

torch.set_num_threads(1)

CASES = ("plain", "accum")
METRICS = {"plain": ("loss", "contrastive_loss", "tagging_loss", "ce_loss",
                     "grad_norm", "logit_scale"),
           "accum": ("loss", "contrastive_loss", "tagging_loss",
                     "logit_scale")}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    directory = tmp_path_factory.mktemp("dp")
    cfg_path = os.path.join(str(directory), w.CFG_NAME + ".json")
    with open(cfg_path, "w") as f:
        json.dump(w.CFG, f)
    jax_add_model_config(cfg_path)
    w.register(directory)
    bundle = jax_create_model(w.CFG_NAME, use_tagging=True, use_fusion=True)
    jparams = jax.tree.map(np.asarray, bundle.params)
    model = factory.create_model(w.CFG_NAME, device="cpu", precision="fp32",
                                 use_tagging=True, use_fusion=True)
    load_jax_params(model, jparams)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = w.global_batch()
    ranks = w.spawn("dp", 2, directory, {"init": init, "batch": batch})
    ref = {"plain": w.xtag_step(init, batch),
           "accum": w.xtag_step(init, batch, accum=2)}
    out = bundle.module.apply(
        {"params": jax.tree.map(jnp.asarray, jparams)},
        jnp.asarray(batch["images"]),
        prompt_table=jnp.asarray(batch["table"]),
        class_ids=jnp.asarray(batch["class_ids"]), template_id=0,
        deterministic=True)
    jax_loss = (j_clip_loss(out["image_features"], out["text_features"],
                            out["logit_scale"])
                + 2.0 * j_asl(out["tag_logits"],
                              jnp.tile(jnp.asarray(batch["additional"]),
                                       (1, 2)), 4, 1, 0.05)
                + 2.0 * (j_dqncos(out["i2t_cls"]) + j_dqncos(out["t2i_cls"])))
    return {"ranks": ranks, "ref": ref, "init": init, "batch": batch,
            "jax_loss": float(jax_loss), "dir": directory}


@pytest.mark.parametrize("case,metric", [(c, m) for c in CASES
                                         for m in METRICS[c]])
def test_two_rank_metric_matches_one_process(run, case, metric):
    for rank in run["ranks"]:
        err = w.metric_errors(rank[case]["metrics"],
                              run["ref"][case]["metrics"])[metric]
        assert err <= 1e-5, (metric, err)


@pytest.mark.parametrize("case", CASES)
def test_two_rank_update_matches_one_process(run, case):
    ref = run["ref"][case]
    for rank in run["ranks"]:
        got = rank[case]
        a, r = w.fingerprint(got["params"]), w.fingerprint(ref["params"])
        assert abs(a - r) <= 1e-6 * r
        norm = float(sum(g.double().square().sum()
                         for g in ref["grads"].values()) ** 0.5)
        errs = w.grad_errors(got["grads"], ref["grads"], norm)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-6, (worst, errs[worst])
        assert set(got["grads"]) == set(ref["grads"])


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_the_same_update(run, case):
    a, b = (r[case] for r in run["ranks"])
    assert a["metrics"] == b["metrics"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


@pytest.mark.parametrize("case", CASES)
def test_parameter_without_gradient_stays(run, case):
    """TQN's logit_scale (kept for checkpoint parity) gets no gradient:
    DDP finds it unused, the optimizer counts its gradient as zero, as
    JAX's does, and it keeps its value on every rank."""
    name = "fusion_model.logit_scale"
    for rank in run["ranks"]:
        assert not rank[case]["grads"][name].any()
        assert torch.equal(rank[case]["params"][name], run["init"][name])


def test_two_rank_loss_matches_jax_on_the_global_batch(run):
    want = run["jax_loss"]
    for rank in run["ranks"]:
        got = rank["plain"]["metrics"]["loss"]
        assert abs(got - want) <= 1e-3 * abs(want), (got, want)


@pytest.mark.parametrize("case", CASES)
def test_world_one_ddp_step_is_the_step_without_a_group(run, case, tmp_path):
    """DDP at world size 1 (what ``torchrun --nproc_per_node 1`` runs):
    the same metrics and parameters, bit for bit."""
    dist.init_process_group(
        "gloo", init_method="file://" + str(tmp_path / "rdv"), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        got = w.xtag_step(run["init"], run["batch"],
                          accum=2 if case == "accum" else 1)
    finally:
        dist.destroy_process_group()
    ref = run["ref"][case]
    assert got["metrics"] == ref["metrics"]
    for k in ref["params"]:
        assert torch.equal(got["params"][k], ref["params"][k]), k
