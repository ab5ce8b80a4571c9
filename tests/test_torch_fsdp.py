"""``--fsdp`` in the port: FSDP2 across 2 ranks (gloo, on the CPU) against
DDP and the one-process step on the concatenated batch, for each
``--opt``, with the accumulation step, and an FSDP checkpoint resumed at
2 ranks and at 1; and ``param_partition_spec`` against JAX's rule.

One spawn of tests/torch_dist_worker.py runs every case on the 2 ranks;
the one-process steps run here. The model is the tests/test_torch_train.py
geometry with tagging and fusion, deterministic. Bars
(tests/test_torch_dp.py's): metrics within 1e-5 relative, the updated
parameters' fingerprint within 1e-6 relative, each gradient within 1e-6
in cosine (or zero in exact arithmetic in both); a resumed checkpoint
bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_dist_worker as w  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401
from xtagclip_tpu.parallel import sharding as jax_sharding
from xtagclip_tpu_torch.parallel import sharding

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    directory = tmp_path_factory.mktemp("fsdp")
    init = w.init_state_dict(directory)
    batch = w.global_batch()
    ranks = w.spawn("fsdp", 2, directory, {"init": init, "batch": batch},
                    timeout=300)
    ref = {opt: w.xtag_step(init, batch, opt=opt) for opt in w.OPTS}
    ref["accum"] = w.xtag_step(init, batch, accum=2)
    return {"ranks": ranks, "ref": ref, "init": init}


def _check(got, ref):
    errs = w.metric_errors(got["metrics"], ref["metrics"])
    assert max(errs.values()) <= 1e-5, errs
    a, r = w.fingerprint(got["params"]), w.fingerprint(ref["params"])
    assert abs(a - r) <= 1e-6 * r, (a, r)
    norm = float(sum(g.double().square().sum()
                     for g in ref["grads"].values()) ** 0.5)
    gerr = w.grad_errors(got["grads"], ref["grads"], norm)
    worst = max(gerr, key=gerr.get)
    assert gerr[worst] <= 1e-6, (worst, gerr[worst])


@pytest.mark.parametrize("fsdp", [False, True], ids=["ddp", "fsdp"])
@pytest.mark.parametrize("opt", w.OPTS)
def test_step_matches_one_process(run, opt, fsdp):
    for rank in run["ranks"]:
        _check(rank[(opt, fsdp)], run["ref"][opt])


@pytest.mark.parametrize("opt", w.OPTS)
def test_fsdp_step_matches_ddp(run, opt):
    for rank in run["ranks"]:
        _check(rank[(opt, True)], rank[(opt, False)])


def test_fsdp_accumulation_step_matches_one_process(run):
    for rank in run["ranks"]:
        _check(rank["accum"], run["ref"]["accum"])


def test_fsdp_shards_on_jax_dims(run):
    """Each parameter is a DTensor sharded on the port dim of the JAX dim
    that JAX's rule names at FSDP size 2, else on dim 0; the 0-dim logit
    scales stay whole."""
    placements = run["ranks"][0][("adamw", True)]["placements"]
    for name, value in run["init"].items():
        if name not in placements:
            continue  # a buffer
        if value.dim() == 0:
            assert placements[name] is None, name
            continue
        d = sharding.fsdp_dim(name, value, 2)
        assert placements[name] == (0 if d is None else d), name
    assert any(d not in (None, 0) for d in placements.values())


def test_checkpoint_resumes_at_two_ranks(run):
    for rank in run["ranks"]:
        c = rank["checkpoint"]
        assert c["epoch"] == 0
        for k in c["saved"]:
            assert torch.equal(c["restored"][k], c["saved"][k]), k
            assert torch.equal(c["resumed"][k], c["straight"][k]), k


def test_checkpoint_resumes_at_one_rank(run):
    c = run["ranks"][0]["checkpoint"]
    for k in c["saved"]:
        assert torch.equal(c["one_rank"][k], c["saved"][k]), k
    moments = c["one_rank_moments"]
    assert moments and all(torch.is_tensor(s["exp_avg"])
                           and not sharding.is_sharded(s["exp_avg"])
                           for s in moments.values())


SHAPES = [(768, 3072), (3072, 768), (512, 512), (64, 1024), (1000, 7),
          (3, 3, 64, 128), (16, 16, 3, 768), (49408, 512), (1024,), (4096,),
          (77, 512), (256, 256), (255, 257), (8,)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("model_size,fsdp_size", [(1, 1), (1, 2), (1, 8),
                                                  (2, 1), (2, 4), (4, 2)])
def test_partition_spec_is_jax_rule(shape, model_size, fsdp_size):
    leaf = np.zeros(shape, np.float32)
    want = tuple(jax_sharding.param_partition_spec((), leaf, model_size,
                                                   fsdp_size))
    want = want + (None,) * (len(shape) - len(want))
    assert sharding.param_partition_spec("x", shape, model_size,
                                         fsdp_size) == want
