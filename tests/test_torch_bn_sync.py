"""BatchNorm statistics across ranks in the port (gloo, on the CPU): a
toy RN CLIP's train step on 2 ranks, with and without ``--use-bn-sync``,
against the one-process step on the concatenated batch (JAX's
tests/test_bn_sync.py: JAX's one program takes the global batch's
statistics either way), and ``--lock-image-freeze-bn-stats`` keeping
them.

One spawn runs the four cases on 2 ranks under DDP; the one-process
steps run here. Bars: running statistics within 1e-6 (absolute; they are
O(1)), loss and gradient norm within 1e-5 relative, the updated
parameters' fingerprint within 1e-6 relative.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_dist_worker as w  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

CASES = [(sync, freeze) for sync in (False, True) for freeze in (False, True)]
IDS = [f"sync{int(s)}-freeze{int(f)}" for s, f in CASES]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("bn"))
    init = w.rn_init(directory)
    batch = w.rn_batch()
    ranks = w.spawn("bn", 2, directory, {"init": init, "batch": batch})
    local = {**batch, "dir": directory}
    ref = {freeze: w.bn_step(init, local, False, freeze)
           for freeze in (False, True)}
    return {"ranks": ranks, "ref": ref, "init": init}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_statistics_are_the_global_batch(run, case):
    sync, freeze = case
    ref = run["ref"][freeze]["stats"]
    assert ref
    for rank in run["ranks"]:
        got = rank[case]["stats"]
        for k, v in ref.items():
            assert (got[k] - v).abs().max().item() <= 1e-6, k


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_step_matches_one_process(run, case):
    sync, freeze = case
    ref = run["ref"][freeze]
    for rank in run["ranks"]:
        got = rank[case]
        errs = w.metric_errors(got["metrics"], ref["metrics"])
        assert max(errs.values()) <= 1e-5, errs
        a, r = w.fingerprint(got["params"]), w.fingerprint(ref["params"])
        assert abs(a - r) <= 1e-6 * r


@pytest.mark.parametrize("sync", [False, True])
def test_frozen_statistics_stay(run, sync):
    for rank in run["ranks"]:
        for k, v in rank[(sync, True)]["stats"].items():
            assert torch.equal(v, run["init"][k]), k


@pytest.mark.parametrize("sync", [False, True])
def test_statistics_move_and_the_flag_is_recorded(run, sync):
    got = run["ranks"][0][(sync, False)]
    assert any(not torch.equal(v, run["init"][k])
               for k, v in got["stats"].items())
    assert got["sync"] and all(s == sync for s in got["sync"])
