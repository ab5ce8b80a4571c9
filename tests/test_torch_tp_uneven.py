"""``--model-parallel`` at a head count the model size does not divide:
each rank holds ``piece_sizes(heads, N)`` whole heads (6 heads over 4
ranks: 2, 2, 1, 1), the q, k and v columns, the out-projection rows and
the per-head tables cut on those head boundaries.

One (1 x 4) gloo spawn (tests/torch_tp_uneven_worker.py) runs the
contrastive step of a ``ResidualAttentionBlock`` toy with 6 heads of 64
(its text tower on the fused halves' partial modes, its vision tower on
the non-fused route), the same toy under ``--fsdp``, and a ViTamin toy
whose ``GeGluBlock`` has 6 heads of 16; it also restores a checkpoint
that one process wrote and steps on. Each is held to the one-process
step in fp32: the metrics within 1e-5 relative, the parameters'
fingerprint within 1e-6 relative, every gradient's cosine at least
0.99999 (or zero in exact arithmetic in both).
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_dist_worker as w  # noqa: E402
import torch_tp_uneven_worker as uw  # noqa: E402
import torch_tp_zoo_worker as zw  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401
from xtagclip_tpu_torch.parallel import sharding  # noqa: E402

torch.set_num_threads(1)

CASES = [("rab6", "rab6", {}), ("rab6_fsdp", "rab6", {"fsdp": True}),
         ("vitamin6", "vitamin6", {})]
RANK_HEADS = (2, 2, 1, 1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpuneven")
    uw.register(d)
    init = {kind: uw.init_state_dict(kind, d) for kind in uw.KINDS}
    batch = zw.global_batch()
    ckpt = str(d / "ckpt")
    written = uw.step("rab6", init["rab6"], batch, d, ckpt=ckpt)
    sub = d / "1x4"
    sub.mkdir()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            w.spawn, "uneven", 4, sub,
            {"model": 4, "init": init, "cfg_dir": str(d), "batch": batch,
             "cases": CASES, "resume": ckpt}, 300, uw.__file__)
        ref = {kind: uw.step(kind, init[kind], batch, d)
               for kind in uw.KINDS}
        ranks = ranks.result()
    return {"ranks": ranks, "ref": ref, "init": init, "written": written}


def _check(got, ref):
    errs = w.metric_errors(got["metrics"], ref["metrics"])
    assert max(errs.values()) <= 1e-5, errs
    a, r = w.fingerprint(got["params"]), w.fingerprint(ref["params"])
    assert abs(a - r) <= 1e-6 * r, (a, r)
    norm = float(sum(g.double().square().sum()
                     for g in ref["grads"].values()) ** 0.5)
    gerr = w.grad_errors(got["grads"], ref["grads"], norm)
    worst = max(gerr, key=gerr.get)
    assert gerr[worst] <= 1e-5, (worst, gerr[worst])
    assert set(got["grads"]) == set(ref["grads"])


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_step_at_1x4_matches_one_process(run, label):
    kind = label.split("_")[0]
    for rank in run["ranks"]:
        _check(rank[label], run["ref"][kind])


@pytest.mark.parametrize("kind", uw.KINDS)
def test_each_rank_holds_its_whole_heads(run, kind):
    """2, 2, 1, 1 heads a rank in every split block; the attention leaves'
    local widths are those heads' columns (q | k | v and the
    out-projection rows), never a part of a head."""
    for r, rank in enumerate(run["ranks"]):
        heads = rank["local_heads"][kind]
        assert heads and all(h == (RANK_HEADS[r],) * 2 or
                             h == (RANK_HEADS[r], None)
                             for h in heads.values()), heads
        local = rank[kind]["local_shape"]
        n = RANK_HEADS[r]
        if kind == "rab6":
            for tower in ("visual", "text"):
                pre = (f"{tower}.transformer.resblocks.0"
                       if tower == "visual" else "text.transformer.resblocks.0")
                assert local[f"{pre}.attn.in_proj.kernel"] == (
                    uw.WIDTH, 3 * 64 * n)
                assert local[f"{pre}.attn.out_proj.kernel"] == (64 * n,
                                                                uw.WIDTH)
                assert local[f"{pre}.mlp.c_fc.kernel"] == (uw.WIDTH,
                                                           uw.WIDTH)
        else:
            qkv = [k for k in local if k.endswith("qkv.kernel")]
            assert qkv and all(local[k] == (96, 3 * 16 * n) for k in qkv)


def test_ranks_hold_the_same_update(run):
    first = run["ranks"][0]
    for rank in run["ranks"][1:]:
        for label, *_ in CASES:
            for k, v in first[label]["params"].items():
                assert torch.equal(rank[label]["params"][k], v), (label, k)


def test_one_process_checkpoint_resumes_at_1x4(run):
    """A checkpoint of whole tensors written by one process restores at
    (1 x 4), every rank cutting its heads' pieces of the parameters and
    of the AdamW moments (``shard_optimizer_state``), and its next step
    equals the one-process run's straight through."""
    written = run["written"]
    for rank in run["ranks"]:
        got = rank["resume"]
        assert got["restored"] == written["params"]
        a, r = got["stepped"], written["straight"]
        assert abs(a - r) <= 1e-6 * r, (a, r)


def test_pieces_cut_on_head_boundaries():
    """14 heads of 64 over 4 ranks: 4, 4, 3, 3 heads of each of q, k and
    v, and of the out-projection's rows; the pieces join back whole, and
    none holds part of a head (a ``tensor_split`` of 896 columns would
    cut at 224, mid-head)."""
    dh, heads, e = 64, 14, 896
    qkv = torch.arange(2 * 3 * e, dtype=torch.float32).reshape(2, 3 * e)
    shard = sharding.ModelShard(1, qkv=True, whole=3 * e, by_heads=True,
                                unit=dh)
    pieces = [sharding.model_piece(qkv, shard, r, 4) for r in range(4)]
    assert [p.shape[1] for p in pieces] == [3 * dh * n for n in (4, 4, 3, 3)]
    assert torch.equal(sharding.model_whole(pieces, shard), qkv)
    first_head = 0
    for r, p in enumerate(pieces):
        n = (4, 4, 3, 3)[r]
        for part in range(3):
            cols = p[0, part * n * dh:(part + 1) * n * dh]
            lo = part * e + first_head * dh
            assert torch.equal(cols, qkv[0, lo:lo + n * dh])
        first_head += n
    rows = sharding.ModelShard(0, whole=e, by_heads=True, unit=dh)
    out = torch.arange(e * 3, dtype=torch.float32).reshape(e, 3)
    assert [sharding.model_piece(out, rows, r, 4).shape[0]
            for r in range(4)] == [dh * n for n in (4, 4, 3, 3)]
    assert sharding.part_sizes(e, rows, 4) == [dh * n for n in (4, 4, 3, 3)]


def test_more_ranks_than_heads_raise(tmp_path):
    """A rank would hold no head: ValueError naming the block, before
    anything is split."""
    model = uw.build("rab6", tmp_path)
    with pytest.raises(ValueError, match=r"has 6 heads, fewer than 8"):
        sharding.shard_tensor_parallel(model, size=8, rank=0)
    assert not sharding.model_shards(model)
