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

A model size above a block's head count replicates that block whole on
every rank (parallel/sharding.py): a (1 x 2) gloo spawn beside it steps
a toy whose 1-head vision block is replicated and whose 2-head text block
splits, held to the one-process step at tests/test_torch_tp.py's bars
(each gradient within 1e-6 of the gradient norm).
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
    init = {kind: uw.init_state_dict(kind, d)
            for kind in uw.KINDS + ("mixed",)}
    batch = zw.global_batch()
    ckpt = str(d / "ckpt")
    written = uw.step("rab6", init["rab6"], batch, d, ckpt=ckpt)
    sub, sub2 = d / "1x4", d / "1x2"
    sub.mkdir()
    sub2.mkdir()
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(
            w.spawn, "uneven", 4, sub,
            {"model": 4, "init": init, "cfg_dir": str(d), "batch": batch,
             "cases": CASES, "resume": ckpt}, 300, uw.__file__)
        mixed = pool.submit(
            w.spawn, "replicated", 2, sub2,
            {"model": 2, "init": init["mixed"], "cfg_dir": str(d),
             "batch": batch}, 300, uw.__file__)
        ref = {kind: uw.step(kind, init[kind], batch, d)
               for kind in uw.KINDS + ("mixed",)}
        ranks, mixed = ranks.result(), mixed.result()
    return {"ranks": ranks, "ref": ref, "init": init, "written": written,
            "mixed": mixed}


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
    """More ranks than a block's heads (6 heads at --model-parallel 8): a
    rank would hold no head, so every such block is replicated whole, as
    JAX's GSPMD rule replicates it: on every rank each leaf keeps its
    whole shape and values, nothing is tagged or listed in
    ``model_shards``, and the blocks run their one-process route
    (``tp_size`` 1, all 6 heads)."""
    init = uw.init_state_dict("rab6", tmp_path)
    names = {"visual.transformer.resblocks.0",
             "text.transformer.resblocks.0"}
    assert set(sharding.replicated_blocks(uw.build("rab6", tmp_path),
                                          8)) == names
    for rank in (0, 7):
        model = uw.build("rab6", tmp_path)
        model.load_state_dict(init)
        sharding.shard_tensor_parallel(model, size=8, rank=rank)
        assert not sharding.model_shards(model)
        for k, v in model.state_dict().items():
            assert torch.equal(v, init[k]), (rank, k)
        for n in names:
            blk = model.get_submodule(n)
            assert blk.tp_size == 1 and blk.local_heads == uw.HEADS
            assert not any(sharding.is_model_sharded(p)
                           for p in blk.parameters())


def test_replicated_block_step_at_1x2_matches_one_process(run):
    """The (1 x 2) step of the ``mixed`` toy: its 1-head vision block
    whole on both ranks (its leaves at their whole shapes, none in
    ``model_shards``), its 2-head text block split one head a rank, and
    the step held to the one-process step at tests/test_torch_tp.py's
    bars: metrics within 1e-5, the parameters' fingerprint within 1e-6,
    each gradient within 1e-6 of the gradient norm."""
    ref = run["ref"]["mixed"]
    init = run["init"]["mixed"]
    vis = "visual.transformer.resblocks.0."
    txt = "text.transformer.resblocks.0."
    for got in run["mixed"]:
        errs = w.metric_errors(got["metrics"], ref["metrics"])
        assert max(errs.values()) <= 1e-5, errs
        a, r = w.fingerprint(got["params"]), w.fingerprint(ref["params"])
        assert abs(a - r) <= 1e-6 * r, (a, r)
        norm = float(sum(g.double().square().sum()
                         for g in ref["grads"].values()) ** 0.5)
        gerr = w.grad_errors(got["grads"], ref["grads"], norm)
        worst = max(gerr, key=gerr.get)
        assert gerr[worst] <= 1e-6, (worst, gerr[worst])
        assert set(got["grads"]) == set(ref["grads"])
        assert not any(k.startswith(vis) for k in got["shards"])
        for k, shape in got["local_shape"].items():
            if k.startswith(vis):
                assert shape == tuple(init[k].shape), k
        assert got["local_shape"][txt + "attn.in_proj.kernel"] == (128, 192)
        assert got["local_shape"][txt + "mlp.c_fc.kernel"] == (128, 256)
    assert torch.equal(run["mixed"][0]["params"][vis + "attn.in_proj.kernel"],
                       run["mixed"][1]["params"][vis + "attn.in_proj.kernel"])
