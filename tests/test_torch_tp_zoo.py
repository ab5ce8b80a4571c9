"""``--model-parallel`` over every tower family outside the
``ResidualAttentionBlock`` towers: the timm ViT (SigLIP's ``map`` pool,
the relpos bias), EVA-01 and EVA-02, ViTamin, the HF text towers
(XLM-R/BERT, T5, M2M100 with their token tables split by rows), Swin,
ConvNeXt, FastViT and the ResNets' attention pool, on gloo ranks on the
CPU, against the one-process step on the concatenated batch.

Two spawns, run once: (1 x 2) carries every family's contrastive step
(the BERT, T5 and M2M100 towers with their dropout on, the same
generator seed on every rank) and an EVA-02 checkpoint; (2 x 2) carries
EVA-02 and T5 with and without --fsdp. EVA-02's toy has a SwiGLU width
of 171, so its hidden slices and its ``mlp_norm`` are uneven (86 and 85).
The EVA-02 steps are also held against JAX's step jitted on
``create_mesh(2, 2)``.

Bars (tests/test_torch_dp.py's): metrics within 1e-5 relative, the
parameters' fingerprint within 1e-6 relative, each gradient within 1e-6
in cosine (or zero in exact arithmetic in both); JAX's metrics within
1e-3 and each parameter's update within 1e-3 of its largest entry, as
tests/test_torch_tp.py's ``test_step_matches_jax_2x2_mesh``.
"""

import json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_dist_worker as w  # noqa: E402
import torch_tp_zoo_worker as zw  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401
from torch_zoo import randomize  # noqa: E402
from xtagclip_tpu.core.mesh import create_mesh  # noqa: E402
from xtagclip_tpu.factory import add_model_config as jax_add_model_config  # noqa: E402
from xtagclip_tpu.factory import create_model as jax_create_model  # noqa: E402
from xtagclip_tpu.models import eva as jeva  # noqa: E402
from xtagclip_tpu.parallel.sharding import shard_batch, shard_params  # noqa: E402
from xtagclip_tpu.train import loop as jloop  # noqa: E402
from xtagclip_tpu.train import scheduler as jsched  # noqa: E402
from xtagclip_tpu.train import train_state as jts  # noqa: E402
from xtagclip_tpu_torch.convert.from_jax import (  # noqa: E402
    load_jax_params,
    port_name,
    port_value,
)
from xtagclip_tpu_torch.parallel import sharding  # noqa: E402

torch.set_num_threads(1)

WORKER = zw.__file__
DROPOUT = ("bert", "t5", "m2m100")
# EVA-02's steps take JAX's AdamW (its init is JAX's, randomized)
KW = {"eva02": {"opt_kw": zw.JAX_OPT}}
CASES_2X2 = [("eva02", "eva02", KW["eva02"]),
             ("eva02_fsdp", "eva02", {**KW["eva02"], "fsdp": True}),
             ("t5", "t5", {}), ("t5_fsdp", "t5", {"fsdp": True})]
# the split leaves of each family's tower, as "<module>.<leaf>"
SPLIT = {
    "timm_map": {"qkv.kernel", "qkv.bias", "proj.kernel", "fc1.kernel",
                 "fc1.bias", "fc2.kernel", "q.kernel", "q.bias", "kv.kernel",
                 "kv.bias", "mlp_fc1.kernel", "mlp_fc1.bias",
                 "mlp_fc2.kernel"},
    "timm_relpos": {"qkv.kernel", "qkv.bias", "proj.kernel", "fc1.kernel",
                    "fc1.bias", "fc2.kernel", "relpos.table"},
    "eva01": {"qkv.kernel", "qkv.bias", "proj.kernel", "fc1.kernel",
              "fc1.bias", "fc2.kernel"},
    "eva02": {"q_proj.kernel", "q_proj.bias", "k_proj.kernel",
              "v_proj.kernel", "v_proj.bias", "proj.kernel", "fc1_g.kernel",
              "fc1_g.bias", "fc1_x.kernel", "fc1_x.bias", "mlp_norm.scale",
              "mlp_norm.bias", "fc2.kernel"},
    "vitamin": {"qkv.kernel", "qkv.bias", "proj.kernel", "fc1_g.kernel",
                "fc1_g.bias", "fc1_x.kernel", "fc1_x.bias", "fc2.kernel"},
    "bert": {"word_embeddings.embedding", "query.kernel", "query.bias",
             "key.kernel", "key.bias", "value.kernel", "value.bias",
             "out_dense.kernel", "intermediate.kernel", "intermediate.bias",
             "output.kernel"},
    "t5": {"shared.embedding", "relpos_bias.embedding", "q.kernel",
           "k.kernel", "v.kernel", "o.kernel", "wi_0.kernel", "wi_1.kernel",
           "wo.kernel"},
    "m2m100": {"embed_tokens.embedding", "q_proj.kernel", "q_proj.bias",
               "k_proj.kernel", "k_proj.bias", "v_proj.kernel",
               "v_proj.bias", "out_proj.kernel", "fc1.kernel", "fc1.bias",
               "fc2.kernel"},
    "swin": {"qkv.kernel", "qkv.bias", "attn.rel_pos_bias", "proj.kernel",
             "fc1.kernel", "fc1.bias", "fc2.kernel"},
    "convnext": {"mlp_fc1.kernel", "mlp_fc1.bias", "mlp_fc2.kernel"},
    "fastvit": {"qkv.kernel", "qkv.bias", "proj.kernel"},
    "resnet": {"q_proj.kernel", "q_proj.bias", "k_proj.kernel",
               "k_proj.bias", "v_proj.kernel", "v_proj.bias",
               "c_proj.kernel"},
}


def _step_kw(kind: str, layout: str) -> dict:
    """A case's ``step`` kwargs: dropout on for the HF towers at (1 x 2)
    (at (2 x 2) each data rank would draw its own rows' masks)."""
    return {**KW.get(kind, {}),
            **({"dropout": True} if kind in DROPOUT and layout == "1x2"
               else {})}


def _jax_bundle(d):
    """JAX's toy EVA-02 CLIP (its trunk's entry in JAX's EVA table only
    while JAX builds it) and its parameters, randomized."""
    path = d / "torchtinytpzooeva02.json"
    path.write_text(json.dumps(zw.eva_config("eva02")))
    jax_add_model_config(str(path))
    name = zw.EVA_NAMES["eva02"]
    jeva.EVA_CONFIGS[name] = zw.EVA_TOYS[name]
    try:
        bundle = jax_create_model("torchtinytpzooeva02")
    finally:
        del jeva.EVA_CONFIGS[name]
    return bundle, randomize(jax.tree.map(np.asarray, bundle.params), 3)


def _flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {port_name(".".join(str(getattr(k, "key", k)) for k in path)):
            port_value(np.asarray(v)) for path, v in leaves}


def _jax_step(bundle, params, batch):
    """JAX's contrastive ``make_train_step`` jitted on a 2 x 2 (data,
    model) mesh, AdamW at ``zw.JAX_OPT``: (metrics, parameters after)."""
    mesh = create_mesh(data_parallel=2, model_parallel=2,
                       devices=jax.devices()[:4])
    params = shard_params(jax.tree.map(jnp.asarray, params), mesh)
    o = zw.JAX_OPT
    tx = jts.make_optimizer(jsched.const_lr(o["lr"], 0, 10), eps=o["eps"],
                            weight_decay=o["weight_decay"], params=params)
    state = jts.create_train_state(params, tx)
    sb = shard_batch({"images": jnp.asarray(batch["images"]),
                      "texts": jnp.asarray(zw.texts("eva02", batch)
                                           .astype(np.int32))}, mesh)
    step = jloop.make_train_step(bundle.module, tx, {}, donate=False)
    with jax.sharding.use_mesh(mesh) if hasattr(jax.sharding, "use_mesh") \
            else mesh:
        new, metrics = step(state, sb, jax.random.PRNGKey(0))
    return ({k: float(v) for k, v in metrics.items()},
            _flat(jax.tree.map(np.asarray, new.params)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpzoo")
    zw.register(d)
    bundle, jparams = _jax_bundle(d)
    init = {kind: zw.init_state_dict(kind, d) for kind in zw.KINDS}
    eva02 = zw.build("eva02", d)
    load_jax_params(eva02, jparams)
    init["eva02"] = {k: v.clone() for k, v in eva02.state_dict().items()}
    batch = zw.global_batch()
    ckpt = str(d / "ckpt")
    spawns = {
        "1x2": (2, [(k, k, _step_kw(k, "1x2")) for k in zw.KINDS]
                + [("ckpt", "eva02", {"ckpt": ckpt})]),
        "2x2": (4, CASES_2X2)}
    with ThreadPoolExecutor(len(spawns)) as pool:
        futures = {}
        for layout, (world, cases) in spawns.items():
            sub = d / layout
            sub.mkdir()
            futures[layout] = pool.submit(
                w.spawn, "zoo", world, sub,
                {"model": 2, "init": init, "cfg_dir": str(d),
                 "batch": batch, "cases": cases}, 300, WORKER)
        ref = {k: zw.step(k, init[k], batch, d, **_step_kw(k, "1x2"))
               for k in zw.KINDS}
        ref["t5_deterministic"] = zw.step("t5", init["t5"], batch, d)
        jax_step = _jax_step(bundle, jparams, batch)
        ranks = {layout: f.result() for layout, f in futures.items()}
    ref["resume"] = zw.resume("eva02", ckpt, init["eva02"], batch, d)
    return {"ranks": ranks, "ref": ref, "init": init, "jax": jax_step,
            "jparams": _flat(jparams), "dir": d}


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
    assert set(got["grads"]) == set(ref["grads"])
    for k, v in ref["params"].items():
        assert got["params"][k].shape == v.shape, k


@pytest.mark.parametrize("kind", zw.KINDS)
def test_family_step_at_1x2_matches_one_process(run, kind):
    for rank in run["ranks"]["1x2"]:
        _check(rank[kind], run["ref"][kind])


@pytest.mark.parametrize("label", [c[0] for c in CASES_2X2])
def test_step_at_2x2_matches_one_process(run, label):
    """EVA-02 and T5 (its dropout off) at (2 x 2), DDP or FSDP over the
    data group."""
    kind = label.split("_")[0]
    ref = run["ref"]["t5_deterministic" if kind == "t5" else kind]
    for rank in run["ranks"]["2x2"]:
        _check(rank[label], ref)


@pytest.mark.parametrize("layout", ["1x1", "1x2", "2x2"])
def test_eva02_step_matches_jax_2x2_mesh(run, layout):
    """EVA-02 (the ``mlp_norm`` over its split hidden width) against
    JAX's contrastive step on its 2 x 2 mesh: the metrics within 1e-3
    relative, each parameter's update within 1e-3 of its largest entry
    (1x1: the one-process step, the same bar)."""
    j_metrics, after = run["jax"]
    before = run["jparams"]
    got_all = [run["ref"]["eva02"]] if layout == "1x1" else \
        [r["eva02"] for r in run["ranks"][layout]]
    for got in got_all:
        for k in ("loss", "contrastive_loss", "grad_norm", "logit_scale"):
            assert abs(got["metrics"][k] - j_metrics[k]) <= 1e-3 * abs(
                j_metrics[k]), (k, got["metrics"][k], j_metrics[k])
        assert set(got["params"]) == set(after)
        for k, p in got["params"].items():
            d_jax = after[k] - before[k]
            d_port = p.numpy() - before[k]
            if not np.any(d_jax):
                assert not np.any(d_port), k
                continue
            err = np.abs(d_port - d_jax).max() / np.abs(d_jax).max()
            assert err <= 1e-3, (k, err)


@pytest.mark.parametrize("kind", zw.KINDS)
def test_model_ranks_hold_their_share_of_each_split_leaf(run, kind):
    """The family's split leaves are the table's (``SPLIT``), each rank
    holding its ``model_piece`` (EVA-02's hidden width 171: 86 and 85
    rows; the HF token tables by rows), and every other leaf whole."""
    tower = "text." if kind in zw.HF_KINDS else "visual."
    ranks = run["ranks"]["1x2"]
    got = {k for k in ranks[0][kind]["shards"] if k.startswith(tower)}
    assert {".".join(k.split(".")[-2:]) for k in got} == SPLIT[kind]
    for r, rank in enumerate(ranks):
        shards, local = rank[kind]["shards"], rank[kind]["local_shape"]
        for k, v in run["init"][kind].items():
            if k not in local:  # a buffer
                continue
            want = (sharding.model_piece(v, shards[k], r, 2).shape
                    if k in shards else v.shape)
            assert local[k] == tuple(want), (k, local[k])
    if kind == "eva02":
        for rank, rows in zip(ranks, (86, 85)):
            local = rank[kind]["local_shape"]
            assert local["visual.trunk.blocks.0.mlp_norm.scale"] == (rows,)
            assert local["visual.trunk.blocks.0.fc2.kernel"] == (rows, 64)


def test_ranks_of_a_model_group_hold_the_same_update(run):
    first = run["ranks"]["1x2"][0]
    for kind in zw.KINDS:
        for k, v in first[kind]["params"].items():
            assert torch.equal(run["ranks"]["1x2"][1][kind]["params"][k],
                               v), (kind, k)


def test_checkpoint_written_at_1x2_resumes_at_1x1(run):
    """The (1 x 2) EVA-02 checkpoint (uneven hidden slices) holds whole
    tensors: it restores whole in one process and its next step equals
    the (1 x 2) run's straight through."""
    written = run["ranks"]["1x2"][0]["ckpt"]
    got = run["ref"]["resume"]
    assert got["epoch"] == 0
    assert got["restored"] == written["params"]
    a, r = got["stepped"], written["straight"]
    assert abs(a - r) <= 1e-6 * r, (a, r)
    saved = torch.load(os.path.join(str(run["dir"]), "ckpt", "epoch_1",
                                    "state.pt"), map_location="cpu",
                       weights_only=True)["state"]["model"]
    for k, v in run["init"]["eva02"].items():
        assert saved[k].shape == v.shape, k


@pytest.mark.parametrize("kind,size,match", [
    ("eva02", 5, r"'trunk\.blocks\.0\.attn' \(EvaAttention\) has 4 heads, "
                 r"fewer than 5"),
    ("swin", 4, r"\(WindowAttention\) has 2 heads, fewer than 4"),
    ("t5", 5, r"\(T5EncoderStack\) has 4 heads")])
def test_non_divisible_heads_raise(run, kind, size, match):
    """Heads stay whole heads: a head count the model size does not
    divide splits unevenly (tests/test_torch_tp_uneven.py), and a block
    with fewer heads than the model size, where a rank would hold no head,
    is replicated whole on every rank, as JAX's GSPMD rule replicates it:
    ``match`` names it as "'<name>' (<class>) has <heads> heads, fewer
    than <size>". Its leaves keep their whole shapes and are absent from
    ``model_shards``; its neighbours still split."""
    def tower():
        t = getattr(zw.build(kind, run["dir"]),
                    "text" if kind in zw.HF_KINDS else "visual")
        t.load_state_dict(whole)
        return t

    whole = {k: v.clone() for k, v in getattr(
        zw.build(kind, run["dir"]),
        "text" if kind in zw.HF_KINDS else "visual").state_dict().items()}
    sharded = tower()
    sharding.shard_tensor_parallel(sharded, size=size, rank=0)
    found = [f"'{n}' ({type(m).__name__}) has {sharding._heads(m)} heads, "
             f"fewer than {size}"
             for n, m in sharded.named_modules()
             if n in sharding.replicated_blocks(tower(), size)]
    assert any(re.search(match, f) for f in found), found
    shards = sharding.model_shards(sharded)
    assert shards  # the neighbours split
    local = dict(sharded.state_dict())
    for n in sharding.replicated_blocks(tower(), size):
        # the leaves its own plan would split (a block holding other
        # blocks, T5's stack, leaves theirs to their own plans)
        own = [f"{n}.{k}" for k in
               sharding._split_leaves(sharded.get_submodule(n))]
        assert own and not any(k in shards for k in own), n
        for k in own:
            assert local[k].shape == whole[k].shape, k
    assert any(local[k].shape != whole[k].shape for k in shards)


def test_uneven_pieces_round_trip():
    """``model_piece`` cuts a hidden width of 2730 over 4 ranks as
    ``tensor_split`` does (683, 683, 682, 682) and ``model_whole`` joins
    them back; q|k|v and k|v leaves cut each part alike."""
    t = torch.arange(3 * 2730.0).reshape(3, 2730)
    shard = sharding.ModelShard(1, whole=2730)
    pieces = [sharding.model_piece(t, shard, r, 4) for r in range(4)]
    assert [p.shape[1] for p in pieces] == [683, 683, 682, 682]
    assert sharding.piece_sizes(2730, 4) == [683, 683, 682, 682]
    assert torch.equal(sharding.model_whole(pieces, shard), t)
    for kv in (False, True):
        parts = 2 if kv else 3
        fused = torch.arange(4 * parts * 8.0).reshape(4, parts * 8)
        s = sharding.ModelShard(1, qkv=not kv, kv=kv)
        pieces = [sharding.model_piece(fused, s, r, 2) for r in range(2)]
        assert torch.equal(pieces[0], torch.cat(
            [c[:, :4] for c in fused.chunk(parts, 1)], 1))
        assert torch.equal(sharding.model_whole(pieces, s), fused)
