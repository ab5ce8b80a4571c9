"""``--model-parallel`` in the port: tensor parallelism of the
``ResidualAttentionBlock`` towers on a (data x model) mesh of gloo ranks
on the CPU, against the one-process step on the concatenated batch and
against JAX's step jitted on a 2 x 2 mesh.

(a) the plain partial modes of kernels #1-#4 summed over 2 and 4 head or
hidden shards equal the whole-width plain versions; (b) the XTag
ViT-B-32-shaped toy step at (1 x 2) and (2 x 2) equals the one-process
step, with adamw and adafactor, and at (2 x 2) with --fsdp, each model
rank holding 1 / N of every sharded leaf and of its AdamW moment; (c)
the contrastive step, and the XTag step with adamw and adafactor, of the
same towers at (1 x 2) and (2 x 2) against JAX's ``make_train_step``
(dropout off) on ``create_mesh(2, 2)``; (d) checkpoints written at
(1 x 2) with adamw and adafactor resume at (1 x 1), (2 x 1), (1 x 2) and
(2 x 2); (e) the GAP toy
(non-fused route) and the CoCa toy (cross-attention and per-sample masks
on the plain core) step under model 2, and so does a CoCa toy whose
decoder width (96) is not its image tokens' (64), so that the
cross-attention's separate q/k/v projections split, and bf16 blocks of
both routes with the kernels on (the tensor-parallel Functions on the plain partial
modes); (f) widths the model size does not divide raise, and a timm ViT
image tower splits and steps under model 2 (tests/test_torch_tp_zoo.py
holds every other tower family); (g) ``main_other`` (scar, with its eval) at (1 x 2) and
``cli.main`` at (1 x 4) under a launcher's env against the one-process
runs.

Bars (tests/test_torch_dp.py's): metrics within 1e-5 relative, the
parameters' fingerprint within 1e-6 relative, each gradient within 1e-6
in cosine (or zero in exact arithmetic in both); JAX's metrics within
1e-3, and each parameter's update within 1e-3 of its largest entry (the
contrastive step), each gradient within 1e-3 normalized (the XTag step
with AdamW) or the Adafactor update's bar of
``test_xtag_step_matches_jax_2x2_mesh``; the bf16 block within atol = max|ref| / 128 and rtol 1e-2; the plain partial
sums within 1e-5 of max|ref|.
"""

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_dist_worker as w  # noqa: E402
from scar_fixtures import make_scar_dataset  # noqa: E402
import torch_tp_worker as tw  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401
from xtagclip_tpu.core.mesh import create_mesh  # noqa: E402
from xtagclip_tpu.factory import add_model_config as jax_add_model_config  # noqa: E402
from xtagclip_tpu.factory import create_model as jax_create_model  # noqa: E402
from xtagclip_tpu.parallel.sharding import shard_batch, shard_params  # noqa: E402
from xtagclip_tpu.train import loop as jloop  # noqa: E402
from xtagclip_tpu.train import scheduler as jsched  # noqa: E402
from xtagclip_tpu.train import train_state as jts  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.convert.from_jax import (  # noqa: E402
    load_jax_params,
    port_name,
    port_value,
)
from xtagclip_tpu_torch.ops import fused_attn_block as fab  # noqa: E402
from xtagclip_tpu_torch.ops import fused_mlp  # noqa: E402
from xtagclip_tpu_torch.parallel import sharding  # noqa: E402
from xtagclip_tpu_torch.train.params import parse_args, unported  # noqa: E402

torch.set_num_threads(1)

WORKER = tw.__file__
LAYOUTS = ("1x2", "2x2")
OPTS = ("adamw", "adafactor")


def _port_init(bundle, name, **kw):
    model = factory.create_model(name, device="cpu", precision="fp32", **kw)
    load_jax_params(model, jax.tree.map(np.asarray, bundle.params))
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    for name, cfg in ((tw.CFG_NAME, tw.CFG),):
        path = d / f"{name}.json"
        path.write_text(json.dumps(cfg))
        jax_add_model_config(str(path))
    tw.register(d)
    clip_bundle = jax_create_model(tw.CFG_NAME)
    xtag_bundle = jax_create_model(tw.CFG_NAME, use_tagging=True,
                                   use_fusion=True)
    init = {"xtag": _port_init(xtag_bundle, tw.CFG_NAME, use_tagging=True,
                               use_fusion=True),
            "clip": _port_init(clip_bundle, tw.CFG_NAME),
            "gap": tw.init_state_dict(tw.GAP_NAME),
            "coca": tw.init_state_dict(tw.COCA_NAME),
            "coca_kv": tw.init_state_dict(tw.COCA_KV_NAME),
            "timm": tw.init_state_dict(tw.TIMM_NAME)}
    batch = tw.global_batch()
    ckpt = {opt: str(d / f"ckpt_{opt}") for opt in OPTS}
    resume = [(f"resume_{opt}", ckpt[opt], opt) for opt in OPTS]
    # the steps held against JAX's carry no gradients (their size on disk)
    common = [("adamw", {}), ("adafactor", {"opt": "adafactor"}),
              ("clip", {"kind": "clip", "opt_kw": tw.JAX_OPT,
                        "grads": False}),
              ("xtag", {"opt_kw": tw.JAX_OPT, "grads": False})]
    towers = [("gap", {"kind": "gap"}), ("coca", {"kind": "coca"}),
              ("coca_kv", {"kind": "coca_kv"}), ("timm", {"kind": "timm"})]
    layouts = {
        "1x2": (2, common + towers + [
            (f"ckpt_{opt}", {"ckpt": ckpt[opt], "opt": opt})
            for opt in OPTS],
            {"blocks": ["fused_halves", "non_fused"], "resume": resume}),
        "2x2": (4, common + [("fsdp", {"fsdp": True})], {"resume": resume}),
        "2x1": (2, [], {"resume": resume})}

    def spawn_layout(layout):
        world, cases, extra = layouts[layout]
        sub = d / layout
        sub.mkdir()
        return w.spawn(
            "tp", world, sub, {"model": int(layout[-1]), "init": init,
                               "cfg_dir": str(d),
                               "batch": batch, "cases": cases, **extra},
            timeout=300, script=WORKER)

    # the train CLIs under a launcher's env: main_other's scar run with
    # eval at (1 x 2), cli.main on synthetic data at (1 x 4)
    (d / f"{tw.CLI_NAME}.json").write_text(json.dumps(tw.CLI_CFG))
    factory.add_model_config(d / f"{tw.CLI_NAME}.json")
    root = str(d / "scar")
    csv = make_scar_dataset(root, n=8, image_size=40)
    clis = (("main_other", 2, 2, 4), ("main", 4, 4, 4))

    for entry, *_ in clis:
        (d / f"cli_{entry}").mkdir()

    def spawn_cli(entry, world, model, per_rank):
        sub = d / f"cli_{entry}"
        data = {"root": root, "csv": csv, "batch": per_rank}
        return w.spawn("cli", world, sub, {"entry": entry, "model": model,
                                           "data": data, "cfg_dir": str(d)},
                       timeout=300, script=WORKER)

    def spawn_layouts():
        # (2 x 2) and (2 x 1) resume (1 x 2)'s checkpoints
        ranks = {"1x2": spawn_layout("1x2")}
        with ThreadPoolExecutor(2) as pool:
            later = {layout: pool.submit(spawn_layout, layout)
                     for layout in ("2x2", "2x1")}
            ranks.update({layout: f.result() for layout, f in later.items()})
        return ranks

    # the spawns run in threads (their ranks are processes) beside the
    # one-process runs and JAX's steps
    with ThreadPoolExecutor(3) as pool:
        layouts_done = pool.submit(spawn_layouts)
        got_cli = {c[0]: pool.submit(spawn_cli, *c) for c in clis}
        ref = {label: tw.step(init[kw.get("kind", "xtag")], batch, **kw)
               for label, kw in common + towers}
        ref["blocks"] = {r: tw.block_bf16(5, r)
                         for r in ("fused_halves", "non_fused")}
        cli = {}
        for entry, world, model, per_rank in clis:
            one = {"root": root, "csv": csv,
                   "batch": per_rank * world // model}
            want = tw.run_cli(entry, tw.cli_argv(
                entry, one, str(d / f"cli_{entry}" / "one"), "one"))
            cli[entry] = (got_cli[entry].result(), want)
        ref["cli"] = cli
        jax_steps = {"clip": _jax_step(clip_bundle, batch),
                     "xtag": _jax_step(xtag_bundle, batch, "xtag"),
                     "adafactor": _jax_step(xtag_bundle, batch, "xtag",
                                            "adafactor")}
        ranks = layouts_done.result()
    for label, path, opt in resume:
        ref[label] = tw.resume(path, init["xtag"], batch, opt)
    return {"ranks": ranks, "ref": ref, "init": init, "batch": batch,
            "ckpt": ckpt, "jax": jax_steps}


def _flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {port_name(".".join(str(getattr(k, "key", k)) for k in path)):
            port_value(np.asarray(v)) for path, v in leaves}


class _Deterministic:
    """A module whose ``apply`` runs with dropout off (TQN's 0.1): JAX's
    ``make_train_step`` applies it with ``deterministic=False``, the
    port's step under test is deterministic."""

    def __init__(self, module):
        self.module = module

    def apply(self, *args, **kw):
        return self.module.apply(*args, **{**kw, "deterministic": True})


def _jax_step(bundle, batch, kind="clip", opt="adamw"):
    """JAX's ``make_train_step`` jitted on a 2 x 2 (data, model) mesh (as
    tests/test_collective_traffic.py builds one), dropout off: the
    contrastive step (``clip``) or the XTag step with tagging and fusion
    (``xtag``), AdamW as ``tw.JAX_OPT`` or Adafactor at ``tw.step``'s lr:
    (metrics, parameters before, after)."""
    mesh = create_mesh(data_parallel=2, model_parallel=2,
                       devices=jax.devices()[:4])
    params = shard_params(bundle.params, mesh)
    if opt == "adamw":
        o = tw.JAX_OPT
        tx = jts.make_optimizer(jsched.const_lr(o["lr"], 0, 10), eps=o["eps"],
                                weight_decay=o["weight_decay"], params=params)
    else:
        tx = jts.make_optimizer(jsched.const_lr(1e-3, 0, 10), opt=opt,
                                params=params)
    state = jts.create_train_state(params, tx)
    keys = ("images", "texts") if kind == "clip" else (
        "images", "class_ids", "additional")
    sb = shard_batch({k: jnp.asarray(batch[k].astype(np.int32)
                                     if batch[k].dtype == np.int64
                                     else batch[k]) for k in keys}, mesh)
    cfg, table = ({}, None) if kind == "clip" else (
        {"use_tagging_loss": True},
        jnp.asarray(batch["table"].astype(np.int32)))
    step = jloop.make_train_step(_Deterministic(bundle.module), tx, cfg,
                                 prompt_table=table, donate=False)
    with jax.sharding.use_mesh(mesh) if hasattr(jax.sharding, "use_mesh") \
            else mesh:
        new, metrics = step(state, sb, jax.random.PRNGKey(0))
    return ({k: float(v) for k, v in metrics.items()},
            _flat(jax.tree.map(np.asarray, bundle.params)),
            _flat(jax.tree.map(np.asarray, new.params)))


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


# -- (a) the plain partial modes ------------------------------------------------

def _rnd(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(
        np.float32))


def _pieces(t, kind, n):
    shards = {"qkv_w": sharding.ModelShard(1, True),
              "qkv_b": sharding.ModelShard(0, True),
              "rows": sharding.ModelShard(0), "cols": sharding.ModelShard(1),
              "col_b": sharding.ModelShard(0), "dqkv": sharding.ModelShard(2,
                                                                          True)}
    return [sharding.model_piece(t, shards[kind], r, n) for r in range(n)]


def _near(got, want):
    scale = max(want.abs().max().item(), 1e-6)
    assert (got - want).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
def test_partial_attention_halves_sum_to_whole(n, masked):
    """#1 and #3: the ranks' plain partials (fp32, without bias, residual
    or g) summed and finished equal the whole-width plain version."""
    rng = np.random.default_rng(n)
    b, l, d, h = 2, 9, 256, 4
    x, g = _rnd(rng, (b, l, d)), _rnd(rng, (b, l, d))
    ls, lb = 1 + _rnd(rng, d, 0.1), _rnd(rng, d, 0.1)
    wqkv, bqkv = _rnd(rng, (d, 3 * d), d**-0.5), _rnd(rng, 3 * d, 0.1)
    wout, bout = _rnd(rng, (d, d), d**-0.5), _rnd(rng, d, 0.1)
    mask = torch.triu(torch.full((l, l), float("-inf")), 1) if masked \
        else None
    pw, pb, po = (_pieces(wqkv, "qkv_w", n), _pieces(bqkv, "qkv_b", n),
                  _pieces(wout, "rows", n))
    whole = fab.reference_attn_half(x, ls, lb, wqkv, bqkv, wout, bout, mask,
                                    h)
    parts = [fab.reference_attn_half(x, ls, lb, pw[r], pb[r], po[r], None,
                                     mask, h // n, partial=True)
             for r in range(n)]
    _near(x + (sum(parts) + bout), whole)
    wb = fab.reference_attn_half_bwd(x, g, ls, lb, wqkv, bqkv, wout, mask, h)
    pbk = [fab.reference_attn_half_bwd(x, g, ls, lb, pw[r], pb[r], po[r],
                                       mask, h // n, partial=True)
           for r in range(n)]
    _near(g + sum(p[0] for p in pbk), wb[0])
    _near(sharding.model_whole([p[1] for p in pbk],
                               sharding.ModelShard(2, True)), wb[1])
    _near(torch.cat([p[2] for p in pbk]), wb[2])
    for i in (3, 4, 5):  # dbout whole on every rank; dls, dlb summed
        got = pbk[0][i] if i == 3 else sum(p[i] for p in pbk)
        _near(got, wb[i])


@pytest.mark.parametrize("n", [2, 4])
def test_partial_mlps_sum_to_whole(n):
    """#2 (and its backward) and #4: the hidden slices' partials summed,
    with b2 and the residual added once, equal the whole MLPs."""
    rng = np.random.default_rng(10 + n)
    rows, d, hd = 12, 128, 512
    x, g = _rnd(rng, (rows, d)), _rnd(rng, (rows, d))
    ls, lb = 1 + _rnd(rng, d, 0.1), _rnd(rng, d, 0.1)
    w1, b1 = _rnd(rng, (d, hd), d**-0.5), _rnd(rng, hd, 0.1)
    w2, b2 = _rnd(rng, (hd, d), hd**-0.5), _rnd(rng, d, 0.1)
    p1, pb1, p2 = (_pieces(w1, "cols", n), _pieces(b1, "col_b", n),
                   _pieces(w2, "rows", n))
    for act in ("gelu", "quick_gelu"):
        whole = fab.reference_mlp_half(x, ls, lb, w1, b1, w2, b2, act)
        parts = [fab.reference_mlp_half(x, ls, lb, p1[r], pb1[r], p2[r],
                                        None, act, partial=True)
                 for r in range(n)]
        _near(x + (sum(parts) + b2), whole)
        wb = fab.mlp_half_bwd(x, g, ls, lb, w1, b1, w2, act)
        pbk = [fab.mlp_half_bwd(x, g, ls, lb, p1[r], pb1[r], p2[r], act,
                                partial=True) for r in range(n)]
        _near(g + sum(p[0] for p in pbk), wb[0])
        _near(sum(p[1] for p in pbk), wb[1])
        _near(sum(p[2] for p in pbk), wb[2])
        _near(torch.cat([p[3] for p in pbk], 1), wb[3])
        _near(torch.cat([p[4] for p in pbk]), wb[4])
        _near(torch.cat([p[5] for p in pbk]), wb[5])
        whole = fused_mlp.reference_fused_mlp(x, w1, b1, w2, b2, act)
        parts = [fused_mlp.reference_fused_mlp(x, p1[r], pb1[r], p2[r], None,
                                               act, partial=True)
                 for r in range(n)]
        _near(sum(parts) + b2, whole)


def test_partial_wrappers_run_the_plain_partials_on_the_cpu():
    """The wrappers' partial mode on a CPU tensor is the plain partial
    version, and refuses autograd (the tensor-parallel Functions own it)."""
    rng = np.random.default_rng(3)
    d, hd = 128, 256
    x = _rnd(rng, (2, 5, d)).bfloat16()
    ls, lb = torch.ones(d), torch.zeros(d)
    w1, b1 = _rnd(rng, (d, hd), 0.05).bfloat16(), torch.zeros(hd)
    w2 = _rnd(rng, (hd, d), 0.05).bfloat16()
    got = fab.fused_mlp_half(x, ls, lb, w1, b1, w2, None, "gelu",
                             partial=True)
    want = fab.reference_mlp_half(x, ls, lb, w1, b1, w2, None, "gelu",
                                  partial=True)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    with pytest.raises(ValueError, match="partial mode"):
        fab.fused_mlp_half(x, ls.requires_grad_(), lb, w1, b1, w2, None,
                           "gelu", partial=True)


# -- (b) the step at (1 x 2) and (2 x 2) ------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_step_matches_one_process(run, layout, opt):
    for rank in run["ranks"][layout]:
        _check(rank[opt], run["ref"][opt])


def test_fsdp_step_matches_one_process(run):
    for rank in run["ranks"]["2x2"]:
        _check(rank["fsdp"], run["ref"]["adamw"])


@pytest.mark.parametrize("layout,case", [("1x2", "adamw"), ("2x2", "adamw"),
                                         ("2x2", "fsdp")])
def test_model_ranks_hold_a_share_of_each_sharded_leaf(run, layout, case):
    """Each model rank holds 1 / N of every sharded leaf and of its AdamW
    moment (1 / (N x data) under --fsdp); every block leaf of the plan is
    sharded and nothing outside the blocks is."""
    n = int(layout[-1])
    data = int(layout[0])
    whole = run["ref"]["adamw"]["params"]
    div = n * (data if case == "fsdp" else 1)
    for rank in run["ranks"][layout]:
        got = rank[case]
        assert got["sharded"] and all("resblocks." in k
                                      for k in got["sharded"])
        assert {k.rsplit(".", 2)[-2] for k in got["sharded"]} == {
            "in_proj", "out_proj", "c_fc", "c_proj"}
        for k in got["sharded"]:
            assert got["local_numel"][k] * div == whole[k].numel(), k
            assert got["moment_numel"][k] * div == whole[k].numel(), k


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ranks_hold_the_same_update(run, layout):
    first = run["ranks"][layout][0]["adamw"]
    for rank in run["ranks"][layout][1:]:
        for k, v in first["params"].items():
            assert torch.equal(rank["adamw"]["params"][k], v), k


# -- (c) against JAX's 2 x 2 mesh step ------------------------------------

def _check_jax_metrics(got, j_metrics, metrics):
    for k in metrics:
        assert abs(got["metrics"][k] - j_metrics[k]) <= 1e-3 * abs(
            j_metrics[k]), (k, got["metrics"][k], j_metrics[k])


def _jax_ranks(run, layout, case):
    return [run["ref"][case]] if layout == "1x1" else \
        [rank[case] for rank in run["ranks"][layout]]


@pytest.mark.parametrize("layout", ("1x1",) + LAYOUTS)
def test_step_matches_jax_2x2_mesh(run, layout):
    """The contrastive step against JAX's on its 2 x 2 mesh: the metrics
    within 1e-3 relative, each parameter's update within 1e-3 of its
    largest entry (1x1: the one-process step, the same bar)."""
    j_metrics, before, after = run["jax"]["clip"]
    for got in _jax_ranks(run, layout, "clip"):
        _check_jax_metrics(got, j_metrics, ("loss", "contrastive_loss",
                                            "grad_norm", "logit_scale"))
        for k, p in got["params"].items():
            d_jax = after[k] - before[k]
            d_port = p.numpy() - before[k]
            if not np.any(d_jax):
                assert not np.any(d_port), k
                continue
            err = np.abs(d_port - d_jax).max() / np.abs(d_jax).max()
            assert err <= 1e-3, (k, err)


XTAG_METRICS = ("loss", "contrastive_loss", "tagging_loss", "ce_loss",
                "grad_norm", "logit_scale")


def _read_back(before, params):
    """The gradients of a first AdamW step at ``tw.JAX_OPT`` (lr 1, eps
    10, no decay), read back from its update d = -g / (|g| + 10):
    g = -10 d / (1 - |d|), in fp64."""
    out = {}
    for k, p in params.items():
        d = np.asarray(p, np.float64) - before[k]
        out[k] = -10.0 * d / (1.0 - np.abs(d))
    return out


def _normalized_err(a, r):
    """tests/test_torch_train.py's gradient error: max |a - r| over
    max(1, max |r|)."""
    return float(np.abs(a - r).max()) / max(1.0, float(np.abs(r).max()))


@pytest.mark.parametrize("layout", ("1x1",) + LAYOUTS)
@pytest.mark.parametrize("opt", OPTS)
def test_xtag_step_matches_jax_2x2_mesh(run, layout, opt):
    """The XTag step (tag head, fusion head and their losses) against
    JAX's on its 2 x 2 mesh: the metrics within 1e-3 relative. AdamW
    (``tw.JAX_OPT``): each gradient, read back from the update, within
    1e-3 normalized, the repo's gradient contract (the tag head's key
    biases and other leaves that are zero in exact arithmetic hold
    rounding noise, which a per-leaf relative bar would compare).
    Adafactor: its first update of an unfactored entry is the gradient's
    sign times lr · rms(p), and a factored leaf's is the gradient over
    its RMS, so the update carries the gradient's error relative to the
    leaf: each leaf's update within 1e-3 · max(1, |g|) / |g| of its
    largest entry (|g|: the largest of JAX's gradient), leaving out the
    entries whose gradients (the port's and JAX's, each read back from
    its AdamW step) differ in sign, which the gradient contract puts
    within rounding of zero."""
    j_metrics, before, j_after = run["jax"]["xtag" if opt == "adamw"
                                            else "adafactor"]
    g_jax = _read_back(before, run["jax"]["xtag"][2])
    for got_x, got in zip(_jax_ranks(run, layout, "xtag"),
                          _jax_ranks(run, layout, "xtag" if opt == "adamw"
                                     else "adafactor")):
        _check_jax_metrics(got, j_metrics, XTAG_METRICS)
        assert set(got["params"]) == set(j_after)
        g_port = _read_back(before, {k: v.numpy() for k, v in
                                     got_x["params"].items()})
        for k, p in got["params"].items():
            if opt == "adamw":
                assert _normalized_err(g_port[k], g_jax[k]) <= 1e-3, k
                continue
            d_jax = j_after[k] - before[k]
            d_port = p.numpy() - before[k]
            if not np.any(d_jax):
                assert not np.any(d_port), k
                continue
            same = np.sign(g_port[k]) == np.sign(g_jax[k])
            if not same.any():
                continue
            scale = float(np.abs(g_jax[k]).max())
            err = np.abs(d_port - d_jax)[same].max() / np.abs(d_jax).max()
            assert err <= 1e-3 * max(1.0, scale) / scale, (k, err, scale)


# -- (d) checkpoints across layouts ------------------------------------

def test_checkpoint_holds_whole_open_clip_tensors(run):
    """The (1 x 2) checkpoint holds every parameter and moment whole, in
    the one-process shapes."""
    saved = torch.load(os.path.join(run["ckpt"]["adamw"], "epoch_1",
                                    "state.pt"),
                       map_location="cpu", weights_only=True)["state"]
    for k, v in run["init"]["xtag"].items():
        assert saved["model"][k].shape == v.shape, k
    shapes = {tuple(v.shape) for v in run["init"]["xtag"].values()}
    for s in saved["optimizer"]["state"].values():
        assert tuple(s["exp_avg"].shape) in shapes


def test_adafactor_checkpoint_holds_whole_statistics(run):
    """Adafactor steps on whole leaves: the (1 x 2) checkpoint holds each
    leaf's statistics whole, ``v`` in the leaf's one-process shape and
    the factored rows and columns of it."""
    saved = torch.load(os.path.join(run["ckpt"]["adafactor"], "epoch_1",
                                    "state.pt"),
                       map_location="cpu", weights_only=True)["state"]
    model = factory.create_model(tw.CFG_NAME, device="cpu", use_tagging=True,
                                 use_fusion=True)
    tx = tw.ts.make_optimizer(lambda _: 1e-3, opt="adafactor",
                              params=dict(model.named_parameters()))
    leaves = [p for g in tx.optimizer.param_groups for p in g["params"]]
    state = saved["optimizer"]["state"]
    assert len(state) == len(leaves)
    for i, s in state.items():
        p = leaves[int(i)]
        dims = tw.ts.factored_dims(p)
        if dims is None:
            assert s["v"].shape == p.shape, i
        else:
            assert s["v_row"].shape == p.mean(dims[1]).shape, i
            assert s["v_col"].shape == p.mean(dims[0]).shape, i


def _check_resume(run, where, opt):
    written = run["ranks"]["1x2"][0][f"ckpt_{opt}"]
    label = f"resume_{opt}"
    got = [run["ref"][label]] if where == "1x1" else \
        [r[label] for r in run["ranks"][where]]
    for g in got:
        assert g["epoch"] == 0
        differ = [k for k, v in written["params"].items()
                  if g["restored"].get(k) != v]
        assert not differ and g["restored"].keys() == written[
            "params"].keys(), differ
        a, r = g["stepped"], written["straight"]
        assert abs(a - r) <= 1e-6 * r, (a, r)


@pytest.mark.parametrize("where", ["1x1", "2x1", "1x2", "2x2"])
def test_checkpoint_written_at_1x2_resumes(run, where):
    """The (1 x 2) AdamW state, its moments cut to the pieces, restores
    whole at (1 x 1), (2 x 1), (1 x 2) and (2 x 2), and its next step
    equals the (1 x 2) run's straight through."""
    _check_resume(run, where, "adamw")


@pytest.mark.parametrize("where", ["1x1", "2x1", "1x2", "2x2"])
def test_adafactor_checkpoint_written_at_1x2_resumes(run, where):
    """As above with Adafactor, whose statistics every rank keeps whole."""
    _check_resume(run, where, "adafactor")


# -- (e) the GAP and CoCa towers, and bf16 blocks ----------------------------

@pytest.mark.parametrize("kind", ["gap", "coca", "coca_kv"])
def test_other_towers_step_under_model_2(run, kind):
    """``coca_kv``: the decoder's cross-attention has a key/value width
    (the image tokens' 64) of its own beside the decoder's 96, so its
    separate q/k/v projections are split by heads, and the image tokens'
    and the decoder stream's gradients are summed over the model group
    once."""
    for rank in run["ranks"]["1x2"]:
        _check(rank[kind], run["ref"][kind])
        assert rank[kind]["sharded"]
        if kind == "coca_kv":
            assert "text_decoder.cross_attn.0.attn.k_proj.kernel" in \
                rank[kind]["sharded"]


@pytest.mark.parametrize("route", ["fused_halves", "non_fused"])
def test_bf16_block_kernels_on_matches_whole(run, route):
    ref = run["ref"]["blocks"][route]
    for rank in run["ranks"]["1x2"]:
        got = rank[route]
        for k in ("y", "dx"):
            np.testing.assert_allclose(
                got[k].numpy(), ref[k].numpy(), rtol=1e-2,
                atol=ref[k].abs().max().item() / 128, err_msg=k)
        for k, g in ref["grads"].items():
            np.testing.assert_allclose(
                got["grads"][k].numpy(), g.numpy(), rtol=1e-2,
                atol=g.abs().max().item() / 128, err_msg=k)


# -- the train CLIs ------------------------------------------------------------

@pytest.mark.parametrize("entry", ["main_other", "main"])
def test_cli_at_model_parallel_matches_one_process(run, entry):
    """``main_other`` (scar, with the eval every rank runs) at (1 x 2) and
    ``cli.main`` (synthetic) at (1 x 4): every step's loss and the eval
    metrics within 1e-5 of the one-process run on the same global
    batches; the blocks split on every rank."""
    got, want = run["ref"]["cli"][entry]
    for rank in got:
        assert rank["sharded"]
        assert len(rank["losses"]) == len(want["losses"]) > 0
        for a, b in zip(rank["losses"], want["losses"]):
            assert abs(a - b) <= 1e-5 * abs(b), (a, b)
        assert rank["eval"].keys() == want["eval"].keys()
        for k, v in want["eval"].items():
            assert abs(rank["eval"][k] - v) <= 1e-5 * max(abs(v), 1.0), k


# -- (f) what raises ------------------------------------------------------

def test_non_divisible_heads_raise(run):
    """4 heads over 3 ranks split into whole heads (2, 1, 1), the hidden
    width 1024 into 342, 341, 341; over 5 ranks one would hold no head,
    which raises before anything is split."""
    model = factory.create_model(tw.CFG_NAME, device="cpu")
    with pytest.raises(ValueError, match=r"has 4 heads, fewer than 5"):
        sharding.shard_tensor_parallel(model, size=5, rank=0)
    assert not sharding.model_shards(model)
    for r, (heads, hidden) in enumerate(((2, 342), (1, 341), (1, 341))):
        model = factory.create_model(tw.CFG_NAME, device="cpu")
        sharding.shard_tensor_parallel(model, size=3, rank=r)
        blk = model.text.transformer.resblocks[0]
        assert blk.local_heads == heads
        assert blk.mlp.c_fc.kernel.shape[1] == hidden
        assert blk.attn.in_proj.kernel.shape[1] == 3 * 64 * heads


def test_tower_outside_the_slice_raises_naming_item_11(run):
    """A timm ViT image tower (once outside item 10's slice) splits by its
    plan and steps at (1 x 2) as the one-process step; ``unported`` names
    nothing for it."""
    for rank in run["ranks"]["1x2"]:
        _check(rank["timm"], run["ref"]["timm"])
        trunk = {k.rsplit(".", 2)[-2] for k in rank["timm"]["sharded"]
                 if k.startswith("visual.trunk.blocks.")}
        assert trunk == {"qkv", "proj", "fc1", "fc2"}
    assert unported(parse_args(["--model", tw.TIMM_NAME,
                                "--model-parallel", "2"])) == []
    assert unported(parse_args(["--model", tw.CFG_NAME,
                                "--model-parallel", "2"])) == []
