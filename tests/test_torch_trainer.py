"""The PyTorch port's trainer slice against the JAX package, on the CPU:
the accumulation step, the scar evaluation and its artifacts, the
open_clip checkpoint loader, and the train CLI end to end on the scar
fixture (tests/scar_fixtures.py).

Models: the eval, loader and CLI tests use the ``tiny-e2e`` geometry of
tests/test_scar_data.py (2 layers, vision width 64, text width 512 with
the real vocabulary, as TQN and the tokenizer need); the accumulation
step uses the smaller tests/test_torch_train.py geometry, which keeps
JAX's compile of its two scanned passes short. Weights cross through
``load_jax_params`` or the open_clip state dict the JAX package exports.

Bars (the repo's parity contract, BASELINE.md:18, fp32): features,
logits and the --save-embed arrays within 1e-3; top-1/top-2, tag picks,
tag metrics and the tagging artifact exactly; the class artifact's names
exactly and its printed scores within 1e-3; the accumulation step's loss
within 1e-5 relative and each parameter's update within 1e-3 of JAX's,
normalized by JAX's (‖Δport − Δjax‖ / ‖Δjax‖). The update check runs
AdamW with eps = 1e3, where the first update is lr·g/(|g| + eps), nearly
linear in the summed gradient g, so it checks the gradients themselves.
"""

import json
import math
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from scar_fixtures import make_scar_dataset  # noqa: E402

from xtagclip_tpu.convert.export import save_open_clip_checkpoint  # noqa: E402
from xtagclip_tpu.data import loader as jloader  # noqa: E402
from xtagclip_tpu.data import transforms as jtransforms  # noqa: E402
from xtagclip_tpu.data.scar import ScarDataset as JScarDataset  # noqa: E402
from xtagclip_tpu.factory import add_model_config as jax_add_model_config  # noqa: E402
from xtagclip_tpu.factory import create_model as jax_create_model  # noqa: E402
from xtagclip_tpu.tokenize.bpe import SimpleTokenizer as JTokenizer  # noqa: E402
from xtagclip_tpu.train import loop as jloop  # noqa: E402
from xtagclip_tpu.train import scheduler as jsched  # noqa: E402
from xtagclip_tpu.train import train_state as jts  # noqa: E402
from xtagclip_tpu.train import zero_shot as jzs  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.cli import main_other  # noqa: E402
from xtagclip_tpu_torch.convert.from_jax import load_jax_params, port_name  # noqa: E402
from xtagclip_tpu_torch.convert.loader import (  # noqa: E402
    load_checkpoint_into,
    tagging_only_filter,
)
from xtagclip_tpu_torch.data import loader, transforms  # noqa: E402
from xtagclip_tpu_torch.data.scar import ScarDataset  # noqa: E402
from xtagclip_tpu_torch.models.clip import num_combos  # noqa: E402
from xtagclip_tpu_torch.tokenize.bpe import SimpleTokenizer  # noqa: E402
from xtagclip_tpu_torch.train import scheduler  # noqa: E402
from xtagclip_tpu_torch.train import train_state as ts  # noqa: E402
from xtagclip_tpu_torch.train import zero_shot  # noqa: E402
from xtagclip_tpu_torch.train.logger import close_logging  # noqa: E402
from xtagclip_tpu_torch.train.loop import make_accum_train_step  # noqa: E402
from xtagclip_tpu_torch.train.params import parse_args, unported  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

TINY_E2E = dict(
    embed_dim=512,
    vision_cfg=dict(layers=2, width=64, head_width=32, patch_size=16,
                    image_size=32),
    text_cfg=dict(context_length=77, vocab_size=49408, width=512, heads=4,
                  layers=2),
)
TOY = dict(
    embed_dim=64,
    fusion_dim=64,
    vision_cfg=dict(layers=2, width=64, head_width=32, patch_size=8,
                    image_size=32),
    text_cfg=dict(context_length=16, vocab_size=1024, width=64, heads=2,
                  layers=2),
)


def _register(tmp_path_factory, name, cfg):
    path = tmp_path_factory.mktemp("cfg") / f"{name}.json"
    path.write_text(json.dumps(cfg))
    jax_add_model_config(str(path))
    factory.add_model_config(path)
    return name


def _flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {port_name(".".join(str(getattr(k, "key", k)) for k in path)): v
            for path, v in leaves}


# -- the accumulation step ---------------------------------------------------

class _Deterministic:
    """The JAX module with dropout off: the accumulation step's forward
    passes ``deterministic=False``; the parity runs without dropout."""

    def __init__(self, module):
        self.module = module

    def apply(self, *args, **kwargs):
        kwargs["deterministic"] = True
        kwargs.pop("rngs", None)
        return self.module.apply(*args, **kwargs)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    name = _register(tmp_path_factory, "torchtinyaccum", TOY)
    bundle = jax_create_model(name, use_tagging=True, use_fusion=True)
    return name, bundle, jax.tree.map(np.asarray, bundle.params)


def _accum_batch(accum, micro):
    rng = np.random.default_rng(7)
    b = accum * micro
    additional = np.zeros((b, 22), np.float32)
    for off, size in zip((0, 3, 7, 10, 14, 18), (3, 4, 3, 4, 4, 4)):
        additional[np.arange(b), off + rng.integers(0, size, b)] = 1.0
    batch = dict(
        images=rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
        texts=rng.integers(1, 1000, (b, 16)).astype(np.int32),
        class_ids=rng.integers(0, 3, b).astype(np.int32),
        additional=additional)
    table = rng.integers(1, 1000, (1, 3, num_combos(), 16)).astype(np.int32)
    return ({k: v.reshape((accum, micro) + v.shape[1:])
             for k, v in batch.items()}, table)


def test_accum_step_matches_jax(toy):
    name, bundle, jparams = toy
    accum, micro, lr, eps = 2, 3, 1.0, 1e3
    batch, table = _accum_batch(accum, micro)
    args_cfg = {"use_tagging_loss": True}

    j_tx = jts.make_optimizer(jsched.const_lr(lr, 0, 10), eps=eps,
                              weight_decay=0.0, params=jparams)
    j_state = jts.create_train_state(jax.tree.map(jnp.asarray, jparams), j_tx)
    j_step = jloop.make_accum_train_step(
        _Deterministic(bundle.module), j_tx, args_cfg, accum,
        prompt_table=jnp.asarray(table), donate=False)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_batch["template_id"] = 0
    j_new, j_metrics = j_step(j_state, j_batch, jax.random.PRNGKey(0))

    model = factory.create_model(name, device="cpu", use_tagging=True,
                                 use_fusion=True)
    load_jax_params(model, jparams)
    named = dict(model.named_parameters())
    state = ts.create_train_state(model, ts.make_optimizer(
        scheduler.const_lr(lr, 0, 10), eps=eps, weight_decay=0.0,
        params=named))
    step = make_accum_train_step(args_cfg, accum,
                                 prompt_table=torch.from_numpy(table).long(),
                                 deterministic=True)
    p_batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
               else torch.from_numpy(v) for k, v in batch.items()}
    p_batch["template_id"] = 0
    state, metrics = step(state, p_batch, None)

    assert state.step == 1
    # trap 5: contrastive + ASL at 1x, no DQNCOS term
    assert set(metrics) == {"contrastive_loss", "tagging_loss", "loss",
                            "logit_scale"}
    assert metrics["loss"].item() == pytest.approx(
        metrics["contrastive_loss"].item() + metrics["tagging_loss"].item(),
        rel=1e-6)
    for k, v in metrics.items():
        want = float(j_metrics[k])
        assert abs(v.item() - want) <= 1e-5 * abs(want), k
    before, after = _flat(jparams), _flat(j_new.params)
    for n, p in named.items():
        if "crossattention.key.bias" in n:
            continue  # an exactly-zero gradient: both hold rounding noise
        d_jax = np.asarray(after[n]) - before[n]
        d_port = p.detach().numpy() - before[n]
        if not np.any(d_jax):
            assert not np.any(d_port), n
            continue
        err = np.linalg.norm(d_port - d_jax) / np.linalg.norm(d_jax)
        assert err <= 1e-3, (n, err)


def test_accum_step_replays_the_dropout_masks(toy):
    """Microbatch i draws the same masks in both passes, so with one
    microbatch the accumulation step's gradient is the plain objective's."""
    name, _, jparams = toy
    batch, table = _accum_batch(1, 4)
    p_batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
               else torch.from_numpy(v) for k, v in batch.items()}

    def run(seed):
        model = factory.create_model(name, device="cpu", use_tagging=True,
                                     use_fusion=True)
        load_jax_params(model, jparams)
        state = ts.create_train_state(model, ts.make_optimizer(
            scheduler.const_lr(1e-3, 0, 10),
            params=dict(model.named_parameters())))
        step = make_accum_train_step({"use_tagging_loss": True}, 1,
                                     prompt_table=torch.from_numpy(table).long())
        _, m = step(state, p_batch, torch.Generator().manual_seed(seed))
        return m["loss"].item(), model.tag_fc.kernel.detach().clone()

    a, b, c = run(3), run(3), run(4)
    assert a[0] == b[0] and torch.equal(a[1], b[1])
    assert a[0] != c[0]


# -- the scar eval -----------------------------------------------------------

@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    name = _register(tmp_path_factory, "torchtinye2e", TINY_E2E)
    bundle = jax_create_model(name, use_tagging=True, use_fusion=True)
    ckpt = str(tmp_path_factory.mktemp("openclip") / "xtag.pt")
    save_open_clip_checkpoint(bundle, ckpt)
    return name, bundle, ckpt


@pytest.fixture(scope="module")
def scar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scar")
    csv = make_scar_dataset(str(root), n=10, image_size=48)
    return str(root), csv


@pytest.fixture(scope="module")
def port_e2e(e2e):
    """The port's model, loaded from the JAX package's exported
    open_clip state dict."""
    name, _, ckpt = e2e
    model = factory.create_model(name, device="cpu", use_tagging=True,
                                 use_fusion=True)
    load_checkpoint_into(model, ckpt)
    return model


@pytest.fixture
def cli_logging():
    yield
    close_logging()


def test_openclip_loader_gives_the_jax_parameters(e2e, port_e2e):
    name, bundle, _ = e2e
    want = factory.create_model(name, device="cpu", use_tagging=True,
                                use_fusion=True)
    load_jax_params(want, jax.tree.map(np.asarray, bundle.params))
    got_named = dict(port_e2e.named_parameters())
    for n, p in want.named_parameters():
        assert torch.equal(got_named[n], p), n


def test_tagging_only_filter_loads_only_the_tag_head(e2e):
    name, bundle, ckpt = e2e
    jflat = _flat(jax.tree.map(np.asarray, bundle.params))
    model = factory.create_model(name, device="cpu", use_tagging=True,
                                 use_fusion=True, init_seed=3)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    load_checkpoint_into(model, ckpt, key_filter=tagging_only_filter)
    n_tag = 0
    for n, p in model.named_parameters():
        if n.split(".")[0] in ("tag_head", "tag_labels", "tag_fc"):
            np.testing.assert_array_equal(p.detach().numpy(), jflat[n])
            n_tag += 1
        else:
            assert torch.equal(p, init[n]), n
    assert n_tag > 0


def _loaders(root, csv, tokenizer_j, tokenizer_p):
    j = JScarDataset(root, csv_file=csv, transform=jtransforms.EvalTransform(
        jtransforms.PreprocessCfg(size=32)), tokenizer=tokenizer_j,
        is_train=False)
    p = ScarDataset(root, csv_file=csv, transform=transforms.EvalTransform(
        transforms.PreprocessCfg(size=32)), tokenizer=tokenizer_p,
        is_train=False)
    return (jloader.DataLoader(j, batch_size=4, num_workers=2),
            loader.DataLoader(p, batch_size=4, num_workers=2))


@pytest.mark.parametrize("fusion", [False, True])
def test_eval_forward_and_classifier_match_jax(e2e, port_e2e, scar_root,
                                               fusion):
    _, bundle, _ = e2e
    model = port_e2e
    classnames, templates = zero_shot._pick_classnames_templates("scar_val")
    j_cls = jzs.build_zero_shot_classifier(bundle.module, bundle.params,
                                           JTokenizer(), classnames, templates)
    p_cls = zero_shot.build_zero_shot_classifier(model, SimpleTokenizer(),
                                                 classnames, templates)
    np.testing.assert_allclose(p_cls.numpy(), np.asarray(j_cls), atol=1e-3)
    jl, pl = _loaders(*scar_root, JTokenizer(), SimpleTokenizer())
    j_fwd = jzs.make_eval_forward(bundle.module, fusion_scoring=fusion)
    p_fwd = zero_shot.make_eval_forward(model, fusion_scoring=fusion)
    for jb, pb in zip(jl, pl):
        want = j_fwd(bundle.params, jnp.asarray(jb[0]), j_cls)
        got = p_fwd(torch.from_numpy(pb[0]), p_cls)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_zero_shot_eval_matches_jax(e2e, port_e2e, scar_root, tmp_path,
                                    monkeypatch):
    _, bundle, _ = e2e
    root, csv = scar_root
    model = port_e2e
    jl, pl = _loaders(root, csv, JTokenizer(), SimpleTokenizer())
    out = {}
    for side, fn, dl, tok, target in (
            ("jax", jzs.zero_shot_eval, jloader.DataInfo(jl), JTokenizer(),
             (bundle.module, bundle.params)),
            ("port", zero_shot.zero_shot_eval, loader.DataInfo(pl),
             SimpleTokenizer(), (model,))):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        args = SimpleNamespace(checkpoint_path=str(d), save_embed=True,
                               name="parity", use_fusion=True)
        out[side] = (fn(*target, {"scar_val": dl}, 1, args, tok), d)
    (jm, jd), (pm, pd) = out["jax"], out["port"]
    assert set(pm) == set(jm)
    for k, v in jm.items():
        if k.endswith(("top1", "top2", "-n", "per_class_acc")) or "tag_" in k:
            assert pm[k] == v, k
    assert (pd / "val_data_tagging_output.txt").read_text() == (
        jd / "val_data_tagging_output.txt").read_text()
    p_lines = (pd / "val_data_class_output.txt").read_text().splitlines()
    j_lines = (jd / "val_data_class_output.txt").read_text().splitlines()
    assert len(p_lines) == len(j_lines) == 10 + 2
    for a, b in zip(p_lines, j_lines):
        if " - [" not in b:
            assert a == b
            continue
        (a_names, a_scores), (b_names, b_scores) = (
            s.split(" - [") for s in (a, b))
        assert a_names == b_names
        np.testing.assert_allclose(
            [float(x) for x in a_scores.rstrip("]").split(",")],
            [float(x) for x in b_scores.rstrip("]").split(",")], atol=1e-3)
    emb = "dataset_embeddings_all_no_templete_parity"
    pz, jz = np.load(pd / f"{emb}.npz"), np.load(jd / f"{emb}.npz")
    assert sorted(pz.files) == sorted(jz.files) == [
        "img_embeddings", "labels", "txt_embeddings"]
    for k in jz.files:
        assert pz[k].shape == jz[k].shape and pz[k].dtype == jz[k].dtype, k
        np.testing.assert_allclose(pz[k], jz[k], atol=1e-3)
    pt = torch.load(pd / f"{emb}.pt", weights_only=True)
    assert sorted(pt) == ["dataset_labels", "img_embeddings", "labels",
                          "txt_embeddings"]


# -- the train CLI end to end ------------------------------------------------

def _cli(root, csv, logs, name, *extra):
    return main_other.main([
        "--model", "torchtinye2e", "--train-data", root, "--val-data", root,
        "--scar-train-csv", csv, "--scar-val-csv", csv, "--dataset-type",
        "csv", "--batch-size", "4", "--warmup", "1", "--precision", "fp32",
        "--lr", "1e-4", "--use-tagging", "--use-fusion",
        "--prompt-template-setting", "total", "--logs", logs, "--name", name,
        "--log-every-n-steps", "1", "--val-frequency", "1", "--workers", "2",
        "--save-best", "--device", "cpu", *extra])


def test_main_other_scar_end_to_end(e2e, scar_root, tmp_path, cli_logging):
    """Train one epoch, resume it with the accumulation step for a second,
    and read the artifacts with the viz tools."""
    root, csv = scar_root
    logs = str(tmp_path / "logs")
    first = _cli(root, csv, logs, "scar_e2e", "--epochs", "1")
    ckpt_dir = os.path.join(logs, "scar_e2e", "checkpoints")
    for tag in ("epoch_1", "epoch_latest", "last", "best_train_top1",
                "best_train_loss", "best_val_top1", "best_tag_acc"):
        assert os.path.isfile(os.path.join(ckpt_dir, tag, "state.pt")), tag
    for artifact in ("val_data_tagging_output.txt", "val_data_class_output.txt",
                     "traindata_val_tagging_output.txt",
                     "traindata_val_class_output.txt"):
        assert os.path.isfile(os.path.join(ckpt_dir, artifact)), artifact
    assert os.path.isfile(os.path.join(logs, "scar_e2e", "params.txt"))
    assert os.path.isfile(os.path.join(logs, "scar_e2e", "out.log"))
    (rec,) = first["epochs"]
    assert rec["epoch"] == 1 and math.isfinite(rec["train"]["loss"])
    assert "scar_val-top1" in rec["eval"] and "train_data-top1" in rec["eval"]
    assert first["state"].step == 2  # 10 rows, batch 4, drop_last

    saved = {n: p.detach().clone()
             for n, p in first["state"].model.named_parameters()}
    second = _cli(root, csv, logs, "scar_e2e", "--epochs", "2", "--resume",
                  "latest", "--accum-freq", "2")
    assert [r["epoch"] for r in second["epochs"]] == [2]
    assert second["state"].step == 4
    assert set(second["epochs"][0]["train"]) >= {"loss", "tagging_loss",
                                                 "contrastive_loss"}
    assert "ce_loss" not in second["epochs"][0]["train"]  # trap 5
    assert os.path.isdir(os.path.join(ckpt_dir, "epoch_2"))
    moved = [n for n, p in second["state"].model.named_parameters()
             if not torch.equal(p, saved[n])]
    assert moved  # resumed from epoch 1's weights and trained on

    viz_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "viz")
    sys.path.insert(0, viz_dir)
    try:
        import visualize_max_prob_heatmap as heatmap_tool
        import visualize_tag_class_distribution as dist_tool

        out_dir = str(tmp_path / "viz_out")
        tag_txt = os.path.join(ckpt_dir, "traindata_val_tagging_output.txt")
        cls_txt = os.path.join(ckpt_dir, "traindata_val_class_output.txt")
        heatmap_tool.main(["--class-file", cls_txt, "--tag-file", tag_txt,
                           "--output-dir", out_dir])
        dist_tool.main(["--class-file", cls_txt, "--tag-file", tag_txt,
                        "--output-dir", out_dir])
        assert os.path.isfile(os.path.join(out_dir,
                                           "scar_tag_max_prob_data.csv"))
        assert os.path.isfile(os.path.join(
            out_dir, "combined_scar_class_distribution.png"))
    finally:
        sys.path.remove(viz_dir)


def test_main_other_eval_only_save_embed(e2e, scar_root, tmp_path,
                                         monkeypatch, cli_logging):
    """No train data: one zero-shot eval with --save-embed, after
    --load-tagging-only from the JAX package's exported checkpoint."""
    _, _, ckpt = e2e
    root, csv = scar_root
    monkeypatch.chdir(tmp_path)  # --save-embed writes into the cwd
    metrics = main_other.main([
        "--model", "torchtinye2e", "--val-data", root, "--scar-val-csv", csv,
        "--batch-size", "4", "--precision", "fp32", "--logs",
        str(tmp_path / "logs"), "--name", "evalonly", "--save-embed",
        "--workers", "2", "--device", "cpu", "--resume", ckpt,
        "--load-tagging-only"])
    assert "scar_val-top1" in metrics and metrics["scar_val-n"] == 10
    emb = np.load(tmp_path / "dataset_embeddings_all_no_templete_evalonly.npz")
    assert emb["img_embeddings"].shape == (10, 512)
    assert emb["txt_embeddings"].shape == (3, 512)
    assert emb["labels"].shape == (10, 3)
    assert (tmp_path / "dataset_embeddings_all_no_templete_evalonly.pt").is_file()


@pytest.mark.parametrize("flags,match", [
    (["--remote-sync", "s3://bucket/x"], "remote-sync"),
    (["--pretrained", "laion400m_e32"], "laion400m_e32"),
    (["--fsdp"], "fsdp"),
    (["--distill-pretrained", "openai"], "openai"),
])
def test_main_other_unported_flags_raise(flags, match, tmp_path,
                                        cli_logging):
    """All four are ported: ``unported`` passes them (--remote-sync is
    held in tests/test_torch_file_utils.py, named --pretrained tags in
    tests/test_torch_pretrained.py, a named --distill-pretrained tag in
    tests/test_torch_distill.py, --fsdp in tests/test_torch_fsdp.py).
    Beside --fsdp, ``--model-parallel 2`` (tests/test_torch_tp.py) raises
    before the model in one process, whose world size 2 does not divide
    (JAX's mesh assert), and with a timm tower ROADMAP Queue 1 item 11's
    refusal names the flag."""
    argv = ["--model", "ViT-B-32", "--device", "cpu", "--logs",
            str(tmp_path), "--name", "x", *flags]
    assert unported(parse_args(argv)) == []
    if match != "fsdp":
        return
    with pytest.raises(ValueError, match="model-parallel 2 does not divide"):
        main_other.main(argv + ["--model-parallel", "2"])
    timm = argv + ["--model-parallel", "2", "--model", "ViT-B-16-SigLIP"]
    with pytest.raises(NotImplementedError, match="model-parallel"):
        main_other.main(timm)
