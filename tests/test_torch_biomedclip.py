"""BASELINE config 3's model in the port against the JAX package, on the
CPU: a toy config of BiomedCLIP's shape (a timm ViT image tower with the
avg pool and a linear head; an HF BERT text tower with
``cls_last_hidden_state_pooler`` and the ``mlp`` projection; a WordPiece
tokenizer), with a vocabulary, a BERT config.json and the scar data
written in the test. Nothing is downloaded.

Covered: the HF-tokenizer prompt table (the fault the port had: its
``PromptTable`` called ``tok.encode`` unconditionally), the towers and the
tag forward, the --lock-image --lock-text trainable mask leaf for leaf
(trap 2: BERT's ``embeddings_ln``, ``out_ln`` and ``output_ln`` and the
projection lock, as in JAX), one train step, one ``main_other`` epoch with
scar_Biomedclip_pretrain.sh's flags through both CLIs, the open_clip
loader on a BiomedCLIP-layout state dict, and the build sweep: the
parameter counts of six shipped configs equal to JAX's.

Bars: fp32 outputs within 1e-3 (BASELINE.md:18); the train step's losses
within 1e-5 relative with dropout off in both; token ids, masks, loaded
parameters and parameter counts exactly. The CLI epoch starts both CLIs
from JAX's seeded init (the two packages' seeded inits differ, an
accepted difference), seeds both train transforms' crops alike, and runs
its steps with dropout off in both (the masks come from a
``torch.Generator`` in the port, an accepted difference): its mean
losses within 1e-4 relative, its eval's top-1/top-2 and tag accuracies
exactly.
"""

import json
import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# imported at collection (tests/test_torch_hf_tokenize.py says why)
import transformers  # noqa: F401

sys.path.insert(0, os.path.dirname(__file__))
from scar_fixtures import make_scar_dataset  # noqa: E402

from xtagclip_tpu.factory import add_model_config as jax_add_model_config  # noqa: E402
from xtagclip_tpu.factory import create_model as jax_create_model  # noqa: E402
from xtagclip_tpu.tokenize.hf import HFTokenizer as JaxHF  # noqa: E402
from xtagclip_tpu.tokenize.prompts import PromptTable as JaxPromptTable  # noqa: E402
from xtagclip_tpu.train import loop as jloop  # noqa: E402
from xtagclip_tpu.train import train_state as jts  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.cli import main_other  # noqa: E402
from xtagclip_tpu_torch.convert.from_jax import load_jax_params, port_name  # noqa: E402
from xtagclip_tpu_torch.convert.loader import load_checkpoint_into  # noqa: E402
from xtagclip_tpu_torch.models.clip import num_combos  # noqa: E402
from xtagclip_tpu_torch.tokenize.hf import HFTokenizer  # noqa: E402
from xtagclip_tpu_torch.tokenize.prompts import PromptTable  # noqa: E402
from xtagclip_tpu_torch.train import loop, metadata  # noqa: E402
from xtagclip_tpu_torch.train import train_state as ts  # noqa: E402
from xtagclip_tpu_torch.train.logger import close_logging  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=1e-3)
NAME = "torchtoybiomedclip"
CTX = 16
HIDDEN, TEXT_LAYERS, INTER, VOCAB, MAX_POS = 64, 2, 128, 1000, 40


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    """A local PubMedBERT stand-in: a WordPiece vocab.txt over the scar
    prompt words and the model's config.json, in a directory whose name
    names BERT."""
    cs = _chip_smoke()
    d = str(tmp_path_factory.mktemp("pubmedbert") / "toy-biomedbert")
    cs.write_wordpiece_vocab(d, cs.scar_prompt_words(), size=VOCAB)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(model_type="bert", vocab_size=VOCAB,
                       hidden_size=HIDDEN, num_hidden_layers=TEXT_LAYERS,
                       num_attention_heads=4, intermediate_size=INTER,
                       max_position_embeddings=MAX_POS), f)
    return d


@pytest.fixture(scope="module")
def cfg_name(bert_dir, tmp_path_factory):
    cfg = dict(
        embed_dim=64,
        vision_cfg=dict(timm_model_name="vit_tiny_patch16_32",
                        timm_model_pretrained=False, timm_pool="",
                        timm_proj="linear", image_size=32),
        text_cfg=dict(hf_model_name=bert_dir, hf_tokenizer_name=bert_dir,
                      hf_proj_type="mlp",
                      hf_pooler_type="cls_last_hidden_state_pooler",
                      context_length=CTX))
    path = tmp_path_factory.mktemp("cfg") / f"{NAME}.json"
    path.write_text(json.dumps(cfg))
    jax_add_model_config(str(path))
    factory.add_model_config(path)
    return NAME


def _noisy(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: np.asarray(v) + 0.05 * rng.standard_normal(
        v.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def pair(cfg_name):
    bundle = jax_create_model(cfg_name, use_tagging=True)
    params = _noisy(bundle.params, 0)
    model = factory.create_model(cfg_name, device="cpu", use_tagging=True)
    load_jax_params(model, params)
    return bundle, params, model


# -- the fault: the HF-tokenizer prompt table --------------------------------

def test_prompt_table_with_hf_tokenizer_equals_jax(bert_dir):
    templates = ["sentence_1", "itemization"]
    classes = list(metadata.SCAR_CLASSNAMES)
    want = JaxPromptTable(classes, JaxHF(bert_dir, context_length=CTX),
                          templates=templates).table
    tok = HFTokenizer(bert_dir, context_length=CTX)
    assert not hasattr(tok, "encode")  # the tokenizer the port tripped on
    got = PromptTable(classes, tok, templates=templates).table
    assert got.dtype == np.int32
    assert got.shape == (2, 3, num_combos(), CTX)
    np.testing.assert_array_equal(got, want)
    assert (got[..., 0] == 101).all()  # [CLS] opens every prompt
    assert (got == 100).mean() < 0.01  # the prompt words are in the vocab


# -- the towers --------------------------------------------------------------

def _images(b=3, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, 32, 32, 3)).astype(np.float32)


def _texts(b=3, seed=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(104, VOCAB, (b, CTX)).astype(np.int32)
    ids[:, 0] = 101
    ids[0, 7:] = 0
    ids[1, 12:] = 0
    return ids


def test_encode_image_text_and_tags_match_jax(pair):
    bundle, params, model = pair
    images, texts = _images(), _texts()
    m = bundle.module

    @jax.jit
    def jax_side(p, images, texts):
        v = {"params": p}
        img, img_tokens = m.apply(v, images, True, method=m.encode_image)
        txt, txt_tokens = m.apply(v, texts, True, method=m.encode_text)
        tags = m.apply(v, img_tokens, method=m.tag_forward)
        return img, img_tokens, txt, txt_tokens, tags

    want = jax_side(params, images, texts)
    with torch.no_grad():
        img, img_tokens = model.encode_image(torch.from_numpy(images), True)
        txt, txt_tokens = model.encode_text(torch.from_numpy(texts).long(),
                                            True)
        tags = model.tag_forward(img_tokens)
    assert img_tokens.shape == (3, 5, 64)   # cls + 4 patches, projected
    assert txt_tokens.shape == (3, CTX - 1, HIDDEN)  # seq[:, 1:], unprojected
    for g, w in zip((img, img_tokens, txt, txt_tokens, tags), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# -- the lock mask (trap 2) --------------------------------------------------

def test_lock_image_lock_text_mask_equals_jax_leaf_for_leaf(pair):
    bundle, params, model = pair
    want = jts.trainable_mask(params, lock_image=True, lock_text=True)
    want = {port_name(".".join(str(getattr(k, "key", k)) for k in path)): v
            for path, v in jax.tree_util.tree_leaves_with_path(want)}
    got = ts.trainable_mask(dict(model.named_parameters()), lock_image=True,
                            lock_text=True)
    assert got == want
    # trap 2: BERT's LayerNorms and the projection lock with the tower,
    # where the reference's HFTextEncoder.lock keeps them trainable
    for name in ("text.transformer.embeddings_ln.scale",
                 "text.transformer.layers.0.attention.out_ln.scale",
                 "text.transformer.layers.1.output_ln.bias",
                 "text.proj_fc1.kernel", "text.proj_fc2.kernel"):
        assert got[name] is False, name
    assert {n for n, t in got.items() if t} == {
        n for n in got if n.split(".")[0] in (
            "logit_scale", "tag_head", "tag_labels", "tag_fc")}


@pytest.mark.parametrize("groups", [1, 2, 5])
def test_timm_lock_groups_equal_jax(pair, groups):
    bundle, params, model = pair
    want = jts.trainable_mask(params, lock_image=True,
                              lock_image_unlocked_groups=groups)
    want = {port_name(".".join(str(getattr(k, "key", k)) for k in path)): v
            for path, v in jax.tree_util.tree_leaves_with_path(want)}
    got = ts.trainable_mask(dict(model.named_parameters()), lock_image=True,
                            lock_image_unlocked_groups=groups)
    assert got == want
    assert any(got[n] for n in got if n.startswith("visual."))


# -- training ----------------------------------------------------------------

class _Deterministic:
    """The JAX module with dropout off (the step passes
    ``deterministic=False``)."""

    def __init__(self, module):
        self.module = module

    def apply(self, *args, **kwargs):
        kwargs["deterministic"] = True
        kwargs.pop("rngs", None)
        return self.module.apply(*args, **kwargs)


def test_train_step_losses_match_jax(pair):
    bundle, params, model = pair
    rng = np.random.default_rng(3)
    b = 4
    additional = np.zeros((b, 22), np.float32)
    for off, size in zip((0, 3, 7, 10, 14, 18), (3, 4, 3, 4, 4, 4)):
        additional[np.arange(b), off + rng.integers(0, size, b)] = 1.0
    images = _images(b, 4)
    class_ids = rng.integers(0, 3, b).astype(np.int32)
    table = _texts(3 * num_combos(), 5).reshape(1, 3, num_combos(), CTX)
    args_cfg = {"use_tagging_loss": True}
    _, (jm, _) = jax.jit(lambda p: jloop._model_losses(
        _Deterministic(bundle.module), p,
        {"images": images, "class_ids": class_ids, "additional": additional,
         "template_id": 0}, None, args_cfg, jnp.asarray(table)))(params)
    total, pm = loop._model_losses(
        model, {"images": torch.from_numpy(images),
                "class_ids": torch.from_numpy(class_ids).long(),
                "additional": torch.from_numpy(additional),
                "template_id": 0},
        args_cfg, torch.from_numpy(table).long(), deterministic=True)
    assert set(pm) == set(jm) == {"contrastive_loss", "tagging_loss", "loss",
                                  "logit_scale"}
    for k, v in jm.items():
        assert abs(pm[k].item() - float(v)) <= 1e-5 * abs(float(v)), k


@pytest.fixture(scope="module")
def scar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scar_biomed")
    return str(root), make_scar_dataset(str(root), n=10, image_size=48)


def _script_flags(root, csv, logs, name):
    """scar_Biomedclip_pretrain.sh's flags at the toy config, one epoch."""
    return ["--batch-size", "4", "--workers", "1", "--train-data", root,
            "--val-data", root, "--scar-train-csv", csv, "--scar-val-csv",
            csv, "--dataset-type", "csv", "--precision", "fp32",
            "--warmup", "50", "--lr", "5e-6", "--wd", "0.1", "--epochs", "1",
            "--lock-image", "--lock-text", "--model", NAME,
            "--prompt-template-setting", "sentence_1", "--use-tagging",
            "--logs", logs, "--name", name, "--val-frequency", "1"]


def test_main_other_epoch_matches_jax(pair, scar_root, tmp_path,
                                      monkeypatch):
    from xtagclip_tpu.cli import main_other as jmain

    root, csv = scar_root
    logs = str(tmp_path / "logs")
    jax_epochs, jax_eval, jax_init = [], [], []
    real_epoch, real_eval = jmain.train_one_epoch, jmain.zero_shot_eval
    real_create = jmain.create_model_and_transforms
    port_create = main_other.create_model_and_transforms

    def record_create(*a, **k):
        out = real_create(*a, **k)
        jax_init.append(jax.tree.map(np.asarray, out[0].params))
        return out

    def create_from_jax_init(*a, **k):  # the two CLIs' seeded inits differ
        out = port_create(*a, **k)
        load_jax_params(out[0], jax_init[0])
        return out

    def record_epoch(*a, **k):
        state, metrics = real_epoch(*a, **k)
        jax_epochs.append(metrics)
        return state, metrics

    def record_eval(*a, **k):
        out = real_eval(*a, **k)
        jax_eval.append(out)
        return out

    monkeypatch.setattr(jmain, "train_one_epoch", record_epoch)
    monkeypatch.setattr(jmain, "zero_shot_eval", record_eval)
    monkeypatch.setattr(jmain, "create_model_and_transforms", record_create)
    # both train transforms draw their crops from an unseeded random.Random
    # (with one worker, in item order): seed them alike
    # dropout off in both steps (its masks come from a torch.Generator in
    # the port, an accepted difference)
    real_jax_losses, real_losses = jloop._model_losses, loop._model_losses
    monkeypatch.setattr(jloop, "_model_losses", lambda module, *a, **k:
                        real_jax_losses(_Deterministic(module), *a, **k))
    monkeypatch.setattr(loop, "_model_losses", lambda model, batch, cfg,
                        table=None, generator=None, deterministic=False,
                        teacher=None: real_losses(model, batch, cfg, table,
                                                  None, True, teacher))

    class SeededRandom(random.Random):
        def __init__(self, x=0):
            super().__init__(x)

    monkeypatch.setattr(random, "Random", SeededRandom)
    monkeypatch.setattr(main_other, "create_model_and_transforms",
                        create_from_jax_init)
    try:
        jmain.main(_script_flags(root, csv, logs, "jax"))
    finally:
        close_logging()
        import logging

        for h in list(logging.getLogger().handlers):
            logging.getLogger().removeHandler(h)
    try:
        out = main_other.main(_script_flags(root, csv, logs, "port")
                              + ["--device", "cpu"])
    finally:
        close_logging()
    (rec,) = out["epochs"]
    (jrec,) = jax_epochs
    assert np.isfinite(rec["train"]["loss"])
    for k in ("loss", "contrastive_loss", "tagging_loss"):
        assert abs(rec["train"][k] - jrec[k]) <= 1e-4 * abs(jrec[k]), k
    (jev,) = jax_eval
    for k, v in jev.items():
        if k.endswith(("top1", "top2")) or "tag_acc" in k:
            assert rec["eval"][k] == v, k
    # the locked towers are bit-unchanged, the head moved
    fresh = factory.create_model(NAME, device="cpu", use_tagging=True)
    load_jax_params(fresh, jax_init[0])
    fresh = dict(fresh.named_parameters())
    moved = []
    for n, p in out["state"].model.named_parameters():
        if n.startswith(("visual.", "text.")):
            assert torch.equal(p, fresh[n]), n
        elif not torch.equal(p, fresh[n]):
            moved.append(n)
    assert any(n.startswith("tag_") for n in moved)


# -- loading a BiomedCLIP-layout checkpoint ----------------------------------

def test_openclip_biomedclip_checkpoint_loads_as_jax(pair, tmp_path):
    bundle, _, _ = pair
    cs = _chip_smoke()
    sd = cs.biomedclip_state_dict(
        np.random.default_rng(7), width=192, layers=12, patch=16,
        image_size=32, embed_dim=64, vocab=VOCAB, hidden=HIDDEN,
        text_layers=TEXT_LAYERS, intermediate=INTER, max_positions=MAX_POS)
    path = cs.save_state_dict(sd, str(tmp_path / "biomedclip.pt"))
    from xtagclip_tpu.convert.loader import load_checkpoint_into as jax_load

    jax_load(bundle, path)
    want = {port_name(".".join(str(getattr(k, "key", k)) for k in p)): v
            for p, v in jax.tree_util.tree_leaves_with_path(bundle.params)}
    model = factory.create_model(NAME, device="cpu", use_tagging=True)
    load_checkpoint_into(model, path)
    loaded = [n for n in want if n.startswith(("visual.", "text."))]
    assert len(loaded) == 12 * 12 + 7 + 2 * 16 + 7
    for name in loaded:
        p = dict(model.named_parameters())[name]
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(want[name]), err_msg=name)


# -- the build sweep ---------------------------------------------------------

@pytest.mark.parametrize("name", [
    "RN50", "RN50x4", "BiomedCLIP-PubMedBERT_256-vit_base_patch16_224",
    "roberta-ViT-B-32", "vit_medium_patch16_gap_256", "ViT-B-16-SigLIP"])
def test_config_parameter_count_equals_jax(name):
    bundle = jax_create_model(name, skip_init=True)
    cfg = bundle.model_cfg
    side = cfg["vision_cfg"].get("image_size", 224)
    ctx = cfg["text_cfg"].get("context_length", 77)
    shapes = jax.eval_shape(lambda: bundle.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)),
        text=jnp.zeros((1, ctx), jnp.int32)))
    want = sum(int(np.prod(v.shape))
               for v in jax.tree_util.tree_leaves(shapes["params"]))
    model = factory.create_model(name, device="meta", skip_init=True)
    assert sum(p.numel() for p in model.parameters()) == want
    stats = jax.tree_util.tree_leaves(shapes.get("batch_stats", {}))
    from xtagclip_tpu_torch.convert.from_jax import stats_buffers

    assert sum(b.numel() for b in stats_buffers(model).values()) == sum(
        int(np.prod(v.shape)) for v in stats)
