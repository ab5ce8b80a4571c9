"""The port's three fine-tune baseline CLIs (cli/baselines/, BASELINE
configs 1 and 3) on the CPU: tests/test_baselines_cli.py's three runs with
``--device cpu`` on a tiny scar dataset, and their parts against the JAX
package: ``classification_metrics`` and ``EarlyStopping`` on seeded
arrays, ``train_supervised`` on the ResNet-50 classifier (no dropout) over
2 epochs under a trainability mask, and the eval-mode logits of the
clip_baseline and biomedclip_baseline classifiers on the same weights.

Bars: metrics and early-stopping decisions exactly; per-epoch train and
validation losses, logits and the new BatchNorm statistics within 1e-3
(the repo's parity bar, BASELINE.md:18); masked parameters bit-unchanged.
The heads' train-mode dropout masks come from a ``torch.Generator`` (an
accepted difference), so the CLIP classifiers are held in eval mode.
"""

import json
import logging
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from scar_fixtures import make_scar_dataset  # noqa: E402

from xtagclip_tpu.cli.baselines import clip_baseline as jclip  # noqa: E402
from xtagclip_tpu.cli.baselines import common as jcommon  # noqa: E402
from xtagclip_tpu.cli.baselines import resnet50_baseline as jresnet  # noqa: E402
from xtagclip_tpu.factory import add_model_config as jax_add_model_config  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.cli.baselines import (  # noqa: E402
    biomedclip_baseline,
    clip_baseline,
    common,
    resnet50_baseline,
)
from xtagclip_tpu_torch.convert.from_jax import (  # noqa: E402
    _flatten,
    load_jax_params,
    port_name,
    stats_buffers,
)
from xtagclip_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)
TINY = dict(
    embed_dim=64,
    vision_cfg=dict(layers=2, width=64, head_width=32, patch_size=16,
                    image_size=64),
    text_cfg=dict(context_length=16, vocab_size=1000, width=64, heads=2,
                  layers=2))


@pytest.fixture(scope="module")
def scar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scar_baselines")
    return str(root), make_scar_dataset(str(root), n=10, image_size=48)


def _register(tmp_path_factory, name, cfg):
    path = tmp_path_factory.mktemp("cfg") / f"{name}.json"
    path.write_text(json.dumps(cfg))
    jax_add_model_config(str(path))
    factory.add_model_config(path)
    return name


@pytest.fixture(scope="module")
def tiny_clip(tmp_path_factory):
    return _register(tmp_path_factory, "torchtinybaseline", TINY)


@pytest.fixture(scope="module")
def tiny_biomedclip(tmp_path_factory):
    """BiomedCLIP's shape at toy size: a timm ViT image tower and an HF
    BERT text tower (a config.json written here; the classifier holds the
    image tower only)."""
    bert = tmp_path_factory.mktemp("bert") / "toy-biomedbert"
    bert.mkdir()
    (bert / "config.json").write_text(json.dumps(dict(
        model_type="bert", vocab_size=200, hidden_size=64,
        num_hidden_layers=1, num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=40)))
    cfg = dict(embed_dim=64,
               vision_cfg=dict(timm_model_name="vit_tiny_patch16_64",
                               timm_pool="", timm_proj="linear",
                               image_size=64),
               text_cfg=dict(hf_model_name=str(bert), hf_proj_type="mlp",
                             hf_pooler_type="cls_last_hidden_state_pooler",
                             context_length=16))
    return _register(tmp_path_factory, "torchtinybiomedbaseline", cfg)


# -- the CLIs (tests/test_baselines_cli.py's runs) ---------------------------

def _common_args(scar_root, tmp_path, ckpt, plot):
    root, csv = scar_root
    return ["--train-root", root, "--val-root", root, "--train-csv", csv,
            "--val-csv", csv, "--batch-size", "4", "--epochs", "2",
            "--patience", "5", "--ckpt", str(tmp_path / ckpt),
            "--output", str(tmp_path / plot), "--device", "cpu"]


def _check(metrics, tmp_path, ckpt, plot):
    assert 0.0 <= metrics["accuracy"] <= 1.0
    for k in ("macro_precision", "macro_recall", "macro_f1", "weighted_f1",
              "per_class"):
        assert k in metrics, metrics
    assert (tmp_path / ckpt).exists()
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    assert (tmp_path / plot).exists()


def test_resnet50_baseline_cli(scar_root, tmp_path):
    metrics = resnet50_baseline.main(
        _common_args(scar_root, tmp_path, "r50.pkl", "r50.png")
        + ["--image-size", "64"])
    _check(metrics, tmp_path, "r50.pkl", "r50.png")
    tree = common.load_pytree(tmp_path / "r50.pkl")
    assert "backbone.layer4_2.bn3.var" in tree["extra"]


def test_resnet50_baseline_loads_torchvision_weights(scar_root, tmp_path):
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    sd = chip_smoke.torchvision_resnet_state_dict(np.random.default_rng(9))
    pth = tmp_path / "resnet50.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    model = resnet50_baseline.ScarClassifier()
    resnet50_baseline.load_torchvision_backbone(model, str(pth))
    np.testing.assert_array_equal(model.backbone.conv1.kernel.detach(),
                                  sd["conv1.weight"])
    np.testing.assert_array_equal(model.backbone.layer3_5.bn2.mean,
                                  sd["layer3.5.bn2.running_mean"])
    metrics = resnet50_baseline.main(
        _common_args(scar_root, tmp_path, "r50.pkl", "r50.png")
        + ["--image-size", "64", "--epochs", "1", "--pretrained", str(pth)])
    assert 0.0 <= metrics["accuracy"] <= 1.0


def test_clip_baseline_cli(scar_root, tmp_path, tiny_clip):
    metrics = clip_baseline.main(
        _common_args(scar_root, tmp_path, "clip.pkl", "clip.png")
        + ["--model", tiny_clip, "--lock-image"])
    _check(metrics, tmp_path, "clip.pkl", "clip.png")


@pytest.mark.parametrize("lock_text", [True, False])
def test_biomedclip_baseline_cli(scar_root, tmp_path, tiny_biomedclip,
                                 lock_text, caplog):
    """--lock-image with --lock-text-encoder on and off (BASELINE config
    3's flags): the built model is the one asked for (the fallback ladder
    did not run), the locked image tower is bit-unchanged and the head
    trained."""
    flags = ["--model", tiny_biomedclip, "--lock-image"]
    flags += ["--lock-text-encoder"] if lock_text else []
    with caplog.at_level(logging.WARNING):
        metrics = biomedclip_baseline.main(
            _common_args(scar_root, tmp_path, "bmc.pkl", "bmc.png") + flags)
    _check(metrics, tmp_path, "bmc.pkl", "bmc.png")
    assert not [r for r in caplog.records if "falling back" in r.message]
    trained = common.load_pytree(tmp_path / "bmc.pkl")["params"]
    assert any(n.startswith("visual.trunk.blocks.11.") for n in trained)
    fresh, _ = clip_baseline.build_classifier(tiny_biomedclip, None, 3, True,
                                              "cpu")
    changed = []
    for n, p in fresh.named_parameters():
        if n.startswith("visual."):
            np.testing.assert_array_equal(trained[n], p.detach().numpy(),
                                          err_msg=n)
        elif np.any(trained[n] != p.detach().numpy()):
            changed.append(n)
    assert any(n.startswith("head.") for n in changed)


def test_biomedclip_baseline_falls_back_with_a_warning(scar_root, tmp_path,
                                                       caplog, monkeypatch):
    """The fallback ladder as JAX has it: a failed build trains a random
    ViT-B-32 and says so (here at ViT-B-32's toy stand-in)."""
    monkeypatch.setattr(biomedclip_baseline, "FALLBACK_MODEL",
                        "torchtinybaseline")
    with caplog.at_level(logging.WARNING):
        biomedclip_baseline.main(
            _common_args(scar_root, tmp_path, "bmc.pkl", "bmc.png")
            + ["--model", "no-such-model", "--epochs", "1"])
    assert [r for r in caplog.records if "falling back" in r.message]


# -- the parts against JAX ---------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_classification_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((37, 4)).astype(np.float32)
    targets = rng.integers(0, 4 if seed else 3, 37)
    assert common.classification_metrics(logits, targets, 4) == \
        jcommon.classification_metrics(logits, targets, 4)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_early_stopping_equals_jax(mode):
    values = np.random.default_rng(11).standard_normal(30).cumsum()
    ours, theirs = common.EarlyStopping(3, mode), jcommon.EarlyStopping(3, mode)
    for v in values:
        assert ours.step(float(v)) == theirs.step(float(v))
        assert ours.should_stop == theirs.should_stop
        assert (ours.best, ours.counter) == (theirs.best, theirs.counter)


class _Batches:
    """A loader over fixed batches (the same rows for both packages)."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)


def _resnet_batches(normalize: bool):
    rng = np.random.default_rng(12)
    mean, std = np.asarray(IMAGENET_MEAN), np.asarray(IMAGENET_STD)
    out = []
    for _ in range(3):
        images = rng.integers(0, 256, (4, 128, 128, 3), dtype=np.uint8)
        if normalize:  # JAX's host normalize (transforms.py:243-249)
            images = ((images / 255.0 - mean) / std).astype(np.float32)
        out.append((images, rng.integers(0, 3, 4).astype(np.int32),
                    rng.integers(0, 2, (4, 22)).astype(np.float32)))
    return out


def test_train_supervised_on_the_resnet_classifier_matches_jax():
    """Two epochs of the ResNet-50 classifier (no dropout) with the
    backbone's stem and first stage masked: per-epoch losses, the best
    epoch's logits and new BN statistics against JAX's; the masked
    parameters bit-unchanged. At lr 1e-6: Adam's first updates are
    lr * sign(g), and where a gradient is near zero its sign is rounding
    noise that differs between the packages (train-mode BatchNorm over 4
    images amplifies it); at the CLI's 1e-4 the two trajectories part by
    ~2% in the second epoch's loss, at 1e-5 the layer-4 statistics by
    2e-3 (measured on these batches)."""
    jmodel = jresnet.ScarClassifier(num_classes=3)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    extra = {"batch_stats": jax.tree.map(np.asarray,
                                         variables["batch_stats"])}

    def frozen(name):
        return name.startswith(("backbone.conv1", "backbone.bn1",
                                "backbone.layer1_"))

    jmask = jax.tree_util.tree_map_with_path(
        lambda path, _: not frozen(port_name(".".join(
            str(getattr(k, "key", k)) for k in path))), params)

    def apply_fn(params, extra, images, additional, train, rng):
        v = {"params": params, **extra}
        if train:
            return jmodel.apply(v, images, additional, train=True,
                                mutable=["batch_stats"])
        return jmodel.apply(v, images, additional, train=False)

    jbatches = _resnet_batches(True)
    jparams, jextra, jhist = jcommon.train_supervised(
        apply_fn, params, extra, _Batches(jbatches), _Batches(jbatches), 3,
        lr=1e-6, num_epochs=2, patience=5, trainable_mask=jmask,
        mutable_stats=True)

    model = resnet50_baseline.ScarClassifier(num_classes=3)
    load_jax_params(model, params, extra["batch_stats"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    mask = {n: not frozen(n) for n in before}
    pbatches = _resnet_batches(False)
    model, hist = common.train_supervised(
        model, _Batches(pbatches), _Batches(pbatches), 3, lr=1e-6,
        num_epochs=2, patience=5, trainable_mask=mask, device="cpu",
        mean=IMAGENET_MEAN, std=IMAGENET_STD)
    for k in ("train_loss", "val_loss", "train_acc", "val_acc"):
        np.testing.assert_allclose(hist[k], jhist[k], **TOL, err_msg=k)
    for n, p in model.named_parameters():
        if not mask[n]:
            assert torch.equal(p, before[n]), n
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters() if mask[n])
    want_stats = {port_name(k): v for k, v in _flatten(jax.tree.map(
        np.asarray, jextra["batch_stats"]))}
    for n, buf in stats_buffers(model).items():
        np.testing.assert_allclose(buf.numpy(), want_stats[n], **TOL,
                                   err_msg=n)
    want = jax.jit(lambda p, e, x, a: apply_fn(p, e, x, a, False, None))(
        jparams, jextra, jbatches[0][0], jbatches[0][2])
    with torch.no_grad():
        got = model(common.device_batch(pbatches[0], "cpu", IMAGENET_MEAN,
                                        IMAGENET_STD)[0],
                    torch.from_numpy(pbatches[0][2]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("which", ["clip", "biomedclip"])
def test_classifier_eval_logits_match_jax(which, tiny_clip, tiny_biomedclip):
    name = tiny_clip if which == "clip" else tiny_biomedclip
    jmodel, params, extra, side = jclip.build_classifier(name, None, 3, True)
    rng = np.random.default_rng(13)
    params = jax.tree.map(lambda v: np.asarray(v) + 0.05 * rng.standard_normal(
        v.shape).astype(np.float32), params)
    model, port_side = clip_baseline.build_classifier(name, None, 3, True,
                                                      "cpu")
    assert port_side == side
    load_jax_params(model, params)
    images = rng.standard_normal((3, side, side, 3)).astype(np.float32)
    additional = rng.integers(0, 2, (3, 22)).astype(np.float32)
    want = jax.jit(lambda p, x, a: jmodel.apply({"params": p, **extra}, x, a,
                                                train=False))(
        params, images, additional)
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(additional))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_checkpoint_tree_round_trips(tmp_path, tiny_clip):
    model, _ = clip_baseline.build_classifier(tiny_clip, None, 3, False,
                                              "cpu")
    path = tmp_path / "c.pkl"
    common._save_pytree(path, common._named_arrays(model))
    with open(path, "rb") as f:
        tree = pickle.load(f)
    other, _ = clip_baseline.build_classifier(tiny_clip, None, 3, False,
                                              "cpu")
    with torch.no_grad():
        for p in other.parameters():
            p.zero_()
    common.load_into(other, tree)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(a, b), n
