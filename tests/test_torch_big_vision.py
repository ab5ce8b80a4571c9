"""The port's big_vision ``.npz`` loading (convert/big_vision.py and the
``.npz`` branch of convert/loader.py) against the JAX package's, on the
CPU, on tests/test_big_vision_convert.py's synthesized archive
(``_make_npz``: D = 32, 4 heads of 8, 2 image and 3 text encoder blocks),
with both key prefixes ('img/...' and 'params/img/...').

Bars: the converted tree equals JAX's leaf for leaf; a toy model started
from the same weights in both packages and loaded from the archive equals
JAX's ``load_checkpoint_into`` (``merge_converted_params``) parameter for
parameter, exactly, and within 1e-5 where the vision position table is
resized (4 x 4 -> 6 x 6); the loaded models' image and text features within
1e-3 (fp32). What JAX's converter leaves unmapped (the class token,
ln_pre, the image projection; the text projection where the tower has no
projection bias) keeps its value in both.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_big_vision_convert import EMB, _make_npz

from xtagclip_tpu.convert.big_vision import load_big_vision_weights as j_load
from xtagclip_tpu.convert.loader import load_checkpoint_into as j_into
from xtagclip_tpu.factory import add_model_config as jax_add_model_config
from xtagclip_tpu.factory import create_model as jax_create_model
from xtagclip_tpu_torch import factory
from xtagclip_tpu_torch.convert.big_vision import load_big_vision_weights
from xtagclip_tpu_torch.convert.from_jax import (
    _flatten,
    load_jax_params,
    port_name,
)
from xtagclip_tpu_torch.convert.loader import load_checkpoint_into
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

# _make_npz's geometry as a CLIP config: patch 4 on a 16 px image (a 4 x 4
# grid, the archive's 16-row table), FF = 2 D, text context 16, vocab 100
VISION = dict(layers=2, width=32, head_width=8, patch_size=4, image_size=16,
              mlp_ratio=2.0, pool_type="avg", final_ln_after_pool=True)
TEXT = dict(context_length=16, vocab_size=100, width=32, heads=4, layers=3,
            mlp_ratio=2.0, pool_type="last", no_causal_mask=True)
CONFIGS = {
    # the ViT-H-14-CL32-GAP-BigVision layout: a class token, no text bias
    "bv-toy": dict(embed_dim=EMB, vision_cfg=VISION, text_cfg=TEXT),
    # a cls-free GAP tower and a text head with bias: everything maps
    "bv-toy-gap-bias": dict(
        embed_dim=EMB, vision_cfg=dict(VISION, no_class_token=True),
        text_cfg=dict(TEXT, proj_bias=True)),
}


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    root = tmp_path_factory.mktemp("bv_cfg")
    for name, cfg in CONFIGS.items():
        path = root / f"{name}.json"
        path.write_text(json.dumps(cfg))
        jax_add_model_config(str(path))
        factory.add_model_config(path)
    return root


def _archive(tmp_path, prefixed):
    if prefixed:
        return _make_npz(tmp_path, "params/img", "params/txt", "params/")
    return _make_npz(tmp_path)


@pytest.mark.parametrize("prefixed", [False, True])
def test_tree_matches_jax(tmp_path, prefixed):
    path, _ = _archive(tmp_path, prefixed)
    ours = dict(_flatten(load_big_vision_weights(path)))
    want = dict(_flatten(j_load(path)))
    assert sorted(ours) == sorted(want)
    for key, val in want.items():
        assert ours[key].shape == val.shape, key
        np.testing.assert_array_equal(ours[key], val, err_msg=key)


def _loaded_pair(name, path, image_size=None):
    """(JAX bundle, port model): the same init (JAX's, through
    load_jax_params), then the archive loaded by each package's
    load_checkpoint_into."""
    kw = {"vision_cfg": {"image_size": image_size}} if image_size else {}
    bundle = jax_create_model(name, **kw)
    model = factory.create_model(name, device="cpu", **kw)
    load_jax_params(model, jax.tree.map(np.asarray, bundle.params))
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    j_into(bundle, path)
    load_checkpoint_into(model, path)
    return bundle, model, init


def _jax_params(bundle):
    return {port_name(k): np.asarray(v) for k, v in
            _flatten(jax.tree.map(np.asarray, bundle.params))}


@pytest.mark.parametrize("prefixed", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loaded_parameters_equal_jax(configs, tmp_path, name, prefixed):
    path, w = _archive(tmp_path, prefixed)
    bundle, model, init = _loaded_pair(name, path)
    want = _jax_params(bundle)
    ours = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert sorted(ours) == sorted(want)
    for n, val in want.items():
        np.testing.assert_array_equal(ours[n], val, err_msg=n)
    ik = "params/img" if prefixed else "img"
    np.testing.assert_array_equal(
        ours["visual.conv1.kernel"], w[f"{ik}/embedding/kernel"].reshape(
            -1, 32))
    kept = sorted(n for n in ours if n.split(".")[0] in ("visual", "text")
                  and np.array_equal(ours[n], init[n].numpy()))
    # big_vision's ViT has no ln_pre (its init, scale 1 and bias 0, stays)
    unread = ["visual.ln_pre.bias", "visual.ln_pre.scale", "visual.proj"]
    if name == "bv-toy":
        unread = sorted(unread + ["text.text_projection",
                                  "visual.class_embedding"])
    assert kept == unread


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_position_table_resize_matches_jax(configs, tmp_path, name):
    """A 24 px model (6 x 6 grid) from the archive's 4 x 4 table: both
    packages resize it (with the class row kept from the init where the
    tower has one) and agree within 1e-5."""
    path, _ = _archive(tmp_path, False)
    bundle, model, _ = _loaded_pair(name, path, image_size=24)
    want = _jax_params(bundle)["visual.positional_embedding"]
    got = model.visual.positional_embedding.detach().numpy()
    assert got.shape == want.shape == (36 + (name == "bv-toy"), 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_features_match_jax(configs, tmp_path, name):
    path, _ = _archive(tmp_path, True)
    bundle, model, _ = _loaded_pair(name, path)
    rng = np.random.default_rng(4)
    images = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    texts = np.zeros((3, 16), np.int32)
    texts[:, 0] = 98  # the archive's vocabulary has 100 ids
    texts[:, 1:9] = rng.integers(1, 98, (3, 8))
    texts[:, 9] = 99
    variables = {"params": bundle.params}
    module = bundle.module
    j_img, _ = module.apply(variables, jnp.asarray(images), True,
                            method=module.encode_image)
    j_txt, _ = module.apply(variables, jnp.asarray(texts), True,
                            method=module.encode_text)
    model.eval()
    with torch.inference_mode():
        p_img, _ = model.encode_image(torch.from_numpy(images),
                                      normalize=True)
        p_txt, _ = model.encode_text(torch.from_numpy(texts).long(),
                                     normalize=True)
    np.testing.assert_allclose(p_img.numpy(), np.asarray(j_img), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(p_txt.numpy(), np.asarray(j_txt), atol=1e-3,
                               rtol=1e-3)
    assert float(model.logit_scale.detach()) == 2.0


def test_key_filter_and_factory_route(configs, tmp_path):
    """``--pretrained x.npz`` reaches the loader through the factory;
    a key filter loads only the parameters it names."""
    path, w = _archive(tmp_path, False)
    model = factory.create_model_and_transforms(
        "bv-toy-gap-bias", path, device="cpu")[0]
    np.testing.assert_array_equal(
        model.text.token_embedding.embedding.detach().numpy(),
        w["txt/Embed_0/embedding"])
    fresh = factory.create_model("bv-toy-gap-bias", device="cpu")
    before = {n: p.detach().clone() for n, p in fresh.named_parameters()}
    load_checkpoint_into(fresh, path,
                         key_filter=lambda n: n.startswith("text."))
    for n, p in fresh.named_parameters():
        assert torch.equal(p, before[n]) != n.startswith("text."), n


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_unread_keys_and_kept_parameters_are_warned(configs, tmp_path,
                                                    monkeypatch, caplog,
                                                    name):
    """The loader warns with the archive keys JAX's converter leaves unread
    (recorded by wrapping JAX's np.load) and the parameters whose values
    JAX's load leaves at their init, both whole. The archive gains the
    CLIPA-v2 keys that no converter reads: the patch embedding's bias and
    the image head."""
    import xtagclip_tpu.convert.big_vision as jbv

    path, w = _archive(tmp_path, False)
    rng = np.random.default_rng(5)
    np.savez(path, **w, **{
        "img/embedding/bias": rng.standard_normal(32, dtype=np.float32),
        "img/head/kernel": rng.standard_normal((32, EMB), dtype=np.float32),
        "img/head/bias": rng.standard_normal(EMB, dtype=np.float32)})
    jax_read = set()

    class Recording:
        def __init__(self, p):
            self.npz = np.load(p)
            self.files = self.npz.files

        def __getitem__(self, key):
            jax_read.add(key)
            return self.npz[key]

    class Numpy:  # JAX's converter's numpy, its np.load recording
        load = Recording

        def __getattr__(self, attr):
            return getattr(np, attr)

    monkeypatch.setattr(jbv, "np", Numpy())
    with caplog.at_level("WARNING"):
        bundle, model, init = _loaded_pair(name, path)
    monkeypatch.undo()
    records = [r for r in caplog.records
               if hasattr(r, "big_vision_unread")]
    assert len(records) == 1 and records[0].levelname == "WARNING"
    unread = records[0].big_vision_unread
    assert unread == sorted(set(np.load(path).files) - jax_read)
    assert unread == ["img/embedding/bias", "img/head/bias",
                      "img/head/kernel"]
    want_kept = sorted(n for n, v in _jax_params(bundle).items()
                       if np.array_equal(v, init[n].numpy()))
    assert sorted(records[0].big_vision_kept) == want_kept
    assert ("visual.proj" in want_kept) and (
        ("text.text_projection" in want_kept) == (name == "bv-toy"))
