"""The port's position-embedding resize and the loader branch that uses it,
against the JAX package, on the CPU.

``resize_vision_pos_embed`` / ``resize_text_pos_embed`` against JAX's
(``jax.image.resize``: Keys cubic at a = -0.5, half-pixel centres, an
antialiased downsample, renormalised in-bounds weights), and the port's
``load_checkpoint_into`` against JAX's ``merge_converted_params`` on
open_clip ``.pt`` files that the JAX exporter writes from toy trees of
ViT-B-16's geometry (patch 16: 197 rows with the cls row at 224 px, 256
without it at 256 px). Bar: atol 1e-5, since the port sums in float64
with numpy and JAX in float32.
"""

import json

import jax
import numpy as np
import pytest
import torch

from xtagclip_tpu.convert.export import to_openclip_state_dict
from xtagclip_tpu.convert.loader import merge_converted_params
from xtagclip_tpu.convert.openclip import convert_openclip_state_dict
from xtagclip_tpu.factory import add_model_config as jax_add_model_config
from xtagclip_tpu.factory import create_model as jax_create_model
from xtagclip_tpu.models import pos_embed as jpos
from xtagclip_tpu_torch import factory
from xtagclip_tpu_torch.convert.from_jax import load_jax_params, port_name
from xtagclip_tpu_torch.convert.loader import load_checkpoint_into
from xtagclip_tpu_torch.models import pos_embed
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

ATOL = 1e-5
GAP = dict(pool_type="avg", no_class_token=True, image_size=256)
CLS = dict(
    embed_dim=64,
    vision_cfg=dict(layers=1, width=64, head_width=32, patch_size=16,
                    image_size=224),
    text_cfg=dict(context_length=16, vocab_size=1024, width=64, heads=2,
                  layers=1),
)


def _table(seed, rows, dim=48):
    return np.random.default_rng(seed).standard_normal(
        (rows, dim)).astype(np.float32)


@pytest.mark.parametrize("old,new", [(7, 16), (14, 16), (16, 14), (14, 7)])
@pytest.mark.parametrize("prefix", [0, 1])
def test_resize_vision_pos_embed_matches_jax(old, new, prefix):
    """Up- and downsamples (16 -> 14 and 14 -> 7 take the antialiased,
    widened kernel), with and without a cls row, which passes through."""
    pos = _table(old * 10 + new + prefix, old * old + prefix)
    got = pos_embed.resize_vision_pos_embed(pos, (new, new),
                                            num_prefix_tokens=prefix)
    ref = jpos.resize_vision_pos_embed(pos, (new, new),
                                       num_prefix_tokens=prefix)
    assert got.shape == (new * new + prefix, 48) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[:prefix], pos[:prefix])


@pytest.mark.parametrize("old,new", [(77, 16), (16, 77)])
def test_resize_text_pos_embed_matches_jax(old, new):
    pos = _table(old + new, old)
    got = pos_embed.resize_text_pos_embed(pos, new)
    ref = jpos.resize_text_pos_embed(pos, new)
    assert got.shape == (new, 48)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_resize_is_the_identity_at_the_same_size():
    pos = _table(1, 197)
    assert pos_embed.resize_vision_pos_embed(pos, (14, 14)) is pos
    assert pos_embed.resize_text_pos_embed(pos, 197) is pos


def _register(tmp_path_factory, name, cfg):
    path = tmp_path_factory.mktemp("cfg") / f"{name}.json"
    path.write_text(json.dumps(cfg))
    jax_add_model_config(str(path))
    factory.add_model_config(path)
    return name


def _with(vision=None, context=None):
    cfg = json.loads(json.dumps(CLS))
    cfg["vision_cfg"].update(vision or {})
    if context:
        cfg["text_cfg"]["context_length"] = context
    return cfg


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    """A cls tower at 224 px and a GAP tower at 256 px whose text context
    is 20, not 16, so a load between them resizes both tables."""
    return (_register(tmp_path_factory, "torchposcls", _with()),
            _register(tmp_path_factory, "torchposgap", _with(GAP, 20)))


@pytest.fixture(scope="module")
def bundle(configs):
    """JAX bundles by (config index, vision override), built once: the
    cls source at 224 px, the GAP tower, the cls tower at 256 px."""
    cache = {}

    def get(i, image_size=None):
        key = (i, image_size)
        if key not in cache:
            kw = {"vision_cfg": {"image_size": image_size}} if image_size \
                else {}
            cache[key] = jax_create_model(configs[i], init_seed=len(cache),
                                          **kw)
        return cache[key]

    return get


def _export(bundle, path):
    """The JAX bundle as an open_clip .pt (the JAX exporter's state dict)."""
    sd = to_openclip_state_dict(jax.tree.map(np.asarray, bundle.params))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               path)
    return sd


def _assert_matches_tree(model, tree):
    flat = jax.tree_util.tree_leaves_with_path(tree)
    named = dict(model.named_parameters())
    assert len(flat) == len(named)
    for path, v in flat:
        name = port_name(".".join(str(getattr(k, "key", k)) for k in path))
        np.testing.assert_allclose(named[name].detach().numpy(),
                                   np.asarray(v, np.float32), rtol=0,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("src,dst", [(0, 1), (1, 0)], ids=["cls_to_gap",
                                                            "gap_to_cls"])
def test_loader_resizes_as_merge_converted_params(configs, bundle, tmp_path,
                                                  src, dst):
    """cls -> GAP drops the cls row; GAP -> cls keeps the model's own cls
    row (the port model starts from the JAX init, so both hold the same
    one); the vision table resizes bicubically (14 <-> 16 a side), the
    text table linearly (16 <-> 20 rows)."""
    source, target = bundle(src), bundle(dst)
    path = str(tmp_path / "src.pt")
    sd = _export(source, path)
    want = merge_converted_params(target.params,
                                  convert_openclip_state_dict(sd),
                                  strict=False)
    model = factory.create_model(configs[dst], device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, target.params))
    load_checkpoint_into(model, path)
    rows = (256, 20) if dst == 1 else (197, 16)
    assert tuple(model.visual.positional_embedding.shape)[0] == rows[0]
    assert tuple(model.text.positional_embedding.shape)[0] == rows[1]
    _assert_matches_tree(model, want)


@pytest.mark.parametrize("how", ["gap_config", "force_image_size"])
def test_gap_tower_loads_a_vit_b16_openclip_checkpoint(configs, bundle,
                                                       tmp_path, how):
    """An open_clip .pt of ViT-B-16's geometry (197 rows) loads through
    ``create_model_and_transforms(pretrained=...)`` into the GAP config,
    and into the cls config at --force-image-size 256 (the vision_cfg
    override main_other passes), as JAX's loader loads it."""
    source = bundle(0)
    path = str(tmp_path / "vit_b16.pt")
    sd = _export(source, path)
    assert sd["visual.positional_embedding"].shape == (197, 64)
    name, kw = ((configs[1], {}) if how == "gap_config"
                else (configs[0], {"vision_cfg": {"image_size": 256}}))
    target = bundle(*((1,) if how == "gap_config" else (0, 256)))
    want = merge_converted_params(target.params,
                                  convert_openclip_state_dict(sd),
                                  strict=False)
    model, _, _ = factory.create_model_and_transforms(
        name, pretrained=path, device="cpu", **kw)
    rows = 256 if how == "gap_config" else 257
    assert tuple(model.visual.positional_embedding.shape) == (rows, 64)
    got = model.visual.positional_embedding.detach().numpy()
    ref = np.asarray(want["visual"]["positional_embedding"])
    np.testing.assert_allclose(got[rows - 256:], ref[rows - 256:], rtol=0,
                               atol=ATOL)
    if how == "force_image_size":  # the checkpoint's own cls row
        np.testing.assert_array_equal(got[0],
                                      sd["visual.positional_embedding"][0])
    np.testing.assert_array_equal(
        model.visual.conv1.kernel.detach().numpy(),
        np.asarray(want["visual"]["conv1"]["kernel"]))
