"""The port's OpenAI checkpoint reader (convert/openai.py) and
``pretrained="openai"`` against the JAX package's, on the CPU.

Archives are written in the test in OpenAI's layout (the text tower at
the top level, fp16 tensors, the ``input_resolution``, ``context_length``
and ``vocab_size`` entries): with ``torch.save`` as
tests/test_openai_loader.py writes one, and as a TorchScript archive
(``torch.jit.save``), as OpenAI ships them. The toy satisfies the shape
rules the config inference relies on (text heads of 64, vision head
width 64). ``pretrained="openai"`` reads a hub cache written in the test,
offline (tests/torch_hub.py), with the toy standing in for ViT-B-32 in
both packages.

Bars: the inferred config equals JAX's; the loaded parameters equal JAX's
exactly in fp32 (the same fp16 values, upcast).
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from chip_smoke import (  # noqa: E402
    clip_layout_state_dict,
    modified_resnet_state_dict,
    write_hub_snapshot,
)
from torch_hub import hub  # noqa: E402,F401
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

from xtagclip_tpu import factory as jfactory  # noqa: E402
from xtagclip_tpu.convert import openai as jopenai  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.convert import openai  # noqa: E402
from xtagclip_tpu_torch.convert.from_jax import port_name, port_value  # noqa: E402

torch.set_num_threads(1)

CFG = dict(
    embed_dim=64,
    quick_gelu=True,
    vision_cfg=dict(layers=2, width=128, patch_size=8, image_size=32),
    text_cfg=dict(context_length=16, vocab_size=300, width=128, heads=2,
                  layers=2),
)
METADATA = {"input_resolution": torch.tensor(32),
            "context_length": torch.tensor(16),
            "vocab_size": torch.tensor(300)}


@pytest.fixture(scope="module")
def fp16_sd():
    """The toy's CLIP towers, seeded, as OpenAI's fp16 state dict."""
    factory.register_model_config("torch-oai-src", CFG)
    model = factory.create_model("torch-oai-src", device="cpu", init_seed=5)
    return clip_layout_state_dict(model, torch.float16)


class _Holder(nn.Module):
    """A TorchScript-able module whose state dict is ``sd``: one submodule
    per dotted prefix, each tensor a buffer."""

    def __init__(self, sd):
        super().__init__()
        for key, value in sd.items():
            owner = self
            *path, leaf = key.split(".")
            for part in path:
                if part not in owner._modules:
                    owner.add_module(part, nn.Module())
                owner = owner._modules[part]
            owner.register_buffer(leaf, value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _write_archive(path, sd, kind):
    full = {**sd, **METADATA}
    if kind == "jit":
        torch.jit.save(torch.jit.script(_Holder(full)), path)
    else:
        torch.save(full, path)
    return str(path)


def _jax_flat(params):
    leaves = jax.tree_util.tree_leaves_with_path(params)
    return {port_name(".".join(str(k.key) for k in path)):
            port_value(np.asarray(v, np.float32)) for path, v in leaves}


def _assert_loaded_params_equal(model, params):
    """The parameters an OpenAI archive holds (not the tag head or TQN,
    which keep each package's own init) equal JAX's."""
    want = _jax_flat(params)
    for name, p in model.named_parameters():
        if not name.startswith(("tag_", "fusion_model.")):
            np.testing.assert_array_equal(p.detach().numpy(), want[name],
                                          err_msg=name)


@pytest.mark.parametrize("kind", ["torch_save", "jit"])
def test_state_dict_and_config_equal_jax(fp16_sd, tmp_path, kind):
    path = _write_archive(tmp_path / "oai.pt", fp16_sd, kind)
    got = openai.load_openai_state_dict(path)
    want = jopenai.load_openai_state_dict(path)
    assert set(got) == set(want) == set(fp16_sd)
    for k, v in got.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    cfg = openai.config_from_openai_state_dict(got)
    assert cfg == jopenai.config_from_openai_state_dict(want)
    assert cfg["vision_cfg"] == CFG["vision_cfg"]
    assert cfg["text_cfg"] == CFG["text_cfg"] and cfg["quick_gelu"] is True


def test_resnet_config_inference_equals_jax():
    rng = np.random.default_rng(3)
    sd = modified_resnet_state_dict(rng, (1, 1, 1, 1), width=16,
                                    embed_dim=32, image_size=64)
    sd.update({"positional_embedding": np.zeros((16, 64), np.float32),
               "token_embedding.weight": np.zeros((300, 64), np.float32),
               "ln_final.weight": np.zeros(64, np.float32),
               "text_projection": np.zeros((64, 32), np.float32),
               "transformer.resblocks.0.ln_1.weight": np.zeros(64)})
    sd = {k: np.asarray(v) for k, v in sd.items()}
    got = openai.config_from_openai_state_dict(sd)
    assert got == jopenai.config_from_openai_state_dict(sd)
    assert got["vision_cfg"] == dict(layers=[1, 1, 1, 1], width=16,
                                     image_size=64)


@pytest.mark.parametrize("kind", ["torch_save", "jit"])
def test_load_openai_model_equals_jax(fp16_sd, tmp_path, kind):
    """``load_openai_model(path)``: the model the shapes imply (QuickGELU),
    every parameter equal to JAX's exactly."""
    path = _write_archive(tmp_path / f"oai-{kind}.pt", fp16_sd, kind)
    model = openai.load_openai_model(path, device="cpu")
    bundle = jopenai.load_openai_model(path)
    assert model.visual.transformer.resblocks[0].act == "quick_gelu"
    assert model.model_cfg == CFG
    _assert_loaded_params_equal(model, bundle.params)
    first = model.text.token_embedding.embedding
    assert torch.equal(first, fp16_sd["token_embedding.weight"].float())


def test_pretrained_openai_tag_equals_jax(fp16_sd, hub, monkeypatch):
    """``create_model("ViT-B-32", pretrained="openai")``: the registry's
    hub repo (``timm/vit_base_patch32_clip_224.openai``) in the cache holds
    the fp16 archive; the port loads JAX's parameters exactly;
    ``load_openai_model`` is the same call, and ``list_openai_models``
    JAX's list."""
    toy = {k: v for k, v in CFG.items() if k != "quick_gelu"}
    monkeypatch.setitem(jfactory._MODEL_CONFIGS, "ViT-B-32", toy)
    monkeypatch.setitem(factory._EXTRA_CONFIGS, "ViT-B-32", toy)
    snap = write_hub_snapshot(hub, "timm/vit_base_patch32_clip_224.openai")
    _write_archive(os.path.join(snap, "open_clip_pytorch_model.bin"),
                   fp16_sd, "torch_save")
    model = factory.create_model("ViT-B-32", pretrained="openai",
                                 device="cpu")
    bundle = jfactory.create_model("ViT-B-32", pretrained="openai",
                                   cache_dir=hub)
    _assert_loaded_params_equal(model, bundle.params)
    # as in JAX, the model config's activation (no QuickGELU): Queue 3
    assert model.visual.transformer.resblocks[0].act == "gelu"
    again = factory.load_openai_model("ViT-B-32", device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
    assert factory.list_openai_models() == jfactory.list_openai_models()
    assert "ViT-B-32" in factory.list_openai_models()
    assert json.dumps(model.model_cfg, sort_keys=True) == json.dumps(
        bundle.model_cfg, sort_keys=True)
