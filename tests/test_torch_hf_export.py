"""The port's HF hub export (convert/export.py ``save_hf_checkpoint``,
``push_to_hf_hub``, ``push_pretrained_to_hf_hub``) against the JAX
package's, on the CPU.

The port's toy XTag model carries JAX's weights (``load_jax_params``).
Nothing is uploaded: ``HfApi`` is monkeypatched to record its calls, or
``huggingface_hub`` is made unimportable to stand for a machine that
cannot upload. Bars: ``open_clip_config.json`` equals JAX's; the weights
file holds JAX's tensors exactly; a saved directory placed in a hub cache
loads back through ``pretrained="hf-hub:<org>/<name>"`` bit for bit.
"""

import json
import os
import sys

import huggingface_hub
import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from chip_smoke import write_hub_snapshot  # noqa: E402
from torch_hub import hub  # noqa: E402,F401
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

from xtagclip_tpu.convert import export as jexport  # noqa: E402
from xtagclip_tpu.factory import add_model_config as jax_add_model_config  # noqa: E402
from xtagclip_tpu.factory import create_model as jax_create_model  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.convert import export  # noqa: E402
from xtagclip_tpu_torch.convert.from_jax import load_jax_params  # noqa: E402

torch.set_num_threads(1)

NAME = "torch-hf-export-toy"
TOY = dict(
    embed_dim=512,
    vision_cfg=dict(layers=2, width=64, head_width=32, patch_size=16,
                    image_size=32),
    text_cfg=dict(context_length=77, vocab_size=49408, width=512, heads=4,
                  layers=2),
)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / f"{NAME}.json"
    path.write_text(json.dumps(TOY))
    jax_add_model_config(str(path))
    factory.add_model_config(path)
    bundle = jax_create_model(NAME, use_tagging=True, use_fusion=True,
                              init_seed=3)
    model = factory.create_model(NAME, device="cpu", use_tagging=True,
                                 use_fusion=True)
    load_jax_params(model, jax.tree.map(np.asarray, bundle.params))
    return bundle, model


def test_saved_directory_equals_jax(pair, tmp_path):
    bundle, model = pair
    ours = export.save_hf_checkpoint(model, str(tmp_path / "port"))
    theirs = jexport.save_hf_checkpoint(bundle, str(tmp_path / "jax"))
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == [
        "open_clip_config.json", "open_clip_pytorch_model.bin"]
    with open(os.path.join(ours, "open_clip_config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(theirs, "open_clip_config.json")) as f:
        assert cfg == json.load(f)
    assert cfg["model_cfg"] == TOY
    a = torch.load(os.path.join(ours, "open_clip_pytorch_model.bin"),
                   weights_only=True)
    b = torch.load(os.path.join(theirs, "open_clip_pytorch_model.bin"),
                   weights_only=False)
    assert a["name"] == b["name"] == NAME and a["epoch"] == b["epoch"] == 0
    assert set(a["state_dict"]) == set(b["state_dict"])
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k


def test_hub_round_trip_is_bit_for_bit(pair, hub):
    """The saved directory as a hub snapshot loads back through
    ``pretrained="hf-hub:<org>/<name>"``: every parameter (the CLIP
    towers, the tag head, TQN) equals the source model's."""
    _, model = pair
    snap = write_hub_snapshot(hub, "xtag/scar-b32")
    export.save_hf_checkpoint(model, snap)
    back = factory.create_model(NAME, pretrained="hf-hub:xtag/scar-b32",
                                device="cpu", use_tagging=True,
                                use_fusion=True, init_seed=9)
    got = dict(back.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, got[name]), name


class _RecordingApi:
    calls = []

    def create_repo(self, repo_id, private=False, exist_ok=False):
        self.calls.append(("create_repo", repo_id, private, exist_ok))

    def upload_folder(self, folder_path, repo_id, commit_message):
        self.calls.append(("upload_folder", sorted(os.listdir(folder_path)),
                           repo_id, commit_message))


def test_push_uploads_the_prepared_directory(pair, tmp_path, monkeypatch):
    _, model = pair
    _RecordingApi.calls = []
    monkeypatch.setattr(huggingface_hub, "HfApi", _RecordingApi)
    out = export.push_to_hf_hub(model, "xtag/scar-b32",
                                local_dir=str(tmp_path / "push"),
                                private=True)
    assert out == "xtag/scar-b32"
    assert _RecordingApi.calls == [
        ("create_repo", "xtag/scar-b32", True, True),
        ("upload_folder", ["open_clip_config.json",
                           "open_clip_pytorch_model.bin"],
         "xtag/scar-b32", "Add model")]


def test_push_pretrained_builds_then_uploads(pair, tmp_path, monkeypatch):
    """``push_pretrained_to_hf_hub`` builds the model from ``pretrained`` (a
    local open_clip file here) on the given device and pushes it."""
    _, model = pair
    src = export.save_open_clip_checkpoint(model, str(tmp_path / "w.pt"))
    _RecordingApi.calls = []
    monkeypatch.setattr(huggingface_hub, "HfApi", _RecordingApi)
    out = export.push_pretrained_to_hf_hub(
        NAME, src, "xtag/b32", device="cpu", local_dir=str(tmp_path / "p"),
        commit_message="scar")
    assert out == "xtag/b32" and _RecordingApi.calls[-1][-1] == "scar"
    sd = torch.load(tmp_path / "p" / "open_clip_pytorch_model.bin",
                    weights_only=True)["state_dict"]
    want = export.to_openclip_state_dict(model)
    assert np.array_equal(sd["visual.proj"].numpy(), want["visual.proj"])


def test_push_without_the_hub_names_the_directory(pair, tmp_path,
                                                  monkeypatch):
    """Where the upload cannot run (here ``huggingface_hub`` cannot be
    imported), both packages raise RuntimeError naming the directory
    they prepared, and the directory holds the checkpoint."""
    bundle, model = pair
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    for fn, obj, d in ((export.push_to_hf_hub, model, tmp_path / "port"),
                       (jexport.push_to_hf_hub, bundle, tmp_path / "jax")):
        with pytest.raises(RuntimeError, match=f"checkpoint is at {d}"):
            fn(obj, "xtag/scar-b32", local_dir=str(d))
        assert (d / "open_clip_pytorch_model.bin").is_file()


def test_export_refuses_towers_jax_cannot_export():
    """A ResNet tower (as a timm or HF one) has no open_clip export in
    either package: the message names JAX's limit."""
    factory.register_model_config("torch-hf-export-rn", dict(
        embed_dim=32, vision_cfg=dict(layers=[1, 1, 1, 1], width=16,
                                      image_size=64),
        text_cfg=dict(context_length=16, vocab_size=300, width=64, heads=1,
                      layers=1)))
    model = factory.create_model("torch-hf-export-rn", device="cpu",
                                 skip_init=True)
    with pytest.raises(NotImplementedError, match="export.py:154"):
        export.to_openclip_state_dict(model)
