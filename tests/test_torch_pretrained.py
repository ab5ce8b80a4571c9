"""The port's pretrained registry and the resolution and loading of named
``--pretrained`` tags (pretrained.py, factory.load_pretrained,
convert/loader.py) against the JAX package's, on the CPU.

Nothing is fetched: a URL fetch is ``urlretrieve`` monkeypatched (as
tests/test_pretrained_download.py does), and the hub route reads a hub
cache written in the test, offline (tests/torch_hub.py). The weights are a
seeded open_clip CLIP checkpoint in the public repos' layout, written in
the test. Where a tag must resolve, a toy config stands in for ViT-B-32
in both packages (the registry's entries are ViT-B-32's).

Bars: the registry's answers and the resolved paths equal JAX's; the
loaded parameters equal JAX's exactly in fp32 (``.bin`` route), and the
``.safetensors`` route loads the same bits as the ``.bin`` route; the sha
cases are tests/test_pretrained_download.py's.
"""

import hashlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from chip_smoke import clip_layout_state_dict, write_hub_snapshot  # noqa: E402
from scar_fixtures import make_scar_dataset  # noqa: E402
from torch_hub import hub  # noqa: E402,F401
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

from xtagclip_tpu import factory as jfactory  # noqa: E402
from xtagclip_tpu import pretrained as jpretrained  # noqa: E402
from xtagclip_tpu_torch import factory, pretrained  # noqa: E402
from xtagclip_tpu_torch.convert.from_jax import port_name, port_value  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny-e2e geometry of tests/test_torch_trainer.py (text width 512 and
# the real vocabulary, as TQN and the BPE prompts need)
TOY = dict(
    embed_dim=512,
    vision_cfg=dict(layers=2, width=64, head_width=32, patch_size=16,
                    image_size=32),
    text_cfg=dict(context_length=77, vocab_size=49408, width=512, heads=4,
                  layers=2),
)
B32 = "ViT-B-32"
HUB_E32 = "timm/vit_base_patch32_clip_224.laion400m_e32"
GOOD = b"weights-bytes-good"
GOOD_SHA = hashlib.sha256(GOOD).hexdigest()
OPENAI_URL = f"https://openaipublic.azureedge.net/clip/models/{GOOD_SHA}/RN50.pt"


@pytest.fixture
def toy_b32(monkeypatch):
    """ViT-B-32 is the toy in both packages for the test."""
    monkeypatch.setitem(jfactory._MODEL_CONFIGS, B32, json.loads(
        json.dumps(TOY)))
    monkeypatch.setitem(factory._EXTRA_CONFIGS, B32, json.loads(
        json.dumps(TOY)))
    return B32


@pytest.fixture(scope="module")
def clip_sd():
    """A seeded open_clip CLIP checkpoint of the toy (fp32, the text tower
    at the top level, no tag head), as the public repos hold it."""
    name = "torch-pretrained-src"
    factory.register_model_config(name, TOY)
    return clip_layout_state_dict(factory.create_model(
        name, device="cpu", init_seed=11))


def _write_bin(hub_dir, sd, repo=HUB_E32):
    snap = write_hub_snapshot(hub_dir, repo)
    path = os.path.join(snap, "open_clip_pytorch_model.bin")
    torch.save(sd, path)
    return path


def _write_safetensors(hub_dir, sd, repo=HUB_E32):
    from safetensors.torch import save_file

    snap = write_hub_snapshot(hub_dir, repo)
    path = os.path.join(snap, "open_clip_model.safetensors")
    save_file({k: v.contiguous() for k, v in sd.items()}, path)
    return path


def _jax_flat(bundle):
    leaves = jax.tree_util.tree_leaves_with_path(bundle.params)
    return {port_name(".".join(str(k.key) for k in path)):
            port_value(np.asarray(v, np.float32)) for path, v in leaves}


def _clip_params(state):
    return {n: v for n, v in state.items()
            if not n.startswith(("tag_", "fusion_model."))}


# -- the registry --------------------------------------------------------------

def test_registry_answers_equal_jax():
    assert len(pretrained.list_pretrained()) == 165
    assert pretrained.list_pretrained() == jpretrained.list_pretrained()
    assert pretrained.list_pretrained(as_str=True) == \
        jpretrained.list_pretrained(as_str=True)
    for tag in ("openai", "laion400m_e32", "laion2b_s34b_b79k", "nope"):
        assert pretrained.list_pretrained_models_by_tag(tag) == \
            jpretrained.list_pretrained_models_by_tag(tag)
    for model in (B32, "RN50", "ViT-H-14-CL32-GAP", "nope"):
        assert pretrained.list_pretrained_tags_by_model(model) == \
            jpretrained.list_pretrained_tags_by_model(model)
    for model, tag in ((B32, "laion400m_e32"), (B32, "LAION400M-E32"),
                       ("RN50", "openai"), (B32, "nope"), ("nope", "x")):
        assert pretrained.is_pretrained_cfg(model, tag) == \
            jpretrained.is_pretrained_cfg(model, tag)
        assert pretrained.get_pretrained_cfg(model, tag) == \
            jpretrained.get_pretrained_cfg(model, tag)
        assert pretrained.get_pretrained_url(model, tag) == \
            jpretrained.get_pretrained_url(model, tag)


def test_default_cache_dir_reads_xtagclip_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("XTAGCLIP_CACHE", str(tmp_path / "c"))
    assert pretrained.default_cache_dir() == jpretrained.default_cache_dir() \
        == str(tmp_path / "c")
    monkeypatch.delenv("XTAGCLIP_CACHE")
    assert pretrained.default_cache_dir() == jpretrained.default_cache_dir()


# -- URL fetches and their sha256 (tests/test_pretrained_download.py) ---------

def _serve(monkeypatch, payload):
    calls = []

    def fake_retrieve(url, target):
        calls.append(url)
        with open(target, "wb") as f:
            f.write(payload)

    monkeypatch.setattr(pretrained.urllib.request, "urlretrieve",
                        fake_retrieve)
    return calls


@pytest.mark.parametrize("url,explicit,want", [
    (OPENAI_URL, "", GOOD_SHA),
    ("https://github.com/mlfoundations/open_clip/releases/download/"
     "v0.2-weights/vit_b_32-quickgelu-laion400m_e31-d867053b.pt", "",
     "d867053b"),
    ("https://github.com/mlfoundations/open_clip/releases/download/"
     "v0.2-weights/vit_b_32-quickgelu-laion400m_e31-d867053b.pt",
     "abcdef12", "abcdef12"),
    ("https://example.com/weights.pt", "", ""),
    ("https://github.com/mlfoundations/x/releases/model-final.pt", "", ""),
], ids=["openai", "mlfoundations", "explicit", "unknown-host", "not-hex"])
def test_expected_sha256_for_url(url, explicit, want):
    assert pretrained.expected_sha256_for_url(url, explicit) == want
    assert jpretrained.expected_sha256_for_url(url, explicit) == want


def test_download_verifies_and_caches(tmp_path, monkeypatch):
    calls = _serve(monkeypatch, GOOD)
    p = pretrained.download_pretrained_from_url(OPENAI_URL, str(tmp_path))
    assert open(p, "rb").read() == GOOD and len(calls) == 1
    assert pretrained.download_pretrained_from_url(OPENAI_URL,
                                                   str(tmp_path)) == p
    assert len(calls) == 1


def test_corrupted_download_raises_and_leaves_nothing(tmp_path, monkeypatch):
    _serve(monkeypatch, b"corrupted-bytes")
    with pytest.raises(RuntimeError, match="sha256"):
        pretrained.download_pretrained_from_url(OPENAI_URL, str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_corrupted_cache_is_fetched_again(tmp_path, monkeypatch):
    (tmp_path / "RN50.pt").write_bytes(b"stale-or-corrupt")
    calls = _serve(monkeypatch, GOOD)
    p = pretrained.download_pretrained_from_url(OPENAI_URL, str(tmp_path))
    assert calls == [OPENAI_URL] and open(p, "rb").read() == GOOD


def test_unverifiable_url_downloads_once(tmp_path, monkeypatch):
    calls = _serve(monkeypatch, GOOD)
    url = "https://example.com/w.pt"
    p = pretrained.download_pretrained_from_url(url, str(tmp_path))
    assert open(p, "rb").read() == GOOD and len(calls) == 1
    pretrained.download_pretrained_from_url(url, str(tmp_path))
    assert len(calls) == 1


def test_directory_in_the_cache_raises(tmp_path):
    (tmp_path / "RN50.pt").mkdir()
    with pytest.raises(RuntimeError, match="not a regular file"):
        pretrained.download_pretrained_from_url(OPENAI_URL, str(tmp_path))


# -- resolution: tags, URLs, hf-hub: and local files -------------------------

def test_resolution_gives_jax_paths(hub, tmp_path, monkeypatch, clip_sd):
    """A tag (the hub route), an ``hf-hub:`` id, a URL (fetched into
    ``cache_dir``) and a local file resolve to the same paths in both
    packages; an unknown tag and a tag whose repo is not in the cache
    raise."""
    path = _write_bin(hub, clip_sd)
    for mod in (pretrained, jpretrained):
        monkeypatch.setattr(mod.urllib.request, "urlretrieve",
                            lambda url, target: open(target, "wb").write(
                                b"weights"))
    local = tmp_path / "w.pt"
    local.write_bytes(b"x")
    urls = str(tmp_path / "c")
    cases = [("laion400m_e32", hub, path), ("LAION400M-E32", hub, path),
             (f"hf-hub:{HUB_E32}", hub, path),
             ("https://example.com/a.pt", urls, os.path.join(urls, "a.pt")),
             (str(local), None, str(local))]
    for tag, cache, want in cases:
        assert pretrained.resolve_pretrained(B32, tag, cache) == want, tag
        assert jpretrained.resolve_pretrained(B32, tag, cache) == want, tag
    # the port reads HF_HUB_CACHE at the call
    assert pretrained.resolve_pretrained(B32, "laion400m_e32") == path
    with pytest.raises(FileNotFoundError, match="no pretrained tag 'nope'"):
        pretrained.resolve_pretrained(B32, "nope")
    with pytest.raises(FileNotFoundError, match="could not fetch weights"):
        pretrained.resolve_pretrained(B32, "laion400m_e31")


# -- loading a resolved file -------------------------------------------------

def test_bin_tag_loads_jax_parameters(hub, toy_b32, clip_sd):
    """``create_model(ViT-B-32, pretrained="laion400m_e32")`` through the
    hub's ``.bin``: the CLIP parameters equal JAX's exactly in fp32 (both
    the file's), the tag head keeps the port's seeded init, and, as in
    JAX, the registry's ``quick_gelu: true`` is not applied (ROADMAP Queue
    3: the towers keep the config's exact gelu)."""
    _write_bin(hub, clip_sd)
    assert pretrained.get_pretrained_cfg(B32, "laion400m_e32")["quick_gelu"]
    bundle = jfactory.create_model(B32, "laion400m_e32", cache_dir=hub,
                                   use_tagging=True, use_fusion=True)
    assert bundle.quick_gelu is False
    model = factory.create_model(B32, "laion400m_e32", device="cpu",
                                 use_tagging=True, use_fusion=True)
    assert model.visual.transformer.resblocks[0].act == "gelu"
    want = _jax_flat(bundle)
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    for name, value in _clip_params(got).items():
        np.testing.assert_array_equal(value, want[name], err_msg=name)
    fresh = factory.create_model(B32, device="cpu", use_tagging=True,
                                 use_fusion=True)
    for name, p in fresh.named_parameters():
        if name.startswith(("tag_", "fusion_model.")):
            assert np.array_equal(got[name], p.detach().numpy()), name


def test_safetensors_route_loads_the_bin_bits(hub, tmp_path, toy_b32,
                                              clip_sd):
    """Where the hub cache holds ``open_clip_model.safetensors`` (tried
    first; the public repo ships both files), the port reads it with
    ``safetensors`` to the bits of the ``.bin``. JAX hands it to
    ``torch.load``, which reads it only in a torch that dispatches on the
    ``.safetensors`` extension (ROADMAP Queue 3): there JAX's parameters
    equal the port's, elsewhere JAX's load raises."""
    bin_model = factory.create_model(
        B32, str(_write_bin(str(tmp_path / "bin_only"), clip_sd)),
        device="cpu")
    _write_bin(hub, clip_sd)
    path = _write_safetensors(hub, clip_sd)
    assert pretrained.resolve_pretrained(B32, "laion400m_e32") == path
    st_model = factory.create_model(B32, "laion400m_e32", device="cpu")
    got = dict(st_model.named_parameters())
    for name, p in bin_model.named_parameters():
        assert torch.equal(p, got[name]), name
    try:
        torch.load(path, weights_only=True)
    except Exception:  # noqa: BLE001 (this torch's load has no such route)
        with pytest.raises(Exception):
            jfactory.create_model(B32, "laion400m_e32", cache_dir=hub)
        return
    want = _jax_flat(jfactory.create_model(B32, "laion400m_e32",
                                           cache_dir=hub))
    for name, value in _clip_params(got).items():
        np.testing.assert_array_equal(value.detach().numpy(), want[name],
                                      err_msg=name)


def test_precision_and_hf_hub_model_names(hub, toy_b32, clip_sd):
    """A ``pure_bf16`` model loads the file's values rounded to bf16; an
    ``hf-hub:<org>/<name>`` model name builds the registry config
    ``<name>``, as JAX's does, and a name with no config raises."""
    _write_bin(hub, clip_sd)
    model = factory.create_model(B32, f"hf-hub:{HUB_E32}", device="cpu",
                                 precision="pure_bf16")
    w = model.visual.transformer.resblocks[0].attn.in_proj.kernel
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, clip_sd["visual.transformer.resblocks.0.attn."
                                  "in_proj_weight"].T.to(torch.bfloat16))
    model = factory.create_model(f"hf-hub:org/{B32}", device="cpu",
                                 skip_init=True)
    assert model.model_name == B32
    with pytest.raises(RuntimeError, match="no local config"):
        factory.create_model("hf-hub:org/no-such-model", device="cpu")


def test_main_other_runs_the_pretrain_script_flags(hub, tmp_path, toy_b32,
                                                  clip_sd):
    """``python -m xtagclip_tpu_torch.cli.main_other`` with
    scar_openclip_pretrain.sh's flags (``--model ViT-B-32 --pretrained
    laion400m_e32``; the toy as ViT-B-32 through XTAGCLIP_EXTRA_CONFIGS,
    the hub cache through HF_HUB_CACHE, offline) and ``--epochs 0``, so
    that its ``last`` checkpoint holds the loaded weights: they equal
    JAX's ``create_model`` from the same cache exactly."""
    _write_bin(hub, clip_sd)
    cfg_dir = tmp_path / "cfgs"
    cfg_dir.mkdir()
    (cfg_dir / f"{B32}.json").write_text(json.dumps(TOY))
    root = str(tmp_path / "scar_train")
    csv = make_scar_dataset(root, n=8, image_size=40)
    env = dict(os.environ, XTAGCLIP_EXTRA_CONFIGS=str(cfg_dir),
               PYTHONPATH=REPO)
    argv = ["--batch-size", "4", "--workers", "4", "--train-data", root,
            "--val-data", "", "--precision", "amp", "--save-frequency",
            "250", "--warmup", "50", "--lr", "5e-5", "--wd", "0.1",
            "--epochs", "500", "--local-loss", "--model", B32,
            "--pretrained", "laion400m_e32", "--prompt-template-setting",
            "total", "--use-tagging", "--use-fusion",
            # "$@": the run's own flags
            "--scar-train-csv", csv, "--epochs", "0", "--device", "cpu",
            "--logs", str(tmp_path / "logs"), "--name", "pretrain"]
    res = subprocess.run([sys.executable, "-m",
                          "xtagclip_tpu_torch.cli.main_other", *argv],
                         env=env, cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    state = torch.load(tmp_path / "logs" / "pretrain" / "checkpoints" /
                       "last" / "state.pt", weights_only=True)
    got = state["state"]["model"]
    bundle = jfactory.create_model(B32, "laion400m_e32", cache_dir=hub,
                                   use_tagging=True, use_fusion=True)
    want = _jax_flat(bundle)
    clip = _clip_params(dict(got))
    assert len(clip) > 30
    for name, value in clip.items():
        np.testing.assert_array_equal(value.numpy(), want[name],
                                      err_msg=name)
