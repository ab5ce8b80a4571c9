"""The PyTorch port's package surface against the JAX package's (CPU).

- every name of tests/test_public_api.py's list resolves on the port; the
  ten names that waited for ROADMAP Queue 1 item 9 (the registry, the
  OpenAI loader, the hub pushes) return JAX's results on the toy;
- ``list_models()`` lists the shipped configs as JAX's does, in its order;
- ``CLIPVisionCfg`` and ``CLIPTextCfg`` build models; ``CustomTextCLIP``
  is ``CLIP``; ``create_model_from_pretrained``; the precisions' dtypes;
- ``--precision pure_bf16``: the parameters in JAX's dtypes, bf16 but for
  the LayerNorms' (fp32 in JAX's ``LayerNorm``), biases and the logit
  scale included; a toy forward against JAX's ``pure_bf16`` at the serve
  bar of chip_smoke.py (feature cosine >= 0.999 a row), and one train step
  at its train-path bars (loss 1e-2, gradient norm 2%, cosine >= 0.99,
  here of each parameter's update); ``pure_fp16`` runs the plain versions
  on the CPU and is refused on the card.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import xtagclip_tpu_torch as port  # noqa: E402
from test_public_api import REFERENCE_EXPORTS  # noqa: E402
from xtagclip_tpu import factory as jfactory  # noqa: E402
from xtagclip_tpu.convert.export import (  # noqa: E402
    save_open_clip_checkpoint as jexport_save,
)
from xtagclip_tpu.train import loop as jloop  # noqa: E402
from xtagclip_tpu.train import scheduler as jsched  # noqa: E402
from xtagclip_tpu.train import train_state as jts  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.convert.from_jax import load_jax_params, port_name  # noqa: E402
from xtagclip_tpu_torch.models.layers import LayerNorm  # noqa: E402
from xtagclip_tpu_torch.train import scheduler  # noqa: E402
from xtagclip_tpu_torch.train import train_state as ts  # noqa: E402
from xtagclip_tpu_torch.train.loop import make_train_step  # noqa: E402
from torch_hub import hub  # noqa: E402,F401
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

WAITING = ("list_openai_models", "load_openai_model", "list_pretrained",
           "list_pretrained_models_by_tag", "list_pretrained_tags_by_model",
           "get_pretrained_cfg", "get_pretrained_url", "is_pretrained_cfg",
           "push_to_hf_hub", "push_pretrained_to_hf_hub")
# head dim 64 in both towers (L = 17 and 16): the bf16 streams take the
# fused halves' route, whose kernels get the bf16 bias parameters upcast
CFG = dict(
    embed_dim=64,
    vision_cfg=dict(layers=2, width=128, head_width=64, patch_size=8,
                    image_size=32),
    text_cfg=dict(context_length=16, vocab_size=1000, width=128, heads=2,
                  layers=2),
)
B = 4


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {port_name(".".join(str(getattr(k, "key", k)) for k in path)):
            np.asarray(v, np.float32) for path, v in leaves}


def test_reference_exports_resolve():
    missing = [n for n in REFERENCE_EXPORTS
               if getattr(port, n, None) is None]
    assert not missing, missing
    assert set(REFERENCE_EXPORTS) <= set(port.__all__)
    assert callable(port.tokenize) and port.tokenize("a scar")[0][0] == 49406
    assert port.CustomTextCLIP is port.CLIP
    assert port.__version__ == "0.1.0"


@pytest.mark.parametrize("name", WAITING)
def test_waiting_names_raise_and_name_their_item(name, tmp_path, hub,
                                                  monkeypatch):
    """The names that waited for ROADMAP Queue 1 item 9 (ported since):
    each returns JAX's result on the toy. The registry calls answer as
    JAX's; the two OpenAI calls build ``ViT-B-32`` (the toy in both
    packages) from an OpenAI archive in an offline hub cache; the two
    pushes write JAX's directory and raise JAX's RuntimeError where the
    upload cannot run (``huggingface_hub`` made unimportable)."""
    import xtagclip_tpu as jpkg
    from chip_smoke import clip_layout_state_dict, write_hub_snapshot

    fn, jfn = getattr(port, name), getattr(jpkg, name)
    assert not hasattr(port, "_WAITING")
    registry = {
        "list_pretrained": ((), ()), "list_openai_models": ((), ()),
        "list_pretrained_models_by_tag": (("laion400m_e32",),) * 2,
        "list_pretrained_tags_by_model": (("ViT-B-32",),) * 2,
        "get_pretrained_cfg": (("ViT-B-32", "openai"),) * 2,
        "get_pretrained_url": (("RN50", "openai"),) * 2,
        "is_pretrained_cfg": (("RN50", "OPENAI"),) * 2,
    }
    if name in registry:
        args, jargs = registry[name]
        assert fn(*args) == jfn(*jargs) and fn(*args)
        return
    toy = json.loads(json.dumps(CFG))
    monkeypatch.setitem(jfactory._MODEL_CONFIGS, "ViT-B-32", toy)
    monkeypatch.setitem(factory._EXTRA_CONFIGS, "ViT-B-32", toy)
    if name == "load_openai_model":
        snap = write_hub_snapshot(hub, "timm/vit_base_patch32_clip_224.openai")
        factory.register_model_config("torch-api-oai-src", CFG)
        src = factory.create_model("torch-api-oai-src", device="cpu",
                                   init_seed=8)
        torch.save(clip_layout_state_dict(src, torch.float16),
                   os.path.join(snap, "open_clip_pytorch_model.bin"))
        model = fn("ViT-B-32", device="cpu")
        want = _flat(jfactory.load_openai_model("ViT-B-32",
                                                cache_dir=hub).params)
        for n, p in model.named_parameters():
            if not n.startswith(("tag_", "fusion_model.")):  # not in the file
                np.testing.assert_array_equal(_np(p), want[n], err_msg=n)
        return
    # the pushes: one toy, JAX's weights in both
    bundle = jfactory.create_model("ViT-B-32", init_seed=2)
    model = factory.create_model("ViT-B-32", device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, bundle.params))
    pt = tmp_path / "w.pt"
    jexport_save(bundle, str(pt))
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    for push, obj, d in ((fn, model, tmp_path / "port"),
                         (jfn, bundle, tmp_path / "jax")):
        args = (obj, "xtag/b32") if name == "push_to_hf_hub" else \
            ("ViT-B-32", str(pt), "xtag/b32")
        kw = {"device": "cpu"} if (push is fn and name != "push_to_hf_hub") \
            else {}
        with pytest.raises(RuntimeError, match=f"checkpoint is at {d}"):
            push(*args, local_dir=str(d), **kw)
    for f in ("open_clip_config.json", "open_clip_pytorch_model.bin"):
        assert (tmp_path / "port" / f).is_file()
    assert json.loads((tmp_path / "port" / "open_clip_config.json")
                      .read_text()) == json.loads(
        (tmp_path / "jax" / "open_clip_config.json").read_text())
    a = torch.load(tmp_path / "port" / "open_clip_pytorch_model.bin",
                   weights_only=True)["state_dict"]
    b = torch.load(tmp_path / "jax" / "open_clip_pytorch_model.bin",
                   weights_only=False)["state_dict"]
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_list_models_equals_jax(tmp_path):
    builtin = jfactory.list_builtin_models()
    assert len(builtin) == 117
    assert factory.list_builtin_models() == builtin
    assert [n for n in factory.list_models() if n in builtin] == [
        n for n in jfactory.list_models() if n in builtin]
    path = tmp_path / "torch-listed-cfg.json"
    path.write_text(json.dumps(CFG))
    factory.add_model_config(path)
    assert factory.list_models()[-1] == "torch-listed-cfg"


def test_cfg_dataclasses_build_models(tmp_path):
    v = port.CLIPVisionCfg(layers=2, width=64, head_width=32, patch_size=8,
                           image_size=32)
    t = port.CLIPTextCfg(context_length=16, vocab_size=100, width=64,
                         heads=4, layers=2)
    assert dataclasses.asdict(v) == dataclasses.asdict(
        jfactory_cfg("CLIPVisionCfg")(layers=2, width=64, head_width=32,
                                      patch_size=8, image_size=32))
    path = tmp_path / "torch-tinycfg-dc.json"
    path.write_text(json.dumps({"embed_dim": 64, "vision_cfg": v.to_dict(),
                                "text_cfg": dataclasses.asdict(t)}))
    port.add_model_config(path)
    model = port.create_model("torch-tinycfg-dc", device="cpu",
                              skip_init=True)
    assert model.visual.width == 64
    assert model.text.transformer.resblocks[0].heads == 4


def jfactory_cfg(name):
    from xtagclip_tpu.models import config

    return getattr(config, name)


def test_precision_dtypes_and_model_from_pretrained(tmp_path):
    for p in ("fp32", "bf16", "pure_bf16", "fp16", "pure_fp16"):
        assert str(port.get_input_dtype(p)).split(".")[-1] == \
            jnp.dtype(jfactory.get_input_dtype(p)).name
    path = tmp_path / "torch-tinycfg-fp.json"
    path.write_text(json.dumps(CFG))
    port.add_model_config(path)
    model, eval_t = port.create_model_from_pretrained(
        "hf-hub:someorg/torch-tinycfg-fp", device="cpu")
    assert model.model_name == "torch-tinycfg-fp"
    assert eval_t.cfg.size == 32
    assert port.get_model_preprocess_cfg(model)["size"] == 32


# -- pure_bf16 ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_pair(tmp_path_factory):
    """(name, JAX pure_bf16 bundle, its bf16 weights with non-trivial
    values, the port's pure_bf16 model holding them)."""
    path = tmp_path_factory.mktemp("cfg") / "torch-purebf16.json"
    path.write_text(json.dumps(CFG))
    jfactory.add_model_config(str(path))
    factory.add_model_config(path)
    bundle = jfactory.create_model("torch-purebf16", precision="pure_bf16")
    rng = np.random.default_rng(31)
    params = jax.tree.map(
        lambda v: jnp.asarray(np.asarray(v, np.float32) + 0.05
                              * rng.standard_normal(v.shape), v.dtype),
        bundle.params)
    return "torch-purebf16", bundle, params


def _port_bf16(name, params):
    model = factory.create_model(name, precision="pure_bf16", device="cpu")
    load_jax_params(model, jax.tree.map(lambda v: np.asarray(v, np.float32),
                                        params))
    return model


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            rng.integers(1, 1000, (B, 16)).astype(np.int32))


def test_pure_bf16_parameters_are_bf16(bf16_pair):
    name, bundle, params = bf16_pair
    model = _port_bf16(name, params)
    dtypes = {n: str(p.dtype).split(".")[-1]
              for n, p in model.named_parameters()}
    want = {port_name(".".join(str(k.key) for k in path)):
            jnp.dtype(v.dtype).name
            for path, v in jax.tree_util.tree_leaves_with_path(
                bundle.params)}
    assert dtypes == want
    ln = {n for m_name, m in model.named_modules()
          if isinstance(m, LayerNorm)
          for n in (f"{m_name}.scale", f"{m_name}.bias")}
    assert {n for n, v in dtypes.items() if v == "float32"} == ln
    assert model.dtype == torch.bfloat16
    blk = model.visual.transformer.resblocks[0]
    assert blk.route((B, 17, 128)) == "fused_halves"
    assert blk.attn.in_proj.bias.dtype == model.logit_scale.dtype == \
        torch.bfloat16
    assert blk.ln_1.scale.dtype == torch.float32
    fp32 = factory.create_model(name, precision="bf16", device="cpu")
    assert {p.dtype for p in fp32.parameters()} == {torch.float32}


def test_pure_bf16_forward_matches_jax(bf16_pair):
    name, bundle, params = bf16_pair
    model = _port_bf16(name, params)
    images, texts = _batch(1)
    j_out = jax.jit(lambda p, i, t: bundle.module.apply(
        {"params": p}, i, text=t))(params, jnp.asarray(images, jnp.bfloat16),
                                   texts)
    with torch.no_grad():
        out = model(torch.from_numpy(images).bfloat16(),
                    text=torch.from_numpy(texts).long())
    for k in ("image_features", "text_features"):
        assert out[k].dtype == torch.bfloat16, k
        assert _cosines(out[k], j_out[k]).min() >= 0.999, k
    assert out["logit_scale"].item() == float(j_out["logit_scale"])


def _cosines(a, b):
    a, b = _np(a).reshape(len(a), -1), _np(b).reshape(len(b), -1)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def test_pure_bf16_train_step_matches_jax(bf16_pair):
    """One step on the bf16 parameters against JAX's pure_bf16 step
    (optax AdamW on bf16 leaves, lr 1e-3), at chip_smoke.py's train-path
    bars: loss within 1e-2 and gradient norm within 2% of JAX's step, each
    gradient at cosine >= 0.99 with jax.grad of JAX's ``_model_losses``
    where JAX's is nonzero; the parameters keep JAX's dtypes, and most
    move (a step of lr below half a bf16 ULP, as the logit scale's, moves
    nothing in either package)."""
    name, bundle, params = bf16_pair
    images, texts = _batch(2)
    args = {"use_tagging_loss": False}
    j_batch = {"images": jnp.asarray(images, jnp.bfloat16),
               "texts": jnp.asarray(texts)}
    j_tx = jts.make_optimizer(jsched.const_lr(1e-3, 0, 10), params=params)
    j_step = jloop.make_train_step(bundle.module, j_tx, args, donate=False)
    _, j_metrics = j_step(jts.create_train_state(params, j_tx), j_batch,
                          jax.random.PRNGKey(0))
    j_grads = _flat(jax.jit(jax.grad(lambda p: jloop._model_losses(
        bundle.module, p, j_batch, {"dropout": jax.random.PRNGKey(0)}, args,
        None)[0]))(params))
    model = _port_bf16(name, params)
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    state = ts.create_train_state(model, ts.make_optimizer(
        scheduler.const_lr(1e-3, 0, 10), params=named))
    state, metrics = make_train_step(args)(
        state, {"images": torch.from_numpy(images).bfloat16(),
                "texts": torch.from_numpy(texts).long()},
        torch.Generator().manual_seed(0))
    for k, rel in (("loss", 1e-2), ("contrastive_loss", 1e-2),
                   ("grad_norm", 2e-2)):
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   rtol=rel, err_msg=k)
    compared = moved = 0
    for n, p in named.items():
        assert p.dtype == before[n].dtype, n
        moved += int(not torch.equal(p, before[n]))
        g = j_grads[n]
        if not np.any(g):
            continue
        compared += 1
        assert p.grad.dtype == p.dtype, n
        assert _cosines(p.grad[None], g[None])[0] >= 0.99, n
    assert compared > len(named) // 2 and moved > len(named) // 2


def test_pure_fp16_runs_plain_on_the_cpu_and_is_refused_on_the_card(
        bf16_pair):
    name, _, _ = bf16_pair
    model = factory.create_model(name, precision="pure_fp16", device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float16,
                                                     torch.float32}
    images, texts = _batch(3)
    with torch.no_grad():
        out = model(torch.from_numpy(images).half(),
                    text=torch.from_numpy(texts).long())
    assert out["image_features"].dtype == torch.float16
    assert torch.isfinite(out["image_features"]).all()
    with pytest.raises(NotImplementedError, match="bf16"):
        factory.create_model(name, precision="pure_fp16", device="cuda")
