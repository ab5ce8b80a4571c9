"""The port's ConvNeXt tower (models/convnext.py) and its converter
against the JAX package on the CPU, and a timm ConvNeXt ``.pt`` through
convert/loader.py.

A toy ConvNeXt (two stages, one downsample) with the ``linear`` head and
with ``convnext_large_d``'s ``mlp`` head, its params carried by
convert/from_jax.py. Bars: fp32 within 1e-3 (the module bar,
BASELINE.md:18); converted trees exactly; the loaded parameters exactly.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtagclip_tpu.models import convnext as jconvnext
from xtagclip_tpu_torch.convert.from_jax import (
    _flatten,
    load_jax_params,
    port_name,
    port_value,
)
from xtagclip_tpu_torch.convert.loader import load_checkpoint_into
from xtagclip_tpu_torch.models import convnext

sys.path.insert(0, os.path.dirname(__file__))
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401
from torch_zoo import randomize  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)
DEPTHS, DIMS = (1, 2), (16, 32)


def _pair(proj):
    jmodel = jconvnext.ConvNeXtModel(embed_dim=24, depths=DEPTHS, dims=DIMS,
                                     proj=proj, proj_bias=proj == "mlp")
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    params = randomize(jmodel.init(jax.random.PRNGKey(0),
                                   jnp.asarray(x))["params"], 2)
    model = convnext.ConvNeXtModel(24, DEPTHS, DIMS, proj=proj,
                                   proj_bias=proj == "mlp")
    load_jax_params(model, params)
    return jmodel, params, model, x


@pytest.mark.parametrize("proj", ["linear", "mlp"])
def test_convnext_tower_matches_jax(proj):
    jmodel, params, model, x = _pair(proj)
    pooled, tokens = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        params, x)
    with torch.no_grad():
        got_pooled, got_tokens = model(torch.from_numpy(x))
    assert got_tokens.shape == tokens.shape == (2, 16, 24)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled), **TOL)
    np.testing.assert_allclose(got_tokens.numpy(), np.asarray(tokens), **TOL)


def test_train_mode_forward_is_deterministic_given_the_generator():
    """timm_drop_path (0.1 in every convnext config) is applied by
    neither package: a generator changes nothing."""
    _, _, model, x = _pair("linear")
    with torch.no_grad():
        outs = [model(torch.from_numpy(x), g)[0] for g in (
            None, torch.Generator().manual_seed(0),
            torch.Generator().manual_seed(1))]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("name", ["convnext_base", "convnext_base_w",
                                  "convnext_base_w_320", "convnext_large_d",
                                  "convnext_large_d_320", "convnext_xxlarge",
                                  "convnext_huge"])
def test_build_convnext_tower_matches_jax(name):
    cfg = {"timm_model_name": name, "timm_proj": "mlp" if "_d" in name
           else "linear"}
    try:
        jmodel = jconvnext.build_convnext_tower(64, cfg, jnp.float32,
                                                jnp.float32)
    except NotImplementedError:
        with pytest.raises(NotImplementedError, match="not mapped"):
            convnext.build_convnext_tower(64, cfg)
        return
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
    with torch.device("meta"):
        model = convnext.build_convnext_tower(64, cfg)
    ours = {n: tuple(p.shape) for n, p in model.named_parameters()}
    theirs = {port_name(k): tuple(v.shape) for k, v in _flatten(shapes)}
    assert set(ours) == set(theirs)
    for n, t in theirs.items():
        assert ours[n] == (t if len(t) != 4 else (t[3], t[2], t[0], t[1])), n


def _timm_convnext_sd(params):
    """The timm key layout of a ConvNeXt trunk's flax tree (the inverse of
    convert_timm_convnext_state_dict), under ``visual.trunk.``."""
    def conv(v):
        return np.ascontiguousarray(np.asarray(v).transpose(3, 2, 0, 1))

    ln = {"scale": "weight", "bias": "bias"}
    sd = {"stem.0.weight": conv(params["stem_conv"]["kernel"]),
          "stem.0.bias": params["stem_conv"]["bias"]}
    sd.update({f"stem.1.{ln[k]}": v for k, v in params["stem_norm"].items()})
    for name, node in params.items():
        if name.endswith("_downsample_norm"):
            s = name[len("stage"):-len("_downsample_norm")]
            sd.update({f"stages.{s}.downsample.0.{ln[k]}": v
                       for k, v in node.items()})
        elif name.endswith("_downsample_conv"):
            s = name[len("stage"):-len("_downsample_conv")]
            sd[f"stages.{s}.downsample.1.weight"] = conv(node["kernel"])
            sd[f"stages.{s}.downsample.1.bias"] = node["bias"]
        elif "_block" in name:
            s, b = name[len("stage"):].split("_block")
            p = f"stages.{s}.blocks.{b}."
            sd[p + "conv_dw.weight"] = conv(node["conv_dw"]["kernel"])
            sd[p + "conv_dw.bias"] = node["conv_dw"]["bias"]
            sd.update({p + f"norm.{ln[k]}": v
                       for k, v in node["norm"].items()})
            for fc in ("fc1", "fc2"):
                sd[p + f"mlp.{fc}.weight"] = np.ascontiguousarray(
                    np.asarray(node[f"mlp_{fc}"]["kernel"]).T)
                sd[p + f"mlp.{fc}.bias"] = node[f"mlp_{fc}"]["bias"]
            sd[p + "gamma"] = node["gamma"]
    return {"visual.trunk." + k: np.asarray(v, np.float32)
            for k, v in sd.items()}


def test_convnext_converter_matches_jax():
    _, params, _, _ = _pair("linear")
    sd = _timm_convnext_sd(params["trunk"])
    got = dict(_flatten(convnext.convert_timm_convnext_state_dict(sd)))
    want = dict(_flatten(jconvnext.convert_timm_convnext_state_dict(sd)))
    assert set(got) == set(want) == set(dict(_flatten(params["trunk"])))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_convnext_ptloads_through_the_loader(tmp_path):
    """A timm ConvNeXt trunk + head in an open_clip ``.pt``: every trunk
    parameter and the head projection load exactly."""
    _, params, model, _ = _pair("linear")
    sd = _timm_convnext_sd(params["trunk"])
    sd["visual.head.proj.weight"] = np.ascontiguousarray(
        np.asarray(params["head_proj"]["kernel"]).T)
    path = tmp_path / "convnext.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    holder = torch.nn.Module()  # the model's names start with "visual."
    holder.visual = convnext.ConvNeXtModel(24, DEPTHS, DIMS)
    load_checkpoint_into(holder, str(path))
    want = {"visual." + port_name(k): port_value(v)
            for k, v in _flatten(params)}
    for n, p in holder.named_parameters():
        if n.startswith("visual.head_norm."):
            continue  # no key of the .pt maps to it, as in JAX's converter
        np.testing.assert_array_equal(p.detach().numpy(), want[n], err_msg=n)
