"""``nonscalar_logit_scale``: a config key that builds ``logit_scale`` of
shape (1,) instead of () (JAX xtagclip_tpu/models/clip.py:82). A toy
config with the key, read by the port from an ``XTAGCLIP_EXTRA_CONFIGS``
directory, against JAX's model on the same weights (``from_jax``): the
features, the logits and the scale within 1e-3; then its open_clip
``.pt`` (0-d there, as open_clip writes it) read back into a fresh model
bit for bit, and one train step that keeps the (1,) shape."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))

from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401
from xtagclip_tpu.factory import add_model_config as jax_add_model_config  # noqa: E402
from xtagclip_tpu.factory import create_model as jax_create_model  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.convert.export import save_open_clip_checkpoint  # noqa: E402
from xtagclip_tpu_torch.convert.from_jax import load_jax_params  # noqa: E402
from xtagclip_tpu_torch.convert.loader import load_checkpoint_into  # noqa: E402
from xtagclip_tpu_torch.train import train_state as ts  # noqa: E402
from xtagclip_tpu_torch.train.loop import make_train_step  # noqa: E402

torch.set_num_threads(1)

CFG = dict(
    embed_dim=64, nonscalar_logit_scale=True,
    vision_cfg=dict(layers=1, width=64, head_width=32, patch_size=8,
                    image_size=32),
    text_cfg=dict(context_length=16, vocab_size=1024, width=64, heads=2,
                  layers=1),
)
NAME = "torchtinynonscalar"


def test_nonscalar_logit_scale_matches_jax_and_round_trips(tmp_path,
                                                           monkeypatch):
    user = tmp_path / "user"
    user.mkdir()
    path = user / f"{NAME}.json"
    path.write_text(json.dumps(CFG))
    monkeypatch.setenv("XTAGCLIP_EXTRA_CONFIGS", str(user))
    jax_add_model_config(str(path))
    bundle = jax_create_model(NAME)
    assert bundle.params["logit_scale"].shape == (1,)
    model = factory.create_model(NAME, device="cpu", init_seed=2)
    assert model.logit_scale.shape == (1,)
    load_jax_params(model, jax.tree.map(np.asarray, bundle.params))

    rng = np.random.default_rng(0)
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(1, 1000, (3, 16)).astype(np.int32)
    j_out = bundle.module.apply({"params": bundle.params},
                                jnp.asarray(images), text=jnp.asarray(texts),
                                deterministic=True)
    with torch.no_grad():
        out = model(torch.from_numpy(images),
                    text=torch.from_numpy(texts).long())
    for k in ("image_features", "text_features", "logit_scale"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(j_out[k]),
                                   rtol=1e-3, atol=1e-3, err_msg=k)
    with torch.no_grad():
        logits, _ = model.get_logits(torch.from_numpy(images),
                                     torch.from_numpy(texts).long())
    j_logits, _ = bundle.module.apply(
        {"params": bundle.params}, jnp.asarray(images), jnp.asarray(texts),
        method=bundle.module.get_logits)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=1e-3, atol=1e-3)

    pt = save_open_clip_checkpoint(model, str(tmp_path / "nonscalar.pt"))
    assert torch.load(pt, weights_only=True)["state_dict"][
        "logit_scale"].shape == ()
    fresh = factory.create_model(NAME, device="cpu", init_seed=9)
    load_checkpoint_into(fresh, pt)
    sd, got = model.state_dict(), fresh.state_dict()
    assert sd.keys() == got.keys()
    for k in sd:
        assert torch.equal(got[k], sd[k]), k

    tx = ts.make_optimizer(lambda _: 1e-3,
                           params=dict(fresh.named_parameters()))
    state = ts.create_train_state(fresh, tx)
    state, metrics = make_train_step({"use_tagging_loss": False})(
        state, {"images": torch.from_numpy(images),
                "texts": torch.from_numpy(texts).long()},
        torch.Generator().manual_seed(0))
    assert fresh.logit_scale.shape == (1,)
    assert np.isfinite(metrics["loss"].item())
