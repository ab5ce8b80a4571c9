"""Helpers of the zoo's port tests (tests/test_torch_{eva,vitamin,
convnext,swin,fastvit,t5_m2m,registry}.py): JAX params made non-trivial
from a seed, exact tree comparison, and a timm trunk ``.pt`` put through
the port's loader."""

import jax
import numpy as np
import torch

from xtagclip_tpu_torch.convert import timm_families
from xtagclip_tpu_torch.convert.from_jax import _flatten, port_name, port_value
from xtagclip_tpu_torch.convert.loader import load_checkpoint_into
from xtagclip_tpu_torch.models import timm_vit


def randomize(params, seed):
    """``params`` plus seeded noise of scale 0.05 (inits of zeros and ones
    become values that tell parameters apart)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: np.asarray(v, np.float32) + 0.05 * (
        rng.standard_normal(v.shape).astype(np.float32)), params)


def tree_equal(got, want):
    """Two nested trees with the same paths and equal leaves."""
    got, want = dict(_flatten(got)), dict(_flatten(want))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def loads_through_the_loader(trunk_model, sd, tmp_path):
    """``sd`` (timm trunk keys) as an open_clip ``.pt`` under
    ``visual.trunk.``, loaded into a ``TimmModel`` around ``trunk_model``
    by convert/loader.py: every trunk parameter equals the converted
    tree's."""
    path = tmp_path / "trunk.pt"
    torch.save({f"visual.trunk.{k}": torch.from_numpy(np.asarray(v))
                for k, v in sd.items()}, path)
    holder = torch.nn.Module()
    holder.visual = timm_vit.TimmModel(trunk_model, 1, 1)
    load_checkpoint_into(holder, str(path))
    want = {"visual.trunk." + port_name(k): port_value(v) for k, v in
            _flatten(timm_families.convert_timm_trunk(
                {f"visual.trunk.{k}": v for k, v in sd.items()}))}
    got = {n: p for n, p in holder.named_parameters()
           if n.startswith("visual.trunk.")}
    assert set(got) == set(want)
    for n, p in got.items():
        np.testing.assert_array_equal(p.detach().numpy(), want[n], err_msg=n)
