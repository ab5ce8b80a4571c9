"""Workers of tests/test_torch_tp_uneven.py: ``--model-parallel 4`` over
towers whose 6 heads 4 does not divide (2, 2, 1, 1 whole heads a rank),
on gloo ranks, and the one-process steps they are held to.

Two toy CLIPs, built as tests/torch_tp_zoo_worker.py builds its own (its
``step`` and ``resume`` run them, with this file's ``build``):

- ``rab6``: ``ResidualAttentionBlock`` towers of width 384, 6 heads of
  64: the text tower (16 tokens) on the fused halves' partial modes (a
  rank's local width 128 or 64), the vision tower (patch 4: 257 tokens)
  on the non-fused route (the core over the local heads, the
  row-parallel out-projection, #4's partial mode on the hidden slice);
- ``vitamin6``: a ViTamin tower whose one ``GeGluBlock`` has 6 heads of
  16, beside the ``rab6`` text tower.

and, for ``--model-parallel 2`` on two ranks, ``mixed``: a vision tower
whose ``ResidualAttentionBlock`` has 1 head of 64 (fewer than the ranks:
replicated whole) beside a text tower whose block has 2 heads of 64 (split,
on the fused halves' partial modes).

    python tests/torch_tp_uneven_worker.py <scenario> <rank> <world> <dir>
"""

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import torch_dist_worker as w  # noqa: E402
import torch_tp_zoo_worker as zw  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.core import mesh  # noqa: E402
from xtagclip_tpu_torch.models import timm_vit, vitamin  # noqa: E402
from xtagclip_tpu_torch.models.clip import NUM_TAGS  # noqa: E402
from xtagclip_tpu_torch.models.layers import (  # noqa: E402
    Dense,
    Embed,
    local_heads,
)
from xtagclip_tpu_torch.models.tag_head import TagBertHead  # noqa: E402
from xtagclip_tpu_torch.parallel import sharding  # noqa: E402

torch.set_num_threads(1)

HEADS, WIDTH, EMBED = 6, 384, 64
NAME = "torchtinytpuneven"
CFG = dict(
    embed_dim=EMBED,
    vision_cfg=dict(layers=1, width=WIDTH, head_width=WIDTH // HEADS,
                    patch_size=4, image_size=zw.IMAGE),
    text_cfg=dict(context_length=zw.CTX, vocab_size=zw.VOCAB, width=WIDTH,
                  heads=HEADS, layers=1))
KINDS = ("rab6", "vitamin6")
MIXED_NAME = "torchtinytpmixed"
MIXED_CFG = dict(
    embed_dim=EMBED,
    vision_cfg=dict(layers=1, width=64, head_width=64, patch_size=4,
                    image_size=zw.IMAGE),
    text_cfg=dict(context_length=zw.CTX, vocab_size=zw.VOCAB, width=128,
                  heads=2, layers=1))


def register(directory) -> None:
    for name, cfg in ((NAME, CFG), (MIXED_NAME, MIXED_CFG)):
        path = os.path.join(str(directory), f"{name}.json")
        zw._write(path, cfg)
        factory.add_model_config(path)


def build(kind: str, directory):
    """The toy CLIP of ``kind`` (module doc), uninitialized, with a toy tag
    head (the contrastive step reads none)."""
    register(directory)
    model = factory.create_model(MIXED_NAME if kind == "mixed" else NAME,
                                 device="cpu", precision="fp32",
                                 skip_init=True)
    if kind == "vitamin6":
        model.visual = timm_vit.TimmModel(
            vitamin.ViTaminTrunk(conv_channels=(16, 32), conv_depths=(1, 1),
                                 width=96, depth=1, heads=HEADS,
                                 image_size=zw.IMAGE),
            96, EMBED, pool="avg", proj="linear")
    model.tag_hidden_size = EMBED
    model.tag_head = TagBertHead(EMBED, 1, EMBED, 4, 2 * EMBED)
    model.tag_labels = Embed(2 * NUM_TAGS, EMBED, init_std=1.0)
    model.tag_fc = Dense(EMBED, 1)
    return model


@contextlib.contextmanager
def _builds():
    """tests/torch_tp_zoo_worker.py's step and resume on this file's
    toys."""
    old, zw.build = zw.build, build
    try:
        yield
    finally:
        zw.build = old


def init_state_dict(kind: str, directory) -> dict:
    with _builds():
        return zw.init_state_dict(kind, directory)


def step(kind: str, init_sd: dict, batch_np: dict, directory, **kw) -> dict:
    """``torch_tp_zoo_worker.step`` of ``kind``: the metrics, the whole
    parameters and gradients, the split leaves and their local shapes."""
    with _builds():
        return zw.step(kind, init_sd, batch_np, directory, **kw)


def resume(kind: str, ckpt: str, init_sd: dict, batch_np: dict,
           directory) -> dict:
    with _builds():
        return zw.resume(kind, ckpt, init_sd, batch_np, directory)


def scenario_uneven(inputs, directory):
    """Every case of ``inputs["cases"]`` on the (1 x 4) mesh, then the
    one-process checkpoint ``inputs["resume"]`` restored and stepped."""
    mesh.init_mesh(inputs["model"])
    out = {label: step(kind, inputs["init"][kind], inputs["batch"],
                       inputs["cfg_dir"], **kw)
           for label, kind, kw in inputs["cases"]}
    out["resume"] = resume("rab6", inputs["resume"], inputs["init"]["rab6"],
                           inputs["batch"], inputs["cfg_dir"])
    out["local_heads"] = {}
    for kind in KINDS:  # each split block's heads on this rank
        model = build(kind, inputs["cfg_dir"])
        sharding.shard_tensor_parallel(model)
        out["local_heads"][kind] = {
            n: (local_heads(m, m.heads), getattr(m, "local_heads", None))
            for n, m in model.named_modules()
            if getattr(m, "tp_size", 1) > 1 and hasattr(m, "heads")}
    return out


def scenario_replicated(inputs, directory):
    """The ``mixed`` toy's step on the (1 x 2) mesh: its 1-head vision
    block replicated, its 2-head text block split."""
    mesh.init_mesh(inputs["model"])
    return step("mixed", inputs["init"], inputs["batch"], inputs["cfg_dir"])


if __name__ == "__main__":
    w.main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           scenarios={"uneven": scenario_uneven,
                      "replicated": scenario_replicated})
