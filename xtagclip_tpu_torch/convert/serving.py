"""Self-contained serving artifacts through ``torch.export``: port of
xtagclip_tpu/convert/serving.py.

The entry points of JAX's artifact, each exported as its own program with
a symbolic batch dimension (``torch.export.Dim``) by default, or a pinned
``batch_size`` that refuses any other:

- ``encode_image(images_u8 [b, H, W, 3]) -> image features`` (the
  normalize runs in the program, with the model's mean/std);
- ``encode_text(ids int64 [b, ctx]) -> text features``;
- ``forward(images_u8, ids) -> (image features, text features,
  logit_scale.exp())``;
- ``serve_classify(images_u8) -> (image features, tag picks [b, 6],
  fusion logits [b, C])``: the precomputed-prompt classifier
  (serving.py::serve_classify_body) with the [C, K, D] prompt table baked
  in.

Each entry carries the weights it runs and no others (as JAX's per-entry
constants: ``forward`` carries both towers, ``serve_classify`` the vision
tower, tag head and TQN but no text tower). The kernels appear in the
programs as the custom ops of ``xtagclip_tpu_torch.ops`` (one node per
block half, flash attention or MLP, and the normalize), so a loader needs
that package to register them and no model code. ``save_serving`` writes
one ``<entry>.pt2`` (``torch.export.save``) per entry and a
``serving_manifest.json`` with JAX's keys (``model``, ``entries`` with
file, shapes, dtypes and bytes, ``preprocess``, ``classnames``).
``load_serving`` returns callables that run
under inference mode, each as a CUDA graph per batch shape on the card
(serving.py::CudaGraphRunner).
"""

from __future__ import annotations

import copy
import importlib
import json
import os
import time
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from xtagclip_tpu_torch.data.transforms import image_mean_std
from xtagclip_tpu_torch.ops.preprocess import normalize_images
from xtagclip_tpu_torch.serving import CudaGraphRunner, serve_classify_body

_MANIFEST = "serving_manifest.json"
ENTRIES = ("encode_image", "encode_text", "forward")
# the modules that register the kernels' custom ops
_OP_MODULES = ("xtagclip_tpu_torch.ops.fused_attn_block",
               "xtagclip_tpu_torch.ops.fused_mlp",
               "xtagclip_tpu_torch.ops.flash_attn",
               "xtagclip_tpu_torch.ops.preprocess")
_EXAMPLE_BATCH = 2  # a symbolic export's example (0 and 1 would specialize)


def _pruned(model: nn.Module, keep: Sequence[str]) -> nn.Module:
    """A shallow copy of ``model`` that holds only the direct submodules,
    parameters and buffers named in ``keep`` (sharing their tensors), so an
    export of it bakes only their weights."""
    view = copy.copy(model)
    view._modules = {k: m for k, m in model._modules.items() if k in keep}
    view._parameters = {k: p for k, p in model._parameters.items()
                        if k in keep}
    view._buffers = {k: b for k, b in model._buffers.items() if k in keep}
    return view


class _Entry(nn.Module):
    """One entry point as a module: ``body(entry, *inputs)`` over the
    parts of the model named in ``keep``, the normalize's mean/std, and
    ``tables`` as buffers."""

    def __init__(self, model, keep, body, mean, std, **tables):
        super().__init__()
        self.model = _pruned(model, keep)
        self.body = body
        self.mean, self.std = tuple(mean), tuple(std)
        for name, t in tables.items():
            self.register_buffer(name, t)

    def normalize(self, images_u8):
        return normalize_images(images_u8, self.mean, self.std,
                                dtype=self.model.dtype)

    def forward(self, *inputs):
        return self.body(self, *inputs)


def _encode_image(entry, images_u8):
    return entry.model.encode_image(entry.normalize(images_u8),
                                    normalize=True)[0]


def _encode_text(entry, ids):
    return entry.model.encode_text(ids, normalize=True)[0]


def _forward(entry, images_u8, ids):
    return (_encode_image(entry, images_u8), _encode_text(entry, ids),
            entry.model.logit_scale.float().exp())


def _serve_classify(entry, images_u8):
    return serve_classify_body(entry.model, images_u8, entry.table,
                               entry.mean, entry.std)


_TAG_PARTS = ("visual", "tag_head", "tag_labels", "tag_fc", "tag_offsets",
              "fusion_model")
_BODIES = {"encode_image": (("visual",), _encode_image),
           "encode_text": (("text",), _encode_text),
           "forward": (("visual", "text", "logit_scale"), _forward),
           "serve_classify": (_TAG_PARTS, _serve_classify)}


def _examples(model, name, batch):
    v = model.model_cfg["vision_cfg"].get("image_size", 224)
    ih, iw = v if isinstance(v, (tuple, list)) else (v, v)
    ctx = model.model_cfg["text_cfg"].get("context_length", 77)
    dev = model.logit_scale.device
    img = torch.zeros((batch, ih, iw, 3), dtype=torch.uint8, device=dev)
    ids = torch.zeros((batch, ctx), dtype=torch.int64, device=dev)
    return {"encode_image": (img,), "encode_text": (ids,),
            "forward": (img, ids), "serve_classify": (img,)}[name]


def _export(model, name, batch_size, **tables):
    keep, body = _BODIES[name]
    entry = _Entry(model, keep, body, *image_mean_std(model), **tables)
    args = _examples(model, name, batch_size or _EXAMPLE_BATCH)
    dynamic = None
    if batch_size is None:
        b = torch.export.Dim("b")
        dynamic = (tuple({0: b} for _ in args),)  # forward(*inputs)
    with torch.no_grad():
        return torch.export.export(entry, args, dynamic_shapes=dynamic)


def export_serving(model, batch_size: Optional[int] = None,
                   entries: Sequence[str] = ENTRIES
                   ) -> Dict[str, torch.export.ExportedProgram]:
    """Export ``entries`` of encode_image / encode_text / forward as
    ``torch.export`` programs: a symbolic batch (any size at serving time)
    by default, or a pinned ``batch_size``. Export a model already cast
    for compute (factory.cast_for_compute) to serve in its dtype."""
    unknown = set(entries) - set(ENTRIES)
    if unknown:
        raise ValueError(f"unknown serving entries: {sorted(unknown)}")
    return {name: _export(model, name, batch_size) for name in entries}


def export_serve_classify(model, text_g_table: torch.Tensor,
                          batch_size: Optional[int] = None
                          ) -> torch.export.ExportedProgram:
    """Export the precomputed-prompt fusion classifier,
    ``serve_classify(images_u8) -> (image features, tag picks, [b, C]
    fusion logits)``, with the weights and ``text_g_table`` ([C, K, D]
    from serving.precompute_prompt_features) baked in."""
    if not getattr(model, "use_fusion", False):
        raise ValueError(
            "export_serve_classify needs a model built with use_fusion=True "
            "(and use_tagging=True) — pass them to create_model")
    return _export(model, "serve_classify", batch_size, table=text_g_table)


def _aval(t) -> str:
    """``dtype[dims]`` of a traced value, "b" for the symbolic batch."""
    dims = [d if isinstance(d, int) else "b" for d in t.shape]
    return f"{str(t.dtype).replace('torch.', '')}[{', '.join(map(str, dims))}]"


def _avals(ep):
    ins = [n.meta["val"] for n in ep.graph.nodes
           if n.op == "placeholder" and n.name in
           ep.graph_signature.user_inputs]
    (out,) = [n for n in ep.graph.nodes if n.op == "output"]
    outs = [a.meta["val"] for a in out.args[0]]
    return [_aval(v) for v in ins], [_aval(v) for v in outs]


def save_serving(model, out_dir: str, model_name: str = "",
                 batch_size: Optional[int] = None,
                 entries: Sequence[str] = ENTRIES,
                 serve_classify_table: Optional[torch.Tensor] = None,
                 classnames: Optional[Sequence[str]] = None) -> dict:
    """Write the artifact: one ``<entry>.pt2`` per entry (``entries``, and
    ``serve_classify`` when ``serve_classify_table`` is given) and the
    manifest, which it returns. Each entry's record also holds its export
    and save seconds."""
    from xtagclip_tpu_torch.factory import get_model_preprocess_cfg

    os.makedirs(out_dir, exist_ok=True)
    todo = [(name, {}) for name in entries]
    if serve_classify_table is not None:
        todo.append(("serve_classify", {"table": serve_classify_table}))
    unknown = {n for n, _ in todo} - set(_BODIES)
    if unknown:
        raise ValueError(f"unknown serving entries: {sorted(unknown)}")
    if serve_classify_table is not None and not getattr(
            model, "use_fusion", False):
        raise ValueError("serve_classify needs a model built with "
                         "use_fusion=True (and use_tagging=True)")
    manifest = {"model": model_name, "entries": {},
                # the host stage is resize/crop to uint8
                # (data/transforms.py); the normalize is in the program
                "preprocess": get_model_preprocess_cfg(model)}
    if classnames is not None:
        manifest["classnames"] = list(classnames)
    for name, tables in todo:
        t0 = time.perf_counter()
        ep = _export(model, name, batch_size, **tables)
        t_export = time.perf_counter() - t0
        fname = f"{name}.pt2"
        path = os.path.join(out_dir, fname)
        t0 = time.perf_counter()
        torch.export.save(ep, path)
        in_avals, out_avals = _avals(ep)
        manifest["entries"][name] = {
            "file": fname, "in_avals": in_avals, "out_avals": out_avals,
            "bytes": os.path.getsize(path), "export_s": t_export,
            "save_s": time.perf_counter() - t0}
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def read_manifest(out_dir: str) -> dict:
    """The artifact's manifest (entries, preprocess recipe, classnames)."""
    with open(os.path.join(out_dir, _MANIFEST)) as f:
        return json.load(f)


def load_serving(out_dir: str) -> Dict[str, object]:
    """Load an artifact into callables, ``{entry: fn}``, with no model
    code: the kernels' custom ops are registered, each program is loaded
    (``torch.export.load``) and wrapped to run under inference mode, as a
    CUDA graph per batch shape on the card. Raises FileNotFoundError if
    the manifest is missing."""
    manifest = read_manifest(out_dir)
    for mod in _OP_MODULES:
        importlib.import_module(mod)
    fns = {}
    for name, meta in manifest["entries"].items():
        program = torch.export.load(
            os.path.join(out_dir, meta["file"])).module()
        fns[name] = CudaGraphRunner(program)
    return fns
