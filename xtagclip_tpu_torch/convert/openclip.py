"""The open_clip (CustomTextCLIP-layout) torch state dict -> the port's
parameters: the inverse of xtagclip_tpu/convert/export.py
``to_openclip_state_dict`` (:28), tag head and TQN included, and the
loading half of JAX's ``convert_openclip_state_dict`` (openclip.py:92-155,
179-230) for the towers that have no exporter.

``openclip_key(name)`` gives, for a port parameter name, the state-dict
key it is stored under and how its layout differs:

- ``"same"``: as it is;
- ``"linear"``: a torch ``nn.Linear`` weight [out, in], the transpose of
  the port's (flax) Dense kernel [in, out];
- ``"conv"``: the patch-embed conv weight [W, C, ph, pw], the port's
  kernel [ph*pw*C, W] in (ph, pw, C) row order;
- ``"scalar"``: a 0-d tensor (the logit scales and bias).

The tower options map as JAX's converters map them: LayerScale's
``ls_1``/``ls_2.gamma`` per block, the text projection as a matrix or,
with ``proj_bias``, a ``text_projection`` Linear (weight, bias), a timm
tower's head as ``visual.head.{proj,mlp.fc1,mlp.fc2}`` and an HF text
tower's projection as ``text.proj`` or ``text.proj.{0,2}``. The learnable
vision tokens are ``visual.learnable_tokens`` [n, width], a key JAX's
exporter leaves out and its loader refuses: a ``.pt`` of the JAX package
carries none, and the port keeps its own init for them.

These towers are converted as whole groups into flax-layout trees read
by the names of convert/from_jax.py (``convert_tower_groups``): a timm
trunk's ``visual.trunk.*`` (convert/timm_families.py; its ``fc_norm`` and
SigLIP ``attn_pool`` go onto the ``TimmModel`` head, a FastViT's
BatchNorm running statistics into its buffers), an HF BERT's
``text.transformer.*`` (convert/hf_bert.py) and a ModifiedResNet's
``visual.*``, whose running statistics go into the BN buffers, as JAX
converts them; and, where JAX's converter raises on their keys, a timm
ConvNeXt trunk (models/convnext.py's converter) and an HF T5 or M2M100
encoder's ``text.transformer.*`` (convert/hf_t5.py, convert/hf_m2m100.py;
open_clip keeps the encoder alone there, so its keys lack the ``encoder.``
the converters read, which is put back).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np

from xtagclip_tpu_torch.convert.from_jax import _flatten, port_name, port_value

_BLOCK = re.compile(r"(visual|text)\.transformer\.resblocks\.(\d+)\.(.+)")
_TAG = re.compile(r"tag_head\.layers\.(\d+)\.(crossattention|ffn)\.(.+)")
_TQN = re.compile(r"fusion_model\.decoder_layers\.(\d+)\.(.+)")
_MLP_HEAD = {"mlp_0": 0, "mlp_1": 3, "mlp_2": 6, "mlp_3": 9}
_TIMM_HEAD = {"head_proj": "proj", "head_mlp_fc1": "mlp.fc1",
              "head_mlp_fc2": "mlp.fc2"}
_HF_PROJ = {"proj": "proj.", "proj_fc1": "proj.0.", "proj_fc2": "proj.2."}


def _leaf(part: str) -> str:
    return "weight" if part in ("kernel", "scale") else "bias"


def openclip_key(name: str) -> Tuple[str, str]:
    """(state-dict key, layout kind) of the port parameter ``name``."""
    parts = name.split(".")
    last = parts[-1]
    m = _BLOCK.fullmatch(name)
    if m:
        tower, i, rest = m.groups()
        base = f"{tower}.transformer.resblocks.{i}"
        sub = rest.split(".")
        if sub[0] in ("ln_1", "ln_2"):
            return f"{base}.{sub[0]}.{_leaf(last)}", "same"
        if sub[0] in ("ls_1", "ls_2"):  # LayerScale
            return f"{base}.{sub[0]}.gamma", "same"
        if sub[:2] == ["attn", "in_proj"]:
            return (f"{base}.attn.in_proj_{_leaf(last)}",
                    "linear" if last == "kernel" else "same")
        if sub[0] in ("attn", "mlp"):
            return (f"{base}.{sub[0]}.{sub[1]}.{_leaf(last)}",
                    "linear" if last == "kernel" else "same")
    if name == "visual.conv1.kernel":
        return "visual.conv1.weight", "conv"
    head = parts[1] if len(parts) == 3 else None
    if parts[0] == "visual" and head in _TIMM_HEAD:  # a timm tower's head
        return (f"visual.head.{_TIMM_HEAD[parts[1]]}.{_leaf(last)}",
                "linear" if last == "kernel" else "same")
    if parts[0] == "text" and head in _HF_PROJ:  # an HF tower's projection
        return (f"text.{_HF_PROJ[parts[1]]}{_leaf(last)}",
                "linear" if last == "kernel" else "same")
    if name in ("visual.class_embedding", "visual.positional_embedding",
                "visual.proj", "visual.learnable_tokens",
                "text.positional_embedding", "text.text_projection"):
        return name, "same"
    if parts[:2] == ["text", "text_projection"]:  # the Dense form (proj_bias)
        return (f"text.text_projection.{_leaf(last)}",
                "linear" if last == "kernel" else "same")
    if parts[:2] in (["visual", "ln_pre"], ["visual", "ln_post"],
                     ["text", "ln_final"]):
        return f"{parts[0]}.{parts[1]}.{_leaf(last)}", "same"
    if name == "text.token_embedding.embedding":
        return "text.token_embedding.weight", "same"
    if name in ("logit_scale", "logit_bias"):
        return name, "scalar"
    if name == "tag_labels.embedding":
        return "tag_labels.weight", "same"
    if parts[0] == "tag_fc":
        return f"tag_fc.{_leaf(last)}", ("linear" if last == "kernel"
                                         else "same")
    m = _TAG.fullmatch(name)
    if m:
        i, kind, rest = m.groups()
        sub = rest.split(".")
        base = f"tag_head.encoder.layer.{i}"
        lin = "linear" if last == "kernel" else "same"
        if kind == "crossattention":
            if sub[0] in ("query", "key", "value"):
                return f"{base}.crossattention.self.{sub[0]}.{_leaf(last)}", lin
            if sub[0] == "out_dense":
                return f"{base}.crossattention.output.dense.{_leaf(last)}", lin
            if sub[0] == "out_ln":
                return (f"{base}.crossattention.output.LayerNorm."
                        f"{_leaf(last)}", "same")
        else:
            if sub[0] == "intermediate":
                return f"{base}.intermediate.dense.{_leaf(last)}", lin
            if sub[0] == "output":
                return f"{base}.output.dense.{_leaf(last)}", lin
            if sub[0] == "output_ln":
                return f"{base}.output.LayerNorm.{_leaf(last)}", "same"
    if name == "fusion_model.logit_scale":
        return name, "scalar"
    if parts[:2] == ["fusion_model", "decoder_norm"]:
        return f"fusion_model.decoder_norm.{_leaf(last)}", "same"
    m = _TQN.fullmatch(name)
    if m:
        i, rest = m.groups()
        sub = rest.split(".")
        base = f"fusion_model.decoder.layers.{i}"
        lin = "linear" if last == "kernel" else "same"
        if sub[:2] == ["multihead_attn", "in_proj"]:
            return f"{base}.multihead_attn.in_proj_{_leaf(last)}", lin
        if sub[:2] == ["multihead_attn", "out_proj"]:
            return f"{base}.multihead_attn.out_proj.{_leaf(last)}", lin
        if sub[0] in ("linear1", "linear2"):
            return f"{base}.{sub[0]}.{_leaf(last)}", lin
        if sub[0] in ("norm2", "norm3"):
            return f"{base}.{sub[0]}.{_leaf(last)}", "same"
    if len(parts) == 3 and parts[0] == "fusion_model" and parts[1] in _MLP_HEAD:
        return (f"fusion_model.mlp_head.{_MLP_HEAD[parts[1]]}.{_leaf(last)}",
                "linear" if last == "kernel" else "same")
    raise KeyError(f"no open_clip key for port parameter {name!r}")


def from_openclip(value: np.ndarray, kind: str, shape) -> np.ndarray:
    """A state-dict value in the port's layout (``shape``: the port's)."""
    if kind == "linear":
        return np.ascontiguousarray(value.T)
    if kind == "conv":
        width, c, ph, pw = value.shape
        return np.ascontiguousarray(
            value.transpose(2, 3, 1, 0).reshape(ph * pw * c, width))
    if kind == "scalar":
        return value.reshape(shape)
    return value


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a checkpoint file into fp32 numpy arrays (``state_dict`` and
    ``module.`` wrappers removed): a ``.safetensors`` file through
    ``safetensors``, as the reference open_clip reads the hub's
    ``open_clip_model.safetensors`` (JAX hands it to ``torch.load``, which
    reads it only in a torch that dispatches on the extension: ROADMAP
    Queue 3), anything else through ``torch.load``, local or at an fsspec
    URL (train/file_utils.py ``pt_load``)."""
    if str(path).endswith(".safetensors"):
        from safetensors.torch import load_file

        ckpt = load_file(path, device="cpu")
    else:
        from xtagclip_tpu_torch.train.file_utils import pt_load

        ckpt = pt_load(path, map_location="cpu")
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    if isinstance(ckpt, dict) and "module" in ckpt:
        ckpt = ckpt["module"]
    out = {}
    for k, v in ckpt.items():
        k = k[len("module."):] if k.startswith("module.") else k
        out[k] = (v.detach().float().cpu().numpy() if hasattr(v, "detach")
                  else np.asarray(v))
    return out


_TEXT_ALIAS_PREFIXES = (
    "token_embedding", "ln_final", "transformer.", "positional_embedding",
    "text_projection", "cls_emb", "attn_mask",
)


def normalize_to_custom_text(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Prefix top-level text-tower keys with 'text.' (CLIP ->
    CustomTextCLIP); where ``text.*`` exists the top-level aliases are
    duplicates and are dropped (xtagclip_tpu/convert/openclip.py:43-63)."""
    has_text = any(k.startswith("text.") for k in sd)
    out = {}
    for k, v in sd.items():
        if k in ("logit_scale", "logit_bias") or k.startswith(
                ("visual.", "tag_", "fusion_model.", "text.")):
            out[k] = v
        elif k.startswith(_TEXT_ALIAS_PREFIXES):
            if not has_text:
                out["text." + k] = v
        else:
            out[k] = v
    return out


def _conv_kernel(v: np.ndarray) -> np.ndarray:
    """torch conv [out, in, kh, kw] -> flax [kh, kw, in, out]."""
    return np.ascontiguousarray(v.transpose(2, 3, 1, 0))


def _set(tree: dict, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _convert_modified_resnet_visual(sd: Dict[str, np.ndarray]):
    """A ModifiedResNet's ``visual.*`` keys -> flax-layout (params,
    batch_stats) trees (JAX openclip.py:92-155): the 3-conv stem with
    bn1..bn3, ``layer{l}.{b}`` bottlenecks with ``downsample.{0: conv, 1:
    bn}`` and ``attnpool``. An unknown key raises."""
    vis: Dict = {}
    stats: Dict = {}

    def bn_set(path, key, v):
        if key in ("weight", "bias"):
            _set(vis, path + ("scale" if key == "weight" else "bias",), v)
        elif key in ("running_mean", "running_var"):
            _set(stats, path + (key[len("running_"):],), v)
        elif key != "num_batches_tracked":
            raise KeyError(f"unmapped bn key {'.'.join(path)}.{key}")

    layer_re = re.compile(r"layer([1-4])\.(\d+)\.(.+)")
    for k in [k for k in sd if k.startswith("visual.")]:
        rest, v = k[len("visual."):], sd[k]
        parts = rest.split(".")
        m = layer_re.match(rest)
        if parts[0] in ("conv1", "conv2", "conv3") and parts[1] == "weight":
            _set(vis, (parts[0], "kernel"), _conv_kernel(v))
        elif parts[0] in ("bn1", "bn2", "bn3"):
            bn_set((parts[0],), parts[1], v)
        elif m:
            block = f"layer{m.group(1)}_{m.group(2)}"
            sub = m.group(3).split(".")
            if sub[0].startswith("conv") and sub[1] == "weight":
                _set(vis, (block, sub[0], "kernel"), _conv_kernel(v))
            elif sub[0].startswith("bn"):
                bn_set((block, sub[0]), sub[1], v)
            elif sub[:3] == ["downsample", "0", "weight"]:
                _set(vis, (block, "downsample_conv", "kernel"),
                     _conv_kernel(v))
            elif sub[:2] == ["downsample", "1"]:
                bn_set((block, "downsample_bn"), sub[2], v)
            else:
                raise KeyError(f"unmapped bottleneck key {k}")
        elif parts[0] == "attnpool" and parts[1] == "positional_embedding":
            _set(vis, ("attnpool", "positional_embedding"), v)
        elif parts[0] == "attnpool" and parts[1].endswith("_proj"):
            if parts[2] == "weight":
                _set(vis, ("attnpool", parts[1], "kernel"),
                     np.ascontiguousarray(v.T))
            else:
                _set(vis, ("attnpool", parts[1], "bias"), v)
        else:
            raise KeyError(f"unmapped ModifiedResNet visual key {k}")
    return vis, stats


def _hf_encoder_converter(sd: Dict[str, np.ndarray]):
    """The converter of an HF T5 or M2M100 encoder under
    ``text.transformer.`` (open_clip's encoder alone, or the whole model's
    ``encoder.``), or None."""
    for k in sd:
        rest = k[len("text.transformer."):] if k.startswith(
            "text.transformer.") else None
        if rest is None:
            continue
        rest = rest[len("encoder."):] if rest.startswith("encoder.") else rest
        if rest.startswith("block."):
            from xtagclip_tpu_torch.convert.hf_t5 import (
                convert_hf_t5_state_dict,
            )
            return convert_hf_t5_state_dict
        if rest.startswith("layers."):
            from xtagclip_tpu_torch.convert.hf_m2m100 import (
                convert_hf_m2m100_state_dict,
            )
            return convert_hf_m2m100_state_dict
    return None


def convert_tower_groups(sd: Dict[str, np.ndarray]):
    """The group-converted towers of ``sd`` (module doc) ->
    (parameters, statistics, rest): the first two map port names to
    arrays in the port's layout; ``rest`` holds the keys left for
    ``openclip_key``. Mirrors the up-front part of JAX's
    ``convert_openclip_state_dict`` (openclip.py:195-230)."""
    params, stats = {}, {}
    rest = dict(sd)
    if any(k.startswith(("visual.bn1.", "visual.attnpool.")) for k in sd):
        vis, vis_stats = _convert_modified_resnet_visual(sd)
        params.update(("visual." + k, v) for k, v in _flatten(vis))
        stats.update(("visual." + k, v) for k, v in _flatten(vis_stats))
        rest = {k: v for k, v in rest.items() if not k.startswith("visual.")}
    if "visual.trunk.stem.0.weight" in sd:  # ConvNeXt's stem conv
        from xtagclip_tpu_torch.models.convnext import (
            convert_timm_convnext_state_dict,
        )

        trunk = convert_timm_convnext_state_dict(sd, prefix="visual.trunk.")
        params.update(("visual.trunk." + k, v) for k, v in _flatten(trunk))
        rest = {k: v for k, v in rest.items()
                if not k.startswith("visual.trunk.")}
    elif any(k.startswith("visual.trunk.") for k in sd):
        from xtagclip_tpu_torch.convert.timm_families import convert_timm_trunk

        trunk = convert_timm_trunk(sd, prefix="visual.trunk.")
        bn_stats = trunk.pop("__batch_stats__", None)
        for hoisted, name in (("__fc_norm__", "fc_norm"),
                              ("__attn_pool__", "attn_pool")):
            sub = trunk.pop(hoisted, None)
            if sub:
                params.update((f"visual.{name}.{k}", v)
                              for k, v in _flatten(sub))
        params.update(("visual.trunk." + k, v) for k, v in _flatten(trunk))
        if bn_stats:
            stats.update(("visual.trunk." + k, v)
                         for k, v in _flatten(bn_stats))
        rest = {k: v for k, v in rest.items()
                if not k.startswith("visual.trunk.")}
    hf_text = _hf_encoder_converter(sd)
    if hf_text is not None:
        enc = {("" if k.startswith("text.transformer.encoder.") else
                "encoder.") + k[len("text.transformer."):]: v
               for k, v in sd.items() if k.startswith("text.transformer.")}
        params.update(("text.transformer." + k, v)
                      for k, v in _flatten(hf_text(enc)))
        rest = {k: v for k, v in rest.items()
                if not k.startswith("text.transformer.")}
    if any(k.startswith("text.transformer.embeddings.") for k in sd):
        from xtagclip_tpu_torch.convert.hf_bert import convert_hf_bert_state_dict

        bert = convert_hf_bert_state_dict(sd, prefix="text.transformer.")
        params.update(("text.transformer." + k, v)
                      for k, v in _flatten(bert))
        rest = {k: v for k, v in rest.items()
                if not k.startswith("text.transformer.")}
    return ({port_name(k): port_value(v) for k, v in params.items()},
            {port_name(k): np.asarray(v) for k, v in stats.items()}, rest)
