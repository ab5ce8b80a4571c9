"""timm trunk-family torch state dicts -> flax-layout param trees (and
back); a copy of xtagclip_tpu/convert/timm_families.py, which the port
keeps as its own.

The reference loads the EVA / ViTamin / Swin / FastViT (MobileCLIP) vision
towers through timm; open_clip-layout checkpoints carry the trunk under
``visual.trunk.<timm keys>``. These converters map the documented timm
layouts onto the trees of models/{eva,swin,vitamin,fastvit}.py, whose
port names convert/from_jax.py gives (``convert/openclip.py
convert_tower_groups`` loads them); the ViT family goes through
convert/timm_convert.py.

Every converter is STRICT: it accounts for every input key and raises on
anything unmapped, so a checkpoint whose layout drifts from the documented
one fails loudly instead of producing a silently wrong model.

Documented layouts (timm >= 0.9 module key names):

EVA (timm eva.py — eva_giant_*, eva02_*):
  cls_token [1,1,D]; pos_embed [1,L,D]; patch_embed.proj.{weight,bias};
  blocks.{i}.norm1/norm2.{weight,bias};
  fused attn (EVA-01/E): attn.qkv.weight + attn.{q_bias,v_bias}
      (k_bias is a zero non-persistent buffer);
  split attn (EVA-02):  attn.q_proj.{weight,bias}, attn.k_proj.weight,
      attn.v_proj.{weight,bias};
  attn.proj.{weight,bias};
  SwiGLU mlp (EVA-02):  mlp.fc1_g.*, mlp.fc1_x.*, mlp.norm.* (sub-LN),
      mlp.fc2.*;   plain mlp: mlp.fc1.*, mlp.fc2.*;
  norm.{weight,bias}. rope tables are non-persistent buffers (absent).

Swin (timm swin_transformer.py — swin_base_patch4_window7_224):
  patch_embed.proj.{weight,bias}, patch_embed.norm.{weight,bias};
  layers.{s}.blocks.{b}.{norm1,norm2}.*, .attn.{qkv,proj}.*,
      .attn.relative_position_bias_table ([.(2W-1)^2, H]),
      .mlp.{fc1,fc2}.*;
  layers.{s}.downsample.{norm.{weight,bias}, reduction.weight};
  norm.{weight,bias}.
  NOTE the PatchMerging concat order is x0=(he,we), x1=(ho,we), x2=(he,wo),
  x3=(ho,wo); our merge reshape produces (he,we),(he,wo),(ho,we),(ho,wo) —
  the converter permutes the 4C input groups accordingly.

ViTamin (timm vitamin.py — vitamin_{small,base,large,large2,xlarge}_*):
  patch_embed.backbone.stem.{conv1,norm1,conv2}.*;
  patch_embed.backbone.stages.{s}.blocks.{b}.{pre_norm,conv1_1x1,conv2_kxk,
      conv3_1x1}.*;
  patch_embed.backbone.pool.* (patchify conv to transformer width);
  pos_embed [1,N,D]; blocks.{i}.norm1/norm2.*, attn.{qkv,proj}.*,
      mlp GeGLU: mlp.fc1_g.*, mlp.fc1_x.*, mlp.fc2.*  (also accepted under
      the paper repo's w0/w1/w2 aliases); norm.{weight,bias}.

FastViT / MobileCLIP MCi (timm fastvit.py — fastvit_mci1/mci2,
INFERENCE/reparameterized form, i.e. after timm reparameterize_model or
Apple's *_reparam export; the train form with rbr/conv_kxk branch lists is
rejected with instructions):
  stem.{0,1,2}.reparam_conv.{weight,bias};
  stages.{s}.downsample.proj.{0,1}.reparam_conv.{weight,bias};
  stages.{s}.pos_emb.reparam_conv.{weight,bias}  (RepCPE, attention stage;
      includes the folded identity — converted to our residual form);
  RepMixer: stages.{s}.blocks.{b}.token_mixer.reparam_conv.*  (identity
      folded — converted to residual form);
  ConvFFN: .mlp.conv.conv.weight + .mlp.conv.bn.{weight,bias,running_mean,
      running_var}, .mlp.fc1.*, .mlp.fc2.*;
  attention: .norm.{weight,bias,running_mean,running_var},
      .token_mixer.{qkv,proj}.*; optional .layer_scale*.gamma (folded into
      the branch's output conv);
  final_conv.reparam_conv.*.
  Fused convs map onto our ConvBN via identity batch-norm statistics
  (mean 0, var 1, scale sqrt(1+eps)) — numerically exact; the converted
  model must run with use_running_average (eval/frozen) BN, matching the
  inference-form checkpoint semantics.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

BN_EPS = 1e-5  # flax nn.BatchNorm default, used by our ConvBN


class UnmappedKeysError(KeyError):
    pass


def _strict(family: str, leftovers: List[str]):
    if leftovers:
        raise UnmappedKeysError(
            f"{family} converter: {len(leftovers)} unmapped checkpoint keys "
            f"(layout drift from the documented timm layout?): "
            f"{sorted(leftovers)[:10]}"
        )


def _set(tree: dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value)


def _lin_t(v):
    return np.ascontiguousarray(np.asarray(v).T)


def _conv_t(v):
    # torch [Cout, Cin/g, kh, kw] -> flax HWIO [kh, kw, Cin/g, Cout]
    return np.ascontiguousarray(np.asarray(v).transpose(2, 3, 1, 0))


def _patchify_dense(v):
    # torch conv [D, C, p, p] -> Dense kernel [p*p*C, D] matching the
    # (ph, pw, c) patchify flatten order used by our trunks
    w = np.asarray(v).transpose(2, 3, 1, 0)
    return np.ascontiguousarray(w.reshape(-1, w.shape[-1]))


# ---------------------------------------------------------------------------
# family detection
# ---------------------------------------------------------------------------

def detect_trunk_family(keys) -> str:
    ks = set(keys)
    has = lambda s: any(s in k for k in ks)
    if has("attn.relative_position_bias_table"):
        return "swin"
    if has("patch_embed.backbone."):
        return "vitamin"
    if has("attn.q_proj.") or has("attn.q_bias"):
        return "eva"
    if has("rbr_conv") or has("conv_kxk"):
        raise UnmappedKeysError(
            "FastViT checkpoint is in TRAIN (multi-branch) form; "
            "reparameterize it first (timm.utils.reparameterize_model or "
            "Apple's export) — this converter accepts the inference form."
        )
    if has("reparam_conv"):
        return "fastvit"
    if "cls_token" in ks or has("blocks.0.attn.qkv."):
        return "vit"
    raise UnmappedKeysError(
        f"unrecognized timm trunk layout (families: vit, eva, swin, vitamin, "
        f"fastvit-reparam); sample keys: {sorted(ks)[:6]}"
    )


def convert_timm_trunk(sd: Dict[str, np.ndarray],
                       prefix: str = "visual.trunk.") -> dict:
    """Dispatch `visual.trunk.*` keys to the family converter."""
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    fam = detect_trunk_family(sub.keys())
    if fam == "vit":
        from xtagclip_tpu_torch.convert.timm_convert import (
            convert_timm_vit_state_dict,
        )

        return convert_timm_vit_state_dict(sd, prefix=prefix)
    return {
        "eva": convert_eva_sd,
        "swin": convert_swin_sd,
        "vitamin": convert_vitamin_sd,
        "fastvit": convert_fastvit_sd,
    }[fam](sub)


# ---------------------------------------------------------------------------
# EVA
# ---------------------------------------------------------------------------

_EVA_BLOCK = re.compile(r"blocks\.(\d+)\.(.+)")


def convert_eva_sd(sd: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    leftovers = []
    qkv_bias_parts: Dict[int, dict] = {}

    for k, v in sd.items():
        if k == "cls_token":
            _set(tree, ("cls_token",), np.asarray(v).reshape(1, 1, -1))
        elif k == "pos_embed":
            _set(tree, ("pos_embed",),
                 np.asarray(v).reshape(v.shape[-2], v.shape[-1]))
        elif k == "patch_embed.proj.weight":
            _set(tree, ("patch_embed", "kernel"), _patchify_dense(v))
        elif k == "patch_embed.proj.bias":
            _set(tree, ("patch_embed", "bias"), v)
        elif k in ("norm.weight", "norm.bias"):
            _set(tree, ("norm", "scale" if k.endswith("weight") else "bias"), v)
        else:
            m = _EVA_BLOCK.match(k)
            if not m:
                leftovers.append(k)
                continue
            i, rest = int(m.group(1)), m.group(2)
            base = f"blocks_{i}"
            parts = rest.split(".")
            if parts[0] in ("norm1", "norm2"):
                _set(tree, (base, parts[0],
                            "scale" if parts[1] == "weight" else "bias"), v)
            elif parts[0] == "attn":
                a = parts[1]
                if a == "qkv":
                    _set(tree, (base, "attn", "qkv",
                                "kernel" if parts[2] == "weight" else "bias"),
                         _lin_t(v) if parts[2] == "weight" else v)
                elif a in ("q_bias", "v_bias"):
                    qkv_bias_parts.setdefault(i, {})[a] = np.asarray(v)
                elif a in ("q_proj", "k_proj", "v_proj"):
                    _set(tree, (base, "attn", a,
                                "kernel" if parts[2] == "weight" else "bias"),
                         _lin_t(v) if parts[2] == "weight" else v)
                elif a == "proj":
                    _set(tree, (base, "attn", "proj",
                                "kernel" if parts[2] == "weight" else "bias"),
                         _lin_t(v) if parts[2] == "weight" else v)
                else:
                    leftovers.append(k)
            elif parts[0] == "mlp":
                name_map = {"fc1_g": "fc1_g", "fc1_x": "fc1_x", "fc2": "fc2",
                            "fc1": "fc1", "norm": "mlp_norm"}
                if parts[1] not in name_map:
                    leftovers.append(k)
                    continue
                tgt = name_map[parts[1]]
                if tgt == "mlp_norm":
                    _set(tree, (base, "mlp_norm",
                                "scale" if parts[2] == "weight" else "bias"), v)
                else:
                    _set(tree, (base, tgt,
                                "kernel" if parts[2] == "weight" else "bias"),
                         _lin_t(v) if parts[2] == "weight" else v)
            else:
                leftovers.append(k)

    # fused-qkv EVA: bias = concat(q_bias, zeros_like(k), v_bias)
    for i, bias in qkv_bias_parts.items():
        q, vb = bias.get("q_bias"), bias.get("v_bias")
        if q is None or vb is None:
            raise UnmappedKeysError(f"blocks.{i}: q_bias/v_bias pair incomplete")
        _set(tree, (f"blocks_{i}", "attn", "qkv", "bias"),
             np.concatenate([q, np.zeros_like(q), vb]))
    _strict("eva", leftovers)
    return tree


def export_eva_sd(tree: dict, qkv_fused: bool = False) -> Dict[str, np.ndarray]:
    """Inverse of convert_eva_sd, producing the documented timm layout."""
    sd: Dict[str, np.ndarray] = {}
    sd["cls_token"] = np.asarray(tree["cls_token"]).reshape(1, 1, -1)
    pe = np.asarray(tree["pos_embed"])
    sd["pos_embed"] = pe.reshape(1, *pe.shape)
    # Dense [p*p*C, D]: exported as conv assuming C=3 square patch
    kern = np.asarray(tree["patch_embed"]["kernel"])
    p = int(round((kern.shape[0] / 3) ** 0.5))
    sd["patch_embed.proj.weight"] = np.ascontiguousarray(
        kern.reshape(p, p, 3, -1).transpose(3, 2, 0, 1))
    sd["patch_embed.proj.bias"] = np.asarray(tree["patch_embed"]["bias"])
    sd["norm.weight"] = np.asarray(tree["norm"]["scale"])
    sd["norm.bias"] = np.asarray(tree["norm"]["bias"])
    for name, blk in tree.items():
        if not name.startswith("blocks_"):
            continue
        i = int(name.split("_")[1])
        b = f"blocks.{i}."
        for ln in ("norm1", "norm2"):
            sd[b + ln + ".weight"] = np.asarray(blk[ln]["scale"])
            sd[b + ln + ".bias"] = np.asarray(blk[ln]["bias"])
        attn = blk["attn"]
        if qkv_fused:
            sd[b + "attn.qkv.weight"] = _lin_t(attn["qkv"]["kernel"])
            bias = np.asarray(attn["qkv"]["bias"])
            d = bias.shape[0] // 3
            sd[b + "attn.q_bias"] = bias[:d]
            sd[b + "attn.v_bias"] = bias[2 * d:]
        else:
            sd[b + "attn.q_proj.weight"] = _lin_t(attn["q_proj"]["kernel"])
            sd[b + "attn.q_proj.bias"] = np.asarray(attn["q_proj"]["bias"])
            sd[b + "attn.k_proj.weight"] = _lin_t(attn["k_proj"]["kernel"])
            sd[b + "attn.v_proj.weight"] = _lin_t(attn["v_proj"]["kernel"])
            sd[b + "attn.v_proj.bias"] = np.asarray(attn["v_proj"]["bias"])
        sd[b + "attn.proj.weight"] = _lin_t(attn["proj"]["kernel"])
        sd[b + "attn.proj.bias"] = np.asarray(attn["proj"]["bias"])
        for our, timm in (("fc1_g", "fc1_g"), ("fc1_x", "fc1_x"),
                          ("fc1", "fc1"), ("fc2", "fc2")):
            if our in blk:
                sd[b + f"mlp.{timm}.weight"] = _lin_t(blk[our]["kernel"])
                sd[b + f"mlp.{timm}.bias"] = np.asarray(blk[our]["bias"])
        if "mlp_norm" in blk:
            sd[b + "mlp.norm.weight"] = np.asarray(blk["mlp_norm"]["scale"])
            sd[b + "mlp.norm.bias"] = np.asarray(blk["mlp_norm"]["bias"])
    return sd


# ---------------------------------------------------------------------------
# Swin
# ---------------------------------------------------------------------------

# timm PatchMerging concat order -> ours: timm [x0=(he,we), x1=(ho,we),
# x2=(he,wo), x3=(ho,wo)]; ours [(he,we),(he,wo),(ho,we),(ho,wo)]
_SWIN_MERGE_PERM = (0, 2, 1, 3)


def _permute_merge_rows(v: np.ndarray) -> np.ndarray:
    """Reorder the 4C leading dim from timm group order to ours."""
    v = np.asarray(v)
    c = v.shape[0] // 4
    return np.concatenate([v[p * c:(p + 1) * c] for p in _SWIN_MERGE_PERM],
                          axis=0)


_SWIN_BLOCK = re.compile(r"layers\.(\d+)\.blocks\.(\d+)\.(.+)")
_SWIN_DOWN = re.compile(r"layers\.(\d+)\.downsample\.(.+)")


def convert_swin_sd(sd: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    leftovers = []
    for k, v in sd.items():
        if k == "patch_embed.proj.weight":
            _set(tree, ("patch_embed", "kernel"), _conv_t(v))
        elif k == "patch_embed.proj.bias":
            _set(tree, ("patch_embed", "bias"), v)
        elif k.startswith("patch_embed.norm."):
            _set(tree, ("patch_norm",
                        "scale" if k.endswith("weight") else "bias"), v)
        elif k in ("norm.weight", "norm.bias"):
            _set(tree, ("norm", "scale" if k.endswith("weight") else "bias"), v)
        elif k.endswith("attn.relative_position_index"):
            continue  # static buffer, recomputed
        elif (m := _SWIN_BLOCK.match(k)):
            s, bi, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            base = f"stage{s}_block{bi}"
            parts = rest.split(".")
            if parts[0] in ("norm1", "norm2"):
                _set(tree, (base, parts[0],
                            "scale" if parts[1] == "weight" else "bias"), v)
            elif parts[0] == "attn" and parts[1] in ("qkv", "proj"):
                _set(tree, (base, "attn", parts[1],
                            "kernel" if parts[2] == "weight" else "bias"),
                     _lin_t(v) if parts[2] == "weight" else v)
            elif parts[0] == "attn" and parts[1] == "relative_position_bias_table":
                _set(tree, (base, "attn", "rel_pos_bias"), v)
            elif parts[0] == "mlp" and parts[1] in ("fc1", "fc2"):
                _set(tree, (base, parts[1],
                            "kernel" if parts[2] == "weight" else "bias"),
                     _lin_t(v) if parts[2] == "weight" else v)
            else:
                leftovers.append(k)
        elif (m := _SWIN_DOWN.match(k)):
            s, rest = int(m.group(1)), m.group(2)
            # timm layers.{s}.downsample runs AFTER stage s -> our merge{s+1}
            tgt = f"merge{s + 1}"
            if rest == "reduction.weight":
                # torch [2C, 4C] -> flax kernel [4C, 2C], then reorder the
                # 4C input groups from timm concat order to ours
                _set(tree, (f"{tgt}_reduce", "kernel"),
                     np.ascontiguousarray(_permute_merge_rows(
                         np.asarray(v).T)))
            elif rest in ("norm.weight", "norm.bias"):
                _set(tree, (f"{tgt}_norm",
                            "scale" if rest.endswith("weight") else "bias"),
                     _permute_merge_rows(v))
            else:
                leftovers.append(k)
        else:
            leftovers.append(k)
    _strict("swin", leftovers)
    return tree


def export_swin_sd(tree: dict) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    inv = np.argsort(_SWIN_MERGE_PERM)

    def unpermute(v):
        v = np.asarray(v)
        c = v.shape[0] // 4
        return np.concatenate([v[p * c:(p + 1) * c] for p in inv], axis=0)

    sd["patch_embed.proj.weight"] = np.ascontiguousarray(
        np.asarray(tree["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    sd["patch_embed.proj.bias"] = np.asarray(tree["patch_embed"]["bias"])
    sd["patch_embed.norm.weight"] = np.asarray(tree["patch_norm"]["scale"])
    sd["patch_embed.norm.bias"] = np.asarray(tree["patch_norm"]["bias"])
    sd["norm.weight"] = np.asarray(tree["norm"]["scale"])
    sd["norm.bias"] = np.asarray(tree["norm"]["bias"])
    blk_re = re.compile(r"stage(\d+)_block(\d+)")
    for name, node in tree.items():
        m = blk_re.fullmatch(name)
        if m:
            b = f"layers.{m.group(1)}.blocks.{m.group(2)}."
            for ln in ("norm1", "norm2"):
                sd[b + ln + ".weight"] = np.asarray(node[ln]["scale"])
                sd[b + ln + ".bias"] = np.asarray(node[ln]["bias"])
            sd[b + "attn.qkv.weight"] = _lin_t(node["attn"]["qkv"]["kernel"])
            sd[b + "attn.qkv.bias"] = np.asarray(node["attn"]["qkv"]["bias"])
            sd[b + "attn.proj.weight"] = _lin_t(node["attn"]["proj"]["kernel"])
            sd[b + "attn.proj.bias"] = np.asarray(node["attn"]["proj"]["bias"])
            sd[b + "attn.relative_position_bias_table"] = np.asarray(
                node["attn"]["rel_pos_bias"])
            for fc in ("fc1", "fc2"):
                sd[b + f"mlp.{fc}.weight"] = _lin_t(node[fc]["kernel"])
                sd[b + f"mlp.{fc}.bias"] = np.asarray(node[fc]["bias"])
        elif name.startswith("merge") and name.endswith("_norm"):
            s = int(name[len("merge"):-len("_norm")]) - 1
            sd[f"layers.{s}.downsample.norm.weight"] = unpermute(node["scale"])
            sd[f"layers.{s}.downsample.norm.bias"] = unpermute(node["bias"])
        elif name.startswith("merge") and name.endswith("_reduce"):
            s = int(name[len("merge"):-len("_reduce")]) - 1
            sd[f"layers.{s}.downsample.reduction.weight"] = _lin_t(
                unpermute(np.asarray(node["kernel"])))
    return sd


# ---------------------------------------------------------------------------
# ViTamin
# ---------------------------------------------------------------------------

_VITAMIN_MBBLOCK = re.compile(
    r"patch_embed\.backbone\.stages\.(\d+)\.blocks\.(\d+)\.(.+)")
_VITAMIN_VIT = re.compile(r"blocks\.(\d+)\.(.+)")


def convert_vitamin_sd(sd: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    leftovers = []
    for k, v in sd.items():
        if k.startswith("patch_embed.backbone.stem."):
            rest = k[len("patch_embed.backbone.stem."):]
            name, attr = rest.split(".", 1)
            if name in ("conv1", "conv2"):
                tgt = {"conv1": "stem_conv1", "conv2": "stem_conv2"}[name]
                _set(tree, (tgt, "kernel" if attr == "weight" else "bias"),
                     _conv_t(v) if attr == "weight" else v)
            elif name == "norm1":
                _set(tree, ("stem_norm",
                            "scale" if attr == "weight" else "bias"), v)
            else:
                leftovers.append(k)
        elif (m := _VITAMIN_MBBLOCK.match(k)):
            s, bi, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            base = f"stage{s + 1}_{bi}"
            parts = rest.split(".")
            cmap = {"conv1_1x1": "conv_expand", "conv2_kxk": "conv_dw",
                    "conv3_1x1": "conv_project"}
            if parts[0] in cmap:
                _set(tree, (base, cmap[parts[0]],
                            "kernel" if parts[1] == "weight" else "bias"),
                     _conv_t(v) if parts[1] == "weight" else v)
            elif parts[0] == "pre_norm":
                _set(tree, (base, "norm",
                            "scale" if parts[1] == "weight" else "bias"), v)
            else:
                leftovers.append(k)
        elif k.startswith("patch_embed.backbone.pool."):
            attr = k.rsplit(".", 1)[1]
            _set(tree, ("patch_conv", "kernel" if attr == "weight" else "bias"),
                 _conv_t(v) if attr == "weight" else v)
        elif k == "pos_embed":
            _set(tree, ("pos_embed",),
                 np.asarray(v).reshape(v.shape[-2], v.shape[-1]))
        elif k in ("norm.weight", "norm.bias"):
            _set(tree, ("norm", "scale" if k.endswith("weight") else "bias"), v)
        elif (m := _VITAMIN_VIT.match(k)):
            i, rest = int(m.group(1)), m.group(2)
            base = f"blocks_{i}"
            parts = rest.split(".")
            if parts[0] in ("norm1", "norm2"):
                _set(tree, (base, parts[0],
                            "scale" if parts[1] == "weight" else "bias"), v)
            elif parts[0] == "attn" and parts[1] in ("qkv", "proj"):
                _set(tree, (base, parts[1],
                            "kernel" if parts[2] == "weight" else "bias"),
                     _lin_t(v) if parts[2] == "weight" else v)
            elif parts[0] == "mlp":
                # GeGLU: timm fc1_g/fc1_x/fc2; paper repo w0(gate)/w1(x)/w2
                alias = {"fc1_g": "fc1_g", "w0": "fc1_g", "fc1_x": "fc1_x",
                         "w1": "fc1_x", "fc2": "fc2", "w2": "fc2"}
                if parts[1] not in alias:
                    leftovers.append(k)
                    continue
                _set(tree, (base, alias[parts[1]],
                            "kernel" if parts[2] == "weight" else "bias"),
                     _lin_t(v) if parts[2] == "weight" else v)
            else:
                leftovers.append(k)
        else:
            leftovers.append(k)
    _strict("vitamin", leftovers)
    return tree


def export_vitamin_sd(tree: dict) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}

    def conv_out(node):
        return np.ascontiguousarray(
            np.asarray(node["kernel"]).transpose(3, 2, 0, 1))

    sd["patch_embed.backbone.stem.conv1.weight"] = conv_out(tree["stem_conv1"])
    sd["patch_embed.backbone.stem.conv1.bias"] = np.asarray(
        tree["stem_conv1"]["bias"])
    sd["patch_embed.backbone.stem.norm1.weight"] = np.asarray(
        tree["stem_norm"]["scale"])
    sd["patch_embed.backbone.stem.norm1.bias"] = np.asarray(
        tree["stem_norm"]["bias"])
    sd["patch_embed.backbone.stem.conv2.weight"] = conv_out(tree["stem_conv2"])
    sd["patch_embed.backbone.stem.conv2.bias"] = np.asarray(
        tree["stem_conv2"]["bias"])
    sd["patch_embed.backbone.pool.weight"] = conv_out(tree["patch_conv"])
    sd["patch_embed.backbone.pool.bias"] = np.asarray(
        tree["patch_conv"]["bias"])
    pe = np.asarray(tree["pos_embed"])
    sd["pos_embed"] = pe.reshape(1, *pe.shape)
    sd["norm.weight"] = np.asarray(tree["norm"]["scale"])
    sd["norm.bias"] = np.asarray(tree["norm"]["bias"])
    st_re = re.compile(r"stage(\d+)_(\d+)")
    blk_re = re.compile(r"blocks_(\d+)")
    inv_cmap = {"conv_expand": "conv1_1x1", "conv_dw": "conv2_kxk",
                "conv_project": "conv3_1x1"}
    for name, node in tree.items():
        if (m := st_re.fullmatch(name)):
            b = (f"patch_embed.backbone.stages.{int(m.group(1)) - 1}"
                 f".blocks.{m.group(2)}.")
            sd[b + "pre_norm.weight"] = np.asarray(node["norm"]["scale"])
            sd[b + "pre_norm.bias"] = np.asarray(node["norm"]["bias"])
            for our, timm in inv_cmap.items():
                sd[b + timm + ".weight"] = conv_out(node[our])
                sd[b + timm + ".bias"] = np.asarray(node[our]["bias"])
        elif (m := blk_re.fullmatch(name)):
            b = f"blocks.{m.group(1)}."
            for ln in ("norm1", "norm2"):
                sd[b + ln + ".weight"] = np.asarray(node[ln]["scale"])
                sd[b + ln + ".bias"] = np.asarray(node[ln]["bias"])
            for lin, timm in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                              ("fc1_g", "mlp.fc1_g"), ("fc1_x", "mlp.fc1_x"),
                              ("fc2", "mlp.fc2")):
                sd[b + timm + ".weight"] = _lin_t(node[lin]["kernel"])
                sd[b + timm + ".bias"] = np.asarray(node[lin]["bias"])
    return sd


# ---------------------------------------------------------------------------
# FastViT (inference / reparameterized form)
# ---------------------------------------------------------------------------

def _identity_bn(conv_w: np.ndarray, conv_b: np.ndarray, groups_out: int,
                 subtract_identity: bool = False):
    """Map a fused conv(+bias) onto our ConvBN (conv no-bias + BatchNorm)
    exactly: BN(mean=0 [init], var=1 [init], scale=sqrt(1+eps), bias=b).
    With subtract_identity, remove the folded residual identity tap so our
    residual `x + conv(x)` form reproduces `reparam_conv(x)`."""
    w = _conv_t(conv_w)  # [kh, kw, cin/g, cout]
    if subtract_identity:
        w = w.copy()
        kh, kw, cin_g, cout = w.shape
        assert cin_g == 1, "identity subtraction expects depthwise conv"
        w[kh // 2, kw // 2, 0, :] -= 1.0
    return {
        "conv": {"kernel": w},
        "bn": {"scale": np.full(conv_w.shape[0], np.sqrt(1.0 + BN_EPS),
                                np.float32),
               "bias": np.asarray(conv_b, np.float32)},
    }


def _fuse_convbn(node: dict, stats: dict, subtract: bool = False):
    """ConvBN params+batch_stats -> fused torch conv (weight, bias)."""
    w = np.asarray(node["conv"]["kernel"], np.float64)  # HWIO
    scale = np.asarray(node["bn"]["scale"], np.float64)
    bias = np.asarray(node["bn"]["bias"], np.float64)
    mean = np.asarray(stats["bn"]["mean"], np.float64)
    var = np.asarray(stats["bn"]["var"], np.float64)
    g = scale / np.sqrt(var + BN_EPS)
    fused_w = w * g  # broadcast over cout (last axis)
    if subtract:
        fused_w = fused_w.copy()
        kh, kw, _, _ = fused_w.shape
        fused_w[kh // 2, kw // 2, 0, :] += 1.0
    fused_b = bias - mean * g
    return (np.ascontiguousarray(fused_w.transpose(3, 2, 0, 1).astype(np.float32)),
            fused_b.astype(np.float32))


_FV_STAGE_BLOCK = re.compile(r"stages\.(\d+)\.blocks\.(\d+)\.(.+)")


def convert_fastvit_sd(sd: Dict[str, np.ndarray]) -> dict:
    """Returns {"params": tree}-style flat param tree; BatchNorm running
    statistics stay at their init values (mean 0 / var 1), which the identity
    construction requires — run converted models with frozen (eval) BN."""
    tree: dict = {}
    leftovers = []
    # collect (key, value) pairs into per-module dicts first
    pairs: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        mod, attr = k.rsplit(".", 1)
        pairs.setdefault(mod, {})[attr] = np.asarray(v)

    # layer-scale gammas folded into the branch output conv
    gammas: Dict[str, np.ndarray] = {}
    for mod in list(pairs):
        if mod.endswith(("layer_scale", "layer_scale_1", "layer_scale_2")):
            gammas[mod] = pairs.pop(mod)["gamma"].reshape(-1)

    def gamma_for(block_prefix: str, which: str):
        # which: "mixer"/"attn" -> layer_scale_1 (or RepMixer's own, already
        # folded by reparam); "mlp" -> layer_scale_2 / layer_scale
        for suffix in ({"mlp": ("layer_scale_2", "layer_scale")}.get(
                which, ("layer_scale_1",))):
            g = gammas.get(f"{block_prefix}.{suffix}")
            if g is not None:
                return g
        return None

    def put_convbn(path, mod_pairs, subtract=False):
        node = _identity_bn(mod_pairs["weight"], mod_pairs["bias"],
                            0, subtract_identity=subtract)
        _set(tree, path + ("conv", "kernel"), node["conv"]["kernel"])
        _set(tree, path + ("bn", "scale"), node["bn"]["scale"])
        _set(tree, path + ("bn", "bias"), node["bn"]["bias"])

    def put_lin(path, mod_pairs, gamma=None):
        w, b = mod_pairs["weight"], mod_pairs.get("bias")
        if b is None:
            b = np.zeros(w.shape[0], np.float32)
        if gamma is not None:
            w = w * gamma[:, None]
            b = b * gamma
        _set(tree, path + ("kernel",), _lin_t(w))
        _set(tree, path + ("bias",), b)

    def put_conv(path, mod_pairs, gamma=None):
        w, b = mod_pairs["weight"], mod_pairs.get("bias")
        if b is None:
            b = np.zeros(w.shape[0], np.float32)
        if gamma is not None:
            w = w * gamma[:, None, None, None]
            b = b * gamma
        _set(tree, path + ("kernel",), _conv_t(w))
        _set(tree, path + ("bias",), b)

    def put_bn(path, mod_pairs):
        _set(tree, path + ("scale",), mod_pairs["weight"])
        _set(tree, path + ("bias",), mod_pairs["bias"])
        # running stats: handled by caller via batch_stats (left at init when
        # zero/one; FastViT attn-stage norms carry real stats — see below)

    bn_stats: dict = {}  # batch_stats tree for BN modules with real stats

    def put_bn_stats(path, mod_pairs):
        _set(bn_stats, path + ("mean",), mod_pairs["running_mean"])
        _set(bn_stats, path + ("var",), mod_pairs["running_var"])

    for mod, mp in sorted(pairs.items()):
        if mod in ("stem.0.reparam_conv", "stem.1.reparam_conv",
                   "stem.2.reparam_conv"):
            put_convbn((f"stem{mod.split('.')[1]}",), mp)
        elif mod == "final_conv.reparam_conv":
            put_convbn(("final_conv",), mp)
        elif (m := re.fullmatch(r"stages\.(\d+)\.downsample\.proj\.(\d)\."
                                r"reparam_conv", mod)):
            s, which = int(m.group(1)), m.group(2)
            put_convbn((f"downsample{s}", "dw" if which == "0" else "pw"), mp)
        elif (m := re.fullmatch(r"stages\.(\d+)\.pos_emb\.reparam_conv", mod)):
            s = int(m.group(1))
            put_convbn((f"stage{s}_pos_emb",), mp, subtract=True)
        elif (m := _FV_STAGE_BLOCK.match(mod)):
            s, bi, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            base = f"stage{s}_block{bi}"
            bp = f"stages.{s}.blocks.{bi}"
            if rest == "token_mixer.reparam_conv":
                put_convbn((base, "mixer"), mp, subtract=True)
            elif rest == "norm":
                put_bn((base, "norm"), mp)
                put_bn_stats((base, "norm"), mp)
            elif rest in ("token_mixer.qkv", "token_mixer.proj"):
                name = rest.split(".")[1]
                put_lin((base, name), mp,
                        gamma=gamma_for(bp, "attn") if name == "proj" else None)
            elif rest == "mlp.conv.conv":
                _set(tree, (base, "ffn", "dw", "conv", "kernel"),
                     _conv_t(mp["weight"]))
            elif rest == "mlp.conv.bn":
                put_bn((base, "ffn", "dw", "bn"), mp)
                put_bn_stats((base, "ffn", "dw", "bn"), mp)
            elif rest == "mlp.fc1":
                put_conv((base, "ffn", "fc1"), mp)
            elif rest == "mlp.fc2":
                put_conv((base, "ffn", "fc2"), mp, gamma=gamma_for(bp, "mlp"))
            else:
                leftovers.extend(f"{mod}.{a}" for a in mp)
        else:
            leftovers.extend(f"{mod}.{a}" for a in mp)
    _strict("fastvit", leftovers)
    tree["__batch_stats__"] = bn_stats
    return tree


def export_fastvit_sd(params: dict, batch_stats: dict) -> Dict[str, np.ndarray]:
    """Our FastVitTrunk (params + batch_stats) -> reparameterized timm sd."""
    sd: Dict[str, np.ndarray] = {}

    def emit(timm_name, node, stats, subtract=False):
        w, b = _fuse_convbn(node, stats, subtract=subtract)
        sd[timm_name + ".weight"] = w
        sd[timm_name + ".bias"] = b

    for name in ("stem0", "stem1", "stem2"):
        emit(f"stem.{name[-1]}.reparam_conv", params[name],
             batch_stats[name])
    emit("final_conv.reparam_conv", params["final_conv"],
         batch_stats["final_conv"])
    for name, node in params.items():
        if name.startswith("downsample"):
            s = int(name[len("downsample"):])
            emit(f"stages.{s}.downsample.proj.0.reparam_conv", node["dw"],
                 batch_stats[name]["dw"])
            emit(f"stages.{s}.downsample.proj.1.reparam_conv", node["pw"],
                 batch_stats[name]["pw"])
        elif name.endswith("_pos_emb"):
            s = int(name[len("stage"):-len("_pos_emb")])
            emit(f"stages.{s}.pos_emb.reparam_conv", node,
                 batch_stats[name], subtract=True)
        elif (m := re.fullmatch(r"stage(\d+)_block(\d+)", name)):
            s, bi = m.group(1), m.group(2)
            b = f"stages.{s}.blocks.{bi}."
            stats = batch_stats.get(name, {})
            if "mixer" in node:
                emit(b + "token_mixer.reparam_conv", node["mixer"],
                     stats["mixer"], subtract=True)
            if "norm" in node:
                sd[b + "norm.weight"] = np.asarray(node["norm"]["scale"])
                sd[b + "norm.bias"] = np.asarray(node["norm"]["bias"])
                sd[b + "norm.running_mean"] = np.asarray(
                    stats["norm"]["mean"])
                sd[b + "norm.running_var"] = np.asarray(stats["norm"]["var"])
            for lin, timm in (("qkv", "token_mixer.qkv"),
                              ("proj", "token_mixer.proj")):
                if lin in node:
                    sd[b + timm + ".weight"] = _lin_t(node[lin]["kernel"])
                    sd[b + timm + ".bias"] = np.asarray(node[lin]["bias"])
            ffn = node["ffn"]
            fstats = stats["ffn"]
            sd[b + "mlp.conv.conv.weight"] = np.ascontiguousarray(
                np.asarray(ffn["dw"]["conv"]["kernel"]).transpose(3, 2, 0, 1))
            sd[b + "mlp.conv.bn.weight"] = np.asarray(ffn["dw"]["bn"]["scale"])
            sd[b + "mlp.conv.bn.bias"] = np.asarray(ffn["dw"]["bn"]["bias"])
            sd[b + "mlp.conv.bn.running_mean"] = np.asarray(
                fstats["dw"]["bn"]["mean"])
            sd[b + "mlp.conv.bn.running_var"] = np.asarray(
                fstats["dw"]["bn"]["var"])
            for fc in ("fc1", "fc2"):
                sd[b + f"mlp.{fc}.weight"] = np.ascontiguousarray(
                    np.asarray(ffn[fc]["kernel"]).transpose(3, 2, 0, 1))
                sd[b + f"mlp.{fc}.bias"] = np.asarray(ffn[fc]["bias"])
    return sd
