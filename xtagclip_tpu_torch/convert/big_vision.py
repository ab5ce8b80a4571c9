"""big_vision / SigLIP .npz weights (a copy of xtagclip_tpu/convert/
big_vision.py; reference convert.py:13-150), numpy only.

big_vision stores its parameters as flat 'img/...' and 'txt/...' arrays
(or 'params/img/...', 'params/txt/...'). ``load_big_vision_weights`` maps
the ViT image tower and the text transformer onto the flax-layout tree of
the JAX package, which convert/loader.py then loads by the parameter names
of convert/from_jax.py. It maps what the JAX converter maps and no more:
the patch embedding's kernel, the position tables, the encoder blocks
(q, k, v fused into in_proj), the encoder norms, the token embedding, the
text head and the scalars t and b. Every other key of the archive (an
image head, a MAP head) is left unread, and its parameter keeps its value.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _set(tree, path, v):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = v


class _Archive:
    """An opened .npz that records the keys read from it."""

    def __init__(self, path: str):
        self._npz = np.load(path)
        self.files = self._npz.files
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return self._npz[key]


def load_big_vision_weights(path: str, unread: Optional[list] = None) -> dict:
    """The flax-layout parameter tree of the big_vision archive ``path``
    (module doc); a key the layout lacks raises KeyError naming it. The
    archive's keys left unread are appended to ``unread`` where given."""
    w = _Archive(path)
    tree: dict = {}

    def block_map(prefix, out_prefix, i):
        b = f"{prefix}/encoderblock_{i}"
        o = out_prefix + (f"resblocks_{i}",)
        _set(tree, o + ("ln_1", "scale"), w[f"{b}/LayerNorm_0/scale"])
        _set(tree, o + ("ln_1", "bias"), w[f"{b}/LayerNorm_0/bias"])
        _set(tree, o + ("ln_2", "scale"), w[f"{b}/LayerNorm_1/scale"])
        _set(tree, o + ("ln_2", "bias"), w[f"{b}/LayerNorm_1/bias"])
        att = f"{b}/MultiHeadDotProductAttention_0"
        d = w[f"{att}/query/kernel"].shape[0]
        qkv_k = np.concatenate(
            [w[f"{att}/{n}/kernel"].reshape(d, -1) for n in
             ("query", "key", "value")], axis=1,
        )
        qkv_b = np.concatenate(
            [w[f"{att}/{n}/bias"].reshape(-1) for n in
             ("query", "key", "value")]
        )
        _set(tree, o + ("attn", "in_proj", "kernel"), qkv_k)
        _set(tree, o + ("attn", "in_proj", "bias"), qkv_b)
        _set(tree, o + ("attn", "out_proj", "kernel"),
             w[f"{att}/out/kernel"].reshape(-1, d))
        _set(tree, o + ("attn", "out_proj", "bias"), w[f"{att}/out/bias"])
        mlp = f"{b}/MlpBlock_0"
        _set(tree, o + ("mlp", "c_fc", "kernel"), w[f"{mlp}/Dense_0/kernel"])
        _set(tree, o + ("mlp", "c_fc", "bias"), w[f"{mlp}/Dense_0/bias"])
        _set(tree, o + ("mlp", "c_proj", "kernel"), w[f"{mlp}/Dense_1/kernel"])
        _set(tree, o + ("mlp", "c_proj", "bias"), w[f"{mlp}/Dense_1/bias"])

    keys = set(w.files)

    # ----- image tower (params/img/... or img/...) -----
    def k(name):
        for cand in (f"params/img/{name}", f"img/{name}"):
            if cand in keys:
                return cand
        return None

    emb = k("embedding/kernel")
    if emb is not None:
        kern = w[emb]  # [ph, pw, C, D]
        _set(tree, ("visual", "conv1", "kernel"),
             kern.reshape(-1, kern.shape[-1]))
        prefix = emb.rsplit("/embedding/kernel", 1)[0]
        pos = w[f"{prefix}/pos_embedding"]
        _set(tree, ("visual", "positional_embedding"),
             pos.reshape(pos.shape[-2], pos.shape[-1]))
        n = len([f for f in keys
                 if f.startswith(f"{prefix}/Transformer/encoderblock_")
                 and f.endswith("LayerNorm_0/scale")])
        for i in range(n):
            block_map(f"{prefix}/Transformer", ("visual", "transformer"), i)
        _set(tree, ("visual", "ln_post", "scale"),
             w[f"{prefix}/Transformer/encoder_norm/scale"])
        _set(tree, ("visual", "ln_post", "bias"),
             w[f"{prefix}/Transformer/encoder_norm/bias"])

    # ----- text tower -----
    def t(name):
        for cand in (f"params/txt/{name}", f"txt/{name}"):
            if cand in keys:
                return cand
        return None

    temb = t("Embed_0/embedding")
    if temb is not None:
        _set(tree, ("text", "token_embedding", "embedding"), w[temb])
        prefix = temb.rsplit("/Embed_0/embedding", 1)[0]
        pos = w[f"{prefix}/pos_embedding"]
        _set(tree, ("text", "positional_embedding"),
             pos.reshape(pos.shape[-2], pos.shape[-1]))
        n = len([f for f in keys
                 if f.startswith(f"{prefix}/Encoder_0/encoderblock_")
                 and f.endswith("LayerNorm_0/scale")])
        for i in range(n):
            block_map(f"{prefix}/Encoder_0", ("text", "transformer"), i)
        _set(tree, ("text", "ln_final", "scale"),
             w[f"{prefix}/Encoder_0/encoder_norm/scale"])
        _set(tree, ("text", "ln_final", "bias"),
             w[f"{prefix}/Encoder_0/encoder_norm/bias"])
        head_k = t("head/kernel")
        if head_k is not None:
            _set(tree, ("text", "text_projection", "kernel"), w[head_k])
            _set(tree, ("text", "text_projection", "bias"),
                 w[t("head/bias")])

    for name, out in (("t", ("logit_scale",)), ("b", ("logit_bias",))):
        for cand in (f"params/{name}", name):
            if cand in keys:
                _set(tree, out, w[cand].reshape(()))
    if unread is not None:
        unread.extend(sorted(k for k in w.files if k not in w.read))
    return tree
