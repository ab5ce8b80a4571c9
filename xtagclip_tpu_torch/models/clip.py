"""CLIP assembly with the XTag additions: tag head, pseudo-prompt table,
TQN fusion (port of xtagclip_tpu/models/clip.py).

Tag category layout: sizes (3,4,3,4,4,4) over 22 tags; tag i scores
sigmoid(logits[i]) + sigmoid(logits[22+i]), and each category takes the
argmax of its scores (first index on ties, as ``jnp.argmax``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from xtagclip_tpu_torch.models.layers import Dense, Embed
from xtagclip_tpu_torch.models.tag_head import TagBertHead
from xtagclip_tpu_torch.models.tqn import TQNModel

TAG_CATEGORY_SIZES = (3, 4, 3, 4, 4, 4)
TAG_CATEGORY_OFFSETS = tuple(
    int(v) for v in np.cumsum((0,) + TAG_CATEGORY_SIZES)[:-1])
NUM_TAGS = sum(TAG_CATEGORY_SIZES)  # 22


def combo_index(tag_local_idx: torch.Tensor) -> torch.Tensor:
    """Mixed-radix index of per-category choices [.., 6] -> one per row."""
    idx = tag_local_idx[..., 0]
    for i in range(1, len(TAG_CATEGORY_SIZES)):
        idx = idx * TAG_CATEGORY_SIZES[i] + tag_local_idx[..., i]
    return idx


def num_combos() -> int:
    return int(np.prod(TAG_CATEGORY_SIZES))  # 2304


def l2_normalize(x, dim=-1, eps=1e-12):
    x32 = x.float()
    n = x32.square().sum(dim=dim, keepdim=True).sqrt()
    return (x32 / n.clamp_min(eps)).to(x.dtype)


class CLIP(nn.Module):
    """Two-tower CLIP + tag head + TQN fusion (``fusion_model`` exists only
    with ``use_fusion``, as the JAX tree has it only then)."""

    def __init__(self, visual: nn.Module, text: nn.Module, embed_dim: int,
                 use_tagging: bool = False, use_fusion: bool = False,
                 tag_hidden_size: int = 768, tag_heads: int = 4,
                 tag_layers: int = 2, tag_intermediate_size: int = 3072,
                 num_tags: int = NUM_TAGS, fusion_dim: int = 512,
                 init_logit_scale: float = math.log(1 / 0.07),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if use_fusion and embed_dim != fusion_dim:
            raise ValueError(
                f"use_fusion requires embed_dim == fusion_dim "
                f"({embed_dim} != {fusion_dim})")
        self.visual = visual
        self.text = text
        self.embed_dim = embed_dim
        self.use_tagging = use_tagging
        self.use_fusion = use_fusion
        self.num_tags = num_tags
        self.tag_hidden_size = tag_hidden_size
        self.init_logit_scale = init_logit_scale
        self.dtype = dtype
        self.logit_scale = nn.Parameter(torch.empty(()))
        self.tag_head = TagBertHead(embed_dim, tag_layers, tag_hidden_size,
                                    tag_heads, tag_intermediate_size)
        self.tag_labels = Embed(num_tags * 2, tag_hidden_size, init_std=1.0)
        self.tag_fc = Dense(tag_hidden_size, 1)
        self.fusion_model = TQNModel(fusion_dim) if use_fusion else None
        # on the device once, so that a pick reads no host memory (a CUDA
        # graph or an exported program holds no host-to-device copy)
        self.register_buffer(
            "tag_offsets", torch.tensor(TAG_CATEGORY_OFFSETS),
            persistent=False)

    def init_params(self, generator):
        nn.init.constant_(self.logit_scale, self.init_logit_scale)

    # ---- tower wrappers -------------------------------------------------
    def encode_image(self, image, normalize: bool = False):
        pooled, tokens = self.visual(image)
        return (l2_normalize(pooled) if normalize else pooled), tokens

    def encode_text(self, text, normalize: bool = False):
        projected, seq = self.text(text)
        return (l2_normalize(projected) if normalize else projected), seq

    # ---- XTag pieces -----------------------------------------------------
    def tag_forward(self, image_tokens, generator=None):
        """The 2*num_tags label queries over the image tokens -> [B, 44]."""
        b = image_tokens.shape[0]
        label = self.tag_labels.embedding.to(self.dtype).expand(
            b, self.num_tags * 2, self.tag_hidden_size)
        out = self.tag_head(label, image_tokens, generator)
        return self.tag_fc(out)[..., 0]

    def prepare_tag_indices(self, tag_logits):
        """Per-category argmax of paired sigmoid scores -> local [B, 6] and
        global [B, 6] tag indices."""
        n = self.num_tags
        scores = torch.sigmoid(tag_logits[:, :n]) + torch.sigmoid(
            tag_logits[:, n:])
        local = torch.stack(
            [scores[:, off:off + size].argmax(dim=-1)
             for size, off in zip(TAG_CATEGORY_SIZES, TAG_CATEGORY_OFFSETS)],
            dim=-1)
        return local, local + self.tag_offsets

    # ---- full forward ----------------------------------------------------
    def forward(self, image, text=None, prompt_table=None, class_ids=None,
                template_id: int = 0, deterministic: bool = True,
                generator=None):
        """prompt_table: [T, C, K, ctx] token ids; class_ids: [B].

        ``deterministic=False`` turns on the tag head's and TQN's dropout
        (the JAX ``__call__``, clip.py:238-247), whose masks are drawn from
        ``generator``, a ``torch.Generator`` on the model's device."""
        if deterministic:
            generator = None
        elif generator is None:
            raise ValueError("deterministic=False needs a torch.Generator "
                             "for the dropout masks")
        image_features, image_tokens = self.encode_image(image, normalize=True)
        tag_logits = self.tag_forward(image_tokens, generator)
        tag_local, tag_global = self.prepare_tag_indices(tag_logits)

        if self.use_tagging and prompt_table is not None:
            if class_ids is None:
                raise ValueError(
                    "use_tagging forward needs class_ids alongside "
                    "prompt_table")
            prompts = prompt_table[template_id, class_ids,
                                   combo_index(tag_local)]
            text_features, text_tokens = self.encode_text(prompts,
                                                          normalize=True)
        elif text is not None:
            text_features, text_tokens = self.encode_text(text, normalize=True)
        else:
            text_features, text_tokens = None, None

        out = {
            "image_features": image_features,
            "text_features": text_features,
            "logit_scale": self.logit_scale.exp(),
            "tag_logits": tag_logits,
            "tag_indices": tag_global,
            "i2t_cls": None,
            "t2i_cls": None,
            "text_features_l": None,
            "text_features_g": None,
            "image_features_l": None,
            "image_features_g": None,
        }
        if self.use_fusion and text_features is not None:
            text_g = text_tokens.mean(dim=1)
            image_g = image_tokens.mean(dim=1)
            i2t = self.fusion_model(
                torch.cat([image_g[:, None], image_tokens], dim=1), text_g,
                generator)[..., 0]
            t2i = self.fusion_model(
                torch.cat([text_g[:, None], text_tokens], dim=1), image_g,
                generator)[..., 0]
            out.update(i2t_cls=i2t, t2i_cls=t2i, text_features_l=text_tokens,
                       text_features_g=text_g, image_features_l=image_tokens,
                       image_features_g=image_g)
        return out
