"""Precomputed-prompt serving for the XTag pipeline
(port of xtagclip_tpu/serving.py).

The prompt space (templates x classes x tag combos) is finite, so every
pseudo-prompt is embedded once (``precompute_prompt_features``: the pooled
fusion query ``text_tokens.mean(dim=1)``, a [C, K, D] table) and the serve
step is encode_image -> tag head -> table gather -> TQN fusion over all C
classes: no per-image text tower.
"""

from __future__ import annotations

import numpy as np
import torch

from xtagclip_tpu_torch.models.clip import combo_index


@torch.inference_mode()
def precompute_prompt_features(model, prompt_table, template_id: int = 0,
                               batch_size: int = 512) -> torch.Tensor:
    """Encode every (class, combo) pseudo-prompt of one template.

    prompt_table: [T, C, K, ctx] int token ids (PromptTable(...).table).
    Returns the pooled fusion queries as a [C, K, D] tensor on the model's
    device, in its compute dtype."""
    table = np.asarray(prompt_table)
    _, n_cls, n_combos, ctx = table.shape
    rows = torch.from_numpy(table[template_id].reshape(-1, ctx).astype(np.int64))
    device = model.logit_scale.device
    feats = []
    for start in range(0, rows.shape[0], batch_size):
        chunk = rows[start:start + batch_size].to(device, non_blocking=True)
        _, seq = model.encode_text(chunk)
        feats.append(seq.mean(dim=1))
    return torch.cat(feats).reshape(n_cls, n_combos, -1)


def serve_body(model, images, table):
    """images -> (img_feat, global tag picks, [B, C] fusion logits).

    The fusion logits follow the train path's i2t direction: queries are
    the per-class pooled prompt features for the image's OWN tag combo,
    memory is [global ; local] image tokens."""
    img_feat, tokens = model.encode_image(images, normalize=True)
    tag_logits = model.tag_forward(tokens)
    tag_local, tag_global = model.prepare_tag_indices(tag_logits)
    combo = combo_index(tag_local)                   # [B]
    queries = table[:, combo].transpose(0, 1)        # [B, C, D]
    image_g = tokens.mean(dim=1)
    memory = torch.cat([image_g[:, None], tokens], dim=1)
    i2t = model.fusion_model(memory, queries)[..., 0]
    return img_feat, tag_global, i2t


def make_xtag_serve_step(model, text_g_table):
    """images [B, H, W, 3] normalized -> (img_feat, tag picks, [B, C]).

    text_g_table: [C, K, D] from precompute_prompt_features."""
    if not getattr(model, "use_fusion", False):
        raise ValueError(
            "make_xtag_serve_step needs a model built with use_fusion=True "
            "(and use_tagging=True) — pass them to create_model")

    @torch.inference_mode()
    def serve(images):
        return serve_body(model, images, text_g_table)

    return serve
