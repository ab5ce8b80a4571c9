"""Precomputed-prompt serving for the XTag pipeline
(port of xtagclip_tpu/serving.py), and the CUDA-graph runner that serves
a step as one replay per batch.

The prompt space (templates x classes x tag combos) is finite, so every
pseudo-prompt is embedded once (``precompute_prompt_features``: the pooled
fusion query ``text_tokens.mean(dim=1)``, a [C, K, D] table) and the serve
step is encode_image -> tag head -> table gather -> TQN fusion over all C
classes: no per-image text tower.

``serve_classify_body`` is that step on uint8 images (kernel #5 first),
the program that ``convert/serving.py`` exports and ``cli/predict.py``
serves. ``CudaGraphRunner`` runs such a step as one CUDA graph per input
shape: JAX's predict runs one jitted program for every batch; here the
counterpart is a graph captured once and replayed, so the host launches
one graph instead of some hundreds of kernels a batch.

This module imports no model code at import time, so that a serving
artifact loads without ``xtagclip_tpu_torch.models`` (convert/serving.py).
"""

from __future__ import annotations

import numpy as np
import torch

from xtagclip_tpu_torch.ops.preprocess import normalize_images
from xtagclip_tpu_torch.utils.constants import (
    OPENAI_DATASET_MEAN,
    OPENAI_DATASET_STD,
)


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
    memory is [global ; local] image tokens. The picks stay on the device
    (no host read), so the step can be captured or exported whole."""
    from xtagclip_tpu_torch.models.clip import combo_index

    img_feat, tokens = model.encode_image(images, normalize=True)
    tag_logits = model.tag_forward(tokens)
    tag_local, tag_global = model.prepare_tag_indices(tag_logits)
    combo = combo_index(tag_local)                   # [B]
    queries = table[:, combo].transpose(0, 1)        # [B, C, D]
    image_g = tokens.mean(dim=1)
    memory = torch.cat([image_g[:, None], tokens], dim=1)
    i2t = model.fusion_model(memory, queries)[..., 0]
    return img_feat, tag_global, i2t


def serve_classify_body(model, images_u8, table, mean=OPENAI_DATASET_MEAN,
                        std=OPENAI_DATASET_STD):
    """uint8 [B, H, W, 3] -> ``serve_body``'s outputs: the images
    normalized on the device with ``mean``/``std`` into the model's
    compute dtype (kernel #5), then the serve step. The body JAX's
    ``export_serve_classify`` wraps (convert/serving.py:150-161)."""
    x = normalize_images(images_u8, mean, std, dtype=model.dtype)
    return serve_body(model, x, table)


def make_xtag_serve_step(model, text_g_table):
    """images [B, H, W, 3] normalized -> (img_feat, tag picks, [B, C]).

    text_g_table: [C, K, D] from precompute_prompt_features."""
    _check_fusion(model, "make_xtag_serve_step")

    @torch.inference_mode()
    def serve(images):
        return serve_body(model, images, text_g_table)

    return serve


def make_serve_classify(model, text_g_table, mean=OPENAI_DATASET_MEAN,
                        std=OPENAI_DATASET_STD):
    """uint8 images [B, H, W, 3] on the model's device -> (img_feat, tag
    picks, [B, C]): ``serve_classify_body`` under inference mode."""
    _check_fusion(model, "make_serve_classify")

    @torch.inference_mode()
    def serve(images_u8):
        return serve_classify_body(model, images_u8, text_g_table, mean, std)

    return serve


def _check_fusion(model, what):
    if not getattr(model, "use_fusion", False):
        raise ValueError(
            f"{what} needs a model built with use_fusion=True "
            "(and use_tagging=True) — pass them to create_model")


class CudaGraphRunner:
    """Runs ``fn`` (CUDA tensors in, tensors out) as a CUDA graph.

    The first call for an input shape runs ``fn`` once eagerly on a side
    stream (``warm_up``: kernel builds, library loads and first-use state
    happen there), then captures one call into a graph (``capture``), then
    replays it. Every later call of that shape copies its inputs into the
    graph's static input buffers and replays: the kernels read and write
    the addresses they were captured with (the TMA descriptors in their
    parameters included). The returned tensors are the graph's static
    outputs, overwritten by the next call of the same shape: read or copy
    them first. A call on CPU tensors runs ``fn`` directly.

    Launch counters (ops/*.py) count the warm-up and the capture, never a
    replay. ``fn`` runs under inference mode."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs = {}

    @staticmethod
    def _key(inputs):
        return tuple((tuple(t.shape), t.dtype, t.device) for t in inputs)

    def warm_up(self, *inputs):
        """One eager call on a side stream, as capture requires."""
        side = torch.cuda.Stream(device=inputs[0].device)
        side.wait_stream(torch.cuda.current_stream(inputs[0].device))
        with torch.cuda.stream(side), torch.inference_mode():
            self.fn(*inputs)
        torch.cuda.current_stream(inputs[0].device).wait_stream(side)

    def capture(self, *inputs):
        """Capture one call of ``fn`` on static copies of ``inputs``."""
        static_in = [t.clone() for t in inputs]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph), torch.inference_mode():
            static_out = self.fn(*static_in)
        self.graphs[self._key(inputs)] = (graph, static_in, static_out)

    def __call__(self, *inputs):
        if inputs[0].device.type != "cuda":
            with torch.inference_mode():
                return self.fn(*inputs)
        key = self._key(inputs)
        if key not in self.graphs:
            self.warm_up(*inputs)
            self.capture(*inputs)
        graph, static_in, static_out = self.graphs[key]
        for buf, t in zip(static_in, inputs):
            buf.copy_(t)
        graph.replay()
        return static_out
