"""CoCa: contrastive + captioning model with autoregressive generation
(port of xtagclip_tpu/models/coca.py).

A class-token-pooled text tower (``embed_cls``), an attentionally pooled
vision tower (``attentional_pool``), and a multimodal decoder of
interleaved [causal self-attention, cross-attention to the image
embeddings] blocks projecting to vocabulary logits in fp32.

Routes on the card (models/layers.py): the decoder's causal
self-attention blocks take the fused halves (#1, #2; #3 under grad); its
cross-attention blocks, the text tower's blocks under their per-sample
mask and the vision pooler run their attention core as plain PyTorch
(XLA's in JAX), with the MLP halves on #2; the ViT blocks take flash
attention (#6) and the fused MLP (#4).

Generation (``generate``) stays host-driven as in JAX: one static-shape
decoder step per position over the whole [B, ctx] token buffer (no KV
cache), the logits read at ``pos - 1``, top-k, top-p (HF semantics) or
grouped beam search on the host in numpy, sampling from
``np.random.default_rng(seed)`` exactly as JAX draws, so that the same
logits give the same tokens.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from xtagclip_tpu_torch.models.clip import l2_normalize
from xtagclip_tpu_torch.models.layers import LayerNorm, ResidualAttentionBlock
from xtagclip_tpu_torch.models.text import build_causal_mask

SOT_ID = 49406
EOT_ID = 49407


class _VocabLogits(torch.autograd.Function):
    """x [N, D] @ w [D, V] with an fp32 result, as JAX's
    ``jnp.matmul(..., preferred_element_type=jnp.float32)``: for bf16 CUDA
    operands a tensor-core product with fp32 accumulation (no bf16
    rounding of the logits), else an fp32 product. The backward takes the
    fp32 cotangent: for bf16 CUDA operands it is rounded to bf16 for two
    tensor-core products with fp32 accumulation; else fp32 products."""

    @staticmethod
    def _mm(a, b):
        if a.is_cuda and a.dtype == torch.bfloat16 == b.dtype:
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _VocabLogits._mm(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype) if x.is_cuda else g
        dx = _VocabLogits._mm(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = _VocabLogits._mm(x.t(), g) if ctx.needs_input_grad[1] else None
        return (None if dx is None else dx.to(x.dtype),
                None if dw is None else dw.to(w.dtype))


class MultimodalTransformer(nn.Module):
    """The decoder (JAX coca.py:30-73): ``resblocks.{i}`` causal
    self-attention blocks interleaved with ``cross_attn.{i}`` blocks over
    the image embeddings, under ``build_causal_mask(context_length)[:L,
    :L]``, then ``ln_final`` and a bias-free ``text_projection`` [width,
    vocab] in fp32."""

    def __init__(self, width: int = 512, layers: int = 12, heads: int = 8,
                 context_length: int = 76, mlp_ratio: float = 4.0,
                 ls_init_value=None, output_dim: int = 49408,
                 act: str = "gelu", kv_width=None):
        super().__init__()
        self.width = width
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_ratio, act,
                                   ls_init_value=ls_init_value)
            for _ in range(layers))
        self.cross_attn = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_ratio, act,
                                   ls_init_value=ls_init_value,
                                   is_cross_attention=True,
                                   kv_width=kv_width)
            for _ in range(layers))
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, output_dim))
        self.register_buffer("attn_mask", build_causal_mask(context_length),
                             persistent=False)

    def init_params(self, generator):
        nn.init.normal_(self.text_projection, 0.0, self.width**-0.5,
                        generator=generator)

    def forward(self, image_embs, text_embs, row=None):
        """[B, Li, E] image embeddings, [B, L, width] token embeddings ->
        fp32 logits [B, L, vocab], or [B, vocab] of position ``row`` only
        (generation's step: the same numbers, one row projected)."""
        seq_len = text_embs.shape[1]
        mask = self.attn_mask[:seq_len, :seq_len].contiguous()
        x = text_embs.contiguous()  # the kernels read dense rows
        for blk, cross in zip(self.resblocks, self.cross_attn):
            x = blk(x, attn_mask=mask)
            x = cross(x, kv=image_embs)
        x = self.ln_final(x)
        if row is not None:
            x = x[:, row]
        w = self.text_projection.to(x.dtype)
        return _VocabLogits.apply(x.reshape(-1, x.shape[-1]), w).reshape(
            *x.shape[:-1], w.shape[1])


class CoCa(nn.Module):
    """The CoCa model (JAX coca.py:76-150). ``encode_image`` and
    ``encode_text`` return (features, tokens) as the port's CLIP does, so
    the eval loops (train/evaluate.py, train/zero_shot.py) read them
    alike; ``forward`` returns JAX's output dict."""

    def __init__(self, visual: nn.Module, text: nn.Module,
                 text_decoder: nn.Module, embed_dim: int,
                 init_logit_scale: float = math.log(1 / 0.07),
                 init_logit_bias=None, pad_id: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.visual = visual
        self.text = text
        self.text_decoder = text_decoder
        self.embed_dim = embed_dim
        self.init_logit_scale = init_logit_scale
        self.init_logit_bias = init_logit_bias
        self.pad_id = pad_id
        self.dtype = dtype
        self.logit_scale = nn.Parameter(torch.empty(()))
        self.logit_bias = (nn.Parameter(torch.empty(()))
                           if init_logit_bias is not None else None)

    def init_params(self, generator):
        nn.init.constant_(self.logit_scale, self.init_logit_scale)
        if self.logit_bias is not None:
            nn.init.constant_(self.logit_bias, self.init_logit_bias)

    def encode_image(self, image, normalize: bool = True, generator=None):
        latent, tokens = self.visual(image, generator)
        return (l2_normalize(latent) if normalize else latent), tokens

    def encode_text(self, text, normalize: bool = True, generator=None):
        latent, tokens = self.text(text, generator)
        return (l2_normalize(latent) if normalize else latent), tokens

    def forward(self, image, text=None, image_latent=None, image_embs=None,
                output_labels: bool = True, generator=None,
                logits_row=None):
        """JAX's ``__call__``: with ``output_labels`` the labels are
        ``text[:, 1:]`` and the decoder reads the text tokens but the last
        (teacher forcing). ``generator`` (training) turns the vision
        tower's patch dropout on. ``logits_row`` projects one position
        only (``generate``'s step)."""
        if image_latent is None or image_embs is None:
            image_latent, image_embs = self.encode_image(image,
                                                         generator=generator)
        if text is None:
            return {"image_features": image_latent, "image_embs": image_embs}
        text_latent, token_embs = self.encode_text(text, generator=generator)
        if output_labels:
            token_embs = token_embs[:, :-1]
        out = {"image_features": image_latent, "text_features": text_latent,
               "logits": self.text_decoder(image_embs, token_embs,
                                           logits_row),
               "logit_scale": self.logit_scale.exp()}
        if output_labels:
            out["labels"] = text[:, 1:]
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        return out


# -- generation (JAX coca.py:153-480) ----------------------------------------

def _softmax(x):
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def _logsumexp(x):
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


def top_p_filter(logits: np.ndarray, top_p: float) -> np.ndarray:
    """HF TopPLogitsWarper semantics (JAX coca.py:252-268): keep the
    smallest descending-probability set whose cumulative probability
    reaches ``top_p`` (the crossing token survives, and always the top
    token); the rest become -inf."""
    sorted_idx = np.argsort(-logits, axis=1)
    sorted_logits = np.take_along_axis(logits, sorted_idx, axis=1)
    probs = _softmax(sorted_logits)
    cum = np.cumsum(probs, axis=1)
    cutoff = (cum - probs) >= top_p
    cutoff[:, 0] = False
    mask = np.zeros_like(logits, bool)
    np.put_along_axis(mask, sorted_idx, cutoff, axis=1)
    return np.where(mask, -np.inf, logits)


def _make_step(model):
    """(image_embs, tokens [B, ctx] int32 numpy, pos) -> fp32 numpy
    logits [B, vocab] of position ``pos - 1``: one decoder step over the
    whole buffer (JAX coca.py:231-244)."""
    device = model.logit_scale.device
    latent = torch.zeros((1,), device=device)

    @torch.inference_mode()
    def step(image_embs, tokens, pos):
        out = model(None, torch.from_numpy(tokens).long().to(device),
                    image_latent=latent, image_embs=image_embs,
                    output_labels=False, logits_row=pos - 1)
        return out["logits"].float().cpu().numpy()

    return step


def generate(model, image, seq_len: int = 30, max_seq_len: int = 77,
             temperature: float = 1.0, generation_type: str = "top_k",
             top_p: float = 0.1, top_k: int = 1, pad_token_id: int = 0,
             eos_token_id: int = EOT_ID, sot_token_id: int = SOT_ID,
             num_beams: int = 6, num_beam_groups: int = 3,
             min_seq_len: int = 5, repetition_penalty: float = 1.0,
             diversity_penalty: float = 0.0, seed: int = 0,
             fixed_output_length: bool = False) -> np.ndarray:
    """Autoregressive captions of normalized [B, H, W, 3] ``image`` on the
    model's device; int32 numpy [B, <= seq_len] (JAX's ``generate``, its
    defaults and its draws)."""
    rng = np.random.default_rng(seed)
    device = model.logit_scale.device
    with torch.inference_mode():
        image_embs = model.encode_image(torch.as_tensor(image).to(device))[1]
    b = image_embs.shape[0]
    ctx = min(max_seq_len, seq_len)
    step = _make_step(model)

    if generation_type == "beam_search":
        return _beam_search(
            step, image_embs, b, ctx, num_beams, num_beam_groups,
            diversity_penalty, sot_token_id, eos_token_id, pad_token_id,
            min_seq_len, fixed_output_length, seq_len)

    tokens = np.full((b, ctx), pad_token_id, np.int32)
    tokens[:, 0] = sot_token_id
    finished = np.zeros(b, bool)
    for pos in range(1, ctx):
        logits = step(image_embs, tokens, pos) / max(temperature, 1e-6)
        if repetition_penalty != 1.0:
            for i in range(b):
                seen = tokens[i, :pos]
                logits[i, seen] = np.where(
                    logits[i, seen] > 0,
                    logits[i, seen] / repetition_penalty,
                    logits[i, seen] * repetition_penalty)
        if pos < min_seq_len:
            logits[:, eos_token_id] = -np.inf
        if generation_type == "top_k":
            kth = np.sort(logits, axis=1)[:, -top_k][:, None]
            logits = np.where(logits < kth, -np.inf, logits)
        elif generation_type == "top_p":
            logits = top_p_filter(logits, top_p)
        else:
            raise ValueError(generation_type)
        probs = _softmax(logits)
        nxt = np.array([rng.choice(probs.shape[1], p=probs[i])
                        for i in range(b)], np.int32)
        nxt = np.where(finished, pad_token_id, nxt)
        tokens[:, pos] = nxt
        finished |= nxt == eos_token_id
        if finished.all():
            tokens = tokens[:, :pos + 1]
            break
    if fixed_output_length and tokens.shape[1] < seq_len:
        pad = np.full((b, seq_len - tokens.shape[1]), pad_token_id, np.int32)
        tokens = np.concatenate([tokens, pad], axis=1)
    return tokens


def _beam_search(step, image_embs, b, ctx, num_beams, num_beam_groups,
                 diversity_penalty, sot, eos, pad, min_len,
                 fixed_output_length, seq_len):
    """Grouped (diverse) beam search with HF BeamSearchScorer semantics
    (JAX coca.py:271-480): ``num_beam_groups`` sub-searches share one
    decoder step per position over all B * num_beams rows; groups pick in
    turn, so that a later group can pay the Hamming ``diversity_penalty``
    for an earlier group's tokens; length_penalty 1.0, early_stopping
    False, one hypothesis returned per sample."""
    if num_beams % num_beam_groups != 0:
        raise ValueError(
            f"num_beams ({num_beams}) must be divisible by num_beam_groups "
            f"({num_beam_groups})")
    gsz = num_beams // num_beam_groups
    eb = image_embs.repeat_interleave(num_beams, dim=0)  # [B*K, ...]
    tokens = np.full((b * num_beams, ctx), pad, np.int32)
    tokens[:, 0] = sot
    scores = np.full((b, num_beams), -1e9, np.float32)
    scores[:, ::gsz] = 0.0  # one live beam per group at t = 0
    # finished hypotheses per (sample, group): (normalized score, seq[ctx])
    hyps = [[[] for _ in range(num_beam_groups)] for _ in range(b)]
    done = np.zeros((b, num_beam_groups), bool)
    pos = 0

    def group_done(i, g, best_running, cur_len):
        if len(hyps[i][g]) < gsz:
            return False
        worst = min(h[0] for h in hyps[i][g])
        return worst >= best_running / cur_len

    for pos in range(1, ctx):
        logits = step(eb, tokens, pos)
        logp = (logits - _logsumexp(logits)).astype(np.float64)
        if pos < min_len:
            logp[:, eos] = -np.inf
        v = logp.shape[1]
        logp = logp.reshape(b, num_beams, v)
        tok3 = tokens.reshape(b, num_beams, ctx)
        new_tok3 = tok3.copy()
        current_tokens = np.full((b, num_beams), pad, np.int32)

        for g in range(num_beam_groups):
            s, e = g * gsz, (g + 1) * gsz
            glogp = logp[:, s:e]
            if diversity_penalty > 0.0 and g > 0:
                glogp = glogp.copy()
                for i in range(b):
                    freq = np.bincount(current_tokens[i, :s], minlength=v)
                    glogp[i] -= diversity_penalty * freq[None, :]
            cand = scores[:, s:e, None].astype(np.float64) + glogp
            flat = cand.reshape(b, gsz * v)
            k2 = min(2 * gsz, flat.shape[1])
            part = np.argpartition(-flat, k2 - 1, axis=1)[:, :k2]

            for i in range(b):
                if done[i, g]:
                    continue
                order = part[i][np.argsort(-flat[i, part[i]])]
                new_rows = np.empty((gsz, ctx), np.int32)
                new_sc = np.full(gsz, -1e9, np.float64)
                kept = 0
                for rank, t in enumerate(order):
                    beam, tok_id = divmod(int(t), v)
                    sc = float(flat[i, t])
                    if tok_id == eos:
                        # candidates ranked past the group size never
                        # become hypotheses (HF)
                        if rank < gsz:
                            seq = tok3[i, s + beam].copy()
                            seq[pos] = eos
                            # normalized by the full length with SOT
                            hyps[i][g].append((sc / (pos + 1), seq))
                            if len(hyps[i][g]) > gsz:  # prune the worst
                                hyps[i][g].remove(min(hyps[i][g],
                                                      key=lambda h: h[0]))
                        continue
                    new_rows[kept] = tok3[i, s + beam]
                    new_rows[kept, pos] = tok_id
                    new_sc[kept] = sc
                    kept += 1
                    if kept == gsz:
                        break
                new_tok3[i, s:e] = new_rows
                scores[i, s:e] = new_sc
                current_tokens[i, s:e] = new_rows[:, pos]
                if group_done(i, g, float(new_sc.max()), pos + 1):
                    done[i, g] = True

        tokens = new_tok3.reshape(b * num_beams, ctx)
        if done.all():
            break

    # flush the running beams of unfinished groups as hypotheses
    tok3 = tokens.reshape(b, num_beams, ctx)
    final_len = min(pos + 1, ctx)
    out = np.full((b, final_len), pad, np.int32)
    for i in range(b):
        for g in range(num_beam_groups):
            if not done[i, g]:
                s = g * gsz
                for k in range(gsz):
                    if scores[i, s + k] > -1e8:
                        hyps[i][g].append(
                            (float(scores[i, s + k]) / (pos + 1),
                             tok3[i, s + k].copy()))
        best = max((h for g in range(num_beam_groups) for h in hyps[i][g]),
                   key=lambda h: h[0])
        out[i] = best[1][:final_len]
    if fixed_output_length and out.shape[1] < seq_len:
        out = np.concatenate(
            [out, np.full((b, seq_len - out.shape[1]), pad, np.int32)],
            axis=1)
    return out
