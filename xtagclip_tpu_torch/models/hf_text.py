"""HF-style text tower: a BERT, T5 or M2M100 trunk + pooler + projection;
port of xtagclip_tpu/models/hf_text.py.

``pooler_type`` is one of ``mean_pooler`` (masked mean), ``max_pooler``
(masked max), ``cls_last_hidden_state_pooler`` (token 0) and ``cls_pooler``
(BERT's tanh pooler; token 0 of a T5 or M2M100 trunk, which has no pooling
head); ``proj_type`` ``linear`` (no bias) or ``mlp`` (d -> (d + out) // 2
-> out, exact gelu, no biases). Returns (projected, tokens): with a cls
pooler the tokens are ``seq[:, 1:]``, unprojected (the trunk's width), as
JAX returns them (hf_text.py:233-235).

``resolve_hf_config`` reads ``config.json`` at the model path or at
``~/.cache/huggingface/<path>`` only (not in a hub cache's
``snapshots/``, which the tokenizer searches), else name-keyed presets,
BERT-base by default (hf_text.py:137-179). ``detect_family`` routes the
bert / roberta / xlm-roberta names to models/bert.py, t5 / mt5 to
models/t5.py (``mt5-base``, ``mt5-xl``) and nllb / m2m100 to
models/m2m100.py (the two distilled NLLB-200 presets), as JAX's does.
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

from xtagclip_tpu_torch.models.bert import BertModel
from xtagclip_tpu_torch.models.layers import Dense, gelu_exact
from xtagclip_tpu_torch.models.m2m100 import M2M100Encoder
from xtagclip_tpu_torch.models.t5 import T5EncoderStack

DEFAULT_BERT_CFG = dict(
    vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12,
    intermediate_size=3072, max_position_embeddings=512,
)

# name-keyed shape presets for known hub models (hf_text.py:39-66)
_KNOWN_HF_SHAPES = {
    "roberta-base": dict(vocab_size=50265, max_position_embeddings=514),
    "roberta-large": dict(vocab_size=50265, hidden_size=1024, num_layers=24,
                          num_heads=16, intermediate_size=4096,
                          max_position_embeddings=514),
    "xlm-roberta-base": dict(vocab_size=250002, max_position_embeddings=514),
    "xlm-roberta-large": dict(vocab_size=250002, hidden_size=1024,
                              num_layers=24, num_heads=16,
                              intermediate_size=4096,
                              max_position_embeddings=514),
    # T5 family (family="t5")
    "mt5-base": dict(vocab_size=250112, d_model=768, num_layers=12,
                     num_heads=12, d_kv=64, d_ff=2048),
    "mt5-xl": dict(vocab_size=250112, d_model=2048, num_layers=24,
                   num_heads=32, d_kv=64, d_ff=5120),
    # M2M100/NLLB family (family="m2m100")
    "nllb-200-distilled-600m": dict(vocab_size=256206, d_model=1024,
                                    num_layers=12, num_heads=16,
                                    ffn_dim=4096,
                                    max_position_embeddings=1024),
    "nllb-200-distilled-1.3b": dict(vocab_size=256206, d_model=1024,
                                    num_layers=24, num_heads=16,
                                    ffn_dim=8192,
                                    max_position_embeddings=1024),
}

# the family defaults under a preset (hf_text.py:197-212)
_FAMILY_DEFAULTS = {
    "t5": dict(vocab_size=250112, d_model=768, num_layers=12, num_heads=12,
               d_kv=64, d_ff=2048, pad_token_id=0),
    "m2m100": dict(vocab_size=256206, d_model=1024, num_layers=12,
                   num_heads=16, ffn_dim=4096, max_position_embeddings=1024,
                   pad_token_id=1),
}

POOLERS = ("mean_pooler", "max_pooler", "cls_last_hidden_state_pooler",
           "cls_pooler")


def _is_roberta(name: str) -> bool:
    return "roberta" in name.lower()


def detect_family(model_name: str) -> str:
    """The trunk family from the model name (hf_text.py:73-85)."""
    s = model_name.lower()
    if "mt5" in s or s.endswith("t5") or "/t5" in s or s.startswith("t5-"):
        return "t5"
    if "nllb" in s or "m2m" in s:
        return "m2m100"
    if "bert" in s or "roberta" in s:  # covers PubMedBERT/BiomedBERT/BiomedNLP
        return "bert"
    raise NotImplementedError(
        f"HF text tower {model_name!r}: unknown architecture family "
        f"(supported: bert/roberta/xlm-roberta, mt5/t5, nllb/m2m100). "
        f"Refusing to silently default to BERT shapes.")


def _cfg_from_local_json(c: dict, path: str) -> dict:
    """A local HF config.json -> trunk kwargs + family (hf_text.py:88-134)."""
    model_type = c.get("model_type") or detect_family(path)
    if model_type in ("t5", "mt5"):
        return dict(
            family="t5",
            vocab_size=c.get("vocab_size", 250112),
            d_model=c.get("d_model", 768),
            num_layers=c.get("num_layers", 12),
            num_heads=c.get("num_heads", 12),
            d_kv=c.get("d_kv", 64),
            d_ff=c.get("d_ff", 2048),
            num_buckets=c.get("relative_attention_num_buckets", 32),
            max_distance=c.get("relative_attention_max_distance", 128),
            pad_token_id=c.get("pad_token_id", 0),
        )
    if model_type == "m2m_100":
        return dict(
            family="m2m100",
            vocab_size=c.get("vocab_size", 256206),
            d_model=c.get("d_model", 1024),
            num_layers=c.get("encoder_layers", 12),
            num_heads=c.get("encoder_attention_heads", 16),
            ffn_dim=c.get("encoder_ffn_dim", 4096),
            max_position_embeddings=c.get("max_position_embeddings", 1024),
            scale_embedding=c.get("scale_embedding", True),
            pad_token_id=c.get("pad_token_id", 1),
        )
    if model_type in ("bert", "roberta", "xlm-roberta") or "bert" in path.lower():
        roberta = _is_roberta(c.get("model_type", path))
        return dict(
            family="bert",
            vocab_size=c.get("vocab_size", 30522),
            hidden_size=c.get("hidden_size", 768),
            num_layers=c.get("num_hidden_layers", 12),
            num_heads=c.get("num_attention_heads", 12),
            intermediate_size=c.get("intermediate_size", 3072),
            max_position_embeddings=c.get("max_position_embeddings", 512),
            pad_token_id=c.get("pad_token_id", 1 if roberta else 0),
            roberta_positions=roberta,
        )
    raise NotImplementedError(
        f"HF text tower config at {path}: unsupported model_type "
        f"{model_type!r}")


def resolve_hf_config(model_name: str) -> dict:
    """Trunk kwargs plus a ``family`` key, from a local config.json or the
    name-keyed presets (module doc). Never downloads."""
    path = model_name.replace("hf-hub:", "")
    for base in (path, os.path.expanduser(f"~/.cache/huggingface/{path}")):
        cfg_path = os.path.join(base, "config.json")
        if os.path.isfile(cfg_path):
            with open(cfg_path) as f:
                return _cfg_from_local_json(json.load(f), path)
    family = detect_family(path)
    short = path.split("/")[-1].lower()
    preset = next((dict(p) for key, p in _KNOWN_HF_SHAPES.items()
                   if short.startswith(key)), {})
    if family in _FAMILY_DEFAULTS:
        cfg = dict(_FAMILY_DEFAULTS[family], **preset)
        cfg["family"] = family
        return cfg
    cfg = dict(DEFAULT_BERT_CFG, **preset)
    if _is_roberta(path):
        cfg["pad_token_id"] = 1
        cfg["roberta_positions"] = True
    cfg["family"] = "bert"
    return cfg


class HFTextEncoder(nn.Module):
    def __init__(self, model_name: str, output_dim: int,
                 proj_type: str = "mlp", pooler_type: str = "mean_pooler",
                 pad_token_id: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if pooler_type not in POOLERS:
            raise ValueError(f"unknown pooler {pooler_type}")
        cfg = resolve_hf_config(model_name)
        family = cfg.pop("family")
        self.pad_token_id = cfg.pop("pad_token_id", pad_token_id)
        self.pooler_type = pooler_type
        self.proj_type = proj_type
        if family == "t5":
            self.transformer = T5EncoderStack(dtype=dtype, **cfg)
            d = cfg["d_model"]
        elif family == "m2m100":
            self.transformer = M2M100Encoder(pad_token_id=self.pad_token_id,
                                             dtype=dtype, **cfg)
            d = cfg["d_model"]
        else:
            self.transformer = BertModel(
                add_pooling_layer=pooler_type == "cls_pooler",
                pad_token_id=self.pad_token_id, dtype=dtype, **cfg)
            d = cfg.get("hidden_size", DEFAULT_BERT_CFG["hidden_size"])
        if proj_type == "linear":
            self.proj = Dense(d, output_dim, bias=False)
        elif proj_type == "mlp":
            hidden = (d + output_dim) // 2
            self.proj_fc1 = Dense(d, hidden, bias=False)
            self.proj_fc2 = Dense(hidden, output_dim, bias=False)
        elif proj_type not in (None, "none"):
            raise ValueError(f"unknown proj {proj_type}")

    def forward(self, input_ids, generator=None):
        """[B, L] ids -> (projected [B, E], tokens). ``generator``
        (training) turns the trunk's dropout on."""
        attn_mask = (input_ids != self.pad_token_id).long()
        seq = self.transformer(input_ids, attention_mask=attn_mask,
                               generator=generator)
        seq, hf_pooled = seq if isinstance(seq, tuple) else (seq, None)
        if self.pooler_type == "mean_pooler":
            m = attn_mask[..., None].to(seq.dtype)
            pooled = (seq * m).sum(dim=1) / m.sum(dim=1).clamp_min(1)
            tokens = seq
        elif self.pooler_type == "max_pooler":
            m = attn_mask[..., None].bool()
            pooled = seq.masked_fill(~m, float("-inf")).amax(dim=1)
            tokens = seq
        elif self.pooler_type == "cls_last_hidden_state_pooler":
            pooled, tokens = seq[:, 0], seq[:, 1:]
        else:  # cls_pooler: BERT's tanh pooler, else token 0
            pooled = hf_pooled if hf_pooled is not None else seq[:, 0]
            tokens = seq[:, 1:]
        if self.proj_type == "linear":
            pooled = self.proj(pooled)
        elif self.proj_type == "mlp":
            pooled = self.proj_fc2(gelu_exact(self.proj_fc1(pooled)))
        return pooled, tokens
