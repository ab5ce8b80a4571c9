"""Tower config dataclasses (port of xtagclip_tpu/models/config.py;
reference model.py:31-89 field sets).

The factory reads plain dicts (the model_configs/*.json schema); these
dataclasses are the typed surface for writing them:
``asdict(CLIPVisionCfg(...))`` is a valid ``vision_cfg`` (None-valued
fields fall back to the factory's defaults, as there).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional, Tuple, Union


@dataclass
class CLIPVisionCfg:
    layers: Union[Tuple[int, int, int, int], int] = 12
    width: int = 768
    head_width: int = 64
    mlp_ratio: float = 4.0
    patch_size: int = 16
    image_size: Union[Tuple[int, int], int] = 224

    ls_init_value: Optional[float] = None
    patch_dropout: float = 0.0
    attentional_pool: bool = False
    attn_pooler_queries: int = 256
    attn_pooler_heads: int = 8
    no_ln_pre: bool = False
    pos_embed_type: str = "learnable"
    final_ln_after_pool: bool = False
    pool_type: str = "tok"
    # the cls-free GAP tower; from-scratch recipes only, changes numerics
    # vs the reference
    no_class_token: bool = False
    output_tokens: bool = True  # XTag default (reference model.py:538 flip)
    act_kwargs: Optional[dict] = None
    norm_kwargs: Optional[dict] = None

    # learnable-token injection (folded from the reference's others/ copy)
    n_learnable_tokens: int = 0
    insert_position: int = 1

    timm_model_name: Optional[str] = None
    timm_model_pretrained: bool = False
    timm_pool: str = "avg"
    timm_proj: str = "linear"
    timm_proj_bias: bool = False
    timm_drop: float = 0.0
    timm_drop_path: Optional[float] = None

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class CLIPTextCfg:
    context_length: int = 77
    vocab_size: int = 49408
    hf_tokenizer_name: Optional[str] = None
    tokenizer_kwargs: Optional[dict] = None

    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    ls_init_value: Optional[float] = None
    embed_cls: bool = False
    pad_id: int = 0
    no_causal_mask: bool = False
    final_ln_after_pool: bool = False
    pool_type: str = "argmax"
    proj_bias: bool = False
    proj_type: str = "linear"
    output_tokens: bool = False
    act_kwargs: Optional[dict] = None
    norm_kwargs: Optional[dict] = None

    hf_model_name: Optional[str] = None
    hf_model_pretrained: bool = True
    hf_proj_type: str = "mlp"
    hf_pooler_type: str = "mean_pooler"

    def to_dict(self) -> dict:
        return asdict(self)
