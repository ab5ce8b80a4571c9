"""TQN fusion head: a transformer decoder without self-attention
(port of xtagclip_tpu/models/tqn.py).

Queries cross-attend to the memory through pre-norm layers (4 heads, ffn
1024, relu), then decoder_norm -> MLP head ->1024->512->256->class_num.
Both the memory and the queries pass through ``decoder_norm`` before the
decoder (tqn.py:89-98), kept for weight parity.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from xtagclip_tpu_torch.models.layers import Dense, LayerNorm, MultiheadAttention


class TQNDecoderLayer(nn.Module):
    def __init__(self, d_model: int = 512, nhead: int = 4,
                 dim_feedforward: int = 1024):
        super().__init__()
        self.norm2 = LayerNorm(d_model)
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.norm3 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)

    def forward(self, tgt, memory):
        tgt = tgt + self.multihead_attn(self.norm2(tgt), memory)
        h = torch.relu(self.linear1(self.norm3(tgt)))
        return tgt + self.linear2(h)


class TQNModel(nn.Module):
    def __init__(self, embed_dim: int = 512, class_num: int = 1,
                 num_layers: int = 4, nhead: int = 4,
                 dim_feedforward: int = 1024):
        super().__init__()
        # unused in the forward; kept for checkpoint parity
        self.logit_scale = nn.Parameter(torch.empty(()))
        self.decoder_norm = LayerNorm(embed_dim)
        self.decoder_layers = nn.ModuleList(
            TQNDecoderLayer(embed_dim, nhead, dim_feedforward)
            for _ in range(num_layers))
        self.mlp_0 = Dense(embed_dim, 1024)
        self.mlp_1 = Dense(1024, 512)
        self.mlp_2 = Dense(512, 256)
        self.mlp_3 = Dense(256, class_num)

    def init_params(self, generator):
        nn.init.constant_(self.logit_scale, math.log(1 / 0.07))

    def forward(self, image_features, text_features):
        """image_features [B, P, D] memory; text_features [Q, D] or
        [B, Q, D] queries -> [B, Q, class_num] scores."""
        memory = self.decoder_norm(image_features)
        if text_features.dim() == 2:
            text_features = text_features.expand(
                image_features.shape[0], *text_features.shape)
        x = self.decoder_norm(text_features)
        for layer in self.decoder_layers:
            x = layer(x, memory)
        x = self.decoder_norm(x)
        h = torch.relu(self.mlp_0(x))
        h = torch.relu(self.mlp_1(h))
        h = torch.relu(self.mlp_2(h))
        return self.mlp_3(h)
