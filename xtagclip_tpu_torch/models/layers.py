"""Core transformer layers (port of xtagclip_tpu/models/layers.py).

Parameter names and layouts follow the flax modules so that the JAX
package's param tree loads name for name (convert/from_jax.py): a ``Dense``
keeps its ``kernel`` as [in, out] (flax layout, which is also the B operand
layout the CUDA GEMMs read) and ``LayerNorm`` has ``scale``/``bias``.

Compute dtype: the factory casts every matmul weight to the compute dtype
once at load (see factory.cast_for_compute); a module computes in the
dtype of its input stream. LayerNorm always takes its statistics in fp32
and casts the result back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from xtagclip_tpu_torch.ops import fused_attn_block as fab

# flax lecun_normal: truncated normal on [-2, 2] std, rescaled so the
# truncated distribution has stddev sqrt(1 / fan_in)
_TRUNC_STD = 0.87962566103423978


def gelu_exact(x):
    return F.gelu(x)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, output cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def init_params(self, generator):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale.float() + self.bias.float()
        return y.to(x.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x @ kernel + bias, kernel [in, out]."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def init_params(self, generator):
        std = (1.0 / self.kernel.shape[0]) ** 0.5 / _TRUNC_STD
        nn.init.trunc_normal_(self.kernel, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        y = torch.matmul(x, self.kernel)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Embed(nn.Module):
    """flax ``nn.Embed``: a [num, dim] table read by index."""

    def __init__(self, num: int, dim: int, init_std: float):
        super().__init__()
        self.init_std = init_std
        self.embedding = nn.Parameter(torch.empty(num, dim))

    def init_params(self, generator):
        nn.init.normal_(self.embedding, 0.0, self.init_std, generator=generator)

    def forward(self, ids):
        return self.embedding[ids]


def attention(q, k, v, num_heads: int):
    """Unmasked multi-head attention over [B, L, E] streams
    (``jax.nn.dot_product_attention``): fp32 scores times dh^-0.5, fp32
    softmax, probabilities in the value dtype for P @ V."""
    b, lq, e = q.shape
    lk = k.shape[1]
    dh = e // num_heads

    def heads(t, length):
        return t.reshape(b, length, num_heads, dh).transpose(1, 2)

    qh, kh, vh = heads(q, lq), heads(k, lk), heads(v, lk)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * dh**-0.5
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(vh.dtype), vh)
    return out.transpose(1, 2).reshape(b, lq, e).to(q.dtype)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention-style attention with a fused [E, 3E]
    ``in_proj`` and an ``out_proj``. The forward is the cross-attention of
    TQN: the query and the shared key/value stream project through their
    own column slices (``_FusedQKVProj``, layers.py:181-214). A residual
    block's self-attention reads the same parameters through the fused
    attention half."""

    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj = Dense(width, 3 * width)
        self.out_proj = Dense(width, width)

    def _proj(self, x, lo, hi):
        kernel = self.in_proj.kernel[:, lo:hi]
        return torch.matmul(x, kernel) + self.in_proj.bias[lo:hi].to(x.dtype)

    def forward(self, q, kv):
        """q [B, Lq, E] attends to kv [B, Lk, E]."""
        e = q.shape[-1]
        qh = self._proj(q, 0, e)
        kh, vh = self._proj(kv, e, 3 * e).split(e, dim=-1)
        return self.out_proj(attention(qh, kh, vh, self.num_heads))


class MLP(nn.Module):
    """The parameters of a CLIP block MLP (c_fc -> act -> c_proj), which
    the fused MLP half reads."""

    def __init__(self, width: int, mlp_width: int):
        super().__init__()
        self.c_fc = Dense(width, mlp_width)
        self.c_proj = Dense(mlp_width, width)


class ResidualAttentionBlock(nn.Module):
    """Pre-norm transformer block (layers.py:478-588), self-attention only.

    Dispatch (layers.py:520-559): a bf16 stream goes through the fused
    halves, ``fab.fused_attn_half`` then ``fab.fused_mlp_half``: their CUDA
    kernels on the card (a shape they cannot take raises), their plain
    versions on the CPU. Every other stream takes the plain versions
    ``fab.reference_attn_half`` / ``fab.reference_mlp_half``: an fp32
    stream (the JAX gate likewise keeps fp32 off the kernel; there the
    bf16 rounding points are no-ops), and a bf16 stream with
    ``use_kernels = False`` (set through ``set_use_kernels``), the
    yardstick the chip smoke holds the kernels against."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 act: str = "gelu", norm_eps: float = 1e-5,
                 ls_init_value=None):
        super().__init__()
        if ls_init_value is not None:
            raise NotImplementedError("LayerScale blocks are not ported yet")
        if act not in fab.ACTIVATIONS:
            raise ValueError(f"unknown activation {act!r}")
        self.heads = heads
        self.act = act
        self.norm_eps = norm_eps
        self.use_kernels = True
        self.ln_1 = LayerNorm(width, norm_eps)
        self.attn = MultiheadAttention(width, heads)
        self.ln_2 = LayerNorm(width, norm_eps)
        self.mlp = MLP(width, int(width * mlp_ratio))

    def forward(self, x, attn_mask=None):
        if self.use_kernels and x.dtype == torch.bfloat16:
            attn_half, mlp_half = fab.fused_attn_half, fab.fused_mlp_half
        else:
            attn_half = fab.reference_attn_half
            mlp_half = fab.reference_mlp_half
        a, m = self.attn, self.mlp
        x = attn_half(x, self.ln_1.scale, self.ln_1.bias,
                      a.in_proj.kernel, a.in_proj.bias,
                      a.out_proj.kernel, a.out_proj.bias,
                      attn_mask, self.heads, self.norm_eps)
        return mlp_half(x, self.ln_2.scale, self.ln_2.bias,
                        m.c_fc.kernel, m.c_fc.bias,
                        m.c_proj.kernel, m.c_proj.bias,
                        self.act, self.norm_eps)


def set_use_kernels(module: nn.Module, enabled: bool) -> None:
    """Route every block under ``module`` through the CUDA kernels
    (``True``, the default) or the plain versions (``False``)."""
    for m in module.modules():
        if isinstance(m, ResidualAttentionBlock):
            m.use_kernels = enabled


class Transformer(nn.Module):
    """Stack of residual attention blocks (unrolled)."""

    def __init__(self, width: int, layers: int, heads: int,
                 mlp_ratio: float = 4.0, act: str = "gelu",
                 norm_eps: float = 1e-5, ls_init_value=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_ratio, act, norm_eps,
                                   ls_init_value)
            for _ in range(layers))

    def forward(self, x, attn_mask=None):
        for blk in self.resblocks:
            x = blk(x, attn_mask=attn_mask)
        return x

