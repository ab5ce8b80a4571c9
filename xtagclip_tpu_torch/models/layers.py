"""Core transformer layers (port of xtagclip_tpu/models/layers.py).

Parameter names and layouts follow the flax modules so that the JAX
package's param tree loads name for name (convert/from_jax.py): a ``Dense``
keeps its ``kernel`` as [in, out] (flax layout, which is also the B operand
layout the CUDA GEMMs read) and ``LayerNorm`` has ``scale``/``bias``.

Compute dtype: parameters are fp32 masters (the JAX package's
``param_dtype``) and a module computes in the dtype of its input stream
(its ``dtype``): it casts its weights to that dtype at use, as flax's
``nn.Dense(dtype=...)`` does, and autograd carries each gradient back
into the fp32 parameter as the vjp of JAX's ``astype`` does. The biases
of the fused block halves stay fp32 (the kernels add them in fp32, as the
Pallas kernels do). For serving, ``factory.cast_for_compute`` casts the
weights once, and the casts at use become no-ops. LayerNorm always takes
its statistics in fp32 and casts the result back.

Dropout (``dropout``) is inverted dropout whose keep mask is drawn from an
explicit ``torch.Generator``; it is off where the generator is None, the
``deterministic=True`` of the JAX modules.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from xtagclip_tpu_torch.ops import flash_attn
from xtagclip_tpu_torch.ops import fused_attn_block as fab
from xtagclip_tpu_torch.ops import fused_mlp

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
        y = torch.matmul(x, self.kernel.to(x.dtype))
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


def dropout(x, rate: float, generator):
    """Inverted dropout (flax ``nn.Dropout``): each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate). The keep mask comes
    from ``generator`` (``F.dropout`` takes none); None turns dropout off."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def attention(q, k, v, num_heads: int, dropout_rate: float = 0.0,
              generator=None, mask=None):
    """Multi-head attention over [B, L, E] streams
    (``jax.nn.dot_product_attention``): fp32 scores times dh^-0.5, plus
    the additive [Lq, Lk] ``mask`` if one is given, fp32 softmax, dropout
    on the fp32 probabilities when a generator is given
    (layers.py:117-119), probabilities in the value dtype for P @ V."""
    b, lq, e = q.shape
    lk = k.shape[1]
    dh = e // num_heads

    def heads(t, length):
        return t.reshape(b, length, num_heads, dh).transpose(1, 2)

    qh, kh, vh = heads(q, lq), heads(k, lk), heads(v, lk)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * dh**-0.5
    if mask is not None:
        s = s + mask.float()
    p = dropout(torch.softmax(s, dim=-1), dropout_rate, generator)
    out = torch.matmul(p.to(vh.dtype), vh)
    return out.transpose(1, 2).reshape(b, lq, e).to(q.dtype)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention-style attention with a fused [E, 3E]
    ``in_proj`` and an ``out_proj``. The forward is the cross-attention of
    TQN and the tag head: the query and the shared key/value stream project
    through their own column slices (``_FusedQKVProj``, layers.py:181-214)
    into the plain ``attention`` (XLA's in JAX; Lq != Lk never reaches
    flash). ``self_attention`` is a residual block's self-attention off the
    fused half: one [E, 3E] product, then ``flash_attn``."""

    def __init__(self, width: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj = Dense(width, 3 * width)
        self.out_proj = Dense(width, width)

    def _proj(self, x, lo, hi):
        kernel = self.in_proj.kernel[:, lo:hi].to(x.dtype)
        return torch.matmul(x, kernel) + self.in_proj.bias[lo:hi].to(x.dtype)

    def forward(self, q, kv, generator=None):
        """q [B, Lq, E] attends to kv [B, Lk, E]."""
        e = q.shape[-1]
        qh = self._proj(q, 0, e)
        kh, vh = self._proj(kv, e, 3 * e).split(e, dim=-1)
        return self.out_proj(attention(qh, kh, vh, self.num_heads,
                                       self.dropout, generator))

    def self_attention(self, x, use_kernels: bool = True, mask=None):
        """out_proj(MHA(x, x, x)) over [B, L, E] without dropout, as JAX's
        non-fused block computes it (layers.py:204-206, :295-319): one
        [E, 3E] product plus the bias in x's dtype (two roundings in bf16,
        as flax's Dense), the attention core through
        ``flash_attn.flash_mha`` (its kernel, or with ``use_kernels`` off
        its plain version) where ``flash_attn.supported`` takes it, else
        through the plain ``attention`` with the additive ``mask`` (XLA's
        attention in JAX), then ``out_proj`` in x's dtype."""
        b, l, e = x.shape
        dh = e // self.num_heads
        qkv = self._proj(x, 0, 3 * e)
        if not flash_attn.supported(l, l, mask, dh):
            return self.out_proj(attention(*qkv.split(e, dim=-1),
                                           self.num_heads, mask=mask))
        q, k, v = (t.reshape(b, l, self.num_heads, dh)
                   for t in qkv.split(e, dim=-1))
        core = (flash_attn.flash_mha if use_kernels
                else flash_attn.reference_flash_mha)
        return self.out_proj(core(q, k, v).reshape(b, l, e))


class MLP(nn.Module):
    """A CLIP block MLP (c_fc -> act -> c_proj). The fused MLP half reads
    its parameters; off the fused half, the forward is ``fused_mlp``
    (JAX's MLP under ``XTAG_FUSED_MLP``, layers.py:409-425): its kernel,
    or with ``use_kernels`` off its plain version. The weight matrices are
    cast to x's dtype at use, the biases stay fp32."""

    def __init__(self, width: int, mlp_width: int, act: str = "gelu"):
        super().__init__()
        self.act = act
        self.c_fc = Dense(width, mlp_width)
        self.c_proj = Dense(mlp_width, width)

    def forward(self, x, use_kernels: bool = True):
        fn = fused_mlp.fused_mlp if use_kernels else \
            fused_mlp.reference_fused_mlp
        dt = x.dtype
        return fn(x, self.c_fc.kernel.to(dt), self.c_fc.bias,
                  self.c_proj.kernel.to(dt), self.c_proj.bias, self.act)


class ResidualAttentionBlock(nn.Module):
    """Pre-norm transformer block (layers.py:478-588), self-attention only.

    Two routes, chosen by the stream's shape alone:

    - the fused halves (layers.py:528-559), for every stream that
      ``fab.supported`` and ``fab.supported_mlp`` take (L <= 128, head dim
      64, D and the MLP width multiples of 64; the ViT-B-32 towers and the
      text tower): ``fab.fused_attn_half`` then ``fab.fused_mlp_half``;
    - the non-fused block (layers.py:560-588) for the rest, such as a
      cls-free GAP tower at L = 256: ``x = x + out_proj(attn(LN1(x)))``
      then ``x = x + MLP(LN2(x))``, with the adds in x's dtype, the
      attention core through ``flash_attn.flash_mha`` and the MLP through
      ``fused_mlp.fused_mlp`` (JAX's ``XTAG_FLASH_ATTN`` and
      ``XTAG_FUSED_MLP`` paths). A stream flash attention does not take (a
      mask, another head dim) runs the plain ``attention`` there; it has
      no kernel, so a bf16 one raises on the card.

    Inside a route, a bf16 stream with ``use_kernels`` on (the default;
    ``set_use_kernels``) runs the route's kernel wrappers: their CUDA
    kernels on the card, where a stream the kernels cannot take raises
    before anything runs, their plain versions on the CPU, through their
    autograd Functions when grad is on. Every other stream runs the plain
    versions, under autograd when grad is on: an fp32 stream (the JAX
    gates likewise keep fp32 off the kernels; there the bf16 rounding
    points are no-ops) and a bf16 stream with ``use_kernels`` off, the
    yardstick the chip smoke holds the kernels against. The fused halves
    take the weight matrices cast to the stream's dtype and the biases and
    LayerNorm parameters in fp32 (layers.py:540-543)."""

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
        self.mlp = MLP(width, int(width * mlp_ratio), act)

    def takes_fused_halves(self, shape, attn_mask=None) -> bool:
        """The route of a stream of this shape: the fused halves (True) or
        the non-fused block (False)."""
        mshape = None if attn_mask is None else tuple(attn_mask.shape)
        mlp_width = self.mlp.c_fc.kernel.shape[1]
        return (fab.supported(shape, self.heads, torch.bfloat16, mshape)
                and fab.supported_mlp(shape, mlp_width, self.act))

    def forward(self, x, attn_mask=None):
        kernels = self.use_kernels and x.dtype == torch.bfloat16
        if self.takes_fused_halves(x.shape, attn_mask):
            return self._fused_halves(x, attn_mask, kernels)
        if kernels and x.device.type != "cpu":
            self._check_kernels_take(x.shape, attn_mask)
        return self._non_fused(x, attn_mask, kernels)

    def _fused_halves(self, x, attn_mask, kernels):
        if kernels:
            attn_half, mlp_half = fab.fused_attn_half, fab.fused_mlp_half
        else:
            attn_half = fab.reference_attn_half
            mlp_half = fab.reference_mlp_half
        a, m, dt = self.attn, self.mlp, x.dtype
        x = attn_half(x, self.ln_1.scale, self.ln_1.bias,
                      a.in_proj.kernel.to(dt), a.in_proj.bias,
                      a.out_proj.kernel.to(dt), a.out_proj.bias,
                      attn_mask, self.heads, self.norm_eps)
        return mlp_half(x, self.ln_2.scale, self.ln_2.bias,
                        m.c_fc.kernel.to(dt), m.c_fc.bias,
                        m.c_proj.kernel.to(dt), m.c_proj.bias,
                        self.act, self.norm_eps)

    def _check_kernels_take(self, shape, attn_mask):
        """Raise if the non-fused route's kernels cannot take a stream:
        nothing falls back to a plain version on the card."""
        _, l, d = shape
        mlp_width = self.mlp.c_fc.kernel.shape[1]
        if not flash_attn.supported(l, l, attn_mask, d // self.heads):
            raise ValueError(
                f"no kernel for stream {tuple(shape)} with {self.heads} heads"
                f" and mask {None if attn_mask is None else tuple(attn_mask.shape)}"
                ": neither the fused attention half (L <= 128, head dim 64) "
                "nor flash attention (no mask, head dim 64 or 128) takes it")
        if not fused_mlp.supported(shape, mlp_width, self.act):
            raise ValueError(
                f"no kernel for MLP rows {tuple(shape)}, hidden width "
                f"{mlp_width}, act {self.act!r}")

    def _non_fused(self, x, attn_mask, kernels):
        x = x + self.attn.self_attention(self.ln_1(x), kernels, attn_mask)
        return x + self.mlp(self.ln_2(x), kernels)


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

