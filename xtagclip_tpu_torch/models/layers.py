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
``deterministic=True`` of the JAX modules. ``patch_dropout`` draws its
token scores from such a generator too.

Tensor parallelism (parallel/sharding.py ``shard_tensor_parallel``) sets
the roles of the leaf modules whose parameters it splits: a Dense with
``tp_role`` ``"row"`` holds a slice of its input rows and sums its fp32
product over the model group before its bias
(``tensor_parallel.out_projection``); an Embed with ``tp_rows`` holds
those vocabulary rows (``tensor_parallel.vocab_rows``); a LayerNorm with
``tp_role`` ``"split"`` normalizes a width split over the group
(``tensor_parallel.split_layer_norm``). A Dense split on its output
columns has no role: its block passes the input of each split region
(the attention's or the MLP's first products) through ``tp_input`` once,
``copy_to_model``, whose backward sums the region's input gradient over
the group in one all-reduce.

``Transformer(grad_checkpointing=True)`` is JAX's ``remat``
(layers.py:617-673): each block runs under
``torch.utils.checkpoint(use_reentrant=False)`` while grad is on, so only
its input is kept and the backward runs its forward again, through the
same autograd Functions and kernel launches. The blocks draw no random
numbers (JAX's are rate-0 throughout, layers.py:514-515), so the
recompute is the same computation on the same input and gives the same
bits; the global RNG state needs no saving (``preserve_rng_state=False``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from xtagclip_tpu_torch.core.mesh import data_size, model_rank, model_size
from xtagclip_tpu_torch.ops import flash_attn
from xtagclip_tpu_torch.ops import fused_attn_block as fab
from xtagclip_tpu_torch.ops import fused_mlp
from xtagclip_tpu_torch.parallel import tensor_parallel as tp
from xtagclip_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    copy_to_model,
)

# flax lecun_normal: truncated normal on [-2, 2] std, rescaled so the
# truncated distribution has stddev sqrt(1 / fan_in)
_TRUNC_STD = 0.87962566103423978


def gelu_exact(x):
    return F.gelu(x)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, output cast back to the input
    dtype (``tp_role``: module doc)."""

    tp_role = None

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def init_params(self, generator):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        if self.tp_role == "split":
            return tp.split_layer_norm(x, self.scale, self.bias, self.eps)
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale.float() + self.bias.float()
        return y.to(x.dtype)


def channels_last(fn, x):
    """``fn`` (a LayerNorm, a Dense chain) over the channels of an NCHW
    stream, as flax applies it to the last axis of NHWC; NCHW back."""
    return fn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x @ kernel + bias, kernel [in, out]
    (``tp_role``: module doc)."""

    tp_role = None

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
        if self.tp_role == "row":
            return tp.out_projection(x, self.kernel, self.bias)
        y = torch.matmul(x, self.kernel.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def local_heads(block: nn.Module, heads: int) -> int:
    """This model rank's count of the block's ``heads``: all of them, or,
    once parallel/sharding.py split the block, its share of whole heads
    (``tensor_split``'s: 6 heads over 4 ranks are 2, 2, 1, 1)."""
    n = block.tp_size
    return heads if n == 1 else heads // n + (block.tp_rank < heads % n)


def tp_input(block: nn.Module, x):
    """The input of a split region of ``block`` (module doc):
    ``copy_to_model(x)`` where parallel/sharding.py split the block, else
    ``x``."""
    return copy_to_model(x) if block.tp_size > 1 else x


class Embed(nn.Module):
    """flax ``nn.Embed``: a [num, dim] table read by index (``tp_rows``:
    module doc)."""

    tp_rows = None

    def __init__(self, num: int, dim: int, init_std: float):
        super().__init__()
        self.init_std = init_std
        self.embedding = nn.Parameter(torch.empty(num, dim))

    def init_params(self, generator):
        nn.init.normal_(self.embedding, 0.0, self.init_std, generator=generator)

    def forward(self, ids):
        if self.tp_rows is not None:
            return tp.vocab_rows(ids, self.embedding, *self.tp_rows)
        return self.embedding[ids]


class Conv2d(nn.Module):
    """flax ``nn.Conv`` over an NCHW stream (cuDNN's layout). The
    ``kernel`` is kept in torch's [out, in / groups, kh, kw] layout
    (convert/from_jax.py transposes flax's [kh, kw, in / groups, out]);
    lecun-normal init as flax's. ``padding`` is an int (symmetric, flax's
    ``[(p, p)] * 2``) or ``"SAME"`` (flax's default: any odd extra pixel
    goes after, as XLA pads it). ``groups`` is flax's
    ``feature_group_count`` (a depthwise conv has ``groups == in_ch``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding=0, bias: bool = False, groups: int = 1):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.kernel = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def init_params(self, generator):
        fan_in = self.kernel[0].numel()
        std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
        nn.init.trunc_normal_(self.kernel, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        pad = self.padding
        if pad == "SAME":
            k, s = self.kernel.shape[-1], self.stride
            pads = []
            for size in (x.shape[3], x.shape[2]):  # F.pad order: W, then H
                total = max((-(-size // s) - 1) * s + k - size, 0)
                pads += [total // 2, total - total // 2]
            x, pad = F.pad(x, pads), 0
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.kernel.to(x.dtype), bias, self.stride, pad,
                        1, self.groups)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    dim 1 of an NCHW stream; ``torch.nn.BatchNorm2d`` differs (below).

    With ``train`` it normalizes with the batch statistics, taken in fp32
    as flax takes them (mean and E[x^2] - mean^2, clamped at 0), and moves
    the running ones as flax does: ``mean = 0.9 mean + 0.1 batch_mean`` and
    ``var = 0.9 var + 0.1 batch_var`` with the *biased* batch variance,
    where torch's BatchNorm2d takes the unbiased one (n / (n - 1) more).
    Without ``train`` it uses the running statistics. They are buffers
    named as flax's ``batch_stats`` leaves (``mean``, ``var``), so they
    travel in ``state_dict`` and checkpoints. The output is in x's dtype.

    At a data-parallel size > 1 (core/mesh.py's data group) the batch
    statistics are those of every rank's batch: the sums of x and x^2
    and the count are all-reduced with their gradient, as JAX's one
    program over the global batch takes them, with or without
    ``--use-bn-sync`` (``sync`` records the flag, as
    JAX's ``bn_axis_name`` does; ROADMAP Queue 3)."""

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-5,
                 sync: bool = False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.sync = sync
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def init_params(self, generator):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x, train: bool = False):
        x32 = x.float()
        if train and data_size() > 1:
            n = torch.full((1,), x32.numel() // x32.shape[1],
                           dtype=torch.float32, device=x.device)
            sums = all_reduce_sum(torch.cat([
                x32.sum(dim=(0, 2, 3)), x32.square().sum(dim=(0, 2, 3)), n]))
            c = x32.shape[1]
            mean = sums[:c] / sums[-1]
            var = (sums[c:2 * c] / sums[-1] - mean.square()).clamp_min(0.0)
        elif train:
            mean = x32.mean(dim=(0, 2, 3))
            var = (x32.square().mean(dim=(0, 2, 3))
                   - mean.square()).clamp_min(0.0)
        if train:
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        y = (x32 - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias.float()[:, None, None]).to(x.dtype)


class LayerScale(nn.Module):
    """x * gamma, gamma [dim] initialized to ``init_value``
    (layers.py:83-96), in x's dtype."""

    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def init_params(self, generator):
        nn.init.constant_(self.gamma, self.init_value)

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


def patch_dropout(x, generator, prob: float, exclude_first_token: bool = True):
    """Keep a random subset of tokens of [B, N, D] (layers.py:709-727): the
    first token always (``exclude_first_token``, which the JAX tower always
    sets, cls or not), and of the rest max(1, int(n (1 - prob))) tokens
    picked by the top-k of standard normal scores from ``generator``, in
    top-k order (highest score first), as ``jax.lax.top_k`` orders them."""
    if prob <= 0.0:
        return x
    first, rest = (x[:, :1], x[:, 1:]) if exclude_first_token else (None, x)
    b, n, _ = rest.shape
    keep = max(1, int(n * (1.0 - prob)))
    scores = torch.randn((b, n), generator=generator, device=x.device)
    idx = scores.topk(keep, dim=1).indices
    kept = torch.gather(rest, 1, idx[..., None].expand(-1, -1, rest.shape[-1]))
    return kept if first is None else torch.cat([first, kept], dim=1)


def dropout(x, rate: float, generator, split=None):
    """Inverted dropout (flax ``nn.Dropout``): each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate). The keep mask comes
    from ``generator`` (``F.dropout`` takes none); None turns dropout off.
    ``split`` (dim, whole size): ``x`` is this model rank's slice of a
    tensor split over the model group on ``dim`` (its heads or hidden
    width); the mask is drawn at the whole size, as one process draws it,
    and this rank takes its slice, so that the ranks of a model group draw
    the same numbers and their generators stay in step."""
    if generator is None or rate == 0.0:
        return x
    shape = list(x.shape)
    if split is not None:
        shape[split[0]] = split[1]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - rate
    if split is not None and split[1] != x.shape[split[0]]:
        keep = keep.tensor_split(model_size(), split[0])[model_rank()]
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def attention(q, k, v, num_heads: int, dropout_rate: float = 0.0,
              generator=None, mask=None, whole_heads=None):
    """Multi-head attention over [B, L, E] streams
    (``jax.nn.dot_product_attention``): fp32 scores times dh^-0.5, plus
    the additive [Lq, Lk] ``mask`` if one is given, fp32 softmax, dropout
    on the fp32 probabilities when a generator is given
    (layers.py:117-119), probabilities in the value dtype for P @ V.
    ``whole_heads``: the streams hold this model rank's ``num_heads`` of
    that many heads (the dropout mask is drawn for all of them)."""
    b, lq, e = q.shape
    lk = k.shape[1]
    dh = e // num_heads

    def heads(t, length):
        return t.reshape(b, length, num_heads, dh).transpose(1, 2)

    qh, kh, vh = heads(q, lq), heads(k, lk), heads(v, lk)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * dh**-0.5
    if mask is not None:
        s = s + mask.float()
    p = dropout(torch.softmax(s, dim=-1), dropout_rate, generator,
                None if whole_heads is None else (1, whole_heads))
    out = torch.matmul(p.to(vh.dtype), vh)
    return out.transpose(1, 2).reshape(b, lq, e).to(q.dtype)


# the head dims JAX's fused attention half takes (fused_attn_block.py:262)
JAX_FUSED_HEAD_DIMS = (64, 80, 88, 104, 128)


def flash_takes(l: int, mask, dh: int) -> bool:
    """Whether a self-attention core of length ``l`` and head dim ``dh``
    under ``mask`` goes to flash attention (#6): ``flash_attn.supported``
    takes it and, with an [L, L] mask, JAX has a Pallas kernel for the
    head dim (``JAX_FUSED_HEAD_DIMS``, its fused attention half's); a
    masked core at any other head dim (ViTamin-XL's causal text at 72, a
    masked 256) is XLA's attention in JAX and the plain ``attention``
    here."""
    return flash_attn.supported(l, l, mask, dh) and (
        mask is None or dh in JAX_FUSED_HEAD_DIMS)


def self_attention_core(q, k, v, num_heads: int, use_kernels: bool,
                        mask=None):
    """The core of a self-attention over [B, L, E] streams without dropout,
    as JAX's ``fused_attention`` routes it (layers.py:127-170): through
    ``flash_attn.flash_mha`` with the additive ``mask`` (its kernel, or
    with ``use_kernels`` off its plain version ``reference_flash_mha``)
    where ``flash_takes`` the stream, else through the plain ``attention``
    with the mask (XLA's attention in JAX)."""
    b, l, e = q.shape
    dh = e // num_heads
    if not flash_takes(l, mask, dh):
        return attention(q, k, v, num_heads, mask=mask)
    core = (flash_attn.flash_mha if use_kernels
            else flash_attn.reference_flash_mha)
    heads = (t.reshape(b, l, num_heads, dh) for t in (q, k, v))
    return core(*heads, mask=mask).reshape(b, l, e)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention-style attention with a fused [E, 3E]
    ``in_proj`` and an ``out_proj``; with a key/value width ``kdim`` other
    than E, separate ``q_proj`` [E, E], ``k_proj`` and ``v_proj`` [kdim, E]
    instead of ``in_proj`` (JAX's ``MultiheadAttention``, layers.py:217-265;
    CoCa's attentional pooler). The forward is a cross-attention (TQN, the
    tag head, the pooler, CoCa's cross-attention blocks): the query and the
    shared key/value stream project through their own column slices
    (``_FusedQKVProj``, layers.py:181-214) into the plain ``attention``
    (XLA's in JAX; Lq != Lk never reaches flash). ``self_attention`` is a
    residual block's self-attention off the fused half: one [E, 3E]
    product, then ``flash_attn``."""

    def __init__(self, width: int, num_heads: int, dropout: float = 0.0,
                 kdim=None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.separate = kdim is not None and kdim != width
        if self.separate:
            self.q_proj = Dense(width, width)
            self.k_proj = Dense(kdim, width)
            self.v_proj = Dense(kdim, width)
        else:
            self.in_proj = Dense(width, 3 * width)
        self.out_proj = Dense(width, width)

    def _proj(self, x, lo, hi):
        kernel = self.in_proj.kernel[:, lo:hi].to(x.dtype)
        return torch.matmul(x, kernel) + self.in_proj.bias[lo:hi].to(x.dtype)

    def forward(self, q, kv, generator=None):
        """q [B, Lq, E] attends to kv [B, Lk, kdim]."""
        e = q.shape[-1]
        if self.separate:
            qh, kh, vh = self.q_proj(q), self.k_proj(kv), self.v_proj(kv)
        else:
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
        its plain version) where ``flash_takes`` the stream, else
        through the plain ``attention`` with the additive ``mask`` (XLA's
        attention in JAX), then ``out_proj`` in x's dtype."""
        e = x.shape[-1]
        qkv = self._proj(x, 0, 3 * e)
        return self.out_proj(self_attention_core(
            *qkv.split(e, dim=-1), self.num_heads, use_kernels, mask))


class AttentionalPooler(nn.Module):
    """Query-token attention pooling (JAX layers.py:684-705): ``n_queries``
    learned [d_model] queries, ``ln_q``'d, attend to the ``ln_k``'d
    [B, L, context_dim] stream through a ``MultiheadAttention`` whose
    key/value width is ``context_dim``. The core is the plain
    ``attention`` (Lq != Lk: XLA's in JAX); the products and LayerNorms
    run in the stream's dtype."""

    def __init__(self, d_model: int, context_dim: int, n_head: int = 8,
                 n_queries: int = 256):
        super().__init__()
        self.query = nn.Parameter(torch.empty(n_queries, d_model))
        self.ln_k = LayerNorm(context_dim)
        self.ln_q = LayerNorm(d_model)
        self.attn = MultiheadAttention(d_model, n_head, kdim=context_dim)

    def init_params(self, generator):
        nn.init.normal_(self.query, 0.0, 1.0, generator=generator)

    def forward(self, x):
        """[B, L, context_dim] -> [B, n_queries, d_model]."""
        x = self.ln_k(x)
        q = self.ln_q(self.query.to(x.dtype))
        return self.attn(q.expand(x.shape[0], -1, -1), x)


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
        return fn(x, self.c_fc.kernel.to(dt), self.c_fc.bias.float(),
                  self.c_proj.kernel.to(dt), self.c_proj.bias.float(),
                  self.act)


class ResidualAttentionBlock(nn.Module):
    """Pre-norm transformer block (layers.py:478-588).

    Three routes, chosen by the stream's shape and the mask's rank alone
    (``route``), never because a kernel failed:

    - ``"fused_halves"`` (layers.py:528-559), for every self-attention
      stream that ``fab.supported`` and ``fab.supported_mlp`` take (L <=
      128, head dim 64, D and the MLP width multiples of 64, no mask or an
      [L, L] one; the ViT-B-32 towers, the text towers, CoCa's causal
      decoder blocks): ``fab.fused_attn_half`` then ``fab.fused_mlp_half``;
    - ``"plain_core"``, for a cross-attention block (``is_cross_attention``:
      CoCa's decoder, whose key/value stream, the image embeddings, passes
      ``ln_1_kv`` first, layers.py:560-566) and for self-attention under a
      per-sample [B, 1, L, L] additive mask (CoCa's ``embed_cls`` text
      tower): JAX sends these cores to XLA (a 4-D mask fails ``fmask_ok``,
      layers.py:521-531; flash refuses masks and Lq != Lk), so the core is
      the plain ``attention``; ``x = x + out_proj(attn(LN1(x), ...))``,
      then the MLP half: ``fab.fused_mlp_half`` (#2, exactly
      ``x + MLP(LN2(x))``) where ``fab.supported_mlp`` takes the stream
      and there is no LayerScale, else ``x + MLP(LN2(x))`` through
      ``fused_mlp.fused_mlp`` (#4);
    - ``"non_fused"`` (layers.py:560-588) for the rest, such as a
      cls-free GAP tower at L = 256 or ViT-L/14 at L = 257:
      ``x = x + out_proj(attn(LN1(x)))`` then ``x = x + MLP(LN2(x))``,
      with the adds in x's dtype, the attention core through
      ``flash_attn.flash_mha`` and the MLP through ``fused_mlp.fused_mlp``
      (JAX's ``XTAG_FLASH_ATTN`` and ``XTAG_FUSED_MLP`` paths). Flash
      attention takes an [L, L] mask at the head dims JAX's fused half
      takes (``flash_takes``: a causal text tower at dh 80-128 or at L >
      128, a LayerScale causal block). A stream flash attention does not
      take runs the plain ``attention`` there; it has no kernel, so a
      bf16 one raises on the card, but for a masked one at a head dim
      JAX's fused half refuses too (``JAX_FUSED_HEAD_DIMS``), which XLA
      runs in JAX and the plain core here. A LayerScale block
      (``ls_init_value``; ``ls_1``/``ls_2.gamma`` scale the attention and
      MLP outputs before each residual add, layers.py:577-587) never
      takes the fused halves, as JAX keeps it off the fused kernels
      (:531).

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
    LayerNorm parameters in fp32 (layers.py:540-543): under ``pure_bf16``
    the biases are bf16 parameters, upcast at the call (exact).

    Tensor parallelism (``tp_size`` > 1, set by parallel/sharding.py
    ``shard_tensor_parallel``): the block holds ``local_heads`` of its
    heads (whole heads, uneven where ``tp_size`` does not divide them)
    and its slice of the MLP's hidden width (``mlp_pieces``: every rank's
    slice), and every route runs on them, with the model group's
    all-reduces in
    parallel/tensor_parallel.py. ``fused_halves``: the partial modes of
    #1 and #2, each followed by an fp32 model all-reduce and the bias and
    residual add (``tp.attn_half``, ``tp.mlp_half``); ``non_fused``:
    ``copy_to_model`` of LN1(x), the local [E, 3 E / N] product, #6 over
    the local heads, the local out-projection, ``reduce_from_model``, +
    bias + residual; then ``copy_to_model`` of LN2(x), #4's partial mode
    on the hidden slice, ``reduce_from_model``, + c_proj's bias;
    ``plain_core``: the plain attention over the local heads (CoCa's
    cross-attention and per-sample masks), then the MLP half as above.
    The route is chosen on the local shapes, the MLP half's on every
    rank's hidden slice so that a group takes one route, and on the card
    a stream no kernel takes at the local shape raises."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 act: str = "gelu", norm_eps: float = 1e-5,
                 ls_init_value=None, is_cross_attention: bool = False,
                 kv_width=None):
        super().__init__()
        if act not in fab.ACTIVATIONS:
            raise ValueError(f"unknown activation {act!r}")
        self.heads = heads
        self.act = act
        self.norm_eps = norm_eps
        self.use_kernels = True
        self.is_cross_attention = is_cross_attention
        self.ln_1 = LayerNorm(width, norm_eps)
        if is_cross_attention:
            self.ln_1_kv = LayerNorm(kv_width or width, norm_eps)
        self.attn = MultiheadAttention(
            width, heads, kdim=kv_width if is_cross_attention else None)
        self.ln_2 = LayerNorm(width, norm_eps)
        self.mlp = MLP(width, int(width * mlp_ratio), act)
        if ls_init_value is not None:
            self.ls_1 = LayerScale(width, ls_init_value)
            self.ls_2 = LayerScale(width, ls_init_value)
        self.layer_scale = ls_init_value is not None
        self.tp_size = 1
        self.local_heads = heads
        self.mlp_pieces = [self.mlp.c_fc.kernel.shape[1]]

    def route(self, shape, attn_mask=None) -> str:
        """The route of a stream of this shape under this mask (class
        doc): ``"fused_halves"``, ``"plain_core"`` or ``"non_fused"``."""
        if self.is_cross_attention or (attn_mask is not None
                                       and attn_mask.dim() == 4):
            return "plain_core"
        mshape = None if attn_mask is None else tuple(attn_mask.shape)
        if (not self.layer_scale
                and fab.supported(shape, self.heads, torch.bfloat16, mshape)
                and self._mlp_pieces_fused(shape)):
            return "fused_halves"
        return "non_fused"

    def _mlp_pieces_fused(self, shape) -> bool:
        """Whether #2 takes the MLP's hidden width, on every model rank's
        slice (``mlp_pieces``, uneven where the model size does not
        divide it), so that every rank of a group takes one route."""
        return all(fab.supported_mlp(shape, w, self.act)
                   for w in self.mlp_pieces)

    def _mlp_half_fused(self, shape) -> bool:
        """Whether the plain-core route's MLP half is #2 (else #4)."""
        return not self.layer_scale and self._mlp_pieces_fused(shape)

    def forward(self, x, attn_mask=None, kv=None):
        """``kv``: the key/value stream of a cross-attention block."""
        kernels = self.use_kernels and x.dtype == torch.bfloat16
        route = self.route(x.shape, attn_mask)
        if route == "fused_halves":
            return self._fused_halves(x, attn_mask, kernels)
        if kernels and x.device.type != "cpu":
            self._check_kernels_take(x.shape, attn_mask, route)
        if route == "plain_core":
            return self._plain_core(x, attn_mask, kv, kernels)
        return self._non_fused(x, attn_mask, kernels)

    def _halves(self, kernels):
        """(attention half, MLP half) of the fused route: the kernel
        wrappers, the plain versions, or, sharded, the tensor-parallel
        halves."""
        if self.tp_size > 1:
            return (functools.partial(tp.attn_half, kernels=kernels),
                    functools.partial(tp.mlp_half, kernels=kernels))
        if kernels:
            return fab.fused_attn_half, fab.fused_mlp_half
        return fab.reference_attn_half, fab.reference_mlp_half

    def _fused_halves(self, x, attn_mask, kernels):
        attn_half, mlp_half = self._halves(kernels)
        a, m, dt = self.attn, self.mlp, x.dtype
        x = attn_half(x, self.ln_1.scale.float(), self.ln_1.bias.float(),
                      a.in_proj.kernel.to(dt), a.in_proj.bias.float(),
                      a.out_proj.kernel.to(dt), a.out_proj.bias.float(),
                      attn_mask, self.local_heads, self.norm_eps)
        return self._mlp_half(x, mlp_half)

    def _mlp_half(self, x, mlp_half):
        m, dt = self.mlp, x.dtype
        return mlp_half(x, self.ln_2.scale.float(), self.ln_2.bias.float(),
                        m.c_fc.kernel.to(dt), m.c_fc.bias.float(),
                        m.c_proj.kernel.to(dt), m.c_proj.bias.float(),
                        self.act, self.norm_eps)

    def _check_kernels_take(self, shape, attn_mask, route):
        """Raise if the route's kernels cannot take a stream: nothing
        falls back to a plain version on the card. A masked stream whose
        head dim JAX's fused half refuses too (``JAX_FUSED_HEAD_DIMS``:
        ViTamin-XL's causal text at 72) has no TPU kernel there, so its
        core is the plain attention, as XLA's is in JAX."""
        _, l, d = shape
        mlp_width = self.mlp.c_fc.kernel.shape[1]
        dh = d // self.heads
        xla_core = attn_mask is not None and dh not in JAX_FUSED_HEAD_DIMS
        if route == "non_fused" and not xla_core and not \
                flash_attn.supported(l, l, attn_mask, dh):
            raise ValueError(
                f"no kernel for stream {tuple(shape)} with {self.heads} heads"
                f" and mask {None if attn_mask is None else tuple(attn_mask.shape)}"
                ": neither the fused attention half (L <= 128, head dim 64, "
                "no LayerScale) nor flash attention (no mask or [L, L], head "
                f"dim in {flash_attn.HEAD_DIMS}) takes it")
        if not (route == "plain_core" and self._mlp_half_fused(shape)) \
                and not fused_mlp.supported(shape, mlp_width, self.act):
            raise ValueError(
                f"no kernel for MLP rows {tuple(shape)}, hidden width "
                f"{mlp_width}, act {self.act!r}")

    def _plain_core(self, x, attn_mask, kv, kernels):
        h = self.ln_1(x)
        if self.tp_size > 1:
            a = self._attn_tp(h, attn_mask, kernels, kv)
        elif self.is_cross_attention:
            a = self.attn(h, self.ln_1_kv(kv))
        else:  # a 4-D mask: flash attention takes no mask
            a = self.attn.self_attention(h, kernels, attn_mask)
        x = x + (self.ls_1(a) if self.layer_scale else a)
        if not self._mlp_half_fused(x.shape):
            m = self._mlp(self.ln_2(x), kernels)
            return x + (self.ls_2(m) if self.layer_scale else m)
        return self._mlp_half(x, self._halves(kernels)[1])

    def _non_fused(self, x, attn_mask, kernels):
        h = self.ln_1(x)
        a = (self._attn_tp(h, attn_mask, kernels) if self.tp_size > 1
             else self.attn.self_attention(h, kernels, attn_mask))
        x = x + (self.ls_1(a) if self.layer_scale else a)
        m = self._mlp(self.ln_2(x), kernels)
        return x + (self.ls_2(m) if self.layer_scale else m)

    def _attn_tp(self, h, attn_mask, kernels, kv=None):
        """out_proj(MHA(h)) of a sharded block off the fused half (class
        doc): the local heads' projections of ``copy_to_model(h)``, the
        core over the local heads (#6 where it takes them, else the plain
        attention), then ``tp.out_projection``. ``kv`` is a
        cross-attention block's key/value stream, before ``ln_1_kv``."""
        a, h = self.attn, copy_to_model(h)
        if self.is_cross_attention:
            kvn = copy_to_model(self.ln_1_kv(kv))
            if a.separate:
                q, k, v = a.q_proj(h), a.k_proj(kvn), a.v_proj(kvn)
            else:
                el = a.in_proj.kernel.shape[1] // 3
                q = a._proj(h, 0, el)
                k, v = a._proj(kvn, el, 3 * el).split(el, dim=-1)
            o = attention(q, k, v, self.local_heads)
        else:
            el = a.in_proj.kernel.shape[1] // 3
            q, k, v = a._proj(h, 0, 3 * el).split(el, dim=-1)
            o = self_attention_core(q, k, v, self.local_heads, kernels,
                                    attn_mask)
        return tp.out_projection(o, a.out_proj.kernel, a.out_proj.bias)

    def _mlp(self, h, kernels):
        """MLP(h) off the fused half; sharded, #4's partial mode on the
        hidden slice of ``copy_to_model(h)`` (or its plain version), the
        model group's fp32 sum and c_proj's bias, rounded once."""
        if self.tp_size == 1:
            return self.mlp(h, kernels)
        m, dt = self.mlp, h.dtype
        fn = fused_mlp.fused_mlp if kernels else fused_mlp.reference_fused_mlp
        part = fn(copy_to_model(h), m.c_fc.kernel.to(dt), m.c_fc.bias.float(),
                  m.c_proj.kernel.to(dt), None, self.act, partial=True)
        return tp.finish_sum(part, m.c_proj.bias, dt)


def set_use_kernels(module: nn.Module, enabled: bool) -> None:
    """Route every block under ``module`` (each module with a
    ``use_kernels`` flag: the residual blocks, the zoo trunks' attention)
    through the CUDA kernels (``True``, the default) or the plain versions
    (``False``)."""
    for m in module.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = enabled


def set_grad_checkpointing(module: nn.Module, enabled: bool = True) -> None:
    """Turn per-block activation checkpointing on or off for every block
    stack under ``module`` (a ``Transformer``, JAX's ``remat``, and the
    timm trunk; module doc)."""
    for m in module.modules():
        if hasattr(m, "grad_checkpointing"):
            m.grad_checkpointing = enabled


def run_blocks(blocks, x, checkpointed: bool, *args):
    """x through ``blocks`` (each called as ``blk(x, *args)``), each under
    ``torch.utils.checkpoint`` while ``checkpointed`` and grad is on."""
    remat = checkpointed and torch.is_grad_enabled()
    for blk in blocks:
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                blk, x, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            x = blk(x, *args)
    return x


class Transformer(nn.Module):
    """Stack of residual attention blocks (unrolled); with
    ``grad_checkpointing`` each block is checkpointed while grad is on
    (module doc)."""

    def __init__(self, width: int, layers: int, heads: int,
                 mlp_ratio: float = 4.0, act: str = "gelu",
                 norm_eps: float = 1e-5, ls_init_value=None,
                 grad_checkpointing: bool = False):
        super().__init__()
        self.grad_checkpointing = grad_checkpointing
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_ratio, act, norm_eps,
                                   ls_init_value)
            for _ in range(layers))

    def forward(self, x, attn_mask=None):
        return run_blocks(self.resblocks, x, self.grad_checkpointing,
                          attn_mask)

