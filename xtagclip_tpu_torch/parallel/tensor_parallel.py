"""Tensor parallelism of the transformer block: the fused halves' autograd
Functions on a rank's shard, and the plain products beside them (ROADMAP
Queue 1 item 10; JAX gets the same step from GSPMD over the ``model`` axis
of its mesh, xtagclip_tpu/parallel/sharding.py:31-56).

A sharded ``ResidualAttentionBlock`` (parallel/sharding.py
``shard_tensor_parallel``) holds, on each of the N ranks of its model
group, whole heads (the q, k and v columns of H / N heads, and their rows
of the out-projection) and 1 / N of the MLP's hidden width (columns of
c_fc with its bias, rows of c_proj), in the Megatron split. Its LNs,
LayerScales and the two output biases are whole on every rank. Each half
of the block is then a sum over the ranks of one partial term per rank:

    y = x + bout + sum_r out_proj_r(MHA_r(LN1(x)))
    y = x + b2 + sum_r c_proj_r(act(c_fc_r(LN2(x))))

``attn_half`` and ``mlp_half`` run the hand-written kernels' partial modes
(ops/fused_attn_block.py: the kernels #1 and #2 at the local heads or
hidden slice, fp32 terms without bias and residual), sum the terms over
the model group in fp32 and add the bias and the residual with one
rounding, as the whole kernel's epilogue does; so a sharded forward
differs from the one-rank kernel only by the order of an fp32 sum. Their
backward runs #3's partial mode (the attention half) or the MLP half's
PyTorch backward in its partial mode, sums the LN backward's terms of dx,
dls and dlb over the model group (they are linear in the LN output's
cotangent), adds the residual cotangent once and rounds dx once; the
weight gradients of the shard stay local, and the output bias's gradient
(the cotangent's column sum) is whole on every rank. With ``kernels``
off (an fp32 stream, or the bf16 yardstick) the same sums run as plain
PyTorch under autograd, with ``copy_to_model`` / ``reduce_from_model``
(parallel/collectives.py) carrying the model all-reduces.
"""

from __future__ import annotations

import torch

from xtagclip_tpu_torch.ops import fused_attn_block as fab
from xtagclip_tpu_torch.ops.fused_mlp import _mm_f32
from xtagclip_tpu_torch.parallel.collectives import (
    copy_to_model,
    model_all_reduce,
    reduce_from_model,
)


def _replicated(*tensors):
    """``copy_to_model`` of each of the tensors whole on every rank that a
    partial term reads (x and the LN's parameters), so that their
    gradients sum over the model group."""
    return [copy_to_model(t) for t in tensors]


def _finish(x, part, bias):
    """x + (the summed partial terms + bias), in fp32, rounded once."""
    return (x.float() + (part + bias.float())).to(x.dtype)


class _AttnHalf(torch.autograd.Function):
    """The attention half of a sharded block on kernels #1 and #3 (module
    doc)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, mask,
                heads, eps):
        if x.device.type != "cpu":  # raise now, not in the backward
            fab._attn_launch_checks("fused_attn_half_bwd", x, heads, mask,
                                    fab.supported_bwd, partial=True)
        ctx.save_for_backward(x, ln_scale, ln_bias, wqkv, bqkv, wout, mask)
        ctx.heads, ctx.eps, ctx.bout_dtype = heads, eps, bout.dtype
        part = fab._attn_half_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wout,
                                  bout, mask, heads, eps, partial=True)
        part, = model_all_reduce(part)
        return _finish(x, part, bout)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, wqkv, bqkv, wout, mask = ctx.saved_tensors
        g = g.contiguous()
        dx, dqkv, dwout, dbout, dls, dlb = fab.fused_attn_half_bwd(
            x, g, ln_scale, ln_bias, wqkv, bqkv, wout, mask, ctx.heads,
            ctx.eps, partial=True)
        dx, dls, dlb = model_all_reduce(dx, dls, dlb)
        dx = (g.float() + dx).to(x.dtype)
        xn = fab._layer_norm_rounded(x.float(), ln_scale, ln_bias, ctx.eps,
                                     x.dtype).reshape(-1, x.shape[-1])
        dqkv2 = dqkv.reshape(-1, dqkv.shape[-1])
        with fab._full_fp32_matmul():  # fp32 accumulation, one rounding
            dwqkv = torch.matmul(xn.t(), dqkv2)
        dbqkv = dqkv2.float().sum(0)
        return (dx, dls.to(ln_scale.dtype), dlb.to(ln_bias.dtype),
                dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype),
                dwout.to(wout.dtype), dbout.to(ctx.bout_dtype),
                None, None, None)


class _MLPHalf(torch.autograd.Function):
    """The MLP half of a sharded block on kernel #2 and the MLP half's
    backward (module doc)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, act, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2)
        ctx.act, ctx.eps, ctx.b2_dtype = act, eps, b2.dtype
        part = fab._mlp_half_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, act,
                                 eps, partial=True)
        part, = model_all_reduce(part)
        return _finish(x, part, b2)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, w1, b1, w2 = ctx.saved_tensors
        dx, dls, dlb, dw1, db1, dw2, db2 = fab.mlp_half_bwd(
            x, g, ln_scale, ln_bias, w1, b1, w2, ctx.act, ctx.eps,
            partial=True)
        dx, dls, dlb = model_all_reduce(dx.float(), dls, dlb)
        dx = (g.float() + dx).to(x.dtype)
        return (dx, dls.to(ln_scale.dtype), dlb.to(ln_bias.dtype), dw1,
                db1.to(b1.dtype), dw2, db2.to(ctx.b2_dtype), None, None)


def attn_half(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, mask=None,
              num_heads: int = 8, eps: float = 1e-5, kernels: bool = True):
    """y = x + bout + the model group's sum of out_proj_r(MHA_r(LN(x)))
    over this rank's ``num_heads`` heads (wqkv [D, 3 Dl], bqkv [3 Dl],
    wout [Dl, D]; the rest whole, as ``fab.fused_attn_half`` takes them).
    ``kernels``: kernel #1's partial mode (its plain version on a CPU
    tensor) and ``_AttnHalf`` under grad; else the plain version under
    autograd (module doc)."""
    args = (x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, mask, num_heads,
            eps)
    if not kernels:
        part = fab.reference_attn_half(*_replicated(x, ln_scale, ln_bias),
                                       *args[3:], partial=True)
        return _finish(x, reduce_from_model(part), bout)
    fab.check_device("fused_attn_half", x)
    if fab._needs_grad(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout):
        return _AttnHalf.apply(*args)
    part, = model_all_reduce(fab._attn_half_fwd(*args, partial=True))
    return _finish(x, part, bout)


def mlp_half(x, ln_scale, ln_bias, w1, b1, w2, b2, act_name: str,
             eps: float = 1e-5, kernels: bool = True):
    """y = x + b2 + the model group's sum of c_proj_r(act(c_fc_r(LN(x))))
    over this rank's hidden slice (w1 [D, Hd / N], b1, w2 [Hd / N, D]),
    as ``attn_half`` does for the attention half (kernel #2)."""
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2, act_name, eps)
    if not kernels:
        part = fab.reference_mlp_half(*_replicated(x, ln_scale, ln_bias),
                                      *args[3:], partial=True)
        return _finish(x, reduce_from_model(part), b2)
    fab.check_device("fused_mlp_half", x)
    if fab._needs_grad(x, ln_scale, ln_bias, w1, b1, w2, b2):
        return _MLPHalf.apply(*args)
    part, = model_all_reduce(fab._mlp_half_fwd(*args, partial=True))
    return _finish(x, part, b2)


def out_projection(o, kernel, bias):
    """``reduce_from_model`` of the fp32 o @ kernel over this rank's rows
    of the out-projection, rounded once to o's dtype, + bias in o's dtype:
    the rounding points of the whole block's ``Dense`` (a product rounded
    once, then the bias added in the stream's dtype)."""
    dt = o.dtype
    part = _mm_f32(o.reshape(-1, o.shape[-1]), kernel.to(dt))
    part = reduce_from_model(part).reshape(*o.shape[:-1], kernel.shape[1])
    return part.to(dt) + bias.to(dt)


def finish_sum(part, bias, dtype):
    """``reduce_from_model`` of the fp32 partial term ``part``, + bias in
    fp32, rounded once to ``dtype`` (the fused MLP's epilogue)."""
    return (reduce_from_model(part) + bias.float()).to(dtype)
