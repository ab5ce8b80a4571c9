"""Collectives that carry gradients, for the cross-rank losses and the
BatchNorm statistics (the port of what JAX's GSPMD step gets from
``jax.lax.all_gather``, ``psum`` and ``ppermute`` inside its one program:
xtagclip_tpu/losses/clip_loss.py:22-39, losses/siglip.py:33-86,
models/layers.py's ``bn_axis_name``).

Each is an autograd Function over the default process group. Its backward
is the collective's transpose: an all-gather's is the sum over ranks of
the gradient of the gathered tensor, sliced back to this rank's rows (an
all-reduce then a slice: gloo has no reduce-scatter); an all-reduce's is
an all-reduce; a ring shift's is the opposite shift. At world size 1 every
function returns its input itself, so a one-process step stays bit for bit
the step without a process group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from xtagclip_tpu_torch.core.mesh import world_size as world


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad)
        r = dist.get_rank()
        return grad[r * ctx.rows:(r + 1) * ctx.rows]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


class _RingShift(torch.autograd.Function):
    """Send x to rank + shift, receive from rank - shift (mod world)."""

    @staticmethod
    def forward(ctx, x, shift: int):
        ctx.shift = shift
        return _exchange(x, shift)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, -ctx.shift), None


def _exchange(x, shift: int):
    w, r = dist.get_world_size(), dist.get_rank()
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (r + shift) % w),
           dist.P2POp(dist.irecv, out, (r - shift) % w)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def gather_rows(x):
    """[n, ...] on each rank -> [world * n, ...], rank-major, with the
    gradient of every rank's use flowing back to its owner."""
    return _AllGather.apply(x) if world() > 1 else x


@torch.no_grad()
def gather_rows_no_grad(x):
    """``gather_rows`` of a tensor that needs no gradient (the
    accumulation step's cached features)."""
    if world() == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(world())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def all_reduce_sum(x):
    """The sum of ``x`` over ranks, differentiable."""
    return _AllReduce.apply(x) if world() > 1 else x


def ring_shift(x, shift: int = 1):
    """The ``x`` of rank - shift, differentiable (JAX's ``ppermute`` on the
    ring ``i -> i + shift``)."""
    return _RingShift.apply(x, shift) if world() > 1 else x


def mean_over_ranks(values):
    """A list of scalar tensors -> their means over ranks, in one
    all-reduce (the step's metrics, which JAX returns global)."""
    if world() == 1 or not values:
        return values
    flat = torch.stack([v.detach().float().reshape(()) for v in values])
    dist.all_reduce(flat)
    flat /= world()
    return [f.to(v.dtype) for f, v in zip(flat.unbind(), values)]
