"""Collectives that carry gradients, for the cross-rank losses and the
BatchNorm statistics (the port of what JAX's GSPMD step gets from
``jax.lax.all_gather``, ``psum`` and ``ppermute`` inside its one program:
xtagclip_tpu/losses/clip_loss.py:22-39, losses/siglip.py:33-86,
models/layers.py's ``bn_axis_name``).

Each is an autograd Function over the data group of core/mesh.py
(``init_mesh``: the whole process group unless ``--model-parallel``
splits it; the ranks of a model group hold the same rows and take part
in the data collectives each with its own data group). Its backward
is the collective's transpose: an all-gather's is the sum over ranks of
the gradient of the gathered tensor, sliced back to this rank's rows (an
all-reduce then a slice: gloo has no reduce-scatter); an all-reduce's is
an all-reduce; a ring shift's is the opposite shift. At world size 1 every
function returns its input itself, so a one-process step stays bit for bit
the step without a process group.

The model-axis operators carry tensor parallelism's activations
(parallel/tensor_parallel.py, Megatron's f and g): ``copy_to_model`` is
the identity forward and an all-reduce over the model group backward (a
replicated input that the ranks' shards each use), ``reduce_from_model``
an all-reduce forward and the identity backward (the sum of the ranks'
partial outputs). Both sum in fp32 whatever the dtype, and round once.
At model size 1 both return their input.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from xtagclip_tpu_torch.core.mesh import data_global_rank, data_group
from xtagclip_tpu_torch.core.mesh import data_rank as rank
from xtagclip_tpu_torch.core.mesh import data_size as world
from xtagclip_tpu_torch.core.mesh import model_group, model_size


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        parts = [torch.empty_like(x) for _ in range(world())]
        dist.all_gather(parts, x.contiguous(), group=data_group())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=data_group())
        r = rank()
        return grad[r * ctx.rows:(r + 1) * ctx.rows]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x, group=data_group())
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=data_group())
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
    w, r = world(), rank()
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, data_global_rank((r + shift) % w)),
           dist.P2POp(dist.irecv, out, data_global_rank((r - shift) % w))]
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
    dist.all_gather(parts, x.contiguous(), group=data_group())
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
    dist.all_reduce(flat, group=data_group())
    flat /= world()
    return [f.to(v.dtype) for f, v in zip(flat.unbind(), values)]


def model_all_reduce(*tensors) -> list:
    """Each tensor summed over the model group, in one fp32 all-reduce,
    and rounded once to its dtype (no autograd)."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=model_group())
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape).to(t.dtype))
        start += t.numel()
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return model_all_reduce(grad)[0]


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return model_all_reduce(x)[0]

    @staticmethod
    def backward(ctx, grad):
        return grad


def broadcast_over_model(batch: dict) -> dict:
    """Each tensor of ``batch`` as model rank 0 of this rank's model group
    holds it (a train batch: the ranks of a model group read the same
    rows, and this makes their random crops agree too). At model size 1
    the batch itself."""
    if model_size() == 1:
        return batch
    from xtagclip_tpu_torch.core.mesh import model_rank
    from xtagclip_tpu_torch.core.mesh import rank as global_rank

    src = global_rank() - model_rank()
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            v = v.contiguous()
            dist.broadcast(v, src, group=model_group())
        out[k] = v
    return out


def copy_to_model(x):
    """``x`` itself forward; its gradient summed over the model group
    backward (module doc)."""
    return _CopyToModel.apply(x) if model_size() > 1 else x


def reduce_from_model(x):
    """The sum of ``x`` over the model group forward; the gradient itself
    backward (module doc)."""
    return _ReduceFromModel.apply(x) if model_size() > 1 else x
