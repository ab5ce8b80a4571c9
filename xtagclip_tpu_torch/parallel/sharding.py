"""Data parallelism and parameter sharding across ranks (port of
xtagclip_tpu/parallel/sharding.py:31-56 and of the data-parallel half of
JAX's step, which GSPMD compiles from those rules).

``param_partition_spec`` is JAX's rule, as a function of a leaf's name
and JAX shape: a leaf of at least 2 dims and 2^16 elements shards its
largest dim divisible by the FSDP size over ``data``; biases, norm scales
and other small leaves stay replicated (and ``model`` names the tensor
sharding of ``--model-parallel``, which the port refuses: ROADMAP Queue 1
item 10).

``wrap_model`` makes the step data-parallel once a process group exists
(core/mesh.py ``init_distributed``):

- without ``--fsdp``, DDP over a module that runs the step's loss
  function (``Step``), so that DDP reduces the gradients of the
  parameters the loss reaches and finds the others unused (TQN's
  ``logit_scale``, kept for checkpoint parity; the tag head without
  ``--use-tagging``); ``--ddp-static-graph`` is DDP's ``static_graph``;
- with ``--fsdp``, FSDP2's ``fully_shard`` on every block of the towers
  (the classes whose names end in ``Block``), then on the model: each
  parameter is sharded on the port dim of the JAX dim that
  ``param_partition_spec`` names, else on dim 0. FSDP2 refuses 0-dim
  parameters (the logit scales and bias): they stay whole and their
  gradients are averaged over the ranks by a hook. No
  ``MixedPrecisionPolicy``: the model's own bf16 casts stay, so FSDP's
  step is DDP's.

Both average the gradients over the ranks, and the cross-rank losses make
each rank's loss a term whose mean is the global loss, so the update is
the one-process update on the concatenated batch. ``full_state_dict`` and
``load_full_state_dict`` move the model and optimizer state between the
sharded form and the whole tensors a checkpoint holds.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


def jax_axes(p: torch.Tensor) -> tuple:
    """The port axis of each axis of the leaf's JAX layout: a conv kernel,
    flax's [kh, kw, in, out], is [out, in, kh, kw] here
    (convert/from_jax.py ``port_value``); every other leaf has JAX's
    layout."""
    return (2, 3, 1, 0) if p.dim() == 4 else tuple(range(p.dim()))


def jax_shape(p: torch.Tensor) -> tuple:
    return tuple(p.shape[a] for a in jax_axes(p))


def param_partition_spec(name: str, shape, model_size: int = 1,
                         fsdp_size: int = 1) -> Tuple[Optional[str], ...]:
    """JAX's sharding rule for one leaf of JAX shape ``shape`` (JAX
    sharding.py:31-56, verbatim): per dim None, ``"model"`` or
    ``"data"``."""
    del name  # JAX's rule reads the shape alone
    shape = tuple(shape)
    ndim, size = len(shape), 1
    for d in shape:
        size *= d
    spec = [None] * ndim
    if model_size > 1 and ndim == 2:
        if shape[1] % model_size == 0 and shape[1] >= 128:
            spec[1] = MODEL_AXIS
        elif shape[0] % model_size == 0 and shape[0] >= 128:
            spec[0] = MODEL_AXIS
    if model_size > 1 and ndim == 1 and shape[0] % model_size == 0 \
            and shape[0] >= 1024:
        spec[0] = MODEL_AXIS
    if fsdp_size > 1 and ndim >= 2 and size >= 2 ** 16:
        free = [d for d in range(ndim) if spec[d] is None]
        free.sort(key=lambda d: shape[d], reverse=True)
        for d in free:
            if shape[d] % fsdp_size == 0:
                spec[d] = DATA_AXIS
                break
    return tuple(spec)


def fsdp_dim(name: str, p: torch.Tensor, fsdp_size: int) -> Optional[int]:
    """The port dim that JAX's rule shards ``p`` on over ``data``, or
    None where it keeps ``p`` whole."""
    spec = param_partition_spec(name, jax_shape(p), 1, fsdp_size)
    if DATA_AXIS not in spec:
        return None
    return jax_axes(p)[spec.index(DATA_AXIS)]


# ---- DTensor helpers (plain tensors pass through) -------------------------

def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t):
    """This rank's piece of ``t``."""
    return t.to_local() if is_sharded(t) else t


def full(t):
    """The whole of ``t`` (a collective on a sharded tensor)."""
    return t.full_tensor() if is_sharded(t) else t


def as_sharded(whole: torch.Tensor, like):
    """``whole`` sharded as ``like`` is (no communication: every rank
    holds ``whole``); ``whole`` itself where ``like`` is not sharded."""
    if not is_sharded(like):
        return whole
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(whole.to(like.device), like.device_mesh,
                             like.placements, src_data_rank=None)


def local_piece(whole: torch.Tensor, like):
    """This rank's piece of ``whole`` as ``like`` is sharded."""
    return local(as_sharded(whole, like))


# ---- wrapping ---------------------------------------------------------------

class Step(nn.Module):
    """DDP's module: ``forward(fn)`` runs ``fn(model)``, the step's
    forward and loss, so that DDP sees the loss's graph."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn):
        return fn(self.model)


def _average_grad(p: torch.Tensor) -> None:
    dist.all_reduce(p.grad)
    p.grad /= dist.get_world_size()


def _blocks(model: nn.Module):
    """The tower blocks FSDP shards one by one, innermost first."""
    return [m for m in reversed(list(model.modules()))
            if m is not model and type(m).__name__.endswith("Block")]


def fully_shard_model(model: nn.Module, requires_grad: bool = True):
    """FSDP2 over ``model`` in place (module doc); returns it."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    device = next(model.parameters()).device
    n = dist.get_world_size()
    mesh = init_device_mesh(device.type, (n,))
    names = {id(p): name for name, p in model.named_parameters()}

    def placement(p):
        d = fsdp_dim(names.get(id(p), ""), p, n)
        return Shard(d) if d is not None else None

    scalars = {p for p in model.parameters() if p.dim() == 0}
    for block in _blocks(model):
        fully_shard(block, mesh=mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=mesh, shard_placement_fn=placement,
                ignored_params=scalars)
    if requires_grad:
        for p in scalars:
            p.register_post_accumulate_grad_hook(_average_grad)
    return model


def wrap_model(model: nn.Module, args) -> Optional[nn.Module]:
    """Make ``model``'s step data-parallel (module doc). Returns the DDP
    wrapper the step runs through, or None: FSDP shards ``model`` in
    place, and without a process group the step is the one-process
    step (with ``--fsdp`` too: JAX's rule shards nothing at size 1)."""
    if not dist.is_initialized():
        if getattr(args, "fsdp", False):
            logging.info("--fsdp in one process: nothing to shard")
        return None
    if getattr(args, "fsdp", False):
        fully_shard_model(model)
        return None
    from torch.nn.parallel import DistributedDataParallel as DDP

    static = bool(getattr(args, "ddp_static_graph", False))
    device = next(model.parameters()).device
    return DDP(Step(model),
               device_ids=[device.index] if device.type == "cuda" else None,
               broadcast_buffers=False, static_graph=static,
               find_unused_parameters=not static)


def is_fsdp(model: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


@contextlib.contextmanager
def unsharded(model: nn.Module):
    """The model's own parameters whole for calls other than its forward
    (evaluation's ``encode_image`` and the like); its FSDP blocks gather
    theirs in their own forwards."""
    if not is_fsdp(model):
        yield model
        return
    model.unshard()
    try:
        yield model
    finally:
        model.reshard()


@contextlib.contextmanager
def grad_sync(ddp: Optional[nn.Module], model: nn.Module, enabled: bool):
    """Reduce the gradients in this backward (``enabled``) or only
    accumulate them (the accumulation step's microbatches but the last:
    DDP's ``no_sync``, FSDP2's ``set_requires_gradient_sync``)."""
    if enabled:
        yield
    elif ddp is not None:
        with ddp.no_sync():
            yield
    elif is_fsdp(model):
        model.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            model.set_requires_gradient_sync(True)
    else:
        yield


def full_state_dict(module_or_optimizer) -> dict:
    """``state_dict()`` with every sharded tensor made whole (every rank
    calls it: the gathers are collectives)."""
    sd = module_or_optimizer.state_dict()
    if isinstance(module_or_optimizer, nn.Module):
        return {k: full(v) for k, v in sd.items()}
    state = {i: {k: full(v) for k, v in s.items()}
             for i, s in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def load_full_state_dict(model: nn.Module, sd: dict) -> None:
    """Load whole tensors into ``model``, each sharded parameter taking
    its own piece."""
    own = model.state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            if k not in own:
                raise KeyError(f"unexpected key in state dict: {k}")
            local(own[k]).copy_(local_piece(v, own[k]))
    missing = set(own) - set(sd)
    if missing:
        raise KeyError(f"missing keys in state dict: {sorted(missing)}")


def shard_optimizer_state(optimizer: torch.optim.Optimizer,
                          sd: dict) -> dict:
    """A whole-tensor optimizer state dict with each per-parameter tensor
    of a sharded parameter's shape cut to this rank's piece, as a
    sharded tensor, for ``optimizer.load_state_dict``."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for i, s in sd["state"].items():
        p = params[int(i)]
        state[i] = {k: as_sharded(v, p) if isinstance(v, torch.Tensor)
                    and v.shape == p.shape else v for k, v in s.items()}
    return {"state": state, "param_groups": sd["param_groups"]}
