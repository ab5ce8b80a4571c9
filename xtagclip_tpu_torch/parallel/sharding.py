"""Data parallelism, tensor parallelism and parameter sharding across
ranks (port of xtagclip_tpu/parallel/sharding.py:31-56 and of the step
GSPMD compiles from those rules on JAX's (data, model) mesh).

``param_partition_spec`` is JAX's rule, as a function of a leaf's name
and JAX shape: a leaf of at least 2 dims and 2^16 elements shards its
largest dim divisible by the FSDP size over ``data``; biases, norm scales
and other small leaves stay replicated; under ``--model-parallel`` a 2-D
leaf's output dim (or its input dim) of at least 128, and a 1-D leaf of
at least 1024, shard over ``model``.

Tensor parallelism (``--model-parallel N`` > 1, ``shard_tensor_parallel``)
is the Megatron split of every tower over the model group of
core/mesh.py's mesh, not JAX's rule. It goes by one table a block class
(``plans``; ``block_plan`` for a ``ResidualAttentionBlock``): {leaf:
``ModelShard``}.

- Column-parallel, a rank's heads or its slice of the hidden width with
  their biases: every q, k and v projection (a fused q|k|v or k|v kernel
  by heads, each part cut alike: a contiguous column shard of the [E, 3E]
  kernel would hand rank 0 all of q) and every first MLP projection
  (c_fc, fc1, SwiGLU's and GeGLU's two halves, T5's wi_0 and wi_1,
  BERT's intermediate). The Dense takes ``copy_to_model`` of its input.
- Row-parallel: every output projection and second MLP projection, its
  fp32 product summed over the model group, rounded once, its bias added
  once (``tensor_parallel.out_projection``).
- By heads: the per-head bias tables (timm's relpos, Swin's, T5's
  bucketed one).
- Heads stay whole heads. A head count N does not divide splits into
  ``piece_sizes(heads, N)`` heads a rank (14 heads over 4: 4, 4, 3, 3),
  and every leaf that holds heads (``ModelShard.by_heads``: the q, k and
  v columns, the out-projection rows, the bias tables) is cut on those
  head boundaries, never mid-head (its ``unit`` is the head dim). Each
  rank's attention runs on its own count, ``local_heads``; the partial
  terms and the all-reduces are the same [B, L, D] on every rank. Only a
  model size above a block's head count raises ValueError naming the
  block: a rank would hold no head.
- The hidden width need not divide by N (EVA02-L-14's SwiGLU 2730 at
  N = 4): the slices are ``tensor_split``'s (683, 683, 682, 682), and
  EVA-02's ``mlp_norm``, a LayerNorm over that width, takes its
  statistics over the model group (``tensor_parallel.split_layer_norm``)
  with its scale and bias split alike.
- The HF token tables (BERT's ``word_embeddings``, T5's ``shared``,
  M2M100's ``embed_tokens``) by vocabulary rows: ids outside a rank's
  rows read zero, then one sum over the group.

A ``ResidualAttentionBlock`` runs its split halves on kernels #1-#4's
partial modes (parallel/tensor_parallel.py); the other blocks run their
own forwards on the split Dense, Embed and LayerNorm modules
(models/layers.py ``tp_role``), their attention on #6 where it runs whole.

The LNs, LayerScales, positional tables, patch, conv and downsample
stems, the conv trunks (ConvNeXt's depthwise conv, FastViT's ConvFFN and
RepMixer, the ResNets' bottlenecks), poolers, the final projections and
every module outside the towers (the tag head, TQN) stay whole on each
model rank. JAX's rule shards those over ``model`` too (and the blocks'
leaves on their output dims): that changes where memory goes, not the
step's numbers. A sharded leaf is a plain tensor holding this rank's
piece, tagged with its ``ModelShard`` (and, by name, ``model_shards``).
A split module's attention runs on its ``num_heads // tp_size`` local
heads; a dropout inside a split region draws its mask at the whole width
and takes this rank's slice (models/layers.py ``dropout``).

``wrap_model`` makes the step data-parallel over the data group once a
process group exists (core/mesh.py ``init_distributed``), after the
tensor-parallel split:

- without ``--fsdp``, DDP over a module that runs the step's loss
  function (``Step``), so that DDP reduces the gradients of the
  parameters the loss reaches and finds the others unused (TQN's
  ``logit_scale``, kept for checkpoint parity; the tag head without
  ``--use-tagging``); ``--ddp-static-graph`` is DDP's ``static_graph``;
- with ``--fsdp``, FSDP2's ``fully_shard`` on every block of the towers
  (the classes whose names end in ``Block``, and the classes of
  ``plans``: the text towers' layers), then on the model: each
  parameter is sharded on the port dim of the JAX dim that
  ``param_partition_spec`` names, else on dim 0. FSDP2 refuses 0-dim
  parameters (the logit scales and bias): they stay whole and their
  gradients are averaged over the ranks by a hook. No
  ``MixedPrecisionPolicy``: the model's own bf16 casts stay, so FSDP's
  step is DDP's.

Both average the gradients over the data group, and the cross-rank losses
make each rank's loss a term whose mean over the data group is the global
loss (the ranks of a model group read the same rows and compute the same
loss), so the update is the one-process update on the concatenated
batch. Under ``--fsdp`` with ``--model-parallel`` FSDP2 shards each
rank's tensor-parallel pieces over the data group (its 1-D mesh), and a
leaf is whole after a gather over the data group then one over the model
group. ``full_state_dict`` and ``load_full_state_dict`` move the model
and optimizer state between the sharded form and the whole tensors, in
their one-process shapes, that a checkpoint holds: a checkpoint written
at any (data, model) resumes at any other.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import operator
from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from xtagclip_tpu_torch.core import mesh

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


def full(t, shard: Optional["ModelShard"] = None):
    """The whole of ``t`` (a collective on a sharded tensor): FSDP's
    gather over the data group, then, for a tensor-parallel piece
    (``shard``, by default ``t``'s own tag), the gather over the model
    group."""
    shard = shard or getattr(t, "model_shard", None)
    t = t.full_tensor() if is_sharded(t) else t
    return t if shard is None else gather_model(t, shard)


def as_sharded(whole: torch.Tensor, like):
    """``whole`` sharded as ``like`` is (no communication: every rank
    holds ``whole``); ``whole`` itself where ``like`` is not sharded."""
    if not is_sharded(like):
        return whole
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(whole.to(like.device), like.device_mesh,
                             like.placements, src_data_rank=None)


def local_piece(whole: torch.Tensor, like,
                shard: Optional["ModelShard"] = None):
    """This rank's piece of ``whole`` as ``like`` is sharded: its model
    piece (``shard``, by default ``like``'s tag), then FSDP's."""
    return local(as_sharded_piece(whole, like, shard))


def as_sharded_piece(whole: torch.Tensor, like,
                     shard: Optional["ModelShard"] = None):
    """``as_sharded`` of this rank's model piece of ``whole`` (``shard``,
    by default ``like``'s tag)."""
    shard = shard or getattr(like, "model_shard", None)
    if shard is not None:
        whole = model_piece(whole, shard, mesh.model_rank(),
                            mesh.model_size())
    return as_sharded(whole, like)


# ---- tensor parallelism -----------------------------------------------------

@dataclass(frozen=True)
class ModelShard:
    """How a leaf is cut over the model group, along port dim ``dim``:
    into N contiguous pieces of whole ``unit``s, ``tensor_split``'s counts
    of units (the first ones a unit longer where N does not divide them);
    with ``qkv`` (``kv``) that dim holds q | k | v (k | v), each part cut
    alike, and a rank's piece is its columns of each (module doc).
    ``by_heads``: the dim holds heads, and ``shard_tensor_parallel``
    sets ``unit`` to the head's width there (the head dim; 1 for a bias
    table's heads dim). ``whole``: the dim's whole size, which
    ``shard_tensor_parallel`` records (None: N equal pieces)."""
    dim: int
    qkv: bool = False
    kv: bool = False
    whole: Optional[int] = None
    by_heads: bool = False
    unit: int = 1

    @property
    def parts(self) -> int:
        return 3 if self.qkv else 2 if self.kv else 1


def piece_sizes(whole: int, size: int) -> list:
    """The sizes of ``tensor_split``'s ``size`` pieces of ``whole``."""
    return [whole // size + (r < whole % size) for r in range(size)]


def part_sizes(length: int, shard: ModelShard, size: int) -> list:
    """Each rank's share of one part (q, k or v; the whole dim where
    there is one part) of ``length`` along the shard's dim: whole units,
    ``piece_sizes``' counts of them."""
    return [shard.unit * n for n in piece_sizes(length // shard.unit, size)]


def model_piece(whole: torch.Tensor, shard: ModelShard, rank: int,
                size: int) -> torch.Tensor:
    """Rank ``rank``'s piece of ``whole`` of ``size`` pieces."""
    if size == 1:
        return whole
    parts = whole.chunk(shard.parts, shard.dim)
    sizes = part_sizes(parts[0].shape[shard.dim], shard, size)
    lo = sum(sizes[:rank])
    return torch.cat([p.narrow(shard.dim, lo, sizes[rank]) for p in parts],
                     shard.dim)


def model_whole(pieces, shard: ModelShard) -> torch.Tensor:
    """The whole leaf of the ranks' ``pieces``, in rank order."""
    if len(pieces) == 1:
        return pieces[0]
    if shard.parts == 1:
        return torch.cat(pieces, shard.dim)
    split = [p.chunk(shard.parts, shard.dim) for p in pieces]
    return torch.cat([torch.cat([s[j] for s in split], shard.dim)
                      for j in range(shard.parts)], shard.dim)


def gather_model(t: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The whole leaf of this rank's piece ``t`` (a collective over the
    model group; uneven pieces travel padded to the longest)."""
    n = mesh.model_size()
    if n == 1:
        return t
    t, dim = t.detach().contiguous(), shard.dim
    sizes = ([shard.parts * k for k in part_sizes(
        shard.whole // shard.parts, shard, n)] if shard.whole is not None
        else [t.shape[dim]] * n)
    shape = list(t.shape)
    shape[dim] = max(sizes)
    buf = t.new_zeros(shape)
    buf.narrow(dim, 0, t.shape[dim]).copy_(t)
    pieces = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(pieces, buf, group=mesh.model_group())
    return model_whole([p.narrow(dim, 0, k) for p, k in zip(pieces, sizes)],
                       shard)


def block_plan(block) -> Dict[str, ModelShard]:
    """The sharded leaves of a ``ResidualAttentionBlock`` (module doc),
    by their names in the block. A cross-attention block with a key/value
    width of its own has separate q/k/v projections, each split by
    heads."""
    attn = block.attn
    plan = {}
    if getattr(attn, "separate", False):
        for p in ("q_proj", "k_proj", "v_proj"):
            plan[f"attn.{p}.kernel"] = ModelShard(1, by_heads=True)
            plan[f"attn.{p}.bias"] = ModelShard(0, by_heads=True)
    else:
        plan["attn.in_proj.kernel"] = ModelShard(1, qkv=True, by_heads=True)
        plan["attn.in_proj.bias"] = ModelShard(0, qkv=True, by_heads=True)
    plan.update({"attn.out_proj.kernel": ModelShard(0, by_heads=True),
                 "mlp.c_fc.kernel": ModelShard(1),
                 "mlp.c_fc.bias": ModelShard(0),
                 "mlp.c_proj.kernel": ModelShard(0)})
    return plan


def _is_block(m) -> bool:
    from xtagclip_tpu_torch.models.layers import ResidualAttentionBlock

    return isinstance(m, ResidualAttentionBlock)


@dataclass(frozen=True)
class Plan:
    """A block class's split (module doc): its {leaf: ModelShard}, a leaf
    absent from an instance skipped (EVA's fused or separate q/k/v, a
    bias-free k); ``heads``, the instance's whole head count, which its
    ``by_heads`` leaves are cut by (None: the block splits no heads)."""
    leaves: Dict[str, ModelShard]
    heads: Optional[Callable[[nn.Module], int]] = None


def _column(*names, heads: bool = False) -> dict:
    """Column-parallel Denses: kernel columns and bias (``heads``: the
    attention's q, k or v, cut by whole heads)."""
    return {f"{n}.{leaf}": ModelShard(d, by_heads=heads) for n in names
            for leaf, d in (("kernel", 1), ("bias", 0))}


def _row(*names, heads: bool = False) -> dict:
    """Row-parallel Denses: kernel rows (the bias whole; ``heads``: an
    attention's out-projection, cut by whole heads)."""
    return {f"{n}.kernel": ModelShard(0, by_heads=heads) for n in names}


def _fused(name: str, kv: bool = False) -> dict:
    """A fused q|k|v (``kv``: k|v) Dense, by heads."""
    return {f"{name}.kernel": ModelShard(1, qkv=not kv, kv=kv, by_heads=True),
            f"{name}.bias": ModelShard(0, qkv=not kv, kv=kv, by_heads=True)}


@functools.lru_cache(maxsize=None)
def plans() -> Dict[type, Plan]:
    """The split of every block class but ``ResidualAttentionBlock``
    (``block_plan``), one table a class (module doc)."""
    from xtagclip_tpu_torch.models import (
        bert,
        convnext,
        eva,
        fastvit,
        m2m100,
        resnet,
        swin,
        t5,
        timm_vit,
        vitamin,
    )

    heads, by_heads = operator.attrgetter, ModelShard(1, by_heads=True)
    return {
        timm_vit.TimmBlock: Plan({**_fused("qkv"), **_row("proj", heads=True),
                                  **_column("fc1"), **_row("fc2")},
                                 heads("num_heads")),
        timm_vit.RelPosBias: Plan({"table": by_heads},
                                  lambda m: m.table.shape[1]),
        timm_vit.MapPool: Plan({**_column("q", heads=True),
                                **_fused("kv", kv=True),
                                **_row("proj", heads=True),
                                **_column("mlp_fc1"), **_row("mlp_fc2")},
                               heads("num_heads")),
        eva.EvaAttention: Plan({**_fused("qkv"),
                                **_column("q_proj", "k_proj", "v_proj",
                                          heads=True),
                                **_row("proj", heads=True)},
                               heads("num_heads")),
        eva.EvaBlock: Plan({**_column("fc1", "fc1_g", "fc1_x"),
                            "mlp_norm.scale": ModelShard(0),
                            "mlp_norm.bias": ModelShard(0),
                            **_row("fc2")}),
        vitamin.GeGluBlock: Plan({**_fused("qkv"), **_row("proj", heads=True),
                                  **_column("fc1_g", "fc1_x"),
                                  **_row("fc2")}, heads("heads")),
        bert.BertModel: Plan({"word_embeddings.embedding": ModelShard(0)}),
        bert.BertSelfAttentionLayer: Plan(
            {**_column("query", "key", "value", heads=True),
             **_row("out_dense", heads=True)}, heads("num_heads")),
        bert.BertEncoderLayer: Plan({**_column("intermediate"),
                                     **_row("output")}),
        t5.T5EncoderStack: Plan({"shared.embedding": ModelShard(0),
                                 "relpos_bias.embedding": by_heads},
                                lambda m: m.relpos_bias.embedding.shape[1]),
        t5.T5SelfAttention: Plan({**_column("q", "k", "v", heads=True),
                                  **_row("o", heads=True)},
                                 heads("num_heads")),
        t5.T5GatedFF: Plan({**_column("wi_0", "wi_1"), **_row("wo")}),
        m2m100.M2M100Encoder: Plan({"embed_tokens.embedding":
                                    ModelShard(0)}),
        m2m100.M2M100EncoderLayer: Plan(
            {**_column("q_proj", "k_proj", "v_proj", heads=True),
             **_column("fc1"), **_row("out_proj", heads=True),
             **_row("fc2")}, heads("num_heads")),
        swin.WindowAttention: Plan({**_fused("qkv"),
                                    "rel_pos_bias": by_heads,
                                    **_row("proj", heads=True)},
                                   heads("num_heads")),
        swin.SwinBlock: Plan({**_column("fc1"), **_row("fc2")}),
        convnext.ConvNeXtBlock: Plan({**_column("mlp_fc1"),
                                      **_row("mlp_fc2")}),
        fastvit.AttnBlock: Plan({**_fused("qkv"),
                                 **_row("proj", heads=True)},
                                heads("heads")),
        resnet.AttentionPool2d: Plan(
            {**_column("q_proj", "k_proj", "v_proj", heads=True),
             **_row("c_proj", heads=True)}, heads("num_heads")),
    }


def _plan_of(m: nn.Module) -> Optional[Plan]:
    table = plans()
    return next((table[c] for c in type(m).__mro__ if c in table), None)


def _leaf(module: nn.Module, name: str):
    """(owner, attribute, tensor) of leaf ``name`` of ``module``, or None
    where the instance has no such leaf."""
    path, attr = name.rsplit(".", 1) if "." in name else ("", name)
    try:
        owner = module.get_submodule(path)
    except AttributeError:
        return None
    t = getattr(owner, attr, None)
    return None if t is None else (owner, attr, t)


def _split_leaves(module: nn.Module) -> Dict[str, ModelShard]:
    """{leaf: ModelShard} of ``module`` if it is a block that splits (its
    leaves present in this instance), else {}."""
    if _is_block(module):
        return block_plan(module)
    plan = _plan_of(module)
    if plan is None:
        return {}
    return {k: v for k, v in plan.leaves.items()
            if _leaf(module, k) is not None}


def _heads(module: nn.Module) -> Optional[int]:
    """The whole head count of a block that splits heads, else None."""
    if _is_block(module):
        return module.heads
    plan = _plan_of(module)
    return plan.heads(module) if plan is not None and plan.heads else None


def check_tensor_parallel(model: nn.Module, size: int) -> None:
    """Raise ValueError for a block of ``model`` with fewer heads than
    ``size``: a rank would hold no head. Any other count splits, unevenly
    where ``size`` does not divide it (module doc)."""
    for name, m in model.named_modules():
        heads = _heads(m)
        if heads is not None and heads < size:
            raise ValueError(
                f"--model-parallel {size}: block {name!r} "
                f"({type(m).__name__}) has {heads} heads, fewer than {size}: "
                "each rank holds at least one whole head")


def _set_role(owner: nn.Module, attr: str, shard: ModelShard, rank: int,
              size: int) -> None:
    """How a module whose leaf ``attr`` is split runs (models/layers.py):
    a Dense kernel cut on its rows is row-parallel (one cut on its columns
    needs no role: its block copies the region's input to the group); an
    Embed cut on its rows reads its vocabulary rows; a split LayerNorm
    takes its statistics over the model group."""
    from xtagclip_tpu_torch.models.layers import Dense, Embed, LayerNorm

    if isinstance(owner, Dense) and attr == "kernel":
        if shard.dim == 0:
            owner.tp_role = "row"
    elif isinstance(owner, Embed) and shard.dim == 0:
        sizes = piece_sizes(shard.whole, size)
        lo = sum(sizes[:rank])
        owner.tp_rows = (lo, lo + sizes[rank])
    elif isinstance(owner, LayerNorm):
        owner.tp_role = "split"


def shard_tensor_parallel(model: nn.Module, size: Optional[int] = None,
                          rank: Optional[int] = None) -> nn.Module:
    """Split every block of ``model`` over the model group in place
    (module doc): each sharded leaf becomes this rank's piece, tagged
    ``model_shard``; the block keeps its plan as ``tp_plan`` and its model
    size as ``tp_size``, and runs its tensor-parallel route. Raises
    (``check_tensor_parallel``) before anything is split."""
    size = mesh.model_size() if size is None else size
    rank = mesh.model_rank() if rank is None else rank
    if size == 1:
        return model
    check_tensor_parallel(model, size)
    for block in list(model.modules()):
        plan = {}
        heads = _heads(block)
        for leaf, shard in _split_leaves(block).items():
            owner, attr, old = _leaf(block, leaf)
            whole = old.shape[shard.dim]
            shard = replace(shard, whole=whole, unit=(
                whole // shard.parts // heads if shard.by_heads else 1))
            plan[leaf] = shard
            piece = model_piece(old.detach(), shard, rank, size).clone()
            new = nn.Parameter(piece, requires_grad=old.requires_grad)
            new.model_shard = shard
            setattr(owner, attr, new)
            if not _is_block(block):  # its routes read their leaves
                _set_role(owner, attr, shard, rank, size)
        if plan:
            block.tp_plan = plan
            block.tp_size = size
            block.tp_rank = rank
            if _is_block(block):
                block.local_heads = piece_sizes(block.heads, size)[rank]
                block.mlp_pieces = piece_sizes(
                    plan["mlp.c_fc.kernel"].whole, size)
    return model


def model_shards(model: nn.Module) -> Dict[str, ModelShard]:
    """{state-dict name: ModelShard} of the tensor-parallel leaves of
    ``model`` (empty where nothing is split)."""
    out = {}
    for name, block in model.named_modules():
        prefix = f"{name}." if name else ""
        out.update({prefix + k: v
                    for k, v in getattr(block, "tp_plan", {}).items()})
    return out


def tag_model_shards(model: nn.Module) -> None:
    """Tag each tensor-parallel parameter with its ``ModelShard`` (again
    after FSDP2 has made its own parameters)."""
    shards = model_shards(model)
    for name, p in model.named_parameters():
        if name in shards:
            p.model_shard = shards[name]


def is_model_sharded(p) -> bool:
    return getattr(p, "model_shard", None) is not None


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
    dist.all_reduce(p.grad, group=mesh.data_group())
    p.grad /= mesh.data_size()


def _blocks(model: nn.Module):
    """The tower blocks FSDP shards one by one, innermost first: the
    classes whose names end in ``Block`` and those that ``plans`` splits
    (the text towers' layers among them)."""
    return [m for m in reversed(list(model.modules()))
            if m is not model and (type(m).__name__.endswith("Block")
                                   or _plan_of(m) is not None)]


def _data_mesh(device):
    """The data group as FSDP2's 1-D device mesh."""
    if mesh.model_size() == 1:
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(device.type, (dist.get_world_size(),))
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh.from_group(mesh.data_group(), device.type)


def fully_shard_model(model: nn.Module, requires_grad: bool = True):
    """FSDP2 over ``model`` in place, over the data group (module doc);
    returns it."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    device = next(model.parameters()).device
    n = mesh.data_size()
    data_mesh = _data_mesh(device)
    names = {id(p): name for name, p in model.named_parameters()}

    def placement(p):
        d = fsdp_dim(names.get(id(p), ""), p, n)
        return Shard(d) if d is not None else None

    scalars = {p for p in model.parameters() if p.dim() == 0}
    for block in _blocks(model):
        fully_shard(block, mesh=data_mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=data_mesh, shard_placement_fn=placement,
                ignored_params=scalars)
    if requires_grad:
        for p in scalars:
            p.register_post_accumulate_grad_hook(_average_grad)
    tag_model_shards(model)
    return model


def wrap_model(model: nn.Module, args) -> Optional[nn.Module]:
    """Split ``model`` over the model group (``--model-parallel``), then
    make its step data-parallel over the data group (module doc).
    Returns the DDP wrapper the step runs through, or None: FSDP shards
    ``model`` in place, a data group of one rank needs no wrapper, and
    without a process group the step is the one-process step (with
    ``--fsdp`` too: JAX's rule shards nothing at size 1)."""
    if not dist.is_initialized():
        if getattr(args, "fsdp", False):
            logging.info("--fsdp in one process: nothing to shard")
        return None
    shard_tensor_parallel(model)
    if getattr(args, "fsdp", False):
        fully_shard_model(model)
        return None
    if mesh.model_size() > 1 and mesh.data_size() == 1:
        return None
    from torch.nn.parallel import DistributedDataParallel as DDP

    static = bool(getattr(args, "ddp_static_graph", False))
    device = next(model.parameters()).device
    return DDP(Step(model),
               device_ids=[device.index] if device.type == "cuda" else None,
               broadcast_buffers=False, static_graph=static,
               find_unused_parameters=not static,
               process_group=mesh.data_group())


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


def _shard_of_state(optimizer, p, v):
    """The ModelShard of optimizer state ``v`` of parameter ``p``: the
    parameter's, where ``v`` is shaped as its piece (a moment), else None:
    a step count, and every state of an optimizer that keeps the whole
    leaf's state on each rank (``whole_state``: Adafactor)."""
    shard = getattr(p, "model_shard", None)
    if shard is None or getattr(optimizer, "whole_state", False) \
            or not isinstance(v, torch.Tensor) or v.shape != p.shape:
        return None
    return shard


def full_state_dict(module_or_optimizer) -> dict:
    """``state_dict()`` with every sharded tensor made whole, FSDP's
    pieces and the tensor-parallel ones (every rank calls it: the gathers
    are collectives)."""
    sd = module_or_optimizer.state_dict()
    if isinstance(module_or_optimizer, nn.Module):
        shards = model_shards(module_or_optimizer)
        return {k: full(v, shards.get(k)) for k, v in sd.items()}
    params = [p for g in module_or_optimizer.param_groups
              for p in g["params"]]
    state = {i: {k: full(v, _shard_of_state(module_or_optimizer,
                                            params[int(i)], v))
                 for k, v in s.items()}
             for i, s in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def load_full_state_dict(model: nn.Module, sd: dict) -> None:
    """Load whole tensors into ``model``, each sharded parameter taking
    its own piece."""
    own = model.state_dict()
    shards = model_shards(model)
    with torch.no_grad():
        for k, v in sd.items():
            if k not in own:
                raise KeyError(f"unexpected key in state dict: {k}")
            local(own[k]).copy_(local_piece(v, own[k], shards.get(k)))
    missing = set(own) - set(sd)
    if missing:
        raise KeyError(f"missing keys in state dict: {sorted(missing)}")


def shard_optimizer_state(optimizer: torch.optim.Optimizer,
                          sd: dict) -> dict:
    """A whole-tensor optimizer state dict with each per-parameter tensor
    of a sharded parameter's whole shape cut to this rank's piece (its
    model piece, then FSDP's, as a sharded tensor), for
    ``optimizer.load_state_dict``; as it is for an optimizer that keeps
    whole state (``whole_state``: Adafactor)."""
    if getattr(optimizer, "whole_state", False):
        return sd
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for i, s in sd["state"].items():
        p = params[int(i)]
        shard = getattr(p, "model_shard", None)
        whole = _whole_shape(p, shard)
        state[i] = {k: as_sharded_piece(v, p, shard)
                    if isinstance(v, torch.Tensor) and v.shape == whole
                    else v for k, v in s.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def _whole_shape(p, shard: Optional[ModelShard]) -> torch.Size:
    """The whole leaf's shape of parameter ``p`` (FSDP's global shape,
    times the model size along a tensor-parallel dim)."""
    shape = list(p.shape)
    if shard is not None:
        shape[shard.dim] = (shard.whole if shard.whole is not None
                            else shape[shard.dim] * mesh.model_size())
    return torch.Size(shape)
