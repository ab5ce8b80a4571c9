"""The launcher's process identity and the process group (port of
xtagclip_tpu/core/mesh.py:24-190).

``world_info_from_env`` and ``coordinator_from_env`` read the variables
the reference's launchers set (distributed.py:72-90), in the same family
order: torchrun, then Intel MPI's PMI, then SLURM, then Open MPI.
``init_distributed`` is JAX's ``jax.distributed.initialize`` step as
``torch.distributed.init_process_group``: NCCL on the card, gloo on the
CPU (``--dist-backend`` overrides), one rank per process, and
``cuda:LOCAL_RANK`` as the process's card unless ``--no-set-device-rank``.
Where JAX's process runs one program over every device of a global mesh,
the port's processes each run the step on their share of the batch and
meet in the collectives of parallel/collectives.py and the wrappers of
parallel/sharding.py (DDP, FSDP2), so that a step on N ranks is the
one-process step on the concatenated batch.

``init_mesh`` lays the ranks out as JAX's ``create_mesh`` lays out the
devices (xtagclip_tpu/core/mesh.py:113-125): a (data, model) grid in
row-major order, rank = data_index * N + model_index for ``--model-parallel
N``, so the N ranks of a model group are neighbours. The data group (the
ranks of one model index) carries what JAX's ``data`` axis carries: the
batch split, the gradient average, the loss gathers, the BatchNorm
statistics; the model group (the ranks of one data index) the
tensor-parallel all-reduces of the sharded blocks
(parallel/tensor_parallel.py). Before ``init_mesh`` (or at N = 1) the
data group is the whole process group and the model axis has size 1.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
from typing import Optional, Tuple

import torch
import torch.distributed as dist

LOCAL_RANK_VARS = ("LOCAL_RANK", "MPI_LOCALRANKID", "SLURM_LOCALID",
                   "OMPI_COMM_WORLD_LOCAL_RANK")
RANK_VARS = ("RANK", "PMI_RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
WORLD_SIZE_VARS = ("WORLD_SIZE", "PMI_SIZE", "SLURM_NTASKS",
                   "OMPI_COMM_WORLD_SIZE")


def _first(names) -> Optional[Tuple[str, int]]:
    """(name, value) of the first of ``names`` set in the environment."""
    for name in names:
        if name in os.environ:
            return name, int(os.environ[name])
    return None


def world_size_from_env() -> Tuple[Optional[str], int]:
    """(the variable that set it or None, world size) from the launcher
    env, in ``world_info_from_env``'s order."""
    found = _first(WORLD_SIZE_VARS)
    return found if found else (None, 1)


def world_info_from_env() -> Tuple[int, int, int]:
    """(local_rank, global_rank, world_size) from the launcher env, each
    from the first family that sets it (module doc)."""
    local = _first(LOCAL_RANK_VARS)
    rank = _first(RANK_VARS)
    return (local[1] if local else 0, rank[1] if rank else 0,
            world_size_from_env()[1])


def coordinator_from_env() -> Optional[str]:
    """Coordinator address:port: JAX-native vars first, then the
    torch-style MASTER_ADDR/MASTER_PORT pair (the reference's env://
    default)."""
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS")
    if coord:
        return coord
    addr = os.environ.get("MASTER_ADDR")
    if addr:
        return f"{addr}:{os.environ.get('MASTER_PORT', '29500')}"
    return None


def process_identity() -> Tuple[int, int, int, bool]:
    """(local_rank, rank, world_size, launched) as JAX's
    ``init_distributed`` reads them: ``JAX_PROCESS_ID`` /
    ``JAX_NUM_PROCESSES`` first, then the launcher families; ``launched``
    when one of them names a world size."""
    local_rank, rank, world = world_info_from_env()
    launched = world_size_from_env()[0] is not None
    if os.environ.get("JAX_NUM_PROCESSES"):
        world, launched = int(os.environ["JAX_NUM_PROCESSES"]), True
    if os.environ.get("JAX_PROCESS_ID"):
        rank = int(os.environ["JAX_PROCESS_ID"])
    return local_rank, rank, world, launched


def init_distributed(args=None) -> dict:
    """Join the launcher's process group (module doc): at a world size
    above 1, or at 1 under a launcher that gives a coordinator (so that
    ``torchrun --nproc_per_node 1`` runs the DDP or FSDP step); one
    process without a group otherwise. The init method is ``--dist-url``
    or ``tcp://`` the coordinator of ``coordinator_from_env``. Lays the
    ranks out with ``init_mesh(args.model_parallel)``. Sets
    ``args.{distributed, world_size, rank, local_rank, device_count}``,
    ``args.{data_size, data_rank, model_size, model_rank}`` and, on the
    card, ``args.device`` to this rank's card."""
    local_rank, rank, world, launched = process_identity()
    url = getattr(args, "dist_url", None)
    coord = coordinator_from_env()
    if url is None and coord is not None:
        url = f"tcp://{coord}"
    if world > 1 and url is None:
        raise RuntimeError(
            f"world size {world} but no coordinator: set MASTER_ADDR/"
            "MASTER_PORT (torchrun does), JAX_COORDINATOR_ADDRESS or "
            "--dist-url")
    join = world > 1 or (launched and url is not None)
    device = getattr(args, "device", "cuda") if args is not None else "cuda"
    on_card = torch.device(device).type == "cuda"
    if on_card and join and not getattr(args, "no_set_device_rank", False):
        device = f"cuda:{local_rank}"
        torch.cuda.set_device(local_rank)
    if join and not dist.is_initialized():
        backend = getattr(args, "dist_backend", None) or (
            "nccl" if on_card else "gloo")
        dist.init_process_group(backend, init_method=url, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(minutes=30))
        logging.info("torch.distributed initialized (%s): rank %d/%d",
                     backend, rank, world)
    info = {"world_size": world, "rank": rank, "local_rank": local_rank,
            "distributed": join, "device_count": world}
    layout = init_mesh(getattr(args, "model_parallel", 1) or 1)
    info.update(data_size=layout["data"], data_rank=layout["data_rank"],
                model_size=layout["model"], model_rank=layout["model_rank"])
    if args is not None:
        args.data_size, args.data_rank = layout["data"], layout["data_rank"]
        args.model_size = layout["model"]
        args.model_rank = layout["model_rank"]
        args.distributed = info["distributed"]
        args.world_size = world
        args.rank = rank
        args.local_rank = local_rank
        args.device_count = world
        args.device = device
    return info


def is_master(args=None) -> bool:
    """Rank 0 (JAX's ``process_index() == 0``)."""
    return rank() == 0


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The process count (the data axis times the model axis)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _object_device():
    """Where the object collectives stage their bytes: NCCL moves only
    CUDA tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (reference
    distributed.py:198-208): pickled, its length broadcast, then the
    bytes. One process: ``obj`` itself."""
    if world_size() == 1:
        return obj
    dev = _object_device()
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                               dtype=torch.uint8)
    n = torch.tensor([payload.numel() if rank() == src else 0],
                     dtype=torch.int64, device=dev)
    dist.broadcast(n, src)
    buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=dev)
    if rank() == src:
        buf.copy_(payload)
    dist.broadcast(buf, src)
    return pickle.loads(buf.cpu().numpy().tobytes())


def all_gather_object(obj) -> list:
    """One object of each rank, in rank order (reference
    distributed.py:211-218): pickled, padded to the longest, gathered.
    One process: ``[obj]``."""
    if world_size() == 1:
        return [obj]
    dev = _object_device()
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                               dtype=torch.uint8).to(dev)
    n = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    sizes = [torch.zeros_like(n) for _ in range(world_size())]
    dist.all_gather(sizes, n)
    longest = int(max(s.item() for s in sizes))
    buf = torch.zeros(longest, dtype=torch.uint8, device=dev)
    buf[:payload.numel()] = payload
    parts = [torch.empty_like(buf) for _ in range(world_size())]
    dist.all_gather(parts, buf)
    return [pickle.loads(p[:int(s.item())].cpu().numpy().tobytes())
            for p, s in zip(parts, sizes)]


# the (data, model) layout of init_mesh: sizes, this rank's indices, and
# its two process groups (None: the default group, or no model group)
_MESH = {"model": 1, "model_rank": 0, "data_group": None,
         "model_group": None, "data": None, "data_rank": None}


def init_mesh(model_parallel: int = 1) -> dict:
    """Lay the process group out as a (world / N data) x (N model) grid
    (module doc) and make each rank's data and model groups. Every rank
    calls it, in the same order as its other group constructors. Raises
    where N does not divide the world size (JAX's assert,
    core/mesh.py:121). Returns ``{"data", "model", "data_rank",
    "model_rank"}``."""
    n = int(model_parallel or 1)
    world, r = world_size(), rank()
    if n < 1 or world % n:
        raise ValueError(
            f"--model-parallel {n} does not divide the world size {world}: "
            "the (data, model) mesh needs world = data x model")
    data = world // n
    data_group = model_group = None
    if dist.is_initialized() and n > 1:
        for m in range(n):
            g = dist.new_group([d * n + m for d in range(data)])
            if r % n == m:
                data_group = g
        for d in range(data):
            g = dist.new_group([d * n + m for m in range(n)])
            if r // n == d:
                model_group = g
    _MESH.update(model=n, model_rank=r % n, data=data, data_rank=r // n,
                 data_group=data_group, model_group=model_group)
    return {"data": data, "model": n, "data_rank": r // n,
            "model_rank": r % n}


def model_size() -> int:
    """N, the model axis's size (1 before ``init_mesh``)."""
    return _MESH["model"]


def model_rank() -> int:
    return _MESH["model_rank"]


def model_group():
    """This rank's model group (None at model size 1)."""
    return _MESH["model_group"]


def data_size() -> int:
    """The data axis's size: the world size over N, the unit the train
    split is divided by."""
    return world_size() // model_size() if _MESH["data"] is None \
        else _MESH["data"]


def data_rank() -> int:
    return rank() // model_size() if _MESH["data_rank"] is None \
        else _MESH["data_rank"]


def data_group():
    """This rank's data group (None: the default group)."""
    return _MESH["data_group"]


def data_global_rank(index: int) -> int:
    """The global rank of data index ``index`` in this rank's data
    group."""
    return index * model_size() + model_rank()


def data_size_of(args) -> int:
    """The data-parallel size ``init_distributed`` set on ``args`` (its
    world size where it set none)."""
    return getattr(args, "data_size", None) or getattr(args, "world_size", 1)


def data_rank_of(args) -> int:
    """The data rank ``init_distributed`` set on ``args`` (its rank where
    it set none)."""
    rank_ = getattr(args, "data_rank", None)
    return getattr(args, "rank", 0) if rank_ is None else rank_
