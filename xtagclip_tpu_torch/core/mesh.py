"""The launcher's process identity (port of xtagclip_tpu/core/mesh.py:24-65).

``world_info_from_env`` and ``coordinator_from_env`` read the variables
the reference's launchers set (distributed.py:72-90), in the same family
order: torchrun, then Intel MPI's PMI, then SLURM, then Open MPI. The port
trains in one process: multi-process training (``torch.distributed``,
DDP, FSDP) is ROADMAP Queue 1 item 7, so a launch whose world size is
above 1 is refused by the train CLIs (train/params.py ``unported``) rather
than training one independent copy per process.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

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
