"""The port's process group and cross-rank pieces on the CPU: the
loader's rank split against JAX's ``DataLoader._indices``,
``init_distributed`` against the launcher variables,
``broadcast_object`` and ``all_gather_object`` across 2 ranks, and the
contrastive, distillation and caption losses across 2 ranks against the
one-process loss of the concatenated batch.

One spawn of tests/torch_dist_worker.py (gloo, 2 ranks) runs the object
collectives and every loss. Loss bars: the mean over ranks of the ranks'
losses within 1e-5 relative of the global loss; each rank's gradients of
its rows over the world size within 1e-5 of the global gradients' largest
entry (the gathers carry the other ranks' terms back; JAX's gathers
differentiate too, so ``--gather-with-grad`` changes nothing).
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_dist_worker as w  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401
from xtagclip_tpu.data.loader import DataLoader as JaxDataLoader
from xtagclip_tpu_torch.core import mesh
from xtagclip_tpu_torch.data.loader import DataLoader

torch.set_num_threads(1)

WORLD = 2
LAUNCH_VARS = mesh.WORLD_SIZE_VARS + mesh.RANK_VARS + mesh.LOCAL_RANK_VARS + (
    "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MASTER_ADDR",
    "MASTER_PORT", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    arrays = w.loss_arrays(4 * WORLD)
    ranks = w.spawn("losses", WORLD, tmp_path_factory.mktemp("dist"),
                    {"arrays": arrays})
    return {"ranks": ranks, "ref": w.loss_terms(arrays)}


@pytest.mark.parametrize("name", ["clip_local0", "clip_local1",
                                  "distill_local0", "distill_local1",
                                  "caption"])
def test_loss_across_ranks_matches_one_process(run, name):
    w.check_term(run["ranks"], run["ref"], name)


def test_broadcast_object_sends_rank_zeros(run):
    for r in run["ranks"]:
        assert r["broadcast"] == {"resume": "/ckpt/from_rank_0",
                                  "n": [0, 0, 0]}


def test_all_gather_object_gathers_in_rank_order(run):
    want = ["x" * 50, "x" * 100]
    for i, r in enumerate(run["ranks"]):
        assert r["gathered"] == want
        assert r["is_master"] == (i == 0) and r["world"] == WORLD


def test_object_collectives_are_identity_in_one_process():
    assert mesh.broadcast_object({"a": 1}) == {"a": 1}
    assert mesh.all_gather_object([3]) == [[3]]
    assert mesh.is_master() and mesh.world_size() == 1


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.int64(i)


@pytest.mark.parametrize("n", [17, 20, 23])
@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_rank_split_is_jax(n, world, drop_last):
    for rank in range(world):
        kw = dict(batch_size=3, shuffle=True, drop_last=drop_last, seed=5,
                  rank=rank, world_size=world)
        port, jax_loader = DataLoader(_Items(n), **kw), \
            JaxDataLoader(_Items(n), **kw)
        for epoch in (0, 1):
            port.set_epoch(epoch)
            jax_loader.set_epoch(epoch)
            np.testing.assert_array_equal(port._indices(),
                                          jax_loader._indices())
        assert len(port) == len(jax_loader)
        assert port.num_samples == jax_loader.num_samples
        got = np.concatenate([b for b in port])
        np.testing.assert_array_equal(got, port._indices())


def test_loader_ranks_cover_the_epoch():
    parts = [DataLoader(_Items(23), 4, shuffle=True, seed=1, rank=r,
                        world_size=3)._indices() for r in range(3)]
    assert sorted(set(np.concatenate(parts))) == list(range(23))


@pytest.fixture
def launch_env(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    calls = []
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    return monkeypatch, calls


@pytest.mark.parametrize("env,joins,rank,world", [
    ({}, False, 0, 1),
    ({"WORLD_SIZE": "1"}, False, 0, 1),  # no coordinator: one process
    ({"WORLD_SIZE": "1", "RANK": "0", "MASTER_ADDR": "localhost",
      "MASTER_PORT": "29511"}, True, 0, 1),  # torchrun --nproc_per_node 1
    ({"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1",
      "MASTER_ADDR": "h0"}, True, 3, 4),
    ({"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1", "SLURM_NTASKS": "8",
      "SLURM_PROCID": "5", "JAX_COORDINATOR_ADDRESS": "h1:99"}, True, 1, 2),
])
def test_init_distributed_reads_the_launcher(launch_env, env, joins, rank,
                                             world):
    monkeypatch, calls = launch_env
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = SimpleNamespace(device="cpu", dist_url=None, dist_backend=None)
    info = mesh.init_distributed(args)
    assert bool(calls) == joins
    assert (args.rank, args.world_size, args.distributed) == (rank, world,
                                                              joins)
    assert info["world_size"] == world and args.device == "cpu"
    if joins:
        (backend,), kw = calls[0]
        assert backend == "gloo"
        assert (kw["rank"], kw["world_size"]) == (rank, world)
        assert kw["init_method"].startswith("tcp://")


def test_init_distributed_needs_a_coordinator_above_one(launch_env):
    monkeypatch, calls = launch_env
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="coordinator"):
        mesh.init_distributed(SimpleNamespace(device="cpu", dist_url=None))
    args = SimpleNamespace(device="cpu", dist_url="file:///tmp/x",
                           dist_backend="gloo")
    mesh.init_distributed(args)
    assert calls[0][1]["init_method"] == "file:///tmp/x"


def test_workers_import_no_jax():
    """A spawned rank imports torch and the port only."""
    code = ("import json, sys\n"
            f"sys.path.insert(0, {os.path.dirname(__file__)!r})\n"
            "import torch_dist_worker\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'xtagclip_tpu'))\n"
            "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []

