"""Workers of the port's multi-process tests (tests/test_torch_dp.py,
test_torch_fsdp.py, test_torch_siglip_ring.py, test_torch_bn_sync.py,
test_torch_dist.py), and the one-process references they are held to.

A test spawns W processes of this file, each running

    python tests/torch_dist_worker.py <scenario> <rank> <world> <dir>

with a gloo process group through a ``file://`` rendezvous in ``<dir>``
(no TCP port, so parallel test workers never race for one). Each rank
reads ``<dir>/inputs.pt`` and writes ``<dir>/out_<rank>.pt``. The workers
import torch and the port only, never JAX, and run on one thread. The
same functions, called in the parent without a process group, give the
one-process step on the concatenated batch.
"""

import datetime
import json
import os
import subprocess
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.models.clip import num_combos  # noqa: E402
from xtagclip_tpu_torch.parallel import sharding  # noqa: E402
from xtagclip_tpu_torch.train import train_state as ts  # noqa: E402
from xtagclip_tpu_torch.train.loop import (  # noqa: E402
    make_accum_train_step,
    make_train_step,
)

# the tests/test_torch_train.py geometry: head dim 64 in both towers
CFG = dict(
    embed_dim=64,
    fusion_dim=64,
    vision_cfg=dict(layers=2, width=64, head_width=64, patch_size=8,
                    image_size=32),
    text_cfg=dict(context_length=16, vocab_size=1024, width=64, heads=1,
                  layers=2),
)
CFG_NAME = "torchtinydist"
GLOBAL_B = 8
OPTS = ("adamw", "adam", "sgd", "lion", "adafactor")


def register(directory) -> str:
    path = os.path.join(str(directory), CFG_NAME + ".json")
    if not os.path.exists(path):  # written aside: other ranks read it
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(CFG, f)
        os.replace(tmp, path)
    factory.add_model_config(path)
    return CFG_NAME


def global_batch(seed: int = 91) -> dict:
    """The seeded global batch of the XTag step (numpy)."""
    rng = np.random.default_rng(seed)
    b = GLOBAL_B
    additional = np.zeros((b, 22), np.float32)
    for off, size in zip((0, 3, 7, 10, 14, 18), (3, 4, 3, 4, 4, 4)):
        additional[np.arange(b), off + rng.integers(0, size, b)] = 1.0
    return dict(
        images=rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
        table=rng.integers(1, 1000, (1, 3, num_combos(), 16)).astype(
            np.int64),
        class_ids=rng.integers(0, 3, b).astype(np.int64),
        additional=additional)


def rows(world: int, rank: int, accum: int) -> np.ndarray:
    """This rank's rows of the global batch: a contiguous block, or with
    ``accum`` microbatches, its block of each microbatch, so that the
    gathered microbatch i is the one-process microbatch i."""
    b = GLOBAL_B // world
    if accum == 1:
        return np.arange(rank * b, (rank + 1) * b)
    mb = b // accum
    return np.concatenate([np.arange(i * GLOBAL_B // accum + rank * mb,
                                     i * GLOBAL_B // accum + (rank + 1) * mb)
                           for i in range(accum)])


def _copy(sd: dict) -> dict:
    """A state dict's tensors copied: a whole parameter's entry is the
    live tensor, which the next step changes."""
    return {k: v.clone() for k, v in sd.items()}


def xtag_step(init_sd: dict, batch_np: dict, opt: str = "adamw",
              accum: int = 1, fsdp: bool = False) -> dict:
    """One deterministic XTag step (tagging + fusion) from ``init_sd`` on
    this rank's share of ``batch_np``: the metrics and the whole updated
    parameters."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    model = factory.create_model(CFG_NAME, device="cpu", precision="fp32",
                                 use_tagging=True, use_fusion=True)
    model.load_state_dict(init_sd)
    ddp = sharding.wrap_model(model, SimpleNamespace(fsdp=fsdp))
    named = dict(model.named_parameters())
    tx = ts.make_optimizer(lambda step: 1e-3, weight_decay=0.1,
                           params=named, opt=opt)
    state = ts.create_train_state(model, tx, ddp)
    take = rows(world, rank, accum)
    batch = {k: torch.from_numpy(batch_np[k][take])
             for k in ("images", "class_ids", "additional")}
    table = torch.from_numpy(batch_np["table"])
    cfg = {"use_tagging_loss": True, "world_size": world, "rank": rank}
    if accum > 1:
        batch = {k: v.reshape((accum, -1) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        step = make_accum_train_step(cfg, accum, prompt_table=table,
                                     deterministic=True)
    else:
        step = make_train_step(cfg, prompt_table=table, deterministic=True)
    state, metrics = step(state, batch, None)
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "params": _copy(sharding.full_state_dict(model)),
            "grads": {n: sharding.full(p.grad) for n, p in
                      model.named_parameters() if p.grad is not None},
            "placements": {n: (p.placements[0].dim
                               if sharding.is_sharded(p) else None)
                           for n, p in model.named_parameters()}}


def init_state_dict(directory) -> dict:
    register(directory)
    model = factory.create_model(CFG_NAME, device="cpu", precision="fp32",
                                 use_tagging=True, use_fusion=True,
                                 init_seed=7)
    return model.state_dict()


# ---- the bars a step is held to ---------------------------------------------

def fingerprint(sd: dict) -> float:
    """Sum of |p| over every parameter, in fp64 (JAX's fingerprint,
    tests/two_process_worker.py)."""
    return float(sum(v.double().abs().sum() for v in sd.values()))


def metric_errors(got: dict, ref: dict) -> dict:
    return {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in ref}


def grad_errors(got: dict, ref: dict, grad_norm: float) -> dict:
    """Per parameter: 1 - cosine of the two gradients; for a gradient that
    is zero in exact arithmetic (below 1e-6 of the global norm in both,
    e.g. a key bias under softmax), its size over the global norm."""
    out = {}
    for k, r in ref.items():
        a, r = got[k].double().flatten(), r.double().flatten()
        na, nr = a.norm().item(), r.norm().item()
        if max(na, nr) < 1e-6 * grad_norm:
            out[k] = max(na, nr) / grad_norm
        else:
            out[k] = 1.0 - (a @ r).item() / max(na * nr, 1e-300)
    return out


def check_term(ranks: list, ref: dict, name: str) -> None:
    """Loss term ``name`` of ``loss_terms`` across ``ranks`` against the
    one-process ``ref``: the mean of the ranks' losses within 1e-5
    relative; each input's gradient of that mean (a rank's gradient of
    its rows, or the mean of the shared scales', over the world size)
    within 1e-5 of the largest entry."""
    world = len(ranks)
    ref_loss, ref_grads = ref[name]
    mean = sum(r["terms"][name][0] for r in ranks) / world
    assert abs(mean - ref_loss) <= 1e-5 * abs(ref_loss), (mean, ref_loss)
    per = [r["terms"][name][1] for r in ranks]
    assert set(per[0]) == set(ref_grads)
    for k, g in ref_grads.items():
        if k in SHARED:
            got = sum(p[k] for p in per) / world
        else:
            got = torch.cat([p[k] for p in per]) / world
        err = (got - g).abs().max() / g.abs().max().clamp_min(1e-12)
        assert err <= 1e-5, (name, k, err.item())


# ---- scenarios: each returns what its rank writes ---------------------------

def scenario_dp(inputs, directory):
    """DDP: the plain and the accumulation step."""
    return {"plain": xtag_step(inputs["init"], inputs["batch"]),
            "accum": xtag_step(inputs["init"], inputs["batch"], accum=2)}


def scenario_fsdp(inputs, directory):
    """DDP and FSDP for each optimizer, FSDP's accumulation step, and an
    FSDP checkpoint resumed at 2 ranks and (on rank 0, without a process
    group's wrap) at 1."""
    out = {}
    for opt in OPTS:
        for fsdp in (False, True):
            out[(opt, fsdp)] = xtag_step(inputs["init"], inputs["batch"],
                                         opt=opt, fsdp=fsdp)
    out["accum"] = xtag_step(inputs["init"], inputs["batch"], accum=2,
                             fsdp=True)
    out["checkpoint"] = checkpoint_round_trip(inputs, directory)
    return out


def _fsdp_state(init_sd, fsdp: bool = True):
    model = factory.create_model(CFG_NAME, device="cpu", precision="fp32",
                                 use_tagging=True, use_fusion=True)
    model.load_state_dict(init_sd)
    if fsdp:
        sharding.fully_shard_model(model)
    tx = ts.make_optimizer(lambda step: 1e-3, weight_decay=0.1,
                           params=dict(model.named_parameters()))
    return ts.create_train_state(model, tx)


def checkpoint_round_trip(inputs, directory) -> dict:
    """Two FSDP steps from a checkpoint written after the first, against
    the same steps run straight through: the 2-rank resume; rank 0 also
    reads the checkpoint into a model of its own."""
    from xtagclip_tpu_torch.train.checkpoint import (
        CheckpointManager,
        restore_train_state,
        state_tree,
    )

    world, rank = dist.get_world_size(), dist.get_rank()
    take = rows(world, rank, 1)
    batch = {k: torch.from_numpy(inputs["batch"][k][take])
             for k in ("images", "class_ids", "additional")}
    table = torch.from_numpy(inputs["batch"]["table"])
    step = make_train_step({"use_tagging_loss": True, "world_size": world,
                            "rank": rank}, prompt_table=table,
                           deterministic=True)
    ckpt = os.path.join(directory, "ckpt")
    state = _fsdp_state(inputs["init"])
    state, _ = step(state, batch, None)
    saved = _copy(sharding.full_state_dict(state.model))
    CheckpointManager(ckpt, write=rank == 0).save_epoch(
        1, state_tree(state, 0))
    dist.barrier()
    state, _ = step(state, batch, None)
    straight = sharding.full_state_dict(state.model)
    resumed = _fsdp_state(inputs["init"])
    epoch = restore_train_state(ckpt, "epoch_1", resumed)
    restored = _copy(sharding.full_state_dict(resumed.model))
    resumed.step = 1
    resumed, _ = step(resumed, batch, None)
    out = {"epoch": epoch, "saved": saved, "restored": restored,
           "straight": straight,
           "resumed": sharding.full_state_dict(resumed.model)}
    if rank == 0:
        one = _fsdp_state(inputs["init"], fsdp=False)
        restore_train_state(ckpt, "epoch_1", one)
        out["one_rank"] = one.model.state_dict()
        out["one_rank_moments"] = one.tx.optimizer.state_dict()["state"]
    return out


# ---- losses: each rank's term and its gradients ----------------------------

TEACHER = ("t_img", "t_txt", "t_scale")  # no gradient, as in the step
SHARED = ("scale", "bias", "t_scale")  # whole on every rank


def _leaves(arrays: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).requires_grad_(
        np.asarray(v).dtype.kind == "f" and k not in TEACHER)
        for k, v in arrays.items()}


def _local(t, world, rank):
    b = t.shape[0] // world
    return t[rank * b:(rank + 1) * b].detach().requires_grad_(
        t.requires_grad)


def loss_terms(arrays: dict, world: int = 1, rank: int = 0) -> dict:
    """Every cross-rank loss of losses/ on this rank's rows of
    ``arrays`` (the whole arrays in one process): {name: (loss, {input:
    gradient})}. Features and logits are rows; scales are shared."""
    from xtagclip_tpu_torch.losses import (
        caption_loss,
        clip_loss,
        distill_loss,
        siglip_loss,
    )

    full_t = _leaves(arrays)

    def fresh():
        return {k: (v.detach().requires_grad_(v.requires_grad)
                    if k in SHARED else _local(v, world, rank))
                for k, v in full_t.items()}

    cases = {}
    for local_loss in (False, True):
        cases[f"clip_local{int(local_loss)}"] = lambda t, ll=local_loss: \
            clip_loss(t["img"], t["txt"], t["scale"], ll, world, rank)
        cases[f"distill_local{int(local_loss)}"] = lambda t, ll=local_loss: \
            distill_loss(t["img"], t["txt"], t["scale"], t["t_img"],
                         t["t_txt"], t["t_scale"], ll, world, rank)
    cases["caption"] = lambda t: caption_loss(t["logits"], t["labels"], 0,
                                              world)
    for impl in ("shift", "bidir", "reduce", "gather"):
        cases[f"siglip_{impl}"] = lambda t, i=impl: siglip_loss(
            t["img"], t["txt"], t["scale"], t["bias"], i, world, rank)
    out = {}
    for name, fn in cases.items():
        t = fresh()
        loss = fn(t)
        loss.backward()
        out[name] = (loss.item(), {k: v.grad.clone() for k, v in t.items()
                                   if v.grad is not None})
    return out


def loss_arrays(rows_: int, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)

    def unit(n, d):
        x = rng.standard_normal((n, d))
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(
            np.float32)

    labels = rng.integers(1, 50, (rows_, 7))
    labels[rng.random((rows_, 7)) < 0.3] = 0  # pads, unevenly per rank
    return dict(img=unit(rows_, 16), txt=unit(rows_, 16),
                t_img=unit(rows_, 16), t_txt=unit(rows_, 16),
                scale=np.float32(10.0), t_scale=np.float32(14.0),
                bias=np.float32(-3.0),
                logits=rng.standard_normal((rows_, 7, 50)).astype(np.float32),
                labels=labels.astype(np.int64))


def scenario_losses(inputs, directory):
    from xtagclip_tpu_torch.core import mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    return {"terms": loss_terms(inputs["arrays"], world, rank),
            "broadcast": mesh.broadcast_object(
                {"resume": f"/ckpt/from_rank_{rank}", "n": [rank] * 3}),
            "gathered": mesh.all_gather_object("x" * (rank + 1) * 50),
            "is_master": mesh.is_master(), "world": mesh.world_size()}


# ---- BatchNorm statistics across ranks ----------------------------------

RN_CFG = dict(embed_dim=32,
              vision_cfg=dict(layers=[1, 1, 1, 1], width=16, image_size=64),
              text_cfg=dict(context_length=16, vocab_size=1000, width=64,
                            heads=1, layers=1))
RN_NAME = "torchtinydistrn"


def register_rn(directory) -> str:
    path = os.path.join(str(directory), RN_NAME + ".json")
    if not os.path.exists(path):
        with open(path, "w") as f:
            json.dump(RN_CFG, f)
    factory.add_model_config(path)
    return RN_NAME


def rn_batch(seed: int = 13) -> dict:
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((GLOBAL_B, 64, 64, 3)).astype(
                np.float32) * 2.0 + 0.5,
            "texts": rng.integers(1, 999, (GLOBAL_B, 16)).astype(np.int64)}


def bn_step(init_sd: dict, batch_np: dict, use_bn_sync: bool,
            freeze: bool = False) -> dict:
    """One train step of the toy RN CLIP (its BatchNorms on batch
    statistics) on this rank's rows: loss, the statistics after it and the
    updated parameters."""
    from xtagclip_tpu_torch.convert.from_jax import stats_buffers

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    register_rn(batch_np["dir"])
    model = factory.create_model(RN_NAME, device="cpu", precision="fp32",
                                 use_bn_sync=use_bn_sync)
    model.load_state_dict(init_sd)
    ddp = sharding.wrap_model(model, SimpleNamespace(fsdp=False))
    tx = ts.make_optimizer(lambda step: 1e-3, weight_decay=0.1,
                           params=dict(model.named_parameters()))
    state = ts.create_train_state(model, tx, ddp)
    take = rows(world, rank, 1)
    batch = {k: torch.from_numpy(batch_np[k][take])
             for k in ("images", "texts")}
    step = make_train_step({"use_tagging_loss": False, "world_size": world,
                            "rank": rank, "lock_image_freeze_bn_stats":
                            freeze})
    gen = torch.Generator().manual_seed(0)
    state, metrics = step(state, batch, gen)
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "stats": {k: v.clone() for k, v in stats_buffers(model).items()},
            "params": _copy(model.state_dict()),
            "sync": [m.sync for m in model.modules()
                     if type(m).__name__ == "BatchNorm"]}


def rn_init(directory) -> dict:
    register_rn(directory)
    model = factory.create_model(RN_NAME, device="cpu", precision="fp32",
                                 init_seed=3)
    return model.state_dict()


def scenario_bn(inputs, directory):
    batch = {**inputs["batch"], "dir": directory}
    return {(sync, freeze): bn_step(inputs["init"], batch, sync, freeze)
            for sync in (False, True) for freeze in (False, True)}


SCENARIOS = {"dp": scenario_dp, "fsdp": scenario_fsdp,
             "losses": scenario_losses, "bn": scenario_bn}


def main(scenario: str, rank: int, world: int, directory: str,
         scenarios: dict = None) -> None:
    """Run ``scenario`` (of ``scenarios``, by default this file's) on this
    rank and save what it returns."""
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(directory, "rdv"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120))
    try:
        inputs = torch.load(os.path.join(directory, "inputs.pt"),
                            weights_only=False)
        register(directory)
        out = (scenarios or SCENARIOS)[scenario](inputs, directory)
        torch.save(out, os.path.join(directory, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(scenario: str, world: int, directory, inputs: dict,
          timeout: float = 240.0, script: str = __file__) -> list:
    """Run ``scenario`` of ``script`` (a worker file whose ``__main__``
    calls ``main``) on ``world`` ranks; returns each rank's output.
    Raises on a worker's failure or on the timeout (killing them all)."""
    directory = str(directory)
    torch.save(inputs, os.path.join(directory, "inputs.pt"))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    logs = [os.path.join(directory, f"log_{r}.txt") for r in range(world)]
    procs = []
    for r in range(world):  # logs to files: a full pipe would stall a rank
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(script), scenario, str(r),
                 str(world), directory], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{scenario} on {world} ranks timed out after "
                           f"{timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errors = [f"rank {r} exited {p.returncode}:\n"
              f"{open(logs[r]).read()[-3000:]}"
              for r, p in enumerate(procs) if p.returncode != 0]
    if errors:
        raise RuntimeError("\n".join(errors))
    return [torch.load(os.path.join(directory, f"out_{r}.pt"),
                       weights_only=False) for r in range(world)]


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
