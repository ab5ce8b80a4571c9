"""Workers of tests/test_torch_tp.py: the port's tensor parallelism
(``--model-parallel``) on gloo ranks, and the one-process steps it is held
to.

The ranks are spawned by tests/torch_dist_worker.py's ``spawn`` (a
``file://`` rendezvous, logs to files, a timeout), running this file:

    python tests/torch_tp_worker.py <scenario> <rank> <world> <dir>

Each rank lays the world out as a (world / N data) x (N model) mesh
(core/mesh.py ``init_mesh``, N from ``inputs["model"]``), wraps the model
as the CLIs do (parallel/sharding.py ``wrap_model``: the tensor-parallel
split, then DDP or FSDP2 over the data group) and steps on its data
rank's rows of the global batch. Only torch and the port are imported.
"""

import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_dist_worker as w  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.core import mesh  # noqa: E402
from xtagclip_tpu_torch.models.clip import num_combos  # noqa: E402
from xtagclip_tpu_torch.parallel import sharding  # noqa: E402
from xtagclip_tpu_torch.train import train_state as ts  # noqa: E402
from xtagclip_tpu_torch.train.loop import make_train_step  # noqa: E402

torch.set_num_threads(1)

# the XTag ViT-B-32 geometry at toy size: head dim 64, 4 heads and an MLP
# of 4x in both towers, so the halves take the fused route and split at
# model sizes 2 and 4
CFG = dict(
    embed_dim=256, fusion_dim=256,
    vision_cfg=dict(layers=2, width=256, head_width=64, patch_size=8,
                    image_size=32),
    text_cfg=dict(context_length=16, vocab_size=1024, width=256, heads=4,
                  layers=2),
)
CFG_NAME = "torchtinytp"
# the CLIPA GAP geometry (tests/test_torch_clipa.py): 2 heads of 80, the
# non-fused route (flash attention's plain version and the fused MLP's)
GAP_CFG = dict(
    embed_dim=64,
    vision_cfg=dict(layers=2, width=160, head_width=80, patch_size=8,
                    image_size=32, pool_type="avg", final_ln_after_pool=True),
    text_cfg=dict(context_length=16, vocab_size=1024, width=128, heads=2,
                  layers=2),
)
GAP_NAME = "torchtinytpgap"
# a CoCa toy (tests/test_torch_coca.py's, with 4 vision heads): the
# decoder's cross-attention and the embed_cls tower's per-sample masks
# take the plain core
VOCAB, CTX, SOT, EOT = 200, 12, 198, 199
COCA_CFG = dict(
    embed_dim=64,
    vision_cfg=dict(layers=2, width=128, head_width=32, patch_size=8,
                    image_size=32, attentional_pool=True,
                    attn_pooler_queries=8, attn_pooler_heads=4),
    text_cfg=dict(context_length=CTX, vocab_size=VOCAB, width=64, heads=4,
                  layers=2, embed_cls=True, output_tokens=True),
    multimodal_cfg=dict(context_length=CTX, vocab_size=VOCAB, width=64,
                        heads=4, layers=2),
)
COCA_NAME = "torchtinytpcoca"
# the CoCa toy at text and decoder width 96 beside embed_dim 64 (as
# coca_base's 768 beside 512): the decoder's cross-attention takes the
# image tokens through separate q/k/v projections, split by heads
COCA_KV_CFG = dict(COCA_CFG, text_cfg=dict(COCA_CFG["text_cfg"], width=96),
                   multimodal_cfg=dict(COCA_CFG["multimodal_cfg"], width=96))
COCA_KV_NAME = "torchtinytpcocakv"
# a timm ViT image tower (vit_small: 6 heads of 64, 12 blocks) beside a
# toy text tower, split at model size 2 by its plan (parallel/sharding.py)
TIMM_CFG = dict(embed_dim=64, vision_cfg=dict(
    timm_model_name="vit_small_patch16_224", image_size=32,
    timm_model_pretrained=False, timm_pool="token", timm_proj="linear"),
    text_cfg=dict(context_length=16, vocab_size=1024, width=64, heads=2,
                  layers=1))
TIMM_NAME = "torchtinytptimm"
COCA_ARGS = {"coca": True, "coca_caption_loss_weight": 2.0,
             "coca_contrastive_loss_weight": 1.0}
GLOBAL_B = 8
# AdamW at lr 1 and eps 10 (tests/test_torch_distill.py's device at eps
# 1e3): each update is about the gradient over 10, so updates compare as
# gradients do, and an update of a leaf near 1 (an LN scale) stays well
# above fp32's rounding of the sum (at eps 1e3 one ULP of 1.0 is 1% of
# such an update)
JAX_OPT = dict(lr=1.0, eps=10.0, weight_decay=0.0)


def register(directory) -> None:
    import json

    for name, cfg in ((CFG_NAME, CFG), (GAP_NAME, GAP_CFG),
                      (COCA_NAME, COCA_CFG), (COCA_KV_NAME, COCA_KV_CFG),
                      (TIMM_NAME, TIMM_CFG)):
        path = os.path.join(str(directory), name + ".json")
        if not os.path.exists(path):  # written aside: ranks read it too
            tmp = f"{path}.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(cfg, f)
            os.replace(tmp, path)
        factory.add_model_config(path)


def global_batch(seed: int = 17) -> dict:
    """The seeded global batch (numpy): XTag rows, and CoCa captions."""
    rng = np.random.default_rng(seed)
    b = GLOBAL_B
    additional = np.zeros((b, 22), np.float32)
    for off, size in zip((0, 3, 7, 10, 14, 18), (3, 4, 3, 4, 4, 4)):
        additional[np.arange(b), off + rng.integers(0, size, b)] = 1.0
    captions = np.zeros((b, CTX), np.int64)
    for i, n in enumerate(rng.integers(2, CTX - 1, b)):
        captions[i, 0], captions[i, n + 1] = SOT, EOT
        captions[i, 1:n + 1] = rng.integers(1, SOT, n)
    return dict(
        images=rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
        table=rng.integers(1, 1000, (1, 3, num_combos(), 16)).astype(
            np.int64),
        class_ids=rng.integers(0, 3, b).astype(np.int64),
        texts=rng.integers(1, 1000, (b, 16)).astype(np.int64),
        captions=captions, additional=additional)


def init_state_dict(name: str, seed: int = 7, **kw) -> dict:
    model = factory.create_model(name, device="cpu", precision="fp32",
                                 init_seed=seed, **kw)
    return model.state_dict()


def _rows() -> np.ndarray:
    """This rank's rows: its data rank's block of the global batch."""
    b = GLOBAL_B // mesh.data_size()
    r = mesh.data_rank()
    return np.arange(r * b, (r + 1) * b)


def digest(sd: dict) -> dict:
    """{name: sha256 of the tensor's bytes}: a state compared bit for bit
    without carrying it."""
    import hashlib

    return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy()
                              .tobytes()).hexdigest() for k, v in sd.items()}


def step(init_sd: dict, batch_np: dict, kind: str = "xtag",
         opt: str = "adamw", fsdp: bool = False, opt_kw=None,
         ckpt: str = None, grads: bool = True) -> dict:
    """One deterministic step of ``kind`` (``xtag``: CFG with tagging and
    fusion; ``clip``: CFG's contrastive step; ``gap``, ``coca``,
    ``coca_kv``, ``timm``) from
    ``init_sd`` on this rank's rows: the metrics, the whole parameters
    and (``grads``) gradients, and the shards' sizes. With ``ckpt`` the
    state is saved there after the step (a collective; rank 0 writes),
    stepped once more, and only the saved parameters' ``digest`` and the
    next step's fingerprint are returned."""
    name = {"xtag": CFG_NAME, "clip": CFG_NAME, "gap": GAP_NAME,
            "coca": COCA_NAME, "coca_kv": COCA_KV_NAME,
            "timm": TIMM_NAME}[kind]
    extra = {"use_tagging": True, "use_fusion": True} if kind == "xtag" \
        else {}
    model = factory.create_model(name, device="cpu", precision="fp32",
                                 **extra)
    model.load_state_dict(init_sd)
    ddp = sharding.wrap_model(model, SimpleNamespace(fsdp=fsdp)) \
        if dist.is_initialized() else None
    kw = {"weight_decay": 0.1, **(opt_kw or {})}
    lr = kw.pop("lr", 1e-3)
    tx = ts.make_optimizer(lambda _: lr, params=dict(model.named_parameters()),
                           opt=opt, **kw)
    state = ts.create_train_state(model, tx, ddp)
    take = _rows() if dist.is_initialized() else np.arange(GLOBAL_B)
    cfg = {"world_size": mesh.data_size(), "rank": mesh.data_rank()}
    keys = {"xtag": ("images", "class_ids", "additional"),
            "clip": ("images", "texts"), "gap": ("images", "texts"),
            "coca": ("images", "captions"),
            "coca_kv": ("images", "captions"),
            "timm": ("images", "texts")}[kind]
    batch = {k: torch.from_numpy(batch_np[k][take]) for k in keys}
    if kind.startswith("coca"):
        batch["texts"] = batch.pop("captions")
        cfg.update(COCA_ARGS)
    if kind == "xtag":
        cfg["use_tagging_loss"] = True
        fn = make_train_step(cfg, prompt_table=torch.from_numpy(
            batch_np["table"]), deterministic=True)
    else:
        fn = make_train_step(cfg, deterministic=True)
    state, metrics = fn(state, batch, None)
    if ckpt is not None:
        from xtagclip_tpu_torch.train.checkpoint import (
            CheckpointManager,
            state_tree,
        )

        saved = digest(sharding.full_state_dict(model))
        CheckpointManager(ckpt, write=mesh.rank() == 0).save_epoch(
            1, state_tree(state, 0))
        dist.barrier()
        state, _ = fn(state, batch, None)
        return {"params": saved, "straight": w.fingerprint(
            sharding.full_state_dict(model))}
    shards = sharding.model_shards(model)
    out = {"metrics": {k: v.item() for k, v in metrics.items()},
           "params": w._copy(sharding.full_state_dict(model)),
           "sharded": sorted(shards)}
    if grads:
        out["grads"] = {n: sharding.full(p.grad, shards.get(n)).clone()
                        for n, p in model.named_parameters()
                        if p.grad is not None}
    if dist.is_initialized():
        # each rank's share of a sharded leaf: its parameter and AdamW
        # moment (FSDP's piece of it under --fsdp)
        out["local_numel"] = {
            n: sharding.local(p).numel()
            for n, p in model.named_parameters() if n in shards}
        moments = tx.optimizer.state
        out["moment_numel"] = {
            n: sharding.local(moments[p]["exp_avg"]).numel()
            for n, p in model.named_parameters()
            if n in shards and "exp_avg" in moments.get(p, {})}
    return out


def resume(ckpt: str, init_sd: dict, batch_np: dict,
           opt: str = "adamw") -> dict:
    """The XTag state of ``ckpt`` (written by ``step`` with ``opt``)
    restored under this process's layout and stepped once on its rows:
    the restored whole parameters' ``digest`` and the stepped ones'
    fingerprint."""
    from xtagclip_tpu_torch.train.checkpoint import restore_train_state

    model = factory.create_model(CFG_NAME, device="cpu", precision="fp32",
                                 use_tagging=True, use_fusion=True)
    model.load_state_dict(init_sd)
    ddp = sharding.wrap_model(model, SimpleNamespace(fsdp=False)) \
        if dist.is_initialized() else None
    tx = ts.make_optimizer(lambda _: 1e-3, weight_decay=0.1, opt=opt,
                           params=dict(model.named_parameters()))
    state = ts.create_train_state(model, tx, ddp)
    epoch = restore_train_state(ckpt, "epoch_1", state)
    restored = digest(sharding.full_state_dict(model))
    take = _rows() if dist.is_initialized() else np.arange(GLOBAL_B)
    batch = {k: torch.from_numpy(batch_np[k][take])
             for k in ("images", "class_ids", "additional")}
    fn = make_train_step({"use_tagging_loss": True,
                          "world_size": mesh.data_size(),
                          "rank": mesh.data_rank()},
                         prompt_table=torch.from_numpy(batch_np["table"]),
                         deterministic=True)
    state, _ = fn(state, batch, None)
    return {"epoch": epoch, "restored": restored,
            "stepped": w.fingerprint(sharding.full_state_dict(model))}


def block_bf16(seed: int, route: str) -> dict:
    """A bf16 ``ResidualAttentionBlock`` forward and backward with the
    kernels on (their plain versions on the CPU: the tensor-parallel
    Functions on the partial modes), whole in one process or sharded
    here: the output and the input's and weights' whole gradients."""
    from xtagclip_tpu_torch.models.layers import ResidualAttentionBlock

    width, heads, l = (256, 4, 17) if route == "fused_halves" else \
        (160, 2, 40)
    gen = torch.Generator().manual_seed(seed)
    blk = ResidualAttentionBlock(width, heads)
    with torch.no_grad():
        for n, p in blk.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen)
                    * (0.1 if n.endswith("scale") else 0.05)
                    + (1.0 if n.endswith("scale") else 0.0))
    x = torch.randn((2, l, width), generator=gen).bfloat16()
    x.requires_grad_(True)
    if dist.is_initialized():
        sharding.shard_tensor_parallel(blk)
    assert blk.route(x.shape) == route
    y = blk(x)
    g = torch.randn(y.shape, generator=gen).bfloat16()
    y.backward(g)
    shards = sharding.model_shards(blk)
    return {"y": y.detach().float(), "dx": x.grad.float(),
            "grads": {n: sharding.full(p.grad, shards.get(n)).float()
                      for n, p in blk.named_parameters()}}


# scar's XTag CLI at toy size (tests/test_torch_trainer.py's text tower:
# the real vocabulary, width 512), 4 heads in each tower (model sizes 2
# and 4 divide them)
CLI_CFG = dict(
    embed_dim=512,
    vision_cfg=dict(layers=1, width=256, head_width=64, patch_size=16,
                    image_size=32),
    text_cfg=dict(context_length=77, vocab_size=49408, width=512, heads=4,
                  layers=1),
)
CLI_NAME = "torchtinytpcli"


def cli_argv(entry: str, data: dict, logs: str, name: str) -> list:
    """``main_other``'s scar flags (train and val) or ``cli.main``'s on
    synthetic data, fp32 on the CPU, for ``CLI_NAME``."""
    common = ["--model", CLI_NAME, "--precision", "fp32", "--lr", "1e-4",
              "--warmup", "1", "--logs", logs, "--name", name,
              "--log-every-n-steps", "1", "--workers", "1", "--device",
              "cpu", "--seed", "3"]
    if entry == "main":
        return common + ["--dataset-type", "synthetic", "--train-num-samples",
                         "16", "--batch-size", str(data["batch"]),
                         "--epochs", "1"]
    root, csv = data["root"], data["csv"]
    return common + ["--train-data", root, "--val-data", root,
                     "--scar-train-csv", csv, "--scar-val-csv", csv,
                     "--dataset-type", "csv", "--batch-size",
                     str(data["batch"]), "--use-tagging", "--use-fusion",
                     "--epochs", "1", "--val-frequency", "1"]


def run_cli(entry: str, argv: list) -> dict:
    """The CLI's per-step losses and eval metrics (numbers only). The train
    transform draws its crops from an unseeded ``random.Random`` (one
    loader thread, items in order): seeded here, so that two runs crop
    alike."""
    import random

    from xtagclip_tpu_torch.cli import main as cli_main
    from xtagclip_tpu_torch.cli import main_other
    from xtagclip_tpu_torch.train.logger import close_logging

    real_random = random.Random

    class SeededRandom(real_random):
        def __init__(self, x=0):
            super().__init__(x)

    random.Random = SeededRandom
    try:
        out = {"main": cli_main.main, "main_other": main_other.main}[entry](
            argv)
    finally:
        random.Random = real_random
        close_logging()
    ep = out["epochs"][-1]
    return {"losses": ep["train"]["losses"],
            "eval": {k: float(v) for k, v in ep["eval"].items()
                     if isinstance(v, (int, float))},
            "sharded": sorted(sharding.model_shards(out["state"].model))}


def scenario_cli(inputs, directory):
    """A train CLI as a launcher starts it: each rank's RANK, WORLD_SIZE
    and LOCAL_RANK set, the group already joined (``init_distributed``
    keeps it), ``--model-parallel`` from ``inputs["model"]``."""
    register(inputs["cfg_dir"])
    factory.add_model_config(os.path.join(inputs["cfg_dir"],
                                          CLI_NAME + ".json"))
    r, world = dist.get_rank(), dist.get_world_size()
    os.environ.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r))
    argv = cli_argv(inputs["entry"], inputs["data"],
                    os.path.join(directory, "logs"), "tp") + [
        "--model-parallel", str(inputs["model"]), "--dist-url",
        "file://" + os.path.join(directory, "unused")]
    return run_cli(inputs["entry"], argv)


def scenario_tp(inputs, directory):
    """Every case of ``inputs["cases"]`` ((label, kwargs of ``step``),
    ...), then, where asked, the checkpoints resumed ((label, directory,
    optimizer), ...) and the bf16 blocks."""
    mesh.init_mesh(inputs["model"])
    register(inputs["cfg_dir"])
    out = {}
    for label, kw in inputs["cases"]:
        out[label] = step(inputs["init"][kw.get("kind", "xtag")],
                          inputs["batch"], **kw)
    for label, ckpt, opt in inputs.get("resume", ()):
        out[label] = resume(ckpt, inputs["init"]["xtag"], inputs["batch"],
                            opt)
    for route in inputs.get("blocks", ()):
        out[route] = block_bf16(5, route)
    return out


if __name__ == "__main__":
    w.main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           scenarios={"tp": scenario_tp, "cli": scenario_cli})
