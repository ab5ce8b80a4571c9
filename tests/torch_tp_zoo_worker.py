"""Workers of tests/test_torch_tp_zoo.py: ``--model-parallel`` over every
tower family that is not built from ``ResidualAttentionBlock``s, on gloo
ranks, and the one-process steps it is held to.

Each family is a toy tower (width 64, 4 heads, 1-2 blocks or stages,
vocabulary 1024) in a CLIP whose other tower is a toy
``ResidualAttentionBlock`` one. The ranks are spawned by
tests/torch_dist_worker.py's ``spawn``, running this file:

    python tests/torch_tp_zoo_worker.py <scenario> <rank> <world> <dir>

Each rank lays the world out as a (world / N data) x (N model) mesh
(core/mesh.py ``init_mesh``), wraps the model as the CLIPs do
(parallel/sharding.py ``wrap_model``: the tensor-parallel split, then DDP
or FSDP2 over the data group) and takes one contrastive step on its data
rank's rows of the global batch. Only torch and the port are imported.
"""

import json
import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_dist_worker as w  # noqa: E402
from torch_tp_worker import digest  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.core import mesh  # noqa: E402
from xtagclip_tpu_torch.models import convnext, eva, fastvit, resnet, swin  # noqa: E402
from xtagclip_tpu_torch.models import timm_vit, vitamin  # noqa: E402
from xtagclip_tpu_torch.models.clip import NUM_TAGS  # noqa: E402
from xtagclip_tpu_torch.models.hf_text import HFTextEncoder  # noqa: E402
from xtagclip_tpu_torch.models.layers import Dense, Embed  # noqa: E402
from xtagclip_tpu_torch.models.tag_head import TagBertHead  # noqa: E402
from xtagclip_tpu_torch.parallel import sharding  # noqa: E402
from xtagclip_tpu_torch.train import train_state as ts  # noqa: E402
from xtagclip_tpu_torch.train.loop import make_train_step  # noqa: E402

torch.set_num_threads(1)

WIDTH, HEADS, VOCAB, CTX, IMAGE, GLOBAL_B = 64, 4, 1024, 16, 64, 8
# the other tower: ResidualAttentionBlocks at 4 heads of 16
TEXT = dict(context_length=CTX, vocab_size=VOCAB, width=WIDTH, heads=HEADS,
            layers=1)
VISION = dict(layers=1, width=WIDTH, head_width=16, patch_size=16,
              image_size=IMAGE)
# EVA's toy trunks, as the timm route builds them (JAX's too, under
# these names, for the 2 x 2 mesh step): EVA-02 with an odd SwiGLU width,
# so that its hidden slices are uneven at model size 2 (86 and 85)
EVA_TOYS = {
    "eva_tp_zoo_toy": dict(patch_size=16, width=WIDTH, layers=1,
                           heads=HEADS, mlp_hidden=128, qkv_fused=True),
    "eva02_tp_zoo_toy": dict(patch_size=16, width=WIDTH, layers=2,
                             heads=HEADS, mlp_hidden=171, swiglu=True,
                             scale_mlp=True, qkv_fused=False,
                             use_rope=True),
}
EVA_NAMES = {"eva01": "eva_tp_zoo_toy", "eva02": "eva02_tp_zoo_toy"}
# the HF text towers' config.json (read from the run's directory)
HF_CONFIGS = {
    "xlmr": dict(model_type="xlm-roberta", vocab_size=VOCAB,
                 hidden_size=WIDTH, num_hidden_layers=2,
                 num_attention_heads=HEADS, intermediate_size=128,
                 max_position_embeddings=CTX + 2),
    "t5": dict(model_type="t5", vocab_size=VOCAB, d_model=WIDTH,
               num_layers=2, num_heads=HEADS, d_kv=16, d_ff=96,
               relative_attention_num_buckets=32,
               relative_attention_max_distance=128, pad_token_id=0),
    "nllb": dict(model_type="m2m_100", vocab_size=VOCAB, d_model=WIDTH,
                 encoder_layers=2, encoder_attention_heads=HEADS,
                 encoder_ffn_dim=128, max_position_embeddings=CTX + 2,
                 pad_token_id=1, scale_embedding=True),
}
HF_KINDS = {"bert": "xlmr", "t5": "t5", "m2m100": "nllb"}
PADS = {"bert": 1, "t5": 0, "m2m100": 1}
KINDS = ("timm_map", "timm_relpos", "eva01", "eva02", "vitamin", "bert",
         "t5", "m2m100", "swin", "convnext", "fastvit", "resnet")
# AdamW at lr 1 and eps 10 (tests/torch_tp_worker.py's JAX_OPT): each
# update is about the gradient over 10
JAX_OPT = dict(lr=1.0, eps=10.0, weight_decay=0.0)


def eva_config(kind: str) -> dict:
    """The model config of ``kind``'s EVA toy (its trunk named by
    ``EVA_NAMES``)."""
    return dict(embed_dim=WIDTH, vision_cfg=dict(
        image_size=IMAGE, timm_model_name=EVA_NAMES[kind],
        timm_model_pretrained=False, timm_pool="token", timm_proj=None),
        text_cfg=TEXT)


def register(directory) -> None:
    """The base toy config and the HF config.json files, written into
    ``directory`` once and registered."""
    path = os.path.join(str(directory), "torchtinytpzoo.json")
    _write(path, dict(embed_dim=WIDTH, vision_cfg=VISION, text_cfg=TEXT))
    factory.add_model_config(path)
    for name, cfg in HF_CONFIGS.items():
        os.makedirs(os.path.join(str(directory), name), exist_ok=True)
        _write(os.path.join(str(directory), name, "config.json"), cfg)


def _write(path: str, obj) -> None:
    if not os.path.exists(path):  # written aside: other ranks read it
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)


def _tower(kind: str, directory):
    """The family's toy tower."""
    if kind in EVA_NAMES:  # the timm route's TimmModel around the trunk
        return timm_vit.TimmModel(
            eva.EvaTrunk(image_size=IMAGE, **EVA_TOYS[EVA_NAMES[kind]]),
            WIDTH, WIDTH, pool="token", proj=None)
    if kind in HF_KINDS:
        return HFTextEncoder(os.path.join(str(directory), HF_KINDS[kind]),
                             output_dim=WIDTH, proj_type="mlp",
                             pooler_type="mean_pooler")
    if kind == "timm_map":
        return timm_vit.TimmModel(
            timm_vit.TimmViT(image_size=IMAGE, patch_size=16, width=WIDTH,
                             layers=2, heads=HEADS, use_cls_token=False),
            WIDTH, WIDTH, heads=HEADS, pool="map", proj="linear")
    if kind == "timm_relpos":
        return timm_vit.TimmModel(
            timm_vit.TimmViT(image_size=IMAGE, patch_size=16, width=WIDTH,
                             layers=2, heads=HEADS, use_abs_pos=False,
                             relpos=True), WIDTH, WIDTH, heads=HEADS,
            pool="token", proj="linear")
    if kind == "vitamin":
        return timm_vit.TimmModel(
            vitamin.ViTaminTrunk(conv_channels=(16, 32), conv_depths=(1, 1),
                                 width=WIDTH, depth=2, heads=HEADS,
                                 image_size=IMAGE), WIDTH, WIDTH,
            pool="avg", proj="linear")
    if kind == "swin":  # 2 then 4 heads; shifted windows in stage 0
        return timm_vit.TimmModel(
            swin.SwinTrunk(patch_size=4, embed_dim=32, depths=(2, 2),
                           heads=(2, 4), window=4, image_size=IMAGE),
            WIDTH, WIDTH, pool="avg", proj="linear")
    if kind == "convnext":
        return convnext.ConvNeXtModel(WIDTH, depths=(1, 1), dims=(32, 64))
    if kind == "fastvit":  # the attention stage at 128: 4 heads of 32
        return timm_vit.TimmModel(
            fastvit.FastVitTrunk(dims=(16, 16, 32, 128), depths=(1, 1, 1, 2)),
            256, WIDTH, pool="avg", proj="linear")
    assert kind == "resnet", kind  # the attention pool: 4 heads of 64
    return resnet.ModifiedResNet((1, 1, 1, 1), output_dim=WIDTH, heads=HEADS,
                                 image_size=IMAGE, width=8)


def build(kind: str, directory):
    """The toy CLIP of ``kind``, uninitialized: the family's tower beside
    a ``ResidualAttentionBlock`` one. The contrastive step reads no tag head: but for
    EVA-02's, whose parameters are JAX's, it is cut to toy width too."""
    register(directory)
    model = factory.create_model("torchtinytpzoo", device="cpu",
                                 precision="fp32", skip_init=True)
    setattr(model, "text" if kind in HF_KINDS else "visual",
            _tower(kind, directory))
    if kind != "eva02":
        model.tag_hidden_size = WIDTH
        model.tag_head = TagBertHead(WIDTH, 1, WIDTH, HEADS, 2 * WIDTH)
        model.tag_labels = Embed(2 * NUM_TAGS, WIDTH, init_std=1.0)
        model.tag_fc = Dense(WIDTH, 1)
    return model


def init_state_dict(kind: str, directory, seed: int = 7) -> dict:
    """The factory's init of ``build(kind)``, plus seeded noise of scale
    0.05 on every leaf (the inits of ones and zeros become values that
    tell the leaves apart)."""
    model = build(kind, directory)
    factory.init_params(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return {k: v.clone() for k, v in model.state_dict().items()}


def global_batch(seed: int = 23) -> dict:
    """The seeded global batch (numpy): images, and token ids 2..VOCAB-1
    whose tail (from a random length on) a family's pad id fills."""
    rng = np.random.default_rng(seed)
    return dict(
        images=rng.standard_normal((GLOBAL_B, IMAGE, IMAGE, 3)).astype(
            np.float32),
        texts=rng.integers(2, VOCAB, (GLOBAL_B, CTX)).astype(np.int64),
        lengths=rng.integers(CTX // 2, CTX + 1, GLOBAL_B))


def texts(kind: str, batch_np: dict) -> np.ndarray:
    t = batch_np["texts"].copy()
    if kind in PADS:
        for i, n in enumerate(batch_np["lengths"]):
            t[i, n:] = PADS[kind]
    return t


def _rows() -> np.ndarray:
    if not dist.is_initialized():
        return np.arange(GLOBAL_B)
    b = GLOBAL_B // mesh.data_size()
    r = mesh.data_rank()
    return np.arange(r * b, (r + 1) * b)


def _state(kind, init_sd, directory, fsdp=False, opt_kw=None):
    model = build(kind, directory)
    model.load_state_dict(init_sd)
    ddp = sharding.wrap_model(model, SimpleNamespace(fsdp=fsdp)) \
        if dist.is_initialized() else None
    kw = {"weight_decay": 0.1, **(opt_kw or {})}
    lr = kw.pop("lr", 1e-3)
    tx = ts.make_optimizer(lambda _: lr, params=dict(model.named_parameters()),
                           **kw)
    return model, ts.create_train_state(model, tx, ddp)


def _stepper(kind, batch_np, dropout: bool = False):
    """(step, this rank's batch, a fresh generator maker): the contrastive
    step, its towers' dropout on with ``dropout``."""
    take = _rows()
    batch = {"images": torch.from_numpy(batch_np["images"][take]),
             "texts": torch.from_numpy(texts(kind, batch_np)[take])}
    fn = make_train_step({"world_size": mesh.data_size(),
                          "rank": mesh.data_rank()},
                         deterministic=not dropout)
    return fn, batch, lambda: torch.Generator().manual_seed(11)


def step(kind: str, init_sd: dict, batch_np: dict, directory,
         fsdp: bool = False, opt_kw=None, ckpt: str = None,
         grads: bool = True, dropout: bool = False) -> dict:
    """One contrastive step of ``kind`` from ``init_sd`` on this rank's
    rows (``dropout``: its towers' dropout on, the same generator seed on
    every rank): the metrics, the whole parameters and (``grads``) gradients,
    the split leaves and each one's size on this rank. With ``ckpt`` the
    state is saved there after the step (rank 0 writes), stepped once
    more, and only the saved parameters' digest and the next step's
    fingerprint are returned."""
    model, state = _state(kind, init_sd, directory, fsdp, opt_kw)
    fn, batch, gen = _stepper(kind, batch_np, dropout)
    state, metrics = fn(state, batch, gen())
    if ckpt is not None:
        from xtagclip_tpu_torch.train.checkpoint import (
            CheckpointManager,
            state_tree,
        )

        saved = digest(sharding.full_state_dict(model))
        CheckpointManager(ckpt, write=mesh.rank() == 0).save_epoch(
            1, state_tree(state, 0))
        if dist.is_initialized():
            dist.barrier()
        state, _ = fn(state, batch, gen())
        return {"params": saved, "straight": w.fingerprint(
            sharding.full_state_dict(model))}
    shards = sharding.model_shards(model)
    out = {"metrics": {k: v.item() for k, v in metrics.items()},
           "params": w._copy(sharding.full_state_dict(model)),
           "shards": shards,
           "local_shape": {n: tuple(sharding.local(p).shape)
                           for n, p in model.named_parameters()}}
    if grads:
        out["grads"] = {n: sharding.full(p.grad, shards.get(n)).clone()
                        for n, p in model.named_parameters()
                        if p.grad is not None}
    return out


def resume(kind: str, ckpt: str, init_sd: dict, batch_np: dict,
           directory) -> dict:
    """The state of ``ckpt`` (written by ``step``) restored under this
    process's layout and stepped once on its rows: the restored
    parameters' digest and the stepped ones' fingerprint."""
    from xtagclip_tpu_torch.train.checkpoint import restore_train_state

    model, state = _state(kind, init_sd, directory)
    epoch = restore_train_state(ckpt, "epoch_1", state)
    restored = digest(sharding.full_state_dict(model))
    fn, batch, gen = _stepper(kind, batch_np)
    state, _ = fn(state, batch, gen())
    return {"epoch": epoch, "restored": restored,
            "stepped": w.fingerprint(sharding.full_state_dict(model))}


def scenario_zoo(inputs, directory):
    """Every case of ``inputs["cases"]`` ((label, kind, kwargs of
    ``step``), ...) on the (data x model) mesh of ``inputs["model"]``."""
    mesh.init_mesh(inputs["model"])
    return {label: step(kind, inputs["init"][kind], inputs["batch"],
                        inputs["cfg_dir"], **kw)
            for label, kind, kw in inputs["cases"]}


if __name__ == "__main__":
    w.main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           scenarios={"zoo": scenario_zoo})
