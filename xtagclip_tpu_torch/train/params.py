"""CLI flag surface (a copy of xtagclip_tpu/train/params.py).

Same flags as reference open_clip_train/params.py:26-496 plus the 8 XTag
custom flags (main_other_simple.py:81-141). ``--device`` defaults to
``cuda``; ``cpu`` runs the plain PyTorch versions of the kernels.
``unported`` names the flags whose branches the port does not have yet:
the train CLIs raise on them. ``--grad-checkpointing`` checkpoints every
tower block (models/layers.py). ``--dist-url``, ``--dist-backend``,
``--no-set-device-rank`` and ``--ddp-static-graph`` shape the process
group and DDP (core/mesh.py, parallel/sharding.py); ``--gather-with-grad``
changes nothing, as in JAX (the gathers carry their gradient); the flags
the JAX package accepts as no-ops (``--torchcompile``,
``--use-bnb-linear``, ``--horovod``) are accepted as no-ops here too.
"""

from __future__ import annotations

import argparse
import ast


def get_default_params(model_name: str) -> dict:
    model_name = (model_name or "").lower()
    if "vit" in model_name:
        return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6}
    return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8}


class ParseKwargs(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        kw = {}
        for value in values:
            key, v = value.split("=")
            try:
                kw[key] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                kw[key] = str(v)
        setattr(namespace, self.dest, kw)


def add_xtag_args(parser: argparse.ArgumentParser):
    """The 8 XTag custom flags (main_other_simple.py:81-141)."""
    parser.add_argument("--save-embed", default=False, action="store_true",
                        help="Dump image/text embeddings at eval")
    parser.add_argument("--add-learnable-tokens", default=False,
                        action="store_true",
                        help="Insert learnable prompt tokens into the ViT seq")
    parser.add_argument("--n-learnable-tokens", type=int, default=4)
    parser.add_argument("--insert-position", type=int, default=1)
    parser.add_argument("--prompt-template-setting", type=str, default=None,
                        help="sentence_1..4 | itemization | total")
    parser.add_argument("--use-tagging", default=False, action="store_true")
    parser.add_argument("--save-best", default=False, action="store_true")
    parser.add_argument("--load-tagging-only", default=False,
                        action="store_true",
                        help="Partial-load only tag_head/tag_labels/tag_fc")
    return parser


def parse_args(args=None, include_xtag: bool = True):
    parser = argparse.ArgumentParser("xtagclip_tpu_torch training")

    # data
    parser.add_argument("--train-data", type=str, default=None)
    parser.add_argument("--train-data-upsampling-factors", type=str, default=None)
    parser.add_argument("--val-data", type=str, default=None)
    parser.add_argument("--train-num-samples", type=int, default=None)
    parser.add_argument("--val-num-samples", type=int, default=None)
    parser.add_argument("--dataset-type",
                        choices=["webdataset", "csv", "synthetic", "auto"],
                        default="auto")
    parser.add_argument("--dataset-resampled", default=False, action="store_true")
    parser.add_argument("--csv-separator", type=str, default="\t")
    parser.add_argument("--csv-img-key", type=str, default="filepath")
    parser.add_argument("--csv-caption-key", type=str, default="title")
    parser.add_argument("--imagenet-val", type=str, default=None)
    parser.add_argument("--imagenet-v2", type=str, default=None)
    parser.add_argument("--cache-dir", type=str, default=None)
    # scar CSVs (reference hard-codes these paths; explicit flags here)
    parser.add_argument("--scar-train-csv", type=str, default=None)
    parser.add_argument("--scar-val-csv", type=str, default=None)

    # logging / experiment
    parser.add_argument("--logs", type=str, default="./logs/")
    parser.add_argument("--log-local", action="store_true", default=False)
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--workers", type=int, default=8)

    # optimization
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=32)
    parser.add_argument("--epochs-cooldown", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--beta1", type=float, default=None)
    parser.add_argument("--beta2", type=float, default=None)
    parser.add_argument("--eps", type=float, default=None)
    parser.add_argument("--wd", type=float, default=0.2)
    parser.add_argument("--momentum", type=float, default=None)
    parser.add_argument("--warmup", type=int, default=10000)
    parser.add_argument("--opt", type=str, default="adamw")
    parser.add_argument("--use-bn-sync", default=False, action="store_true")
    parser.add_argument("--skip-scheduler", action="store_true", default=False)
    parser.add_argument("--lr-scheduler", type=str, default="cosine",
                        help="cosine | const | const-cooldown")
    parser.add_argument("--lr-cooldown-end", type=float, default=0.0)
    parser.add_argument("--lr-cooldown-power", type=float, default=1.0)
    parser.add_argument("--save-frequency", type=int, default=1)
    parser.add_argument("--save-most-recent", action="store_true", default=False)
    parser.add_argument("--zeroshot-frequency", type=int, default=2)
    parser.add_argument("--val-frequency", type=int, default=1)
    parser.add_argument("--resume", default=None, type=str)
    parser.add_argument("--precision",
                        choices=["amp", "amp_bf16", "amp_bfloat16", "bf16",
                                 "fp16", "pure_bf16", "pure_fp16", "fp32"],
                        default="amp")
    parser.add_argument("--model", type=str, default="RN50")
    parser.add_argument("--pretrained", default="", type=str)
    parser.add_argument("--pretrained-image", default=False, action="store_true")
    parser.add_argument("--lock-image", default=False, action="store_true")
    parser.add_argument("--lock-image-unlocked-groups", type=int, default=0)
    parser.add_argument("--lock-image-freeze-bn-stats", default=False,
                        action="store_true")
    parser.add_argument("--image-mean", type=float, nargs="+", default=None)
    parser.add_argument("--image-std", type=float, nargs="+", default=None)
    parser.add_argument("--image-interpolation", default=None, type=str,
                        choices=["bicubic", "bilinear", "random"])
    parser.add_argument("--image-resize-mode", default=None, type=str,
                        choices=["shortest", "longest", "squash"])
    parser.add_argument("--aug-cfg", nargs="*", default={}, action=ParseKwargs)
    parser.add_argument("--grad-checkpointing", default=False,
                        action="store_true")
    parser.add_argument("--local-loss", default=False, action="store_true")
    parser.add_argument("--gather-with-grad", default=False, action="store_true")
    parser.add_argument("--force-image-size", type=int, nargs="+", default=None)
    parser.add_argument("--force-quick-gelu", default=False, action="store_true")
    parser.add_argument("--force-patch-dropout", default=None, type=float)
    parser.add_argument("--force-custom-text", default=False, action="store_true")
    # --torchscript/--trace: cli/main.py writes the serving artifact
    # (convert/serving.py)
    parser.add_argument("--torchscript", default=False, action="store_true")
    parser.add_argument("--torchcompile", default=False, action="store_true")
    parser.add_argument("--trace", default=False, action="store_true")
    parser.add_argument(
        "--native-decode", default=False, action="store_true",
        help="use the native C++ JPEG decode pipeline for webdataset loading "
             "(threaded libjpeg decode + RandomResizedCrop/center-crop)")
    # capture a torch.profiler trace of a short steady-state step window
    # during epoch 0
    parser.add_argument("--profile", default=False, action="store_true",
                        help="capture a torch.profiler trace in epoch 0")
    parser.add_argument("--profile-dir", default=None, type=str,
                        help="trace output dir (default logs/<name>/trace)")
    parser.add_argument("--profile-steps", default=5, type=int,
                        help="number of steps to trace")
    parser.add_argument("--accum-freq", type=int, default=1)
    # device and process group (core/mesh.py init_distributed)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device; 'cpu' runs the plain versions")
    parser.add_argument("--dist-url", default=None, type=str)
    parser.add_argument("--dist-backend", default=None, type=str)
    parser.add_argument("--report-to", default="", type=str)
    parser.add_argument("--wandb-notes", default="", type=str)
    parser.add_argument("--wandb-project-name", type=str, default="open-clip")
    parser.add_argument("--debug", default=False, action="store_true")
    parser.add_argument("--copy-codebase", default=False, action="store_true")
    parser.add_argument("--horovod", default=False, action="store_true")
    parser.add_argument("--ddp-static-graph", default=False, action="store_true")
    parser.add_argument("--no-set-device-rank", default=False, action="store_true")
    # FSDP2 parameter + optimizer-state sharding and tensor parallelism
    # of the ResidualAttentionBlock towers (--model-parallel > 1) on a
    # (data, model) mesh (core/mesh.py, parallel/sharding.py)
    parser.add_argument("--fsdp", default=False, action="store_true")
    parser.add_argument("--model-parallel", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--grad-clip-norm", type=float, default=None)
    parser.add_argument("--lock-text", default=False, action="store_true")
    parser.add_argument("--lock-text-unlocked-layers", type=int, default=0)
    parser.add_argument("--lock-text-freeze-layer-norm", default=False,
                        action="store_true")
    parser.add_argument("--log-every-n-steps", type=int, default=100)
    parser.add_argument("--coca-caption-loss-weight", type=float, default=2.0)
    parser.add_argument("--coca-contrastive-loss-weight", type=float, default=1.0)
    parser.add_argument("--remote-sync", type=str, default=None)
    parser.add_argument("--remote-sync-frequency", type=int, default=300)
    parser.add_argument("--remote-sync-protocol",
                        choices=["s3", "fsspec", "gcs"], default="s3")
    parser.add_argument("--delete-previous-checkpoint", default=False,
                        action="store_true")
    parser.add_argument("--distill-model", default=None)
    parser.add_argument("--distill-pretrained", default=None)
    parser.add_argument("--use-bnb-linear", default=None)
    parser.add_argument("--siglip", default=False, action="store_true")
    parser.add_argument("--loss-dist-impl", default=None, type=str)
    parser.add_argument("--use-fusion", default=False, action="store_true")

    if include_xtag:
        add_xtag_args(parser)

    args = parser.parse_args(args)

    # set default opt params based on model name (ViT recipe vs CNN recipe)
    default_params = get_default_params(args.model)
    for name, val in default_params.items():
        if getattr(args, name) is None:
            setattr(args, name, val)

    return args


def unported(args) -> list:
    """The flags set in ``args`` whose branches are not ported yet, each
    with the ROADMAP Queue 1 item that ports it
    (tests/test_torch_clipa.py checks that each item exists):
    ``--model-parallel`` above 1 with a tower of ``--model``'s config
    that tensor parallelism does not cover (parallel/sharding.py
    ``towers_outside_slice``: a timm vision tower, the ResNets, an HF
    text tower)."""
    n = args.model_parallel or 1
    if n == 1:
        return []
    from xtagclip_tpu_torch.factory import get_model_config, tower_types
    from xtagclip_tpu_torch.parallel.sharding import (
        ITEM_11,
        towers_outside_slice,
    )

    cfg = get_model_config(str(args.model).replace("/", "-"))
    outside = towers_outside_slice(tower_types(cfg)) if cfg else []
    if not outside:
        return []
    return [f"--model-parallel {n} with {' and '.join(outside)} of "
            f"{args.model} ({ITEM_11})"]
