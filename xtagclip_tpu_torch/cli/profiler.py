"""Model FLOPs and parameters profiler (port of xtagclip_tpu/cli/profiler.py;
reference open_clip_train/profiler.py:128-249).

Per model: the parameter counts of the whole model and of its towers,
GFLOPs and GMACs of one image and one text forward, the train state's size
and its per-device share under ``--fsdp`` on 8 devices, as a row and in a
CSV report with JAX's columns in JAX's order; ``--model all`` sweeps the
registry, and a model that fails is reported and skipped.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``, which counts
matmuls, convolutions and attention. JAX takes XLA's cost analysis, which
counts elementwise work too, so the port's GFLOPs are the matmul, conv and
attention FLOPs and sit below JAX's. The kernels' custom ops carry flop
formulas (ops/), so a forward through them counts what its plain version
counts. The parameter counts, ``train_state_gb`` (bf16 parameters and two
fp32 moments: 10 bytes a parameter) and ``fsdp8_gb_per_chip`` (from
``parallel/sharding.py::param_partition_spec``) are JAX's.

    python -m xtagclip_tpu_torch.cli.profiler --model ViT-B-32 \\
        [--results-file out.csv] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch


def count_params(model, prefix: str = "") -> int:
    return sum(p.numel() for n, p in model.named_parameters()
               if n.startswith(prefix))


def _flops_of(fn, *args) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    return float(counter.get_total_flops())


def _fsdp_share_bytes(model, n: int, bytes_per_param: float = 10.0) -> float:
    """Per-device train-state bytes under JAX's FSDP rule on n devices."""
    from xtagclip_tpu_torch.parallel.sharding import (
        DATA_AXIS,
        jax_shape,
        param_partition_spec,
    )

    total = 0.0
    for name, p in model.named_parameters():
        spec = param_partition_spec(name, jax_shape(p), 1, n)
        total += p.numel() * bytes_per_param / (n if DATA_AXIS in spec
                                                else 1)
    return total


def profile_model(model_name: str, batch_size: int = 1,
                  force_custom_text=False, device="cuda") -> dict:
    from xtagclip_tpu_torch.factory import create_model

    model = create_model(model_name, device=device)
    model.eval()
    cfg = model.model_cfg
    image_size = cfg["vision_cfg"].get("image_size", 224)
    if isinstance(image_size, (list, tuple)):
        image_size = image_size[0]
    ctx = cfg["text_cfg"].get("context_length", 77)
    img = torch.zeros((batch_size, image_size, image_size, 3),
                      device=device)
    txt = torch.zeros((batch_size, ctx), dtype=torch.long, device=device)
    image_flops = _flops_of(model.encode_image, img)
    text_flops = _flops_of(model.encode_text, txt)
    n = count_params(model)
    return {
        "model": model_name,
        "image_size": image_size,
        "image_width": cfg["vision_cfg"].get("width", 0),
        "text_width": cfg["text_cfg"].get("width", 0),
        "embed_dim": cfg["embed_dim"],
        "mparams": round(n / 1e6, 2),
        "image_mparams": round(count_params(model, "visual.") / 1e6, 2),
        "text_mparams": round(count_params(model, "text.") / 1e6, 2),
        "gflops": round((image_flops + text_flops) / 1e9 / batch_size, 2),
        "image_gflops": round(image_flops / 1e9 / batch_size, 2),
        "image_gmacs": round(image_flops / 2e9 / batch_size, 2),
        "text_gflops": round(text_flops / 1e9 / batch_size, 2),
        "text_gmacs": round(text_flops / 2e9 / batch_size, 2),
        "train_state_gb": round(n * 10.0 / 2 ** 30, 2),
        "fsdp8_gb_per_chip": round(_fsdp_share_bytes(model, 8) / 2 ** 30, 2),
    }


def main(argv=None):
    p = argparse.ArgumentParser("profiler")
    p.add_argument("--model", type=str, default="ViT-B-32",
                   help="comma-separated model names, or 'all'")
    p.add_argument("--results-file", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    args = p.parse_args(argv)

    from xtagclip_tpu_torch.factory import list_models

    if args.model == "all":
        names = list_models()
    else:
        names = [m.strip() for m in args.model.split(",") if m.strip()]

    rows = []
    for name in names:
        try:
            row = profile_model(name, batch_size=args.batch_size,
                                device=args.device)
            rows.append(row)
            print(row)
        except Exception as e:  # registry sweep keeps going (reference :223)
            print(f"profile failed for {name}: {e}")

    if args.results_file and rows:
        import csv

        with open(args.results_file, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.results_file}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
