"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Drives the port's main path, the XTag ViT-B-32 fusion-classify serving
path, at full width in bf16 with a seeded random init, through the entry
points a user calls (create_model, PromptTable, precompute_prompt_features,
make_xtag_serve_step), in phases that each print one JSON line:

1. build: compiles the CUDA kernels of xtagclip_tpu_torch/csrc with nvcc;
2. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it, within atol = max|ref|/128 and
   rtol = 1e-2 (one bf16 ULP at output scale); median device times of
   kernel and plain version (CUDA events over 10 back-to-back calls), and
   the card's least time for the same work;
3. serve: precompute every scar pseudo-prompt (3 classes x 2304 combos)
   twice, timing the cold and the warm pass (prompts/s is the warm one);
   then, after two warm-up batches, a timed window of 200 batches of 32
   seeded uint8 224x224 images (about 2 s on an H100): img/s is all the
   window's images over its wall time, latencies are over all its batches;
4. path: the kernel launches counted in phase 3 (12 of each half per serve
   batch and per precompute chunk), and the first 8 serve batches run
   again through the plain versions: fusion logits within 5e-2,
   image-feature cosine >= 0.999, tag picks agreeing on >= 95% of (image,
   category) pairs, every output finite.

With ``--profile`` it then traces one precompute and 20 serve batches with
torch.profiler and prints, for each window, its wall time, the device's
kernel time, the device's busy share (kernel time over wall time; the
kernels run on one stream) and the device time per kernel, split into the
port's hand-written kernels and everything else.

Then the card's name and power limit (nvidia-smi) and, as the last line,
{"ok": true, "device": {...}}. Any failure raises: the exit code is then
not 0 and the last line is not printed. Without a CUDA device it exits 1
before doing anything. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# the card's published dense bf16 peak (FLOP/s) and memory rate (bytes/s)
_PEAKS = (
    ("H100 PCIe", 756e12, 2.0e12),
    ("H100 NVL", 835e12, 3.9e12),
    ("H200", 989e12, 4.8e12),
    ("H100", 989e12, 3.35e12),
)
SERVE_BATCH = 32
N_SERVE_BATCHES = 200  # the timed window
N_WARMUP_BATCHES = 2
N_IMAGE_BATCHES = 8  # distinct seeded batches, cycled; re-run through plain
PRECOMPUTE_BATCH = 512
IMAGE_SIZE = 224
# the device code of csrc/ (fused_attn_half.cu, fused_mlp_half.cu)
PORT_KERNELS = ("gemm_bf16_kernel", "attn_core_kernel", "ln_rows_kernel")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]


def _peaks(name: str):
    for key, flops, rate in _PEAKS:
        if key in name:
            return flops, rate
    raise RuntimeError(f"no published peak rates for {name!r}")


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _median_ms(fn, reps: int = 7, per_rep: int = 10, warmup: int = 3) -> float:
    """Median over ``reps`` of (CUDA-event time of ``per_rep`` back-to-back
    calls) / ``per_rep``: the host enqueues ahead, so this is device time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def _close(out, ref):
    """(ok, max_abs_err, atol) under atol = max|ref|/128, rtol = 1e-2."""
    out, ref = out.float(), ref.float()
    atol = ref.abs().max().item() / 128
    err = (out - ref).abs()
    ok = bool((err <= atol + 1e-2 * ref.abs()).all().item())
    return ok, err.max().item(), atol


def _kernel_cases(gen):
    """The kernels' arguments at the serving path's shapes."""
    from xtagclip_tpu_torch.models.text import build_causal_mask

    dev = "cuda"

    def rnd(shape, std=1.0, dtype=torch.float32):
        t = torch.randn(shape, generator=gen, device=dev) * std
        return t.to(dtype)

    bf = torch.bfloat16
    cases = []
    for tower, l, d, h, causal in (("vision", 50, 768, 12, False),
                                   ("text", 77, 512, 8, True)):
        x = rnd((SERVE_BATCH, l, d), dtype=bf)
        args = (x, 1 + rnd(d, 0.1), rnd(d, 0.1),
                rnd((d, 3 * d), d**-0.5, bf), rnd(3 * d, 0.1),
                rnd((d, d), d**-0.5, bf), rnd(d, 0.1),
                build_causal_mask(l, dev) if causal else None, h, 1e-5)
        flops = 2 * SERVE_BATCH * l * d * (4 * d + 2 * l)
        nbytes = (2 * 2 * SERVE_BATCH * l * d + 2 * 4 * d * d
                  + 4 * (4 * d + 2 * d) + (4 * l * l if causal else 0))
        cases.append(("fused_attn_half", f"{tower} B={SERVE_BATCH} L={l} "
                      f"D={d} H={h}{' causal' if causal else ''}",
                      args, flops, nbytes))
    for tower, l, d in (("vision", 50, 768), ("text", 77, 512)):
        hd = 4 * d
        n = SERVE_BATCH * l
        for act in ("gelu", "quick_gelu"):
            x = rnd((SERVE_BATCH, l, d), dtype=bf)
            args = (x, 1 + rnd(d, 0.1), rnd(d, 0.1), rnd((d, hd), d**-0.5, bf),
                    rnd(hd, 0.1), rnd((hd, d), hd**-0.5, bf), rnd(d, 0.1),
                    act, 1e-5)
            flops = 4 * n * d * hd
            nbytes = 2 * 2 * n * d + 2 * 2 * d * hd + 4 * (3 * d + hd)
            cases.append(("fused_mlp_half", f"{tower} N={n} D={d} "
                          f"H={hd} {act}", args, flops, nbytes))
    return cases


_KERNEL_META = {
    "fused_attn_half": ("xtagclip_tpu_torch/csrc/fused_attn_half.cu",
                        "xtagclip_tpu/ops/fused_attn_block.py:434"),
    "fused_mlp_half": ("xtagclip_tpu_torch/csrc/fused_mlp_half.cu",
                       "xtagclip_tpu/ops/fused_attn_block.py:796"),
}


def phase_kernels(card: str):
    from xtagclip_tpu_torch.ops import fused_attn_block as fab

    peak_flops, peak_rate = _peaks(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernel = {"fused_attn_half": fab.fused_attn_half,
              "fused_mlp_half": fab.fused_mlp_half}
    plain = {"fused_attn_half": fab.reference_attn_half,
             "fused_mlp_half": fab.reference_mlp_half}
    entries = []
    with torch.inference_mode():
        for name, shape, args, flops, nbytes in _kernel_cases(gen):
            out = kernel[name](*args)
            ref = plain[name](*args)
            torch.cuda.synchronize()
            ok, err, atol = _close(out, ref)
            if not ok or not torch.isfinite(out).all():
                raise AssertionError(
                    f"{name} [{shape}]: kernel disagrees with its plain "
                    f"version: max abs err {err} > atol {atol} (rtol 1e-2)")
            t_flops, t_bytes = flops / peak_flops, nbytes / peak_rate
            source, replaces = _KERNEL_META[name]
            entries.append({
                "name": name, "shape": shape, "card": card, "route": "cuda",
                "source": source, "replaces": replaces, "launches": None,
                "max_abs_err": err, "atol": atol,
                "ms": _median_ms(lambda: kernel[name](*args)),
                "plain_ms": _median_ms(lambda: plain[name](*args)),
                "bound_ms": 1e3 * max(t_flops, t_bytes),
                "bound_by": "operations" if t_flops >= t_bytes else "bytes",
                "library_ms": None,
            })
    return entries


def _cosine(a, b):
    a, b = a.float(), b.float()
    return torch.nn.functional.cosine_similarity(a, b, dim=-1)


def phase_serve_and_path(card: str):
    from xtagclip_tpu_torch.factory import create_model, get_tokenizer
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.ops import fused_attn_block as fab
    from xtagclip_tpu_torch.ops.preprocess import normalize_images
    from xtagclip_tpu_torch.serving import (
        make_xtag_serve_step,
        precompute_prompt_features,
    )
    from xtagclip_tpu_torch.tokenize.prompts import PromptTable
    from xtagclip_tpu_torch.train import metadata

    wrappers = (fab.fused_attn_half, fab.fused_mlp_half)

    def reset():
        for w in wrappers:
            w.launches = 0

    def counts():
        return {w.__name__: w.launches for w in wrappers}

    t0 = time.perf_counter()
    model = create_model("ViT-B-32", use_tagging=True, use_fusion=True,
                         precision="bf16", init_seed=0)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptable = PromptTable(metadata.SCAR_CLASSNAMES,
                         tokenizer=get_tokenizer("ViT-B-32"),
                         templates=["sentence_1"]).table
    t_table = time.perf_counter() - t0
    n_prompts = ptable.shape[1] * ptable.shape[2]

    def precompute():
        t0 = time.perf_counter()
        out = precompute_prompt_features(model, ptable, template_id=0,
                                         batch_size=PRECOMPUTE_BATCH)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # main path, part 1: the text tower over every pseudo-prompt, cold
    # (first calls of every op) and then warm
    reset()
    _, t_pre_cold = precompute()
    table, t_pre = precompute()
    pre_counts = counts()

    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(
        0, 256, (SERVE_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8))
        for _ in range(N_IMAGE_BATCHES)]
    serve = make_xtag_serve_step(model, table)

    def serve_one(i):
        images = normalize_images(batches[i % N_IMAGE_BATCHES].to("cuda"),
                                  dtype=torch.bfloat16)
        return serve(images)

    # main path, part 2: warm-up batches, then the timed window, each
    # batch from host uint8 to its results on the device
    reset()
    for i in range(N_WARMUP_BATCHES):
        serve_one(i)
    torch.cuda.synchronize()
    outs, lat = [], []
    t_window = time.perf_counter()
    for i in range(N_SERVE_BATCHES):
        t0 = time.perf_counter()
        outs.append(serve_one(i))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    t_window = time.perf_counter() - t_window
    serve_counts = counts()

    q = statistics.quantiles(lat, n=100)
    _emit({"phase": "serve", "card": card, "model": "ViT-B-32 xtag bf16",
           "weights": "seeded random init", "model_build_s": t_model,
           "prompt_table_s": t_table, "prompts": n_prompts,
           "precompute_batch": PRECOMPUTE_BATCH,
           "precompute_cold_s": t_pre_cold, "precompute_s": t_pre,
           "prompts_per_s": n_prompts / t_pre,
           "serve_batch": SERVE_BATCH, "warmup_batches": N_WARMUP_BATCHES,
           "serve_batches": N_SERVE_BATCHES, "window_s": t_window,
           "img_per_s": SERVE_BATCH * N_SERVE_BATCHES / t_window,
           "p50_batch_ms": 1e3 * statistics.median(lat),
           "p90_batch_ms": 1e3 * q[89], "p99_batch_ms": 1e3 * q[98],
           "max_batch_ms": 1e3 * max(lat)})

    n_chunks = math.ceil(n_prompts / PRECOMPUTE_BATCH)
    want_pre = {w.__name__: 2 * 12 * n_chunks for w in wrappers}
    want_serve = {w.__name__: 12 * (N_WARMUP_BATCHES + N_SERVE_BATCHES)
                  for w in wrappers}
    if pre_counts != want_pre or serve_counts != want_serve:
        raise AssertionError(
            f"kernel launches: precompute {pre_counts} (want {want_pre}), "
            f"serve {serve_counts} (want {want_serve})")

    # the same serve through the plain versions of the two halves
    set_use_kernels(model, False)
    plain = [serve_one(i) for i in range(N_IMAGE_BATCHES)]
    rows = torch.from_numpy(ptable[0].reshape(-1, ptable.shape[-1])[:256]
                            .astype(np.int64)).to("cuda")
    with torch.inference_mode():
        plain_rows = model.encode_text(rows)[1].mean(dim=1)
    set_use_kernels(model, True)

    all_feat = torch.cat([o[0] for o in outs])
    all_logits = torch.cat([o[2] for o in outs])
    feat, tags, logits = (torch.cat([o[j] for o in outs[:N_IMAGE_BATCHES]])
                          for j in range(3))
    p_feat, p_tags, p_logits = (torch.cat([o[j] for o in plain])
                                for j in range(3))
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (all_feat, all_logits, table, p_feat, p_logits))
    logit_err = (logits.float() - p_logits.float()).abs().max().item()
    logits_ok = bool(torch.allclose(logits.float(), p_logits.float(),
                                    atol=5e-2, rtol=5e-2))
    cos = _cosine(feat, p_feat).min().item()
    table_cos = _cosine(table.reshape(-1, table.shape[-1])[:256],
                        plain_rows).min().item()
    tag_agree = (tags == p_tags).float().mean().item()
    n_img = SERVE_BATCH * N_IMAGE_BATCHES
    shapes_ok = (tuple(all_logits.shape) == (SERVE_BATCH * N_SERVE_BATCHES, 3)
                 and tuple(tags.shape) == (n_img, 6)
                 and tuple(table.shape) == (3, 2304, 512))
    result = {"phase": "path", "card": card,
              "launches_precompute": pre_counts,
              "launches_serve": serve_counts,
              "launches_per_serve_batch": {
                  k: v / (N_WARMUP_BATCHES + N_SERVE_BATCHES)
                  for k, v in serve_counts.items()},
              "logits_max_abs_err": logit_err, "logits_ok": logits_ok,
              "image_feature_cos_min": cos,
              "prompt_table_cos_min": table_cos,
              "tag_agreement": tag_agree, "finite": finite,
              "shapes_ok": shapes_ok}
    _emit(result)
    if not (logits_ok and cos >= 0.999 and table_cos >= 0.999
            and tag_agree >= 0.95 and finite and shapes_ok):
        raise AssertionError(f"kernel path disagrees with plain path: {result}")
    launches = {k: pre_counts[k] + serve_counts[k] for k in pre_counts}
    return launches, model, ptable, serve_one


def _device_time_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _profile_window(name, fn, card):
    """Trace ``fn`` with torch.profiler and print where its time went."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] += _device_time_us(evt) / 1e3
    kernel_ms = sum(by_kernel.values())
    port_ms = sum(v for k, v in by_kernel.items()
                  if any(p in k for p in PORT_KERNELS))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    _emit({"phase": "profile", "window": name, "card": card,
           "wall_ms": wall_ms, "device_kernel_ms": kernel_ms,
           "device_busy_share": kernel_ms / wall_ms,
           "port_kernels_ms": port_ms, "other_kernels_ms": kernel_ms - port_ms,
           "top_kernels_ms": {k[:90]: v for k, v in top}})


def phase_profile(card, model, ptable, serve_one, n_batches: int = 20):
    from xtagclip_tpu_torch.serving import precompute_prompt_features

    _profile_window(
        f"precompute 3x2304 prompts, batch {PRECOMPUTE_BATCH}",
        lambda: precompute_prompt_features(model, ptable, template_id=0,
                                           batch_size=PRECOMPUTE_BATCH),
        card)

    def run_serve():
        for i in range(n_batches):
            serve_one(i)

    _profile_window(f"serve {n_batches} batches of {SERVE_BATCH}",
                    run_serve, card)


def main(argv=()) -> int:
    """Run the phases; ``argv`` holds the command-line arguments."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace precompute and serve with torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from xtagclip_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    _emit({"phase": "build", "card": card,
           "seconds": time.perf_counter() - t0,
           "kernels": {k: v["path"] for k, v in built.items()}})

    entries = phase_kernels(card)
    launches, model, ptable, serve_one = phase_serve_and_path(card)
    if args.profile:
        phase_profile(card, model, ptable, serve_one)
    for e in entries:
        e["launches"] = launches[e["name"]]
    _emit({"kernels": entries})
    print(card, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
