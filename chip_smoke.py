"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Drives the port's main paths at full width in bf16 with a seeded random
init, through the entry points a user calls: the XTag ViT-B-32
fusion-classify serving path (create_model, cast_for_compute, PromptTable,
precompute_prompt_features, make_xtag_serve_step), the XTag ViT-B-32
train step (create_model, make_optimizer, create_train_state,
make_train_step), the scar training CLI (main_other.main) and the predict
CLI (predict.main, with weights and its serving artifact); then the serve,
train and CLI paths and the serving artifact for the cls-free GAP tower
(XTag ViT-B-16 with the vision overrides image_size 256, pool_type avg,
no_class_token: L = 256, whose vision blocks run flash attention and the
fused MLP), in phases that each print one JSON line:

1. build: compiles the CUDA kernels of xtagclip_tpu_torch/csrc with nvcc,
   with ptxas's registers and spill bytes for every kernel entry;
2. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main paths give it (and, for flash attention, at edge
   shapes: L = 128, 197, 257, 384, head dim 128), every output within
   atol = max|ref|/128 and rtol = 1e-2 (one bf16 ULP at output scale);
   the image normalize (kernel #5) within one bf16 ULP on every element,
   or 2^-22 for fp32 output, at the main path's batch and at a ragged
   odd-sized one; the device time of kernel and plain version
   (torch.profiler: the summed durations of the kernels one call runs,
   over 20 calls, so a wrapper whose host side outlasts its kernel is
   timed by its kernel, and the kernel's split by the kernels its
   wrapper launches; the median CUDA-event time of 10 back-to-back
   calls beside it), the same for one PyTorch call computing the same
   function where there is one (scaled_dot_product_attention for flash
   attention's forward; for its backward, SDPA's backward alone through
   autograd from a forward run outside the timing, and its forward +
   backward beside it), and the card's least time for the same work; the
   fused attention half, its backward, the MLP half and flash attention's
   backward launched twice on the same inputs must give the same bits;
3. serve: precompute every scar pseudo-prompt (3 classes x 2304 combos)
   twice, timing the cold and the warm pass (prompts/s is the warm one);
   then, after two warm-up batches, a timed window of 200 batches of 32
   seeded uint8 224x224 images (about 2 s on an H100): img/s is all the
   window's images over its wall time, latencies are over all its batches;
4. path: the kernel launches counted in phase 3 (12 of each forward half
   per serve batch and per precompute chunk), and the first 8 serve
   batches run again through the plain versions: fusion logits within
   5e-2, image-feature cosine >= 0.999, tag picks agreeing on >= 95% of
   (image, category) pairs, every output finite;
5. train: ViT-B-32 --use-tagging --use-fusion over fp32 master weights,
   the paper recipe's AdamW (lr 5e-5, wd 0.1, betas (0.9, 0.98), eps 1e-6,
   cosine schedule with warmup 50), batches of 32 seeded uint8 images
   normalized on the card, class ids, one tag per category, the scar
   prompt table and a seeded dropout generator: 3 warm-up steps, then a
   timed window of 30 steps (samples/s, p50/p90 step ms, losses,
   grad_norm), each step launching exactly 24 of each of the forward
   halves and 24 attention-half backward kernels (12 vision + 12 text);
6. train path: one step from the same weights, batch and dropout seed
   with the kernels on and off (autograd through the plain halves and the
   plain normalize), on the batch's ground-truth prompts: loss within 1e-2
   relative, every parameter gradient that is nonzero on the plain side at
   cosine >= 0.99 or within its bf16 noise floor (see phase_train_path),
   global gradient norm within 2%;
7. trainer: ``main_other.main`` on seeded PNG files (256 train and 96 val
   rows of a scar split in the reference's layout), batch 32, 4 loader
   threads: 2 epochs of the plain step, each followed by the scar eval
   (val and train data) and the checkpoint policy (--save-best,
   --delete-previous-checkpoint), then a second call with --resume latest
   and --accum-freq 2 for a third epoch. It prints samples/s, p50 step ms
   and the loss per epoch, eval img/s, seconds per checkpoint save, the
   host ms of one loader item, and the launches per plain step, per
   accumulation step, per eval batch and per classifier build; it fails
   on a value that is not finite, a last plain epoch whose mean loss is
   not below the first's, a missing artifact or checkpoint, launches off
   their expected counts, or a reloaded state that differs in one bit;
8. gap_serve, gap_path, gap_train, gap_train_path: phases 3-6 for the GAP
   tower (batches of 32 seeded uint8 256x256 images), with the same bars;
   per serve batch 12 flash forwards, 12 fused MLPs and 1 normalize; per
   train step 12 flash forwards and backwards and 12 fused MLPs (vision),
   12 of each half and of the attention half's backward (text), 1
   normalize;
9. gap_trainer: one ``main_other.main`` call with ``--model`` naming the
   GAP config through XTAGCLIP_EXTRA_CONFIGS (a JSON written to a
   temporary directory): one plain epoch on 64 train and 32 val seeded
   272x272 PNG rows (crops 256), the scar eval and the checkpoints; it
   fails on a value that is not finite, a missing artifact or checkpoint,
   or launches off their expected counts;
10. predict (after the trainer): the phase-3 model written as an open_clip
   .pt (convert/export.py; reloaded bit for bit) and 70 seeded 224x224
   PNGs (batches 32, 32, 6), then ``predict.main`` five times:
   --pretrained --fusion-classify --export-serving (the torch.export
   artifact: encode_image, encode_text, forward, serve_classify), the same
   from the artifact (--serving-artifact: same classes and tags, probs
   within 0.05), the zero-shot head (--use-tagging, then --fusion-scoring)
   and --resume on the trainer's last tag (finite records, scar classes).
   Each call serves every batch from one CUDA graph: its first serve call
   launches one eager warm-up and one capture (twice one batch's
   launches), later calls launch nothing. The exported serve_classify
   holds 12 + 12 block-half and 1 normalize custom-op nodes. Then the
   serve step on uint8 batches on the card, captured and replayed against
   its eager calls (tag picks equal, features and logits within
   max|ref|/128; bit equality printed) and both timed over the serve
   window (200 batches of 32);
11. gap_predict (last): the GAP tower's serve_classify exported, loaded
   and replayed as a graph against the live eager step, with the same
   bars (12 flash attention, 12 fused MLP and 1 normalize node), both
   timed.

With ``--profile`` it also traces the trainer's second plain epoch, and
then one precompute, 20 serve batches and 5 train steps of each model,
with torch.profiler, and prints, for each window, its wall
time, the device's kernel time, the device's busy share (kernel time over
wall time; the kernels run on one stream) and the device time per kernel,
split into the port's hand-written kernels and everything else.

Then the kernel table (every kernel's launches on the main paths, its
times and its bound), the card's name and power limit (nvidia-smi) and,
as the last line, {"ok": true, "device": {...}}. Any failure raises: the
exit code is then not 0 and the last line is not printed. Without a CUDA
device it exits 1 before doing anything. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the card's published dense bf16 peak (FLOP/s), fp32 peak outside the
# tensor cores (FLOP/s) and memory rate (bytes/s)
_PEAKS = (
    ("H100 PCIe", 756e12, 51e12, 2.0e12),
    ("H100 NVL", 835e12, 60e12, 3.9e12),
    ("H200", 989e12, 67e12, 4.8e12),
    ("H100", 989e12, 67e12, 3.35e12),
)
SERVE_BATCH = 32
N_SERVE_BATCHES = 200  # the timed window
N_WARMUP_BATCHES = 2
N_IMAGE_BATCHES = 8  # distinct seeded batches, cycled; re-run through plain
PRECOMPUTE_BATCH = 512
IMAGE_SIZE = 224
TRAIN_BATCH = SERVE_BATCH  # the kernel rows' batch: they are the step's shapes
N_TRAIN_WARMUP = 3
N_TRAIN_STEPS = 30  # the timed window
N_TRAIN_BATCHES = 4  # distinct seeded batches, cycled
# the paper recipe (scar_openclip_pretrain.sh): AdamW and cosine schedule
TRAIN_LR, TRAIN_WD, TRAIN_WARMUP = 5e-5, 0.1, 50
TRAIN_SCHEDULE_STEPS = 10_000  # nominal length: sets only the cosine decay
# the cls-free GAP tower: ViT-B-16's config with these vision overrides,
# and the name the CLI phase gives its JSON (XTAGCLIP_EXTRA_CONFIGS)
GAP_IMAGE_SIZE = 256
GAP_VISION = {"image_size": GAP_IMAGE_SIZE, "pool_type": "avg",
              "no_class_token": True}
GAP_CONFIG = "ViT-B-16-GAP-256"
GAP_L = (GAP_IMAGE_SIZE // 16) ** 2
# the device code of csrc/ (fused_attn_half.cu, fused_mlp_half.cu,
# fused_attn_half_bwd.cu, normalize_images.cu, flash_attn_fwd.cu,
# flash_attn_bwd.cu, fused_mlp.cu), and gemm_bf16_kernel, the WMMA GEMM of
# earlier commits' fused halves, for their packages run under this script
PORT_KERNELS = ("gemm_bf16_kernel", "gemm_sm90_kernel", "attn_core_kernel",
                "ln_rows_kernel", "mask_by_thread_kernel",
                "attn_bwd_core_kernel", "ln_bwd_rows_kernel",
                "ln_bwd_cols_kernel", "col_sum_kernel", "normalize_u8_kernel",
                "flash_fwd_kernel", "flash_delta_kernel", "flash_dkv_kernel",
                "flash_dq_kernel")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]


def _peaks(name: str):
    """{"bf16": FLOP/s, "fp32": FLOP/s}, bytes/s of the card ``name``."""
    for key, bf16, fp32, rate in _PEAKS:
        if key in name:
            return {"bf16": bf16, "fp32": fp32}, rate
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


def _profiled_split(fn, calls: int = 20, warmup: int = 3) -> dict:
    """{kernel: device ms} of one call of ``fn``: the durations of the
    kernels and copies it runs on the card (torch.profiler), per call. For
    a call whose host side takes longer than its device side, where CUDA
    events would time the host's launch gaps. The profiler can drop events:
    each kind counts as its mean duration times its launches per call (its
    count over ``calls``, rounded, at least one), and a window that recorded
    no device event is traced again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kinds = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and e.count > 0]
        if kinds:
            return {e.key: _device_time_us(e) / e.count
                    * max(1, round(e.count / calls)) / 1e3 for e in kinds}
    raise RuntimeError("torch.profiler recorded no device event in 3 windows")


def _profiled_ms(fn, calls: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` (see _profiled_split)."""
    return sum(_profiled_split(fn, calls, warmup).values())


def _close(out, ref):
    """(ok, max_abs_err, atol) under atol = max|ref|/128, rtol = 1e-2."""
    out, ref = out.float(), ref.float()
    atol = ref.abs().max().item() / 128
    err = (out - ref).abs()
    ok = bool((err <= atol + 1e-2 * ref.abs()).all().item()
              and torch.isfinite(out).all().item())
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
    # the attention half at a serve batch's vision and text blocks, and at
    # a precompute chunk's text blocks (512 prompts of 77 tokens)
    for tower, batch, l, d, h, causal in (
            ("vision", SERVE_BATCH, 50, 768, 12, False),
            ("text", SERVE_BATCH, 77, 512, 8, True),
            ("text", PRECOMPUTE_BATCH, 77, 512, 8, True)):
        x = rnd((batch, l, d), dtype=bf)
        args = (x, 1 + rnd(d, 0.1), rnd(d, 0.1),
                rnd((d, 3 * d), d**-0.5, bf), rnd(3 * d, 0.1),
                rnd((d, d), d**-0.5, bf), rnd(d, 0.1),
                build_causal_mask(l, dev) if causal else None, h, 1e-5)
        flops = 2 * batch * l * d * (4 * d + 2 * l)
        nbytes = (2 * 2 * batch * l * d + 2 * 4 * d * d
                  + 4 * (4 * d + 2 * d) + (4 * l * l if causal else 0))
        cases.append(("fused_attn_half", f"{tower} B={batch} L={l} "
                      f"D={d} H={h}{' causal' if causal else ''}",
                      args, flops, nbytes, "bf16", None))
    # the MLP half at a serve batch's vision and text rows, and at a
    # precompute chunk's text rows (512 prompts of 77 tokens)
    for tower, batch, l, d in (("vision", SERVE_BATCH, 50, 768),
                               ("text", SERVE_BATCH, 77, 512),
                               ("text", PRECOMPUTE_BATCH, 77, 512)):
        hd = 4 * d
        n = batch * l
        for act in ("gelu", "quick_gelu"):
            x = rnd((batch, l, d), dtype=bf)
            args = (x, 1 + rnd(d, 0.1), rnd(d, 0.1), rnd((d, hd), d**-0.5, bf),
                    rnd(hd, 0.1), rnd((hd, d), hd**-0.5, bf), rnd(d, 0.1),
                    act, 1e-5)
            flops = 4 * n * d * hd
            nbytes = 2 * 2 * n * d + 2 * 2 * d * hd + 4 * (3 * d + hd)
            cases.append(("fused_mlp_half", f"{tower} N={n} D={d} "
                          f"H={hd} {act}", args, flops, nbytes, "bf16", None))
    b = TRAIN_BATCH
    for tower, l, d, h, causal in (("vision", 50, 768, 12, False),
                                   ("text", 77, 512, 8, True)):
        args = (rnd((b, l, d), dtype=bf), rnd((b, l, d), dtype=bf),
                1 + rnd(d, 0.1), rnd(d, 0.1), rnd((d, 3 * d), d**-0.5, bf),
                rnd(3 * d, 0.1), rnd((d, d), d**-0.5, bf),
                build_causal_mask(l, dev) if causal else None, h, 1e-5)
        # the Pallas CostEstimate (fused_attn_block.py:728-733), plus the
        # fp32 LN/bias/mask reads and [D] sums
        flops = 2 * b * l * d * (8 * d + 6 * l)
        nbytes = (2 * (2 * b * l * d + 4 * d * d)
                  + 2 * (b * l * d + 3 * b * l * d) + 4 * d * d
                  + 4 * (5 * d + 3 * d) + (4 * l * l if causal else 0))
        cases.append(("fused_attn_half_bwd", f"{tower} B={b} L={l} D={d} "
                      f"H={h}{' causal' if causal else ''}", args, flops,
                      nbytes, "bf16", None))
    # the image normalize: the main path's batch, and a ragged batch whose
    # element count is odd (the kernel's scalar tail); one FMA an element
    from xtagclip_tpu_torch.utils.constants import (
        OPENAI_DATASET_MEAN,
        OPENAI_DATASET_STD,
    )

    for shape in ((SERVE_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), (5, 33, 47, 3)):
        images = torch.randint(0, 256, shape, generator=gen, device=dev,
                               dtype=torch.uint8)
        n = images.numel()
        for dtype, size in ((torch.bfloat16, 2), (torch.float32, 4)):
            cases.append(("normalize_images", f"{'x'.join(map(str, shape))} "
                          f"uint8 -> {str(dtype)[6:]}",
                          (images, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD,
                           dtype), 2 * n, n * (1 + size), "fp32", None))
    cases += _gap_kernel_cases(gen)
    return cases


# flash attention's shapes: the GAP tower's (32, 12, 256, 64), then edge
# shapes (B, H, L, dh): L at one tile, ragged L (ViT-B-16's 197 with its
# class token, ViT-L-14's 257), several tiles, head dim 128
FLASH_CASES = ((TRAIN_BATCH, 12, GAP_L, 64), (1, 12, 128, 64),
               (1, 12, 197, 64), (1, 12, 257, 64), (1, 12, 384, 64),
               (2, 4, 256, 128))


def _gap_kernel_cases(gen):
    """Kernels #4 and #6 at the GAP path's shapes (and #6 at edge
    shapes): q, k, v are column slices of one [B, L, 3 H dh] projection,
    as the model makes them. Library yardsticks (timed, never called by
    the port): scaled_dot_product_attention forward, and its forward and
    backward through autograd."""
    import torch.nn.functional as F

    from xtagclip_tpu_torch.ops import flash_attn

    dev, bf = "cuda", torch.bfloat16
    cases = []
    for b, h, l, dh in FLASH_CASES:
        d = h * dh
        qkv = torch.randn((b, l, 3 * d), generator=gen, device=dev).to(bf)
        q, k, v = (t.reshape(b, l, h, dh) for t in qkv.split(d, dim=-1))
        shape = f"B={b} H={h} L={l} dh={dh}"
        elems = b * h * l * dh
        sdpa_in = [t.transpose(1, 2) for t in (q, k, v)]
        cases.append(("flash_mha", shape, (q, k, v, "blhd"),
                      4 * b * h * l * l * dh, 4 * 2 * elems, "bf16",
                      lambda a=sdpa_in: F.scaled_dot_product_attention(*a)))
        o, lse = flash_attn._flash_fwd(q, k, v, "blhd", with_lse=True)
        do = torch.randn(o.shape, generator=gen, device=dev).to(bf)
        leaves = [t.detach().clone().requires_grad_(True) for t in sdpa_in]
        do_t = do.transpose(1, 2)
        with torch.inference_mode(False), torch.enable_grad():
            sdpa_out = F.scaled_dot_product_attention(*leaves)

        def sdpa_bwd(out=sdpa_out, leaves=leaves, do_t=do_t):
            with torch.inference_mode(False), torch.enable_grad():
                return torch.autograd.grad(out, leaves, do_t,
                                           retain_graph=True)

        def sdpa_fwd_bwd(leaves=leaves, do_t=do_t):
            with torch.inference_mode(False), torch.enable_grad():
                out = F.scaled_dot_product_attention(*leaves)
                return torch.autograd.grad(out, leaves, do_t)

        cases.append(("flash_mha_bwd", shape, (q, k, v, o, lse, do, "blhd"),
                      10 * b * h * l * l * dh,
                      8 * 2 * elems + 4 * b * h * l, "bf16",
                      {"library": sdpa_bwd, "library_fwd_bwd": sdpa_fwd_bwd}))
    n, d, hd = TRAIN_BATCH * GAP_L, 768, 3072
    for rows in (n, 37):
        for act in ("gelu", "quick_gelu"):
            x = torch.randn((rows, d), generator=gen, device=dev).to(bf)
            w1 = (torch.randn((d, hd), generator=gen, device=dev)
                  * d**-0.5).to(bf)
            w2 = (torch.randn((hd, d), generator=gen, device=dev)
                  * hd**-0.5).to(bf)
            b1 = torch.randn(hd, generator=gen, device=dev) * 0.1
            b2 = torch.randn(d, generator=gen, device=dev) * 0.1
            cases.append(("fused_mlp", f"vision N={rows} D={d} H={hd} {act}",
                          (x, w1, b1, w2, b2, act), 4 * rows * d * hd,
                          2 * 2 * rows * d + 2 * 2 * d * hd + 4 * (d + hd),
                          "bf16", None))
    return cases


_KERNEL_META = {
    "fused_attn_half": ("xtagclip_tpu_torch/csrc/fused_attn_half.cu",
                        "xtagclip_tpu/ops/fused_attn_block.py:434"),
    "fused_mlp_half": ("xtagclip_tpu_torch/csrc/fused_mlp_half.cu",
                       "xtagclip_tpu/ops/fused_attn_block.py:796"),
    "fused_attn_half_bwd": ("xtagclip_tpu_torch/csrc/fused_attn_half_bwd.cu",
                            "xtagclip_tpu/ops/fused_attn_block.py:543"),
    "normalize_images": ("xtagclip_tpu_torch/csrc/normalize_images.cu",
                         "xtagclip_tpu/ops/preprocess.py:47"),
    "fused_mlp": ("xtagclip_tpu_torch/csrc/fused_mlp.cu",
                  "xtagclip_tpu/ops/fused_mlp.py:62"),
    "flash_mha": ("xtagclip_tpu_torch/csrc/flash_attn_fwd.cu",
                  "xtagclip_tpu/ops/flash_attn.py:93"),
    "flash_mha_bwd": ("xtagclip_tpu_torch/csrc/flash_attn_bwd.cu",
                      "xtagclip_tpu/ops/flash_attn.py:93"),
}


def _ordered(t):
    """Monotonic integer keys of fp32 values (bf16 widened exactly)."""
    bits = t.float().contiguous().view(torch.int32).long()
    return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


def _close_normalize(out, ref):
    """(ok, max_abs_err, bar): bf16 within one bf16 ULP of the plain
    version on every element; fp32 within one fp32 ulp at the operands'
    scale, 2^-22 (the kernel's one FMA against a multiply and an add)."""
    err = (out.float() - ref.float()).abs().max().item()
    if out.dtype == torch.bfloat16:
        ulps = ((_ordered(out) - _ordered(ref)).abs() >> 16).max().item()
        ok, bar = ulps <= 1, "1 bf16 ULP"
    else:
        ok, bar = err <= 2.0**-22, 2.0**-22
    return ok and bool(torch.isfinite(out).all().item()), err, bar
# kernels whose outputs a run checks for bit-for-bit repeats
_REPEATS = ("fused_attn_half", "fused_mlp_half", "fused_attn_half_bwd",
            "flash_mha_bwd")
_OUTPUTS = {"fused_attn_half_bwd": ("dx", "dqkv", "dwout", "dbout", "dls",
                                     "dlb"),
            "flash_mha_bwd": ("dq", "dk", "dv")}


def _times(kernel_fn, plain_fn, library) -> dict:
    """ms, plain_ms, library_ms: torch.profiler's device time per call (the
    kernels' summed durations), so a wrapper whose host side outlasts its
    kernel (flash attention's, the normalize's) is timed by its kernel;
    ms_by_kernel: ms split by the kernels the wrapper launches; the
    CUDA-event times of back-to-back calls beside them. ``library`` is None,
    one PyTorch call, or {key: call} timed as ``<key>_ms`` (``library`` is
    the yardstick; flash attention's backward also times SDPA's forward and
    backward together as ``library_fwd_bwd``)."""
    libs = library if isinstance(library, dict) else {"library": library}
    split = _profiled_split(kernel_fn)
    out = {"ms": sum(split.values()),
           "ms_by_kernel": {k[:90]: v for k, v in split.items()},
           "plain_ms": _profiled_ms(plain_fn),
           "event_ms": _median_ms(kernel_fn),
           "plain_event_ms": _median_ms(plain_fn)}
    for key, fn in libs.items():
        out[f"{key}_ms"] = None if fn is None else _profiled_ms(fn)
        if fn is not None:
            out[f"{key}_event_ms"] = _median_ms(fn)
    return out


def _kernel_fns():
    """{name: (kernel wrapper, plain version)}, both taking a case's args."""
    from xtagclip_tpu_torch.ops import flash_attn, fused_mlp, preprocess
    from xtagclip_tpu_torch.ops import fused_attn_block as fab

    def plain_flash_bwd(q, k, v, o, lse, do, layout):
        return flash_attn.reference_flash_mha_bwd(q, k, v, o, do, layout)

    return {
        "fused_attn_half": (fab.fused_attn_half, fab.reference_attn_half),
        "fused_mlp_half": (fab.fused_mlp_half, fab.reference_mlp_half),
        "fused_attn_half_bwd": (fab.fused_attn_half_bwd,
                                fab.reference_attn_half_bwd),
        "normalize_images": (preprocess.normalize_images,
                             preprocess.normalize_images_reference),
        "fused_mlp": (fused_mlp.fused_mlp, fused_mlp.reference_fused_mlp),
        "flash_mha": (flash_attn.flash_mha, flash_attn.reference_flash_mha),
        "flash_mha_bwd": (flash_attn.flash_mha_bwd, plain_flash_bwd),
    }


def phase_kernels(card: str):
    peak_flops, peak_rate = _peaks(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    fns = _kernel_fns()
    entries = []
    cases = _kernel_cases(gen)  # outside inference mode: the library rows
    # of flash attention's backward run autograd on their own leaves
    with torch.inference_mode():
        for name, shape, args, flops, nbytes, kind, library in cases:
            kernel, plain = fns[name]
            out = kernel(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            outs, refs = ((out, ref) if isinstance(out, tuple)
                          else ((out,), (ref,)))
            close = _close_normalize if name == "normalize_images" else _close
            checks = [close(o, r) for o, r in zip(outs, refs)]
            bad = [i for i, (ok, _, _) in enumerate(checks) if not ok]
            if bad or len(outs) != len(refs):
                raise AssertionError(
                    f"{name} [{shape}]: kernel disagrees with its plain "
                    f"version in outputs {bad}: (ok, max abs err, atol) "
                    f"{checks} (rtol 1e-2)")
            if name in _REPEATS:  # no atomics: a second launch, same bits
                again = kernel(*args)
                again = again if isinstance(again, tuple) else (again,)
                if not all(torch.equal(a, o) for a, o in zip(again, outs)):
                    raise AssertionError(f"{name} [{shape}]: two launches "
                                         "on the same inputs differ")
            err = max(c[1] for c in checks)
            names = _OUTPUTS.get(name)
            atol = (checks[0][2] if names is None else
                    {k: c[2] for k, c in zip(names, checks)})
            t_flops, t_bytes = flops / peak_flops[kind], nbytes / peak_rate
            source, replaces = _KERNEL_META[name]
            entries.append({
                "name": name, "shape": shape, "card": card, "route": "cuda",
                "peak_type": kind,
                "source": source, "replaces": replaces, "launches": None,
                "max_abs_err": err, "atol": atol,
                **({"repeats_bit_for_bit": True} if name in _REPEATS else {}),
                **({"max_abs_err_by_output": {
                    k: c[1] for k, c in zip(names, checks)}}
                   if names is not None else {}),
                **_times(lambda: kernel(*args), lambda: plain(*args), library),
                "bound_ms": 1e3 * max(t_flops, t_bytes),
                "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            })
    return entries


def _cosine(a, b):
    a, b = a.float(), b.float()
    return torch.nn.functional.cosine_similarity(a, b, dim=-1)


def _wrappers():
    from xtagclip_tpu_torch.ops import flash_attn, fused_mlp, preprocess
    from xtagclip_tpu_torch.ops import fused_attn_block as fab

    return (fab.fused_attn_half, fab.fused_mlp_half, fab.fused_attn_half_bwd,
            preprocess.normalize_images, fused_mlp.fused_mlp,
            flash_attn.flash_mha, flash_attn.flash_mha_bwd)


def _reset_counts() -> None:
    for w in _wrappers():
        w.launches = 0


def _counts() -> dict:
    return {w.__name__: w.launches for w in _wrappers()}


def _want(**nonzero) -> dict:
    """Launches of every wrapper: ``nonzero``, and 0 for the rest."""
    out = dict.fromkeys((w.__name__ for w in _wrappers()), 0)
    out.update(nonzero)
    return out


def _scaled(per, n) -> dict:
    return {k: v * n for k, v in per.items()}


def _paths() -> dict:
    """The two models the serve and train phases drive: their phase-name
    prefix, label, create_model name and overrides, image side, and the
    launches expected per serve batch, per precompute chunk and per train
    step."""
    halves = dict(fused_attn_half=12, fused_mlp_half=12)
    return {
        "b32": dict(
            prefix="", label="ViT-B-32", model="ViT-B-32", kwargs={},
            image=IMAGE_SIZE, per_batch=_want(**halves, normalize_images=1),
            per_chunk=_want(**halves),
            per_step=_want(fused_attn_half=24, fused_mlp_half=24,
                           fused_attn_half_bwd=24, normalize_images=1)),
        "gap": dict(
            prefix="gap_",
            label=f"ViT-B-16 cls-free GAP {GAP_IMAGE_SIZE}px (L={GAP_L})",
            model="ViT-B-16", kwargs={"vision_cfg": GAP_VISION},
            image=GAP_IMAGE_SIZE,
            per_batch=_want(flash_mha=12, fused_mlp=12, normalize_images=1),
            per_chunk=_want(**halves),
            per_step=_want(flash_mha=12, flash_mha_bwd=12, fused_mlp=12,
                           fused_attn_half=12, fused_mlp_half=12,
                           fused_attn_half_bwd=12, normalize_images=1)),
    }


def _serve_batches(side: int):
    """The N_IMAGE_BATCHES seeded host uint8 batches every serve window
    cycles over."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.integers(
        0, 256, (SERVE_BATCH, side, side, 3), dtype=np.uint8))
        for _ in range(N_IMAGE_BATCHES)]


def _scar_prompt_table():
    from xtagclip_tpu_torch.factory import get_tokenizer
    from xtagclip_tpu_torch.tokenize.prompts import PromptTable
    from xtagclip_tpu_torch.train import metadata

    return PromptTable(metadata.SCAR_CLASSNAMES,
                       tokenizer=get_tokenizer("ViT-B-32"),
                       templates=["sentence_1"]).table


def phase_serve_and_path(card: str, path: dict):
    from xtagclip_tpu_torch.factory import cast_for_compute, create_model
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.ops.preprocess import (
        normalize_images,
        normalize_images_reference,
    )
    from xtagclip_tpu_torch.serving import (
        make_xtag_serve_step,
        precompute_prompt_features,
    )

    t0 = time.perf_counter()
    model = create_model(path["model"], use_tagging=True, use_fusion=True,
                         precision="bf16", init_seed=0, **path["kwargs"])
    cast_for_compute(model, torch.bfloat16)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptable = _scar_prompt_table()
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
    _reset_counts()
    _, t_pre_cold = precompute()
    table, t_pre = precompute()
    pre_counts = _counts()

    side = path["image"]
    batches = _serve_batches(side)
    serve = make_xtag_serve_step(model, table)

    def serve_one(i, plain=False):
        norm = normalize_images_reference if plain else normalize_images
        images = norm(batches[i % N_IMAGE_BATCHES].to("cuda"),
                      dtype=torch.bfloat16)
        return serve(images)

    # main path, part 2: warm-up batches, then the timed window, each
    # batch from host uint8 to its results on the device
    _reset_counts()
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
    serve_counts = _counts()

    q = statistics.quantiles(lat, n=100)
    _emit({"phase": path["prefix"] + "serve", "card": card,
           "model": f"{path['label']} xtag bf16", "image_size": side,
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
    n_batches = N_WARMUP_BATCHES + N_SERVE_BATCHES
    want_pre = _scaled(path["per_chunk"], 2 * n_chunks)
    want_serve = _scaled(path["per_batch"], n_batches)
    if pre_counts != want_pre or serve_counts != want_serve:
        raise AssertionError(
            f"kernel launches: precompute {pre_counts} (want {want_pre}), "
            f"serve {serve_counts} (want {want_serve})")

    # the same serve through the plain versions of the halves and the
    # normalize
    set_use_kernels(model, False)
    plain = [serve_one(i, plain=True) for i in range(N_IMAGE_BATCHES)]
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
    result = {"phase": path["prefix"] + "path", "card": card,
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
    return {"precompute": pre_counts, "serve": serve_counts}, model, \
        ptable, serve_one, table


def _train_batches(ptable, side: int = IMAGE_SIZE):
    """N_TRAIN_BATCHES seeded host batches: uint8 images, class ids in
    [0, 3), one tag per category as a [B, 22] multi-hot, and the
    ground-truth prompt (the class's prompt for the batch's own tags)."""
    from xtagclip_tpu_torch.models.clip import (
        NUM_TAGS,
        TAG_CATEGORY_OFFSETS,
        TAG_CATEGORY_SIZES,
        combo_index,
    )

    out = []
    for i in range(N_TRAIN_BATCHES):
        rng = np.random.default_rng(100 + i)
        images = rng.integers(0, 256, (TRAIN_BATCH, side, side, 3),
                              dtype=np.uint8)
        class_ids = rng.integers(0, 3, TRAIN_BATCH)
        local = np.stack([rng.integers(0, n, TRAIN_BATCH)
                          for n in TAG_CATEGORY_SIZES], axis=1)
        additional = np.zeros((TRAIN_BATCH, NUM_TAGS), np.float32)
        np.put_along_axis(additional,
                          local + np.asarray(TAG_CATEGORY_OFFSETS), 1.0, axis=1)
        combo = combo_index(torch.from_numpy(local)).numpy()
        texts = ptable[0, class_ids, combo].astype(np.int64)
        out.append({"images": torch.from_numpy(images),
                    "class_ids": torch.from_numpy(class_ids),
                    "additional": torch.from_numpy(additional),
                    "texts": torch.from_numpy(texts)})
    return out


def _device_batch(host, keys, plain=False):
    """A host batch on the card, its uint8 images normalized there (by
    the kernel, or by its plain version)."""
    from xtagclip_tpu_torch.ops import preprocess

    norm = (preprocess.normalize_images_reference if plain
            else preprocess.normalize_images)
    batch = {"images": norm(host["images"].to("cuda"), dtype=torch.bfloat16)}
    for k in keys:
        batch[k] = host[k].to("cuda")
    return batch


def _new_train_state(model):
    from xtagclip_tpu_torch.train.scheduler import cosine_lr
    from xtagclip_tpu_torch.train.train_state import (
        create_train_state,
        make_optimizer,
    )

    tx = make_optimizer(cosine_lr(TRAIN_LR, TRAIN_WARMUP, TRAIN_SCHEDULE_STEPS),
                        beta1=0.9, beta2=0.98, eps=1e-6,
                        weight_decay=TRAIN_WD,
                        params=dict(model.named_parameters()))
    return create_train_state(model, tx)


def phase_train(card: str, ptable, path: dict):
    """Main path, part 3: the XTag train step, warm-up then a timed
    window, counting the kernel launches of every step."""
    from xtagclip_tpu_torch.factory import create_model
    from xtagclip_tpu_torch.train.loop import make_train_step

    model = create_model(path["model"], use_tagging=True, use_fusion=True,
                         precision="bf16", init_seed=0, **path["kwargs"])
    n_params = sum(p.numel() for p in model.parameters())
    state = _new_train_state(model)
    step = make_train_step({}, prompt_table=torch.from_numpy(
        ptable.astype(np.int64)).to("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    host = _train_batches(ptable, path["image"])
    keys = ("class_ids", "additional")

    def train_one(i):
        nonlocal state
        state, m = step(state, _device_batch(host[i % N_TRAIN_BATCHES], keys),
                        gen)
        return m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    metrics = [train_one(i) for i in range(N_TRAIN_WARMUP)]
    torch.cuda.synchronize()
    lat = []
    t_window = time.perf_counter()
    for i in range(N_TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics.append(train_one(N_TRAIN_WARMUP + i))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    t_window = time.perf_counter() - t_window
    counts = _counts()
    n_steps = N_TRAIN_WARMUP + N_TRAIN_STEPS
    vals = [{k: v.item() for k, v in m.items()} for m in metrics]
    finite = all(math.isfinite(v) for m in vals for v in m.values())
    keys_ok = all(set(m) == {"contrastive_loss", "tagging_loss", "ce_loss",
                             "loss", "logit_scale", "grad_norm"}
                  for m in vals)
    per_step = {k: v / n_steps for k, v in counts.items()}
    q = statistics.quantiles(lat, n=10)
    result = {"phase": path["prefix"] + "train", "card": card,
              "model": f"{path['label']} xtag bf16 over fp32 masters",
              "image_size": path["image"],
              "weights": "seeded random init", "params": n_params,
              "batch": TRAIN_BATCH, "warmup_steps": N_TRAIN_WARMUP,
              "steps": N_TRAIN_STEPS, "window_s": t_window,
              "samples_per_s": TRAIN_BATCH * N_TRAIN_STEPS / t_window,
              "p50_step_ms": 1e3 * statistics.median(lat),
              "p90_step_ms": 1e3 * q[8], "max_step_ms": 1e3 * max(lat),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "loss_first": vals[0]["loss"], "loss_last": vals[-1]["loss"],
              "first_step": vals[0], "last_step": vals[-1],
              "grad_norm_first": vals[0]["grad_norm"],
              "grad_norm_last": vals[-1]["grad_norm"],
              "finite": finite, "launches": counts,
              "launches_per_step": per_step}
    _emit(result)
    if not (finite and keys_ok and per_step == path["per_step"]):
        raise AssertionError(f"train step failed its checks: {result}")
    return counts, train_one


# Parameters whose exact gradient is 0, left out of the gradient check: a
# key bias adds one constant to each query's scores, which the softmax
# removes, so both sides hold rounding noise only.
ZERO_GRAD_PARAMS = ("crossattention.key.bias",)


def _bf16_ulp_shift(x, steps: int):
    """x (bf16) with every element ``steps`` bf16 steps further from zero
    (nearer for a negative ``steps``; zeros move up)."""
    bits = x.view(torch.int16)
    moved = torch.where(bits & 0x7FFF == 0, bits + abs(steps), bits + steps)
    return moved.view(torch.bfloat16)


def _cos(a, b) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return (a @ b / (a.norm() * b.norm()).clamp_min(1e-30)).item()


def phase_train_path(card: str, ptable, path: dict):
    """One step with the kernels on and off from the same weights, batch
    and dropout seed, on the batch's ground-truth prompts (the argmax
    prompt gather is discontinuous: bf16 ties flip a few picks).

    The plain step run again on images one bf16 step up and one step down
    gives each parameter gradient its own bf16 noise floor: the gradients
    that reach the text tower and TQN through the DQNCOS loss move to a
    cosine of 0.984-0.99 under that one-ULP change of the input (an
    NVIDIA H100 80GB HBM3 at 700 W), below a 0.99 bar. A gradient passes at cosine >= 0.99, or at
    cosine >= 0.95 when the kernels move it no further than twice the
    larger one-ULP move. An fp32 step from the same weights is printed
    beside them: how far each bf16 path lies from it, tower by tower."""
    from xtagclip_tpu_torch.factory import create_model
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.train.loop import make_train_step

    kernels = create_model(path["model"], use_tagging=True, use_fusion=True,
                           precision="bf16", init_seed=1, **path["kwargs"])
    plain = copy.deepcopy(kernels)
    set_use_kernels(plain, False)
    fp32 = create_model(path["model"], use_tagging=True, use_fusion=True,
                        precision="fp32", init_seed=1, **path["kwargs"])
    host = _train_batches(ptable, path["image"])[0]
    batch = _device_batch(host, ("additional", "texts"))
    p_batch = _device_batch(host, ("additional", "texts"), plain=True)
    start = copy.deepcopy(plain.state_dict())
    step = make_train_step({})
    runs = (("kernels", kernels, batch), ("plain", plain, p_batch),
            ("plain_up", plain, dict(p_batch, images=_bf16_ulp_shift(
                p_batch["images"], 1))),
            ("plain_down", plain, dict(p_batch, images=_bf16_ulp_shift(
                p_batch["images"], -1))),
            ("fp32", fp32, dict(p_batch, images=p_batch["images"].float())))
    out = {}
    for name, model, b in runs:
        if model is plain:
            plain.load_state_dict(start)
        state = _new_train_state(model)
        gen = torch.Generator(device="cuda").manual_seed(1)
        _, m = step(state, b, gen)
        torch.cuda.synchronize()
        out[name] = ({k: v.item() for k, v in m.items()},
                     {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    (mk, gk), (mp, gp) = out["kernels"], out["plain"]
    names = [n for n in gp if gp[n].abs().max().item() > 0
             and not any(z in n for z in ZERO_GRAD_PARAMS)]

    def dist(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    cos = {n: _cos(gk[n], gp[n]) for n in names}
    under = {}
    for n in names:
        if cos[n] >= 0.99:
            continue
        floor = max(dist(out[k][1][n], gp[n]) for k in ("plain_up",
                                                         "plain_down"))
        under[n] = {"cos": cos[n], "dist": dist(gk[n], gp[n]),
                    "noise_dist": floor}
    failed = [n for n, v in under.items()
              if v["cos"] < 0.95 or v["dist"] > 2 * v["noise_dist"]]

    def tower_cos(g):
        ref = out["fp32"][1]
        res = {}
        for tower in ("visual", "text", "tag_head", "fusion_model"):
            ks = [n for n in names if n.startswith(tower + ".")]
            res[tower] = _cos(torch.cat([g[n].float().flatten() for n in ks]),
                              torch.cat([ref[n].float().flatten() for n in ks]))
        return res

    loss_rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    norm_rel = abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"]
    finite = all(math.isfinite(v) for m in (mk, mp) for v in m.values())
    worst = sorted(under.items(), key=lambda kv: kv[1]["cos"])[:8]
    result = {"phase": path["prefix"] + "train_path", "card": card,
              "model": path["label"], "texts": "ground truth",
              "kernels": mk, "plain": mp, "fp32": out["fp32"][0],
              "loss_rel_err": loss_rel, "grad_norm_rel_err": norm_rel,
              "grads_compared": len(names),
              "grads_missing": sorted(set(gp) - set(gk)),
              "zero_grad_params_max_abs": {
                  n: [gk[n].abs().max().item(), gp[n].abs().max().item()]
                  for n in gp if any(z in n for z in ZERO_GRAD_PARAMS)},
              "grad_cos_min": min(cos.values()),
              "grads_cos_at_least_0.99": len(names) - len(under),
              "grads_under_0.99": len(under),
              "worst_under_0.99": dict(worst),
              "max_dist_over_noise": max(
                  (v["dist"] / v["noise_dist"] for v in under.values()),
                  default=0.0),
              "cos_to_fp32_kernels": tower_cos(gk),
              "cos_to_fp32_plain": tower_cos(gp),
              "grads_failed": failed, "finite": finite}
    _emit(result)
    if not (loss_rel <= 1e-2 and norm_rel <= 2e-2 and not failed
            and finite and not result["grads_missing"]):
        raise AssertionError(f"kernel train step disagrees with plain: "
                             f"{result}")


# the scar label vocabulary (label_info.json) of the reference data
SCAR_LABEL_INFO = {
    "Width": ["Linear", "Widened", "Linear bulging"],
    "Color": ["Normal", "Pink", "Red", "Purple"],
    "Pigmentation": ["Normal", "Pigmented", "Hypopigmented"],
    "Surface": ["Flat", "Hypertrophic", "Keloid", "Atrophic"],
    "Irregular_color": ["no", "mild", "moderate", "severe"],
    "Irregular_height": ["no", "mild", "moderate", "severe"],
}
TRAINER_ROWS = {"scar_train": 256, "scar_val": 96}
TRAINER_IMAGE = 240  # the PNG side; both transforms crop IMAGE_SIZE
TRAINER_WORKERS = 4
TRAINER_EPOCHS = 2  # plain steps; then one epoch of the accumulation step
TRAINER_ACCUM = 2
ARTIFACTS = ("val_data_tagging_output.txt", "val_data_class_output.txt",
             "traindata_val_tagging_output.txt",
             "traindata_val_class_output.txt")
GAP_TRAINER_ROWS = {"scar_train": 64, "scar_val": 32}
GAP_TRAINER_IMAGE = 272  # the PNG side; both transforms crop GAP_IMAGE_SIZE


def _write_scar_split(root, rows: int, rng, side: int = TRAINER_IMAGE) -> str:
    """A scar split in the reference's layout: label_info.json, seeded
    random PNG images and a labels.csv (Name, Class, Use and the six
    attribute columns)."""
    from PIL import Image

    os.makedirs(root)
    with open(os.path.join(root, "label_info.json"), "w") as f:
        json.dump(SCAR_LABEL_INFO, f)
    lines = ["Name,Class,Use," + ",".join(SCAR_LABEL_INFO)]
    for i in range(rows):
        name = f"scar_{i:04d}.png"
        Image.fromarray(rng.integers(
            0, 256, (side, side, 3), dtype=np.uint8)).save(
                os.path.join(root, name), compress_level=1)
        attrs = [v[rng.integers(0, len(v))] for v in SCAR_LABEL_INFO.values()]
        lines.append(f"{name},{rng.integers(1, 4)},yes," + ",".join(attrs))
    path = os.path.join(root, "labels.csv")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _loader_item_ms(root, csv_file, n: int = 64) -> dict:
    """Host ms of one train item, on one thread with nothing else running:
    all of ScarDataset.__getitem__, and its PNG decode + crop alone."""
    from xtagclip_tpu_torch.data.scar import ScarDataset
    from xtagclip_tpu_torch.data.transforms import (
        PreprocessCfg,
        image_transform_train,
    )
    from xtagclip_tpu_torch.factory import get_tokenizer

    ds = ScarDataset(root, csv_file=csv_file, tokenizer=get_tokenizer(
        "ViT-B-32"), transform=image_transform_train(PreprocessCfg(
            size=IMAGE_SIZE)))
    n = min(n, len(ds))
    ds[0]
    t0 = time.perf_counter()
    for i in range(n):
        ds[i]
    item = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    for i in range(n):
        ds.transform(ds.loader(ds.imgs[i]))
    image = (time.perf_counter() - t0) / n
    return {"item": 1e3 * item, "decode_and_crop": 1e3 * image,
            "rest (5 GT prompts tokenized, labels)": 1e3 * (item - image)}


@contextlib.contextmanager
def _probed(targets, log, check=None):
    """Wrap each ``(module, name)`` function for the block: every call
    appends its name, seconds, kernel launches and result to ``log``
    (the launches are read, not counted here), and ``check[name](args,
    result)``, when given, right after the call."""
    saved = []
    for mod, name in targets:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            torch.cuda.synchronize()
            before, t0 = _counts(), time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            after = _counts()
            log.append({"what": _name, "s": time.perf_counter() - t0,
                        "launches": {w: after[w] - before[w] for w in after},
                        "out": out, "call": len(log),
                        "check": (check or {}).get(_name, lambda *_: None)(
                            a, out)})
            return out

        setattr(mod, name, wrapped)
        saved.append((mod, name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _per(calls, n):
    """Launches per unit, summed over ``calls`` and divided by ``n``."""
    tot = {}
    for c in calls:
        for k, v in c["launches"].items():
            tot[k] = tot.get(k, 0) + v
    return {k: v / n for k, v in tot.items()}


def _same_state(a, b) -> bool:
    """Bit for bit: parameters, AdamW moments and step counts, update
    count."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if sa.keys() != sb.keys() or a.step != b.step:
        return False
    if not all(torch.equal(sa[k], sb[k]) for k in sa):
        return False
    oa = a.tx.optimizer.state_dict()["state"]
    ob = b.tx.optimizer.state_dict()["state"]
    return oa.keys() == ob.keys() and all(
        oa[i].keys() == ob[i].keys()
        and all(torch.equal(oa[i][k], ob[i][k]) for k in oa[i]) for i in oa)


def phase_trainer(card: str, keep_tag: str, profile: bool = False):
    """Main path, part 4: the scar training CLI, ``main_other.main``, as a
    user runs it (the recipe of scar_openclip_pretrain.sh at batch 32):
    seeded PNG files through ScarDataset, the train and eval transforms
    and the threaded loader; TRAINER_EPOCHS epochs of the plain step with
    the scar eval after each and the four best checkpoints, then a second
    call with --resume latest that reloads the state and runs one epoch of
    the accumulation step. Returns the launches of both calls, and keeps
    the last checkpoint tag (hard links) at ``keep_tag``. With
    ``profile``, the second plain epoch (loader included) runs inside a
    torch.profiler window, which slows its host side."""
    from xtagclip_tpu_torch.cli import main_other
    from xtagclip_tpu_torch.train import checkpoint, zero_shot
    from xtagclip_tpu_torch.train.logger import close_logging

    train_one_epoch = main_other.train_one_epoch
    epoch_calls = []

    def profiled_epoch(*a, **k):
        epoch_calls.append(None)
        if len(epoch_calls) != TRAINER_EPOCHS:
            return train_one_epoch(*a, **k)
        out = []
        _profile_window(
            f"trainer epoch {TRAINER_EPOCHS}: "
            f"{TRAINER_ROWS['scar_train'] // TRAIN_BATCH} plain steps of "
            f"{TRAIN_BATCH} with the loader",
            lambda: out.append(train_one_epoch(*a, **k)), card)
        return out[0]

    log, first_state = [], {}
    # the state --resume latest restored, held to the one the first call
    # saved, before the second call trains it further
    check = {"restore_train_state": lambda a, out: _same_state(
        a[2], first_state["state"])}
    targets = ((main_other, "train_one_epoch"), (zero_shot, "run_scar_eval"),
               (zero_shot, "build_zero_shot_classifier"),
               (checkpoint, "save_train_state"),
               (main_other, "restore_train_state"))
    with tempfile.TemporaryDirectory(prefix="xtag_trainer_") as tmp:
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        csvs = {split: _write_scar_split(os.path.join(tmp, split), n, rng)
                for split, n in TRAINER_ROWS.items()}
        t_data = time.perf_counter() - t0
        logs = os.path.join(tmp, "logs")
        common = [
            "--model", "ViT-B-32", "--use-tagging", "--use-fusion",
            "--train-data", os.path.join(tmp, "scar_train"),
            "--val-data", os.path.join(tmp, "scar_val"),
            "--scar-train-csv", csvs["scar_train"],
            "--scar-val-csv", csvs["scar_val"],
            "--batch-size", str(TRAIN_BATCH), "--workers",
            str(TRAINER_WORKERS), "--precision", "amp", "--lr",
            str(TRAIN_LR), "--wd", str(TRAIN_WD), "--warmup",
            str(TRAIN_WARMUP), "--prompt-template-setting", "total",
            "--logs", logs, "--name", "trainer", "--log-every-n-steps", "1",
            "--zeroshot-frequency", "1", "--save-best",
            "--delete-previous-checkpoint", "--seed", "0"]
        _reset_counts()
        t0 = time.perf_counter()
        if profile:
            main_other.train_one_epoch = profiled_epoch
        try:
            with _probed(targets, log, check):
                first = main_other.main(common + ["--epochs",
                                                  str(TRAINER_EPOCHS)])
                first_state["state"] = first["state"]
                n_first = len(log)
                second = main_other.main(common + [
                    "--epochs", str(TRAINER_EPOCHS + 1), "--resume", "latest",
                    "--accum-freq", str(TRAINER_ACCUM)])
        finally:
            main_other.train_one_epoch = train_one_epoch
            close_logging()
        t_run = time.perf_counter() - t0
        counts = _counts()
        ckpt_dir = os.path.join(logs, "trainer", "checkpoints")
        listing = sorted(os.listdir(ckpt_dir))
        missing = [a for a in ARTIFACTS + (
            f"epoch_{TRAINER_EPOCHS + 1}", "epoch_latest", "last",
            "best_train_top1", "best_train_loss", "best_val_top1",
            "best_tag_acc") if a not in listing]
        stale = [f"epoch_{e}" for e in range(1, TRAINER_EPOCHS + 1)
                 if f"epoch_{e}" in listing]
        loader_ms = _loader_item_ms(os.path.join(tmp, "scar_train"),
                                    csvs["scar_train"])
        restores = [c for c in log if c["what"] == "restore_train_state"]
        reload_exact = len(restores) == 1 and restores[0]["check"] is True
        resumed_epoch = restores[0]["out"] if restores else None
        shutil.copytree(os.path.join(ckpt_dir, "last"), keep_tag,
                        copy_function=os.link)

    epochs = first["epochs"] + second["epochs"]
    trains = [c for c in log if c["what"] == "train_one_epoch"]
    evals = [c for c in log if c["what"] == "run_scar_eval"]
    builds = [c for c in log if c["what"] == "build_zero_shot_classifier"]
    saves = [c["s"] for c in log if c["what"] == "save_train_state"]
    plain_trains = [c for c in trains if c["call"] < n_first]
    accum_trains = [c for c in trains if c["call"] >= n_first]
    steps_per_epoch = TRAINER_ROWS["scar_train"] // TRAIN_BATCH
    eval_images = sum(c["out"]["n"] for c in evals)
    eval_batches = sum(math.ceil(c["out"]["n"] / TRAIN_BATCH) for c in evals)
    per_epoch = []
    for rec, call in zip(epochs, trains):
        tm, ev = rec["train"], rec["eval"]
        per_epoch.append({
            "epoch": rec["epoch"],
            "step": "plain" if call["call"] < n_first else "accum",
            "samples_per_s": tm["samples_per_second"],
            "p50_step_ms": 1e3 * tm["p50_step_s"],
            "loss": tm["loss"], "contrastive_loss": tm["contrastive_loss"],
            "tagging_loss": tm["tagging_loss"],
            **({"ce_loss": tm["ce_loss"]} if "ce_loss" in tm else {}),
            "eval_s": rec["eval_s"], "checkpoint_s": rec["checkpoint_s"],
            "eval": {k: ev[k] for k in sorted(ev) if k.endswith((
                "top1", "top2", "tag_accuracy", "tag_f1", "-n"))}})
    values = [v for e in per_epoch for v in (
        e["loss"], e["samples_per_s"], e["p50_step_ms"],
        *e["eval"].values())]
    finite = all(math.isfinite(v) for v in values)
    falling = per_epoch[TRAINER_EPOCHS - 1]["loss"] < per_epoch[0]["loss"]
    per_plain_step = _per(plain_trains, steps_per_epoch * len(plain_trains))
    per_accum_step = _per(accum_trains, steps_per_epoch * len(accum_trains))
    per_eval_batch = _per(evals, eval_batches)
    per_build = _per(builds, len(builds))
    result = {
        "phase": "trainer", "card": card,
        "entry": "xtagclip_tpu_torch.cli.main_other.main, twice",
        "data": f"seeded PNG files {TRAINER_IMAGE}x{TRAINER_IMAGE} "
                f"({TRAINER_ROWS}), crops {IMAGE_SIZE}, "
                f"{TRAINER_WORKERS} loader threads",
        "data_write_s": t_data, "run_s": t_run,
        "loader_item_ms_one_thread": loader_ms,
        "model": "ViT-B-32 xtag, bf16 over fp32 masters, seeded random init",
        "profiled_epoch": TRAINER_EPOCHS if profile else None,
        "batch": TRAIN_BATCH, "accum_freq": TRAINER_ACCUM,
        "steps_per_epoch": steps_per_epoch, "epochs": per_epoch,
        "eval_images": eval_images, "eval_img_per_s":
            eval_images / sum(c["s"] for c in evals),
        "classifier_builds": len(builds),
        "checkpoint_save_s": saves,
        "resumed_at_epoch": resumed_epoch, "reload_bit_exact": reload_exact,
        "checkpoints": listing, "missing": missing,
        "not_deleted": stale, "finite": finite,
        "plain_loss_falls": falling,
        "launches": counts,
        "launches_per_plain_step": per_plain_step,
        "launches_per_accum_step": per_accum_step,
        "launches_per_eval_batch": per_eval_batch,
        "launches_per_classifier_build": per_build}
    _emit(result)
    want_plain = _paths()["b32"]["per_step"]
    want_accum = _want(fused_attn_half=48 * TRAINER_ACCUM,
                       fused_mlp_half=48 * TRAINER_ACCUM,
                       fused_attn_half_bwd=24 * TRAINER_ACCUM,
                       normalize_images=1)
    want_eval = _paths()["b32"]["per_batch"]
    want_build = _paths()["b32"]["per_chunk"]
    if not (finite and falling and reload_exact and not missing
            and not stale and resumed_epoch == TRAINER_EPOCHS - 1
            and len(epochs) == TRAINER_EPOCHS + 1
            and per_plain_step == want_plain
            and per_accum_step == want_accum
            and per_eval_batch == want_eval and per_build == want_build):
        raise AssertionError(f"trainer phase failed its checks: {result}")
    return counts


def phase_gap_trainer(card: str):
    """The GAP tower's main path, part 4: the scar training CLI as a user
    reaches a config of their own, ``--model`` naming a JSON in an
    XTAGCLIP_EXTRA_CONFIGS directory (ViT-B-16's config with the GAP
    vision overrides): one plain epoch with the scar eval and the
    checkpoint policy. Returns the launches of the call."""
    from xtagclip_tpu_torch.cli import main_other
    from xtagclip_tpu_torch.factory import get_model_config
    from xtagclip_tpu_torch.train import checkpoint, zero_shot
    from xtagclip_tpu_torch.train.logger import close_logging

    path = _paths()["gap"]
    log = []
    targets = ((main_other, "train_one_epoch"), (zero_shot, "run_scar_eval"),
               (zero_shot, "build_zero_shot_classifier"),
               (checkpoint, "save_train_state"))
    env_before = os.environ.get("XTAGCLIP_EXTRA_CONFIGS")
    with tempfile.TemporaryDirectory(prefix="xtag_gap_trainer_") as tmp:
        cfg = get_model_config(path["model"])
        cfg["vision_cfg"].update(GAP_VISION)
        cfg_dir = os.path.join(tmp, "configs")
        os.makedirs(cfg_dir)
        with open(os.path.join(cfg_dir, f"{GAP_CONFIG}.json"), "w") as f:
            json.dump(cfg, f)
        rng = np.random.default_rng(1)
        t0 = time.perf_counter()
        csvs = {split: _write_scar_split(os.path.join(tmp, split), n, rng,
                                         GAP_TRAINER_IMAGE)
                for split, n in GAP_TRAINER_ROWS.items()}
        t_data = time.perf_counter() - t0
        logs = os.path.join(tmp, "logs")
        argv = [
            "--model", GAP_CONFIG, "--use-tagging", "--use-fusion",
            "--train-data", os.path.join(tmp, "scar_train"),
            "--val-data", os.path.join(tmp, "scar_val"),
            "--scar-train-csv", csvs["scar_train"],
            "--scar-val-csv", csvs["scar_val"],
            "--batch-size", str(TRAIN_BATCH), "--workers",
            str(TRAINER_WORKERS), "--precision", "amp", "--lr",
            str(TRAIN_LR), "--wd", str(TRAIN_WD), "--warmup",
            str(TRAIN_WARMUP), "--prompt-template-setting", "total",
            "--logs", logs, "--name", "gap", "--log-every-n-steps", "1",
            "--zeroshot-frequency", "1", "--save-best", "--seed", "0",
            "--epochs", "1"]
        os.environ["XTAGCLIP_EXTRA_CONFIGS"] = cfg_dir
        _reset_counts()
        t0 = time.perf_counter()
        try:
            with _probed(targets, log):
                out = main_other.main(argv)
        finally:
            if env_before is None:
                os.environ.pop("XTAGCLIP_EXTRA_CONFIGS", None)
            else:
                os.environ["XTAGCLIP_EXTRA_CONFIGS"] = env_before
            close_logging()
        t_run = time.perf_counter() - t0
        counts = _counts()
        listing = sorted(os.listdir(os.path.join(logs, "gap", "checkpoints")))
        missing = [a for a in ARTIFACTS + (
            "epoch_1", "epoch_latest", "last", "best_train_top1",
            "best_train_loss", "best_val_top1", "best_tag_acc")
            if a not in listing]
        cls_free = "visual.class_embedding" not in \
            out["state"].model.state_dict()

    (rec,) = out["epochs"]
    tm, ev = rec["train"], rec["eval"]
    trains = [c for c in log if c["what"] == "train_one_epoch"]
    evals = [c for c in log if c["what"] == "run_scar_eval"]
    builds = [c for c in log if c["what"] == "build_zero_shot_classifier"]
    steps = GAP_TRAINER_ROWS["scar_train"] // TRAIN_BATCH
    eval_images = sum(c["out"]["n"] for c in evals)
    eval_batches = sum(math.ceil(c["out"]["n"] / TRAIN_BATCH) for c in evals)
    per_step = _per(trains, steps)
    per_eval_batch = _per(evals, eval_batches)
    per_build = _per(builds, len(builds))
    evals_kept = {k: ev[k] for k in sorted(ev) if k.endswith((
        "top1", "top2", "tag_accuracy", "tag_f1", "-n"))}
    values = [tm["loss"], tm["samples_per_second"], tm["p50_step_s"],
              *evals_kept.values()]
    finite = all(math.isfinite(v) for v in values)
    result = {
        "phase": "gap_trainer", "card": card,
        "entry": f"xtagclip_tpu_torch.cli.main_other.main --model "
                 f"{GAP_CONFIG} (XTAGCLIP_EXTRA_CONFIGS)",
        "model": f"{path['label']} xtag, bf16 over fp32 masters, seeded "
                 "random init",
        "data": f"seeded PNG files {GAP_TRAINER_IMAGE}x{GAP_TRAINER_IMAGE} "
                f"({GAP_TRAINER_ROWS}), crops {GAP_IMAGE_SIZE}, "
                f"{TRAINER_WORKERS} loader threads",
        "data_write_s": t_data, "run_s": t_run, "batch": TRAIN_BATCH,
        "steps": steps, "samples_per_s": tm["samples_per_second"],
        "p50_step_ms": 1e3 * tm["p50_step_s"], "loss": tm["loss"],
        "eval_s": rec["eval_s"], "checkpoint_s": rec["checkpoint_s"],
        "eval": evals_kept, "eval_images": eval_images,
        "eval_img_per_s": eval_images / sum(c["s"] for c in evals),
        "classifier_builds": len(builds), "checkpoints": listing,
        "missing": missing, "cls_free": cls_free, "finite": finite,
        "launches": counts, "launches_per_plain_step": per_step,
        "launches_per_eval_batch": per_eval_batch,
        "launches_per_classifier_build": per_build}
    _emit(result)
    if not (finite and not missing and cls_free
            and per_step == path["per_step"]
            and per_eval_batch == path["per_batch"]
            and per_build == path["per_chunk"]):
        raise AssertionError(f"GAP trainer phase failed its checks: {result}")
    return counts


PREDICT_IMAGES = 70  # two batches of 32 and a ragged one of 6
SERVED_OPS = {  # custom-op nodes of each exported serve_classify program
    "b32": {"fused_attn_half": 12, "fused_mlp_half": 12,
            "normalize_images": 1},
    "gap": {"flash_mha": 12, "fused_mlp": 12, "normalize_images": 1}}


def _write_pngs(root, n: int, side: int, rng) -> None:
    from PIL import Image

    os.makedirs(root)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
                        ).save(os.path.join(root, f"img_{i:03d}.png"),
                               compress_level=1)


def _decode_ms(root, side: int) -> float:
    """Host ms per image of the CLI's decode and eval crop, one thread."""
    from PIL import Image

    from xtagclip_tpu_torch.data.transforms import (
        PreprocessCfg,
        image_transform_eval,
    )

    transform = image_transform_eval(PreprocessCfg(size=side))
    names = sorted(os.listdir(root))
    t0 = time.perf_counter()
    for n in names:
        np.asarray(transform(Image.open(os.path.join(root, n)).convert("RGB")))
    return 1e3 * (time.perf_counter() - t0) / len(names)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _op_nodes(program) -> dict:
    """{custom op: nodes} of an exported program's graph module."""
    out = {}
    for n in program.graph.nodes:
        target = str(n.target)
        if n.op == "call_function" and target.startswith("xtagclip_tpu_torch."):
            name = target.split(".")[1]
            out[name] = out.get(name, 0) + 1
    return out


def _step_window(fn, batches, n: int = N_SERVE_BATCHES) -> dict:
    """img/s and p50 batch ms of ``fn`` over ``n`` batches cycling
    ``batches`` (uint8 on the device in, results on the device out), each
    ending in a synchronize, after N_WARMUP_BATCHES calls."""
    for i in range(N_WARMUP_BATCHES):
        fn(batches[i % len(batches)])
    torch.cuda.synchronize()
    lat = []
    t_window = time.perf_counter()
    for i in range(n):
        t0 = time.perf_counter()
        fn(batches[i % len(batches)])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    t_window = time.perf_counter() - t_window
    return {"img_per_s": SERVE_BATCH * n / t_window,
            "p50_batch_ms": 1e3 * statistics.median(lat),
            "window_s": t_window}


def _within(out, ref) -> tuple:
    """(ok, max abs err, atol) under atol = max|ref|/128."""
    out, ref = out.float(), ref.float()
    atol = ref.abs().max().item() / 128
    err = (out - ref).abs().max().item()
    return bool(err <= atol and torch.isfinite(out).all().item()), err, atol


def _graph_vs_eager(eager, graphed, batches) -> dict:
    """Each batch through the replayed graph and through an eager call of
    the same step: tag picks equal, features and logits within
    max|ref|/128, and whether every output held bit for bit."""
    ok, bits, errs = True, True, {"feat": 0.0, "logits": 0.0}
    for x in batches:
        got = [t.clone() for t in graphed(x)]  # the graph's static outputs
        want = eager(x)
        torch.cuda.synchronize()
        ok &= torch.equal(got[1], want[1])
        for key, j in (("feat", 0), ("logits", 2)):
            close, err, _ = _within(got[j], want[j])
            ok &= close
            errs[key] = max(errs[key], err)
        bits &= all(torch.equal(g, w) for g, w in zip(got, want))
    return {"ok": bool(ok), "bit_equal": bool(bits),
            "feat_max_abs_err": errs["feat"],
            "logits_max_abs_err": errs["logits"]}


def _graphed_serve(runner, eager, batches, per_batch) -> dict:
    """Warm up and capture ``runner`` on the first batch, counting the
    launches of each; then the replays against ``eager`` and both timed
    over the same window. Raises if the launches at capture are not one
    batch's ``per_batch`` or a replay counts one."""
    x0 = batches[0]
    _reset_counts()
    runner.warm_up(x0)
    warm = _counts()
    _reset_counts()
    runner.capture(x0)
    capture = _counts()
    _reset_counts()
    graphed = _step_window(runner, batches)
    replays = _counts()
    eager_t = _step_window(eager, batches)
    check = _graph_vs_eager(eager, runner, batches)
    zero = _want()
    if warm != per_batch or capture != per_batch or replays != zero:
        raise AssertionError(
            f"CUDA graph launches: warm-up {warm}, capture {capture} (want "
            f"{per_batch} each), replays {replays} (want none)")
    return {"launches_warm_up": warm, "launches_at_capture": capture,
            "launches_in_replays": replays, "graph_vs_eager": check,
            "eager": eager_t, "graphed": graphed,
            "speedup": graphed["img_per_s"] / eager_t["img_per_s"]}


def phase_predict(card: str, model, table, resume_tag: str, tmp: str):
    """Main path, part 5: the predict CLI, ``predict.main``, as a user runs
    it on XTag ViT-B-32 at full width in bf16: the seeded model written as
    an open_clip .pt (convert/export.py), 70 seeded 224x224 PNGs (batches
    of 32, 32 and a ragged 6), then the CLI with --pretrained and
    --fusion-classify --export-serving, from the artifact
    (--serving-artifact), on the zero-shot head (--use-tagging, then
    --fusion-scoring), and with --resume on the trainer phase's last tag.
    Then the serve step (uint8 on the card in) as a CUDA graph against its
    eager calls, both timed over the serve phase's window. Returns the
    CLI calls' launches."""
    from xtagclip_tpu_torch.cli import predict
    from xtagclip_tpu_torch.convert import serving as cs
    from xtagclip_tpu_torch.convert.export import save_open_clip_checkpoint
    from xtagclip_tpu_torch.factory import (
        cast_for_compute,
        create_model,
        load_checkpoint,
    )
    from xtagclip_tpu_torch.serving import CudaGraphRunner, make_serve_classify
    from xtagclip_tpu_torch.train import metadata

    path = _paths()["b32"]
    root = os.path.join(tmp, "predict")
    os.makedirs(root)
    pt = os.path.join(root, "vit_b32_xtag.pt")
    t0 = time.perf_counter()
    save_open_clip_checkpoint(model, pt)
    t_pt = time.perf_counter() - t0
    back = create_model("ViT-B-32", use_tagging=True, use_fusion=True,
                        precision="bf16", init_seed=1)
    load_checkpoint(back, pt)
    cast_for_compute(back, torch.bfloat16)
    theirs = dict(back.named_parameters())
    reload_exact = all(torch.equal(p, theirs[n])
                       for n, p in model.named_parameters())
    del back, theirs
    images = os.path.join(root, "images")
    _write_pngs(images, PREDICT_IMAGES, IMAGE_SIZE, np.random.default_rng(7))
    decode_ms = _decode_ms(images, IMAGE_SIZE)

    art = os.path.join(root, "artifact")
    runs = {
        "live": ["--model", "ViT-B-32", "--pretrained", pt,
                 "--fusion-classify", "--export-serving", art],
        "artifact": ["--serving-artifact", art, "--fusion-classify"],
        "zero_shot": ["--model", "ViT-B-32", "--pretrained", pt,
                      "--use-tagging"],
        "fusion_scoring": ["--model", "ViT-B-32", "--pretrained", pt,
                           "--use-tagging", "--fusion-scoring"],
        "resume": ["--model", "ViT-B-32", "--resume", resume_tag,
                   "--fusion-classify"],
    }
    log, recs, cli = [], {}, {}
    targets = ((cs, "save_serving"), (cs, "load_serving"),
               (CudaGraphRunner, "__call__"))
    _reset_counts()
    with _probed(targets, log):
        for name, flags in runs.items():
            out = os.path.join(root, f"{name}.jsonl")
            n_before = len(log)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as said:
                predict.main(["--input", images, "--batch-size",
                              str(SERVE_BATCH), "--output", out, *flags])
            wall = time.perf_counter() - t0
            recs[name] = _jsonl(out)
            calls = [c for c in log[n_before:] if c["what"] == "__call__"]
            cli[name] = {
                "s": wall, "img_per_s": len(recs[name]) / wall,
                "serve_calls": len(calls),
                "first_call_ms": 1e3 * calls[0]["s"],
                "later_calls_ms": [1e3 * c["s"] for c in calls[1:]],
                "launches_first_call": calls[0]["launches"],
                "launches_later_calls": _per(calls[1:], 1),
                "printed": said.getvalue().strip().splitlines()}
    cli_counts = _counts()
    manifest = cs.read_manifest(art)
    loads = [c for c in log if c["what"] == "load_serving"]
    program = loads[0]["out"]["serve_classify"].fn

    names = metadata.SCAR_CLASSNAMES
    live, from_art = recs["live"], recs["artifact"]
    art_ok = len(live) == len(from_art) == PREDICT_IMAGES and all(
        (a["image"], a["class"], a["tags"]) == (b["image"], b["class"],
                                                b["tags"])
        and all(abs(a["probs"][c] - p) < 0.05 for c, p in b["probs"].items())
        for a, b in zip(from_art, live))
    art_max_prob_err = max(abs(a["probs"][c] - p) for a, b in zip(
        from_art, live) for c, p in b["probs"].items())
    recs_ok = all(
        len(r) == PREDICT_IMAGES and all(
            x["class"] in names and len(x["tags"]) == 6
            and all(math.isfinite(p) for p in x["probs"].values())
            for x in r) for r in recs.values())
    twice = _scaled(path["per_batch"], 2)  # an eager warm-up + the capture
    launches_ok = all(
        c["serve_calls"] == math.ceil(PREDICT_IMAGES / SERVE_BATCH)
        and c["launches_first_call"] == twice
        and not any(c["launches_later_calls"].values()) for c in cli.values())
    nodes = _op_nodes(program)

    # the serve step as a CUDA graph against its eager calls
    batches = [b.to("cuda") for b in _serve_batches(IMAGE_SIZE)]
    eager = make_serve_classify(model, table)
    graph = _graphed_serve(CudaGraphRunner(eager), eager, batches,
                           path["per_batch"])
    result = {
        "phase": "predict", "card": card,
        "entry": "xtagclip_tpu_torch.cli.predict.main, five calls",
        "model": "ViT-B-32 xtag bf16, seeded random init via an open_clip .pt",
        "pt_write_s": t_pt, "pt_bytes": os.path.getsize(pt),
        "pt_reload_bit_exact": reload_exact,
        "images": PREDICT_IMAGES, "host_decode_ms_per_image": decode_ms,
        "cli": cli,
        "artifact_entries": {k: {f: v[f] for f in (
            "bytes", "export_s", "save_s", "in_avals", "out_avals")}
            for k, v in manifest["entries"].items()},
        "artifact_load_s": loads[0]["s"],
        "artifact_vs_live": {"ok": art_ok, "max_prob_err": art_max_prob_err},
        "records_ok": recs_ok, "launches_ok": launches_ok,
        "serve_classify_op_nodes": nodes, "graph": graph,
        "launches": cli_counts}
    _emit(result)
    if not (reload_exact and art_ok and recs_ok and launches_ok
            and nodes == SERVED_OPS["b32"] and graph["graph_vs_eager"]["ok"]):
        raise AssertionError(f"predict phase failed its checks: {result}")
    return cli_counts


def phase_gap_predict(card: str, model, table, tmp: str):
    """The GAP tower's serving artifact: serve_classify exported
    (convert/serving.py), loaded and replayed as a CUDA graph against the
    live eager step, with the predict phase's bars; its program holds 12
    flash attention, 12 fused MLP and one normalize custom-op nodes.
    Returns the launches of the artifact's warm-up and capture (its
    export and load launch none, its replays count none)."""
    from xtagclip_tpu_torch.convert import serving as cs
    from xtagclip_tpu_torch.serving import make_serve_classify
    from xtagclip_tpu_torch.train import metadata

    path = _paths()["gap"]
    art = os.path.join(tmp, "gap_artifact")
    batches = [b.to("cuda") for b in _serve_batches(GAP_IMAGE_SIZE)]
    eager = make_serve_classify(model, table)
    _reset_counts()
    t0 = time.perf_counter()
    manifest = cs.save_serving(model, art, model_name=GAP_CONFIG, entries=(),
                               serve_classify_table=table,
                               classnames=metadata.SCAR_CLASSNAMES)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner = cs.load_serving(art)["serve_classify"]
    t_load = time.perf_counter() - t0
    graph = _graphed_serve(runner, eager, batches, path["per_batch"])
    counts = {k: v + graph["launches_at_capture"][k]  # replays count none
              for k, v in graph["launches_warm_up"].items()}
    nodes = _op_nodes(runner.fn)
    entry = manifest["entries"]["serve_classify"]
    result = {"phase": "gap_predict", "card": card,
              "model": f"{path['label']} xtag bf16, seeded random init",
              "export_s": entry["export_s"], "save_s": entry["save_s"],
              "bytes": entry["bytes"], "save_serving_s": t_save,
              "load_s": t_load, "in_avals": entry["in_avals"],
              "out_avals": entry["out_avals"],
              "serve_classify_op_nodes": nodes, "graph": graph}
    _emit(result)
    if not (nodes == SERVED_OPS["gap"] and graph["graph_vs_eager"]["ok"]):
        raise AssertionError(f"gap_predict phase failed its checks: {result}")
    return counts


def _ptxas_report(built: dict) -> dict:
    """{kernel entry: [registers, spill store bytes, spill load bytes]} from
    nvcc's -Xptxas -v report of one library (its .log beside it)."""
    import re
    from pathlib import Path

    log = built["log"] or Path(built["path"]).with_suffix(".log").read_text()
    out, entry, spills = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = [int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry] = [int(m.group(1)), *(spills or [0, 0])]
            entry, spills = None, None
    return out


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
    host = {}
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):
            continue  # a span around kernels (optimizer.step), not a kernel
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] += _device_time_us(evt) / 1e3
        elif evt.device_type == torch.autograd.DeviceType.CPU:
            host[evt.key] = (evt.self_cpu_time_total / 1e3, evt.count)
    kernel_ms = sum(by_kernel.values())
    port_ms = sum(v for k, v in by_kernel.items()
                  if any(p in k for p in PORT_KERNELS))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    top_host = sorted(host.items(), key=lambda kv: -kv[1][0])[:10]
    _emit({"phase": "profile", "window": name, "card": card,
           "wall_ms": wall_ms, "device_kernel_ms": kernel_ms,
           "device_busy_share": kernel_ms / wall_ms,
           "port_kernels_ms": port_ms, "other_kernels_ms": kernel_ms - port_ms,
           "top_kernels_ms": {k[:90]: v for k, v in top},
           "host_self_ms_and_calls": {k[:60]: v for k, v in top_host}})


def phase_profile(card, label, model, ptable, serve_one, train_one,
                  n_batches: int = 20, n_steps: int = 5):
    from xtagclip_tpu_torch.serving import precompute_prompt_features

    _profile_window(
        f"{label}: precompute 3x2304 prompts, batch {PRECOMPUTE_BATCH}",
        lambda: precompute_prompt_features(model, ptable, template_id=0,
                                           batch_size=PRECOMPUTE_BATCH),
        card)

    def run_serve():
        for i in range(n_batches):
            serve_one(i)

    _profile_window(f"{label}: serve {n_batches} batches of {SERVE_BATCH}",
                    run_serve, card)

    def run_train():
        for i in range(n_steps):
            train_one(i)

    _profile_window(f"{label}: train {n_steps} steps of {TRAIN_BATCH}",
                    run_train, card)


def main(argv=()) -> int:
    """Run the phases; ``argv`` holds the command-line arguments."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace the trainer's second epoch, precompute, "
                         "serve and train steps with torch.profiler")
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
           "kernels": {k: v["path"] for k, v in built.items()},
           "ptxas": {k: _ptxas_report(v) for k, v in built.items()}})

    entries = phase_kernels(card)
    b32, gap = _paths()["b32"], _paths()["gap"]
    with tempfile.TemporaryDirectory(prefix="xtag_smoke_") as tmp:
        paths, model, ptable, serve_one, table = phase_serve_and_path(
            card, b32)
        paths["train"], train_one = phase_train(card, ptable, b32)
        phase_train_path(card, ptable, b32)
        last_tag = os.path.join(tmp, "trainer_last")
        paths["trainer"] = phase_trainer(card, last_tag, profile=args.profile)
        paths["predict"] = phase_predict(card, model, table, last_tag, tmp)
        gap_paths, g_model, _, g_serve_one, g_table = phase_serve_and_path(
            card, gap)
        paths.update({"gap_" + k: v for k, v in gap_paths.items()})
        paths["gap_train"], g_train_one = phase_train(card, ptable, gap)
        phase_train_path(card, ptable, gap)
        paths["gap_trainer"] = phase_gap_trainer(card)
        paths["gap_predict"] = phase_gap_predict(card, g_model, g_table, tmp)
    if args.profile:
        phase_profile(card, b32["label"], model, ptable, serve_one,
                      train_one)
        phase_profile(card, gap["label"], g_model, ptable, g_serve_one,
                      g_train_one)
    for e in entries:
        e["launches_by_path"] = {k: v[e["name"]] for k, v in paths.items()}
        e["launches"] = sum(e["launches_by_path"].values())
    _emit({"kernels": entries})
    print(card, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
