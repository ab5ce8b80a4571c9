"""Flash attention: a hand-written CUDA kernel pair (forward, backward),
their plain PyTorch versions, and the autograd Function that trains
through them.

Port of xtagclip_tpu/ops/flash_attn.py, which routes no-mask
self-attention of the cls-free GAP towers through the stock Pallas TPU
flash kernel and its Pallas dq / dkv backward kernels:

- ``flash_mha`` / ``flash_mha_bwd``: the wrappers. On a CUDA tensor they
  launch the sm_90a kernels of ``csrc/flash_attn_fwd.cu`` /
  ``csrc/flash_attn_bwd.cu`` (built on first use, ops/cuda_build.py) or
  raise: a shape outside ``supported``, a wrong dtype, a stride the kernel
  cannot read, a build or launch failure all raise, none switches to the
  plain version. On a CPU tensor they run the plain version. Each counts
  its launches in ``<wrapper>.launches``.
- ``reference_flash_mha`` / ``reference_flash_mha_bwd``: the plain
  versions. The forward is exact softmax attention: fp32 scores times
  dh^-0.5, fp32 softmax, the normalized probabilities rounded to the value
  dtype for P @ V, one output rounding. The kernel (as the Pallas kernel)
  rounds the UNnormalized probabilities exp(s - m) and divides by the sum
  after P @ V, so the two differ by rounding only (one bf16 ULP at output
  scale). The backward is the analytic one with the Pallas kernels'
  rounding points: P and dS round to the input dtype before the dq, dk and
  dv products, dP and dS stay fp32, D = rowsum(dO o) in fp32.

``supported`` is derived for Hopper, not copied from the TPU gate (which
needs L % 128 == 0): no mask, Lq == Lk, head dim 64 or 128, any L >= 1;
the kernels mask the ragged last key tile, so L = 197 and 257 run too.

Layouts and scale follow JAX's ``flash_mha``: q, k, v in "blhd" [B, L, H,
dh] (the model's) or "bhld" [B, H, L, dh]; the output in the same layout
and q's dtype; scale dh^-0.5. The kernels read any view whose head dim is
contiguous (the model's q, k, v are column slices of one [B, L, 3D]
projection) and write the output contiguous in the given layout.

Without grad ``flash_mha`` calls the forward through the custom op
``xtagclip_tpu_torch::flash_mha`` (the launcher without the log-sum-exp;
a fake implementation for ``torch.export``); ``_FlashMHA`` calls the
launcher itself, for the log-sum-exp its backward reads.
"""

from __future__ import annotations

import torch

from xtagclip_tpu_torch.ops import cuda_build
from xtagclip_tpu_torch.ops.fused_attn_block import (
    _full_fp32_matmul,
    _needs_grad,
    check_device,
)

_HEAD_DIMS = (64, 128)
LAYOUTS = ("blhd", "bhld")


def supported(l_q: int, l_k: int, mask, head_dim: int) -> bool:
    """Shapes the kernels take: no mask, self-attention-like (Lq == Lk),
    any length, head dim 64 or 128."""
    return (mask is None and l_q == l_k and l_q >= 1
            and head_dim in _HEAD_DIMS)


def _bhld(t, layout):
    """A [B, H, L, dh] view of a tensor in ``layout``."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout: {layout!r}")
    return t.transpose(1, 2) if layout == "blhd" else t


def reference_flash_mha(q, k, v, layout: str = "blhd"):
    """Plain exact attention, the kernel's yardstick (module doc)."""
    qh, kh, vh = (_bhld(t, layout).float() for t in (q, k, v))
    with _full_fp32_matmul():
        s = (qh @ kh.transpose(-1, -2)) * q.shape[-1] ** -0.5
        p = torch.softmax(s, dim=-1)
        o = (p.to(v.dtype).float() @ vh).to(q.dtype)
    return _bhld(o, layout).contiguous()


def reference_flash_mha_bwd(q, k, v, o, do, layout: str = "blhd"):
    """Plain backward of attention from q, k, v, its output o and the
    output cotangent do: (dq, dk, dv) in q's dtype and layout (module
    doc)."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5
    qh, kh, vh, oh, doh = (_bhld(t, layout).float()
                           for t in (q, k, v, o, do))
    with _full_fp32_matmul():
        p = torch.softmax((qh @ kh.transpose(-1, -2)) * scale, dim=-1)
        dv = p.to(dt).float().transpose(-1, -2) @ doh
        dp = doh @ vh.transpose(-1, -2)
        di = (oh * doh).sum(dim=-1, keepdim=True)
        ds = ((dp - di) * p * scale).to(dt).float()
        dq = ds @ kh
        dk = ds.transpose(-1, -2) @ qh
    return tuple(_bhld(g.to(dt), layout).contiguous() for g in (dq, dk, dv))


def _view_strides(t, layout):
    """(b, h, l) element strides of t's [B, H, L, dh] view."""
    s = _bhld(t, layout).stride()
    return [s[0], s[1], s[2]]


def _launch_checks(what, named, layout):
    """Device, dtype, shape, stride and alignment checks for a launch;
    every tensor in ``named`` has q's shape."""
    q = named["q"]
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be 4-D ({layout}), got {tuple(q.shape)}")
    b, h, l, dh = _bhld(q, layout).shape
    if not supported(l, l, None, dh):
        raise ValueError(f"{what}: no kernel for [B, H, L, dh] = "
                         f"{(b, h, l, dh)} (needs head dim 64 or 128)")
    for key, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{what}: {key} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: {key} must be torch.bfloat16, got {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{what}: {key} must have shape {tuple(q.shape)}, "
                             f"got {tuple(t.shape)}")
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError(f"{what}: {key} needs a contiguous head dim, "
                             "strides that are multiples of 8 and a 16-byte "
                             "aligned start")
    return b, h, l, dh


def flash_mha(q, k, v, layout: str = "blhd"):
    """Exact multi-head attention (JAX's ``flash_mha``): the CUDA kernel on
    a CUDA tensor, the plain version on a CPU tensor (module doc);
    differentiable through ``_FlashMHA`` when an input requires grad."""
    _bhld(q, layout)
    check_device("flash_mha", q)
    if _needs_grad(q, k, v):
        return _FlashMHA.apply(q, k, v, layout)
    return flash_mha_op(q, k, v, layout)


def _flash_fwd(q, k, v, layout, with_lse):
    """(o, lse): the forward kernel, with the fp32 log-sum-exp [B, H, L]
    when ``with_lse``; on a CPU tensor the plain version and no lse."""
    if q.device.type == "cpu":
        return reference_flash_mha(q, k, v, layout), None
    what = "flash_mha"
    b, h, l, dh = _launch_checks(what, dict(q=q, k=k, v=v), layout)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, l), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = cuda_build.int64_array(
        [s for t in (q, k, v, o) for s in _view_strides(t, layout)])
    lib = cuda_build.load("flash_attn_fwd")
    err = lib.xtag_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), strides, b, h, l, dh,
        float(dh**-0.5), torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, err, what)
    flash_mha.launches += 1
    return o, lse


flash_mha.launches = 0


@torch.library.custom_op("xtagclip_tpu_torch::flash_mha", mutates_args=())
def flash_mha_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 layout: str) -> torch.Tensor:
    """Attention's forward as a custom op: the kernel on a CUDA tensor (or
    a raise), the plain version on a CPU tensor; the output contiguous in
    q's layout."""
    return _flash_fwd(q, k, v, layout, with_lse=False)[0]


@flash_mha_op.register_fake
def _flash_mha_fake(q, k, v, layout):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def flash_mha_bwd(q, k, v, o, lse, do, layout: str = "blhd"):
    """(dq, dk, dv) of ``flash_mha`` from q, k, v, its output o, the fp32
    log-sum-exp of the forward kernel and the output cotangent do: the
    CUDA kernels on a CUDA tensor, the plain version (which needs no lse)
    on a CPU tensor."""
    if q.device.type == "cpu":
        return reference_flash_mha_bwd(q, k, v, o, do, layout)
    what = "flash_mha_bwd"
    b, h, l, dh = _launch_checks(what, dict(q=q, k=k, v=v, o=o, do=do),
                                 layout)
    if (lse is None or lse.dtype != torch.float32 or lse.device != q.device
            or tuple(lse.shape) != (b, h, l) or not lse.is_contiguous()):
        raise ValueError(f"{what}: lse must be a contiguous fp32 [B, H, L] = "
                         f"{(b, h, l)} tensor on {q.device}")
    dev = q.device
    # per 64-row query tile: lse * log2 e and D = rowsum(dO o), 64 each
    stat = torch.empty((b, h, -(-l // 64) * 128), dtype=torch.float32,
                       device=dev)
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=dev)
                  for _ in range(3))
    strides = cuda_build.int64_array(
        [s for t in (q, k, v, o, do, dq, dk, dv)
         for s in _view_strides(t, layout)])
    lib = cuda_build.load("flash_attn_bwd")
    err = lib.xtag_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), stat.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), strides, b, h, l, dh, float(dh**-0.5),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, err, what)
    flash_mha_bwd.launches += 1
    return dq, dk, dv


flash_mha_bwd.launches = 0


class _FlashMHA(torch.autograd.Function):
    """Attention under autograd: the forward kernel, saving q, k, v, o and
    the fp32 log-sum-exp, and the backward kernels (the Pallas custom VJP's
    residuals and dq / dkv kernels)."""

    @staticmethod
    def forward(ctx, q, k, v, layout):
        o, lse = _flash_fwd(q, k, v, layout, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.layout = layout
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_mha_bwd(q, k, v, o, lse, g.contiguous(),
                                   ctx.layout)
        return dq, dk, dv, None
