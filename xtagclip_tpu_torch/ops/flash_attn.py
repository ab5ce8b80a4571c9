"""Flash attention: a hand-written CUDA kernel pair (forward, backward),
their plain PyTorch versions, and the autograd Function that trains
through them.

Port of xtagclip_tpu/ops/flash_attn.py, which routes no-mask
self-attention of the cls-free GAP towers through the stock Pallas TPU
flash kernel and its Pallas dq / dkv backward kernels:

- ``flash_mha`` / ``flash_mha_bwd``: the wrappers. On a CUDA tensor they
  launch the sm_90a kernels of ``csrc/flash_attn_fwd.cuh`` /
  ``csrc/flash_attn_bwd.cuh`` (built on first use, ops/cuda_build.py,
  the unmasked and the masked instantiations as two libraries each) or
  raise: a shape outside ``supported``, a wrong dtype, a stride the kernel
  cannot read, a build or launch failure all raise, none switches to the
  plain version. On a CPU tensor they run the plain version. Each counts
  its launches in ``<wrapper>.launches``.
- ``reference_flash_mha`` / ``reference_flash_mha_bwd``: the plain
  versions. The forward is exact softmax attention: fp32 scores times
  dh^-0.5, plus the additive mask if one is given, fp32 softmax, the
  normalized probabilities rounded to the value dtype for P @ V, one
  output rounding. The kernel (as the Pallas kernel)
  rounds the UNnormalized probabilities exp(s - m) and divides by the sum
  after P @ V, so the two differ by rounding only (one bf16 ULP at output
  scale). The backward is the analytic one with the Pallas kernels'
  rounding points: P and dS round to the input dtype before the dq, dk and
  dv products, dP and dS stay fp32, D = rowsum(dO o) in fp32.

``supported`` is derived for Hopper, not copied from the TPU gate (which
needs L % 128 == 0 and head dim 64, 128 or 256): Lq == Lk, any L >= 1;
the kernels mask the ragged last key tile, so L = 197 and 257 run too.
No mask, or an additive [L, L] mask (fp32 or bf16, the dtype the tower
builds it in), which the kernels read per score and add in fp32 after
the scale, before the running max, as JAX's ``_reference_chain`` and
``dot_product_attention`` add it; the backward adds it again when it
recomputes P. A row that the mask leaves no key gives NaN, as the plain
softmax does. Head dim 64, or a multiple of 8 from 72 to 128 (ViT-H's
80, ViT-g's 88, ViT-bigG's 104, ViT-e's 112): those run the kernels'
128-wide instantiation, whose tensor maps end at the true head dim, so
the padded columns read as zero and only dh columns are written. Head
dim 256 (the stock Pallas flash's widest): a 256-wide forward with O in
two 128-column halves, and a backward that runs each half of dQ, dK and
dV as a work item of its own. The plain versions take any head dim.

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

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from xtagclip_tpu_torch.ops import cuda_build
from xtagclip_tpu_torch.ops.fused_attn_block import (
    _full_fp32_matmul,
    _needs_grad,
    check_device,
)

HEAD_DIMS = (64,) + tuple(range(72, 129, 8)) + (256,)
LAYOUTS = ("blhd", "bhld")
MASK_DTYPES = (torch.float32, torch.bfloat16)


def supported(l_q: int, l_k: int, mask, head_dim: int) -> bool:
    """Shapes the kernels take: self-attention-like (Lq == Lk), any
    length, no mask or an additive [L, L] one (a tensor), head dim in
    ``HEAD_DIMS`` (module doc)."""
    return ((mask is None or tuple(mask.shape) == (l_q, l_k))
            and l_q == l_k and l_q >= 1 and head_dim in HEAD_DIMS)


def _bhld(t, layout):
    """A [B, H, L, dh] view of a tensor in ``layout``."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout: {layout!r}")
    return t.transpose(1, 2) if layout == "blhd" else t


def _scores(qh, kh, scale, mask):
    """fp32 q k^T * scale, plus the additive mask if one is given."""
    s = (qh @ kh.transpose(-1, -2)) * scale
    return s if mask is None else s + mask.float()


def reference_flash_mha(q, k, v, layout: str = "blhd", mask=None):
    """Plain exact attention, the kernel's yardstick (module doc)."""
    qh, kh, vh = (_bhld(t, layout).float() for t in (q, k, v))
    with _full_fp32_matmul():
        p = torch.softmax(_scores(qh, kh, q.shape[-1] ** -0.5, mask), dim=-1)
        o = (p.to(v.dtype).float() @ vh).to(q.dtype)
    return _bhld(o, layout).contiguous()


def reference_flash_mha_bwd(q, k, v, o, do, layout: str = "blhd",
                            mask=None):
    """Plain backward of attention from q, k, v, its output o and the
    output cotangent do (under the forward's additive ``mask``, if any):
    (dq, dk, dv) in q's dtype and layout (module doc)."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5
    qh, kh, vh, oh, doh = (_bhld(t, layout).float()
                           for t in (q, k, v, o, do))
    with _full_fp32_matmul():
        p = torch.softmax(_scores(qh, kh, scale, mask), dim=-1)
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


def _launch_checks(what, named, layout, mask=None):
    """Device, dtype, shape, stride and alignment checks for a launch;
    every tensor in ``named`` has q's shape; ``mask`` None or [L, L] fp32
    or bf16 on q's device."""
    q = named["q"]
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be 4-D ({layout}), got {tuple(q.shape)}")
    b, h, l, dh = _bhld(q, layout).shape
    if not supported(l, l, mask, dh):
        raise ValueError(f"{what}: no kernel for [B, H, L, dh] = "
                         f"{(b, h, l, dh)} with mask "
                         f"{None if mask is None else tuple(mask.shape)} (needs"
                         f" a head dim in {HEAD_DIMS} and no mask or [L, L])")
    if mask is not None and (mask.dtype not in MASK_DTYPES
                             or mask.device != q.device):
        raise ValueError(f"{what}: the mask must be fp32 or bf16 on "
                         f"{q.device}, got {mask.dtype} on {mask.device}")
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


def flash_mha(q, k, v, layout: str = "blhd", mask=None):
    """Exact multi-head attention (JAX's ``flash_mha``), under an additive
    [L, L] ``mask`` if one is given (it gets no gradient): the CUDA kernel
    on a CUDA tensor, the plain version on a CPU tensor (module doc);
    differentiable through ``_FlashMHA`` when an input requires grad."""
    _bhld(q, layout)
    check_device("flash_mha", q)
    if _needs_grad(q, k, v):
        return _FlashMHA.apply(q, k, v, layout, mask)
    return flash_mha_op(q, k, v, layout, mask)


def _mask_args(mask):
    """(pointer, bf16 flag) of a contiguous mask for the kernels."""
    if mask is None:
        return None, 0
    return mask.data_ptr(), int(mask.dtype == torch.bfloat16)


def _flash_fwd(q, k, v, layout, with_lse, mask=None):
    """(o, lse): the forward kernel, with the fp32 log-sum-exp [B, H, L]
    when ``with_lse``; on a CPU tensor the plain version and no lse."""
    if q.device.type == "cpu":
        return reference_flash_mha(q, k, v, layout, mask), None
    what = "flash_mha"
    b, h, l, dh = _launch_checks(what, dict(q=q, k=k, v=v), layout, mask)
    mask = None if mask is None else mask.contiguous()
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, l), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = cuda_build.int64_array(
        [s for t in (q, k, v, o) for s in _view_strides(t, layout)])
    name = "flash_attn_fwd" if mask is None else "flash_attn_fwd_masked"
    lib = cuda_build.load(name)
    err = getattr(lib, f"xtag_{name}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), strides, b, h, l, dh,
        float(dh**-0.5), *_mask_args(mask),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, err, what)
    flash_mha.launches += 1
    return o, lse


flash_mha.launches = 0


@torch.library.custom_op("xtagclip_tpu_torch::flash_mha", mutates_args=())
def flash_mha_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 layout: str, mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Attention's forward as a custom op: the kernel on a CUDA tensor (or
    a raise), the plain version on a CPU tensor; the output contiguous in
    q's layout."""
    return _flash_fwd(q, k, v, layout, with_lse=False, mask=mask)[0]


@flash_mha_op.register_fake
def _flash_mha_fake(q, k, v, layout, mask=None):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def flash_mha_bwd(q, k, v, o, lse, do, layout: str = "blhd", mask=None):
    """(dq, dk, dv) of ``flash_mha`` from q, k, v, its output o, the fp32
    log-sum-exp of the forward kernel, the output cotangent do and the
    forward's ``mask``: the CUDA kernels on a CUDA tensor, the plain
    version (which needs no lse) on a CPU tensor."""
    if q.device.type == "cpu":
        return reference_flash_mha_bwd(q, k, v, o, do, layout, mask)
    what = "flash_mha_bwd"
    b, h, l, dh = _launch_checks(what, dict(q=q, k=k, v=v, o=o, do=do),
                                 layout, mask)
    mask = None if mask is None else mask.contiguous()
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
    name = "flash_attn_bwd" if mask is None else "flash_attn_bwd_masked"
    lib = cuda_build.load(name)
    err = getattr(lib, f"xtag_{name}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), stat.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), strides, b, h, l, dh, float(dh**-0.5),
        *_mask_args(mask), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, err, what)
    flash_mha_bwd.launches += 1
    return dq, dk, dv


flash_mha_bwd.launches = 0


class _FlashMHA(torch.autograd.Function):
    """Attention under autograd: the forward kernel, saving q, k, v, o and
    the fp32 log-sum-exp, and the backward kernels (the Pallas custom VJP's
    residuals and dq / dkv kernels)."""

    @staticmethod
    def forward(ctx, q, k, v, layout, mask):
        o, lse = _flash_fwd(q, k, v, layout, with_lse=True, mask=mask)
        ctx.save_for_backward(q, k, v, o, lse, mask)
        ctx.layout = layout
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, mask = ctx.saved_tensors
        dq, dk, dv = flash_mha_bwd(q, k, v, o, lse, g.contiguous(),
                                   ctx.layout, mask)
        return dq, dk, dv, None, None


@register_flop_formula(torch.ops.xtagclip_tpu_torch.flash_mha)
def _flash_mha_flops(q_shape, k_shape, v_shape, layout, *args,
                     out_shape=None, **kwargs) -> int:
    """QK^T and PV's FLOPs, as FlopCounterMode counts the plain
    version's (the softmax is not counted)."""
    b, lq, h, dh = q_shape if layout == "blhd" else (
        q_shape[0], q_shape[2], q_shape[1], q_shape[3])
    lk = k_shape[1] if layout == "blhd" else k_shape[2]
    return 4 * b * h * lq * lk * dh
