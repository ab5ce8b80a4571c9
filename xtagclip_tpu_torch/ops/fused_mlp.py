"""The fused transformer MLP out = c_proj(act(c_fc(x))): a hand-written
CUDA kernel, its plain PyTorch version, and the autograd Function that
trains through it.

Port of xtagclip_tpu/ops/fused_mlp.py (the MLP of a block that leaves the
fused halves, behind ``XTAG_FUSED_MLP`` there):

- ``fused_mlp``: the wrapper. On a CUDA tensor it launches the sm_90a
  kernel of ``csrc/fused_mlp.cu`` (two launches of the TMA + wgmma GEMM of
  ``csrc/gemm_sm90.cuh``: c_fc with bias and activation, then c_proj with
  bias), or raises; on a CPU tensor it runs the plain version. It counts
  its launches in ``fused_mlp.launches``.
- ``reference_fused_mlp``: the plain version, ``maybe_fused_mlp``'s
  fallback chain (:143-148): act(x @ w1 + b1) with an fp32 product and
  fp32 bias and act, the hidden rounded to x's dtype, then @ w2 + b2 in
  fp32, one rounding. The kernel's gelu is the exact erf gelu of that
  chain, not the Pallas kernel's rational erf (1.5e-7 apart).
- ``fused_mlp_bwd``: the backward, PyTorch as JAX's ``_bwd`` (:109-133)
  is XLA: it recomputes the pre-activation from x and keeps ``_bwd``'s
  rounding points; dhid and dpre stay fp32. Every product whose operands
  ``_bwd`` casts to bf16 runs as a bf16 tensor-core product with an fp32
  result on the card (``_mm_f32``), not as an fp32 product of upcast
  operands.

Without grad the wrapper calls the forward through the custom op
``xtagclip_tpu_torch::fused_mlp`` (the launcher; a fake implementation
for ``torch.export``), as ops/fused_attn_block.py does for its halves.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from xtagclip_tpu_torch.ops import cuda_build
from xtagclip_tpu_torch.ops.fused_attn_block import (
    ACTIVATIONS,
    _act,
    _act_grad,
    _check_args,
    _full_fp32_matmul,
    _needs_grad,
    check_device,
)

# the GEMM's rows must be 16-byte TMA rows: D and the hidden width are
# multiples of 8 bf16 values (csrc/fused_mlp.cu); #2 keeps its 64
_WIDTH_MULTIPLE = 8


def supported(shape, mlp_width: int, act_name: str,
              dtype=torch.bfloat16) -> bool:
    """Rows the kernel takes: bf16, a known activation, D and the hidden
    width multiples of 8 (ragged 64-wide tiles are zero-filled and
    clipped, csrc/gemm_sm90.cuh). Any other stream raises on the card."""
    return (act_name in ACTIVATIONS and dtype == torch.bfloat16
            and shape[-1] % _WIDTH_MULTIPLE == 0
            and mlp_width % _WIDTH_MULTIPLE == 0)


def _mm_f32(a, b):
    """a @ b with an fp32 result: a bf16 tensor-core product with fp32
    accumulation for bf16 CUDA operands; on the CPU, for fp32 operands,
    or under autograd (the plain version as the kernels-off yardstick of
    a train step; the bf16 product has no derivative), an fp32 product
    (TF32 off), which gives the same numbers for bf16 values."""
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.is_cuda and a.dtype == torch.bfloat16 == b.dtype and not grad:
        return torch.mm(a, b, out_dtype=torch.float32)
    with _full_fp32_matmul():
        return a.float() @ b.float()


def reference_fused_mlp(x, w1, b1, w2, b2, act: str = "gelu"):
    """Plain c_proj(act(c_fc(x))) over [..., D] rows (module doc)."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    hid = _act(act, _mm_f32(x2, w1) + b1.float())
    out = _mm_f32(hid.to(x.dtype), w2) + b2.float()
    return out.to(x.dtype).reshape(x.shape)


def fused_mlp(x, w1, b1, w2, b2, act: str = "gelu"):
    """c_proj(act(c_fc(x))): the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor (module doc); differentiable through
    ``_FusedMLP`` when an input requires grad.

    x [..., D] bf16; w1 [D, Hd], w2 [Hd, D] bf16 (flax layout [in, out]);
    b1 [Hd], b2 [D] fp32; act gelu|quick_gelu."""
    args = (x, w1, b1, w2, b2, act)
    check_device("fused_mlp", x)
    if _needs_grad(x, w1, b1, w2, b2):
        return _FusedMLP.apply(*args)
    return fused_mlp_op(*args)


def _fused_mlp_fwd(x, w1, b1, w2, b2, act):
    if x.device.type == "cpu":
        return reference_fused_mlp(x, w1, b1, w2, b2, act)
    what = "fused_mlp"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    d = x.shape[-1]
    hd = w1.shape[-1]
    if not supported(x.shape, hd, act, x.dtype):
        raise ValueError(
            f"{what}: no kernel for rows {tuple(x.shape)} {x.dtype}, hidden "
            f"width {hd}, act {act!r} (needs bf16, gelu|quick_gelu, D and "
            f"hidden width multiples of {_WIDTH_MULTIPLE})")
    bf, f32 = torch.bfloat16, torch.float32
    _check_args(what, x, dict(x=x, w1=w1, b1=b1, w2=w2, b2=b2),
                dict(x=bf, w1=bf, b1=f32, w2=bf, b2=f32),
                dict(x=tuple(x.shape), w1=(d, hd), b1=(hd,), w2=(hd, d),
                     b2=(d,)))
    n = x.numel() // d
    hid = torch.empty((n, hd), dtype=bf, device=x.device)
    out = torch.empty_like(x)
    lib = cuda_build.load("fused_mlp")
    err = lib.xtag_fused_mlp(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), hid.data_ptr(), out.data_ptr(), n, d, hd,
        ACTIVATIONS[act], torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, what)
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0


@torch.library.custom_op("xtagclip_tpu_torch::fused_mlp", mutates_args=())
def fused_mlp_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor,
                 act: str) -> torch.Tensor:
    """The MLP's forward as a custom op: the kernel on a CUDA tensor (or a
    raise), the plain version on a CPU tensor."""
    return _fused_mlp_fwd(x, w1, b1, w2, b2, act)


@fused_mlp_op.register_fake
def _fused_mlp_fake(x, w1, b1, w2, b2, act):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def fused_mlp_bwd(x, g, w1, b1, w2, act: str = "gelu"):
    """(dx, dw1, db1, dw2, db2) of ``fused_mlp`` from x and the output
    cotangent g, as JAX's ``_bwd``: dx and dw1, dw2 in the dtypes of x,
    w1, w2; db1, db2 in fp32."""
    d = x.shape[-1]
    dt = x.dtype
    x2 = x.reshape(-1, d)
    g2 = g.reshape(-1, d).to(dt)
    pre = _mm_f32(x2, w1) + b1.float()
    dhid = _mm_f32(g2, w2.t())
    dpre = dhid * _act_grad(act, pre)
    dpre_c = dpre.to(dt)
    dx = _mm_f32(dpre_c, w1.t()).to(dt)
    dw1 = _mm_f32(x2.t(), dpre_c).to(w1.dtype)
    dw2 = _mm_f32(_act(act, pre).to(dt).t(), g2).to(w2.dtype)
    return (dx.reshape(x.shape), dw1, dpre.sum(0), dw2,
            g.reshape(-1, d).float().sum(0))


class _FusedMLP(torch.autograd.Function):
    """The MLP under autograd: the forward kernel, saving x and the
    weights, and ``fused_mlp_bwd``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.act, ctx.b2_dtype = act, b2.dtype
        return _fused_mlp_fwd(x, w1, b1, w2, b2, act)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_mlp_bwd(x, g, w1, b1, w2, ctx.act)
        return (dx, dw1, db1.to(b1.dtype), dw2, db2.to(ctx.b2_dtype), None)


@register_flop_formula(torch.ops.xtagclip_tpu_torch.fused_mlp)
def _fused_mlp_flops(x_shape, w1_shape, *args, out_shape=None,
                     **kwargs) -> int:
    """The two matmuls' FLOPs, as FlopCounterMode counts the plain
    version's (the activation is not counted)."""
    n = math.prod(x_shape[:-1])
    return 4 * n * w1_shape[0] * w1_shape[1]
