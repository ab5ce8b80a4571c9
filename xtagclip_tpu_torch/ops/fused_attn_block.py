"""The fused block halves: hand-written CUDA kernels, their plain PyTorch
versions, and the autograd Functions that train through them.

Port of xtagclip_tpu/ops/fused_attn_block.py. Each kernel exists twice:

- ``fused_attn_half`` / ``fused_mlp_half`` / ``fused_attn_half_bwd``: the
  wrappers. On a CUDA tensor they launch the sm_90a kernel of
  ``csrc/fused_attn_half.cu`` / ``csrc/fused_mlp_half.cu`` /
  ``csrc/fused_attn_half_bwd.cu`` (built on first use, ops/cuda_build.py)
  or raise: a shape the kernel cannot take, a wrong dtype, a build or
  launch failure all raise, none switches to the plain version. On a CPU
  tensor they run the plain version, because there is no kernel to run
  there. Each counts its kernel launches in ``<wrapper>.launches``.
- ``reference_attn_half`` / ``reference_mlp_half`` /
  ``reference_attn_half_bwd``: the plain versions, counterparts of
  ``_reference_chain`` (:977), ``_reference_mlp_chain`` (:877) and of what
  ``_fused_attn_half_bwd`` (:543) computes. Same rounding points as the
  kernels; every matmul in fp32 on upcast operands with TF32 off.

Numerics contract (fused_attn_block.py:20-25): LN statistics in fp32, the
normalized stream rounded to bf16; q/k/v, out, c_fc and c_proj products
accumulated in fp32 with fp32 biases; scores and softmax in fp32, scaled
by dh^-0.5 after the dot, mask added after the scale, probabilities
rounded to bf16 for P @ V; residual add in fp32, one rounding at the end.
The MLP's gelu is the exact erf gelu of the XLA path (``_act_xla``).

Training (the JAX ``custom_vjp`` at :1051-1148 in its train_bwd branch,
and :896-974 in its chain fallback): when autograd is on and an input
requires grad, ``fused_attn_half`` runs ``_FusedAttnHalf``, whose forward
is the forward kernel saving only x, the weights and the mask, and whose
backward is ``fused_attn_half_bwd`` followed by dwqkv = xn^T dqkv and
dbqkv in PyTorch; ``fused_mlp_half`` runs ``_FusedMLPHalf``, the forward
kernel and ``mlp_half_bwd``, a PyTorch backward that recomputes the half
from x (the JAX MLP backward is XLA, not Pallas). Under ``no_grad`` or
``inference_mode`` the wrappers launch only the forward kernels.

Partial mode (tensor parallelism, parallel/tensor_parallel.py): with
``partial=True`` each of the wrappers and plain versions takes a rank's
share of the block, the q, k and v columns of its heads (wqkv [D, 3 Dl],
Dl = 64 local heads; wout [Dl, D]) or its slice of the MLP's hidden
width, and returns its term of the block's output in fp32, without the
out-projection's bias and the residual: ``out_proj(MHA_local(LN(x)))`` or
``c_proj(act(c_fc_local(LN(x))))``. The backward's partial mode returns
dx in fp32 without the residual cotangent g (dx, dls and dlb are linear
in the LN output's cotangent, so the ranks' terms sum to the whole
block's). The caller sums the ranks' terms in fp32 and adds the bias,
the residual and g once, with one rounding, as the whole kernels'
epilogues do. The partial wrappers are forward launchers with no
autograd of their own: the tensor-parallel Functions train through them.

Custom ops: without grad the wrappers call the forward kernels through
``torch.library`` custom ops, ``xtagclip_tpu_torch::fused_attn_half`` and
``xtagclip_tpu_torch::fused_mlp_half``, so that ``torch.export`` and CUDA
graphs see one opaque node per half (convert/serving.py). An op's
implementation is the launcher above (the plain version on a CPU tensor)
and its fake implementation gives only the output's shape and dtype. The
autograd Functions call the launchers themselves, as before.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from xtagclip_tpu_torch.ops import cuda_build

ACTIVATIONS = {"gelu": 0, "quick_gelu": 1}
_HEAD_DIM = 64
_MAX_LEN = 128
_TILE = 64
_COL_SPLITS = 32  # row splits of the [D] sums, csrc/fused_attn_half_bwd.cu


def supported(shape, num_heads: int, dtype=torch.bfloat16,
              mask_shape=None) -> bool:
    """[B, L, D] streams the attention kernel takes: bf16, head dim 64,
    D % 64 == 0, 1 <= L <= 128 (all keys of a head sit in one block's
    shared memory), and no mask or an additive [L, L] one."""
    if len(shape) != 3 or dtype != torch.bfloat16:
        return False
    _, l, d = shape
    if mask_shape is not None and tuple(mask_shape) != (l, l):
        return False
    if num_heads <= 0 or d % num_heads or d // num_heads != _HEAD_DIM:
        return False
    return d % _TILE == 0 and 1 <= l <= _MAX_LEN


def supported_bwd(shape, num_heads: int, dtype=torch.bfloat16,
                  mask_shape=None) -> bool:
    """Streams the backward kernel takes: those of ``supported``. Its
    attention core holds q, k, v, dO of a head and bf16 copies of p and of
    ds's three terms at L padded to 128 in shared memory, 193 KB of the 227
    KB a block may have. A shape outside this set raises under grad on the
    card; nothing falls back to the plain version."""
    return supported(shape, num_heads, dtype, mask_shape)


def supported_mlp(shape, mlp_width: int, act_name: str,
                  dtype=torch.bfloat16) -> bool:
    """Rows the MLP kernel takes: bf16, a known activation, and D and the
    hidden width multiples of the GEMM's 64-column tile."""
    return (act_name in ACTIVATIONS and dtype == torch.bfloat16
            and shape[-1] % _TILE == 0 and mlp_width % _TILE == 0)


@contextmanager
def _full_fp32_matmul():
    """fp32 matmuls on the card in full fp32 (TF32 off) for the duration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _ln_stats(x32, eps):
    """(rstd, xhat) of fp32 rows: two-pass variance, as the kernels."""
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return rstd, (x32 - mean) * rstd


def _layer_norm_rounded(x32, ln_scale, ln_bias, eps, dtype):
    _, xhat = _ln_stats(x32, eps)
    return (xhat * ln_scale.float() + ln_bias.float()).to(dtype)


def _ln_backward(g32, dxn, gamma, xhat, rstd, dtype):
    """dx of y = x + f(LN(x)) from the residual cotangent g32 and the LN
    output's cotangent dxn, summed in fp32 and rounded once
    (fused_attn_block.py:666-670). The partial mode passes g32 = 0 and
    dtype fp32: the LN term alone, unrounded."""
    dxhat = dxn * gamma
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return (g32 + rstd * (dxhat - m1 - xhat * m2)).to(dtype)


def reference_attn_half(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                        mask=None, num_heads: int = 8, eps: float = 1e-5,
                        partial: bool = False):
    """Plain y = x + out_proj(MHA(LN(x))) over [B, L, D] (the composed chain
    the kernel replaces); with ``partial`` the fp32 out_proj(MHA(LN(x)))
    of the ``num_heads`` heads whose columns wqkv and rows wout hold
    (module doc; ``bout`` unread)."""
    with _full_fp32_matmul():
        b, l, _ = x.shape
        dl = wqkv.shape[1] // 3
        dh = dl // num_heads
        x32 = x.float()
        xn = _layer_norm_rounded(x32, ln_scale, ln_bias, eps, x.dtype)
        qkv = (xn.float() @ wqkv.float() + bqkv.float()).to(x.dtype)

        def heads(t):  # [B, L, Dl] -> [B, H, L, dh]
            return t.reshape(b, l, num_heads, dh).transpose(1, 2).float()

        q, k, v = (heads(t) for t in qkv.split(dl, dim=-1))
        s = (q @ k.transpose(-1, -2)) * dh**-0.5
        if mask is not None:
            s = s + mask.float()
        p = torch.softmax(s, dim=-1)
        o = (p.to(x.dtype).float() @ v).to(x.dtype)
        att = o.transpose(1, 2).reshape(b, l, dl)
        if partial:
            return att.float() @ wout.float()
        y = att.float() @ wout.float() + bout.float()
        return (x32 + y).to(x.dtype)


def _act(name: str, v):
    if name == "gelu":
        return F.gelu(v)
    if name == "quick_gelu":
        return v * torch.sigmoid(1.702 * v)
    raise ValueError(name)


def reference_mlp_half(x, ln_scale, ln_bias, w1, b1, w2, b2,
                       act_name: str, eps: float = 1e-5,
                       partial: bool = False):
    """Plain y = x + c_proj(act(c_fc(LN(x)))) over [..., D] rows; with
    ``partial`` the fp32 c_proj(act(c_fc(LN(x)))) of the hidden slice w1,
    b1 and w2 hold (module doc; ``b2`` unread)."""
    with _full_fp32_matmul():
        x32 = x.float()
        xn = _layer_norm_rounded(x32, ln_scale, ln_bias, eps, x.dtype)
        hid = _act(act_name, xn.float() @ w1.float() + b1.float())
        if partial:
            return hid.to(x.dtype).float() @ w2.float()
        y = hid.to(x.dtype).float() @ w2.float() + b2.float()
        return (x32 + y).to(x.dtype)


def reference_attn_half_bwd(x, g, ln_scale, ln_bias, wqkv, bqkv, wout,
                            mask=None, num_heads: int = 8,
                            eps: float = 1e-5, partial: bool = False):
    """Plain backward of ``reference_attn_half`` from x and the output
    cotangent g: (dx [B, L, D], dqkv [B, L, 3D] in x's dtype; dwout [D, D],
    dbout, dls, dlb [D] in fp32, summed over the batch). The analytic
    backward with the Pallas kernel's rounding points (:560-565): datt, p,
    dp, dv, dq, dk and dxn round to x's dtype; dq = ds k and dk = ds^T q
    take fp32 operands. With ``partial`` (module doc) dqkv is
    [B, L, 3 Dl], dwout [Dl, D], and dx the fp32 LN term without g."""
    with _full_fp32_matmul():
        b, l, d = x.shape
        dl = wqkv.shape[1] // 3
        dh = dl // num_heads
        scale = dh**-0.5
        dt = x.dtype
        rstd, xhat = _ln_stats(x.float(), eps)
        gamma = ln_scale.float()
        xn = (xhat * gamma + ln_bias.float()).to(dt)
        qkv = (xn.float() @ wqkv.float() + bqkv.float()).to(dt)

        def heads(t):  # [B, L, Dl] -> [B, H, L, dh], fp32
            return t.reshape(b, l, num_heads, dh).transpose(1, 2).float()

        def merge(t):  # [B, H, L, dh] -> [B, L, Dl]
            return t.transpose(1, 2).reshape(b, l, dl)

        q, k, v = (heads(t) for t in qkv.split(dl, dim=-1))
        g32 = g.float()
        datt = (g32 @ wout.float().t()).to(dt)
        s = (q @ k.transpose(-1, -2)) * scale
        if mask is not None:
            s = s + mask.float()
        p = torch.softmax(s, dim=-1)
        pb = p.to(dt).float()
        att = merge((pb @ v).to(dt))
        do = heads(datt)
        dp = (do @ v.transpose(-1, -2)).to(dt).float()
        ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))) * scale
        dv = (pb.transpose(-1, -2) @ do).to(dt)
        dq = (ds @ k).to(dt)
        dk = (ds.transpose(-1, -2) @ q).to(dt)
        dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
        dwout = att.float().reshape(-1, dl).t() @ g32.reshape(-1, d)
        dxn = (dqkv.float() @ wqkv.float().t()).to(dt).float()
        dx = (_ln_backward(0.0, dxn, gamma, xhat, rstd, torch.float32)
              if partial else _ln_backward(g32, dxn, gamma, xhat, rstd, dt))
        return (dx, dqkv, dwout, g32.sum(dim=(0, 1)),
                (dxn * xhat).sum(dim=(0, 1)), dxn.sum(dim=(0, 1)))


def mlp_half_bwd(x, g, ln_scale, ln_bias, w1, b1, w2, act_name: str,
                 eps: float = 1e-5, partial: bool = False):
    """Backward of the MLP half from x and the output cotangent g: (dx,
    dls, dlb, dw1, db1, dw2, db2). Counterpart of ``_mlp_bwd``'s fallback
    branch (:953-958), ``jax.vjp`` of ``_reference_mlp_chain``: it
    recomputes from x with the chain's rounding points (LN output in x's
    dtype, fp32 pre-activation, hidden rounded before c_proj) and rounds
    each cotangent to its primal's dtype where autodiff of the chain does.
    A product of an fp32 cotangent with a bf16 weight runs in fp32 (TF32
    off); the residual and LN contributions to dx add in fp32 and round
    once (:904-913). With ``partial`` (module doc) w1, b1, w2 are a hidden
    slice and dx is the fp32 LN term without g."""
    with _full_fp32_matmul():
        d = x.shape[-1]
        dt = x.dtype
        g32 = g.float().reshape(-1, d)
        rstd, xhat = _ln_stats(x.float().reshape(-1, d), eps)
        gamma = ln_scale.float()
        xn = (xhat * gamma + ln_bias.float()).to(dt).float()
        pre = xn @ w1.float() + b1.float()
        hid = _act(act_name, pre).to(dt).float()
        dhid = (g32 @ w2.float().t()).to(dt).float()
        dw2 = (hid.t() @ g32).to(w2.dtype)
        dpre = dhid * _act_grad(act_name, pre)
        dxn = (dpre @ w1.float().t()).to(dt).float()
        dw1 = (xn.t() @ dpre).to(w1.dtype)
        dx = (_ln_backward(0.0, dxn, gamma, xhat, rstd, torch.float32)
              if partial else _ln_backward(g32, dxn, gamma, xhat, rstd, dt))
        return (dx.reshape(x.shape), (dxn * xhat).sum(0), dxn.sum(0), dw1,
                dpre.sum(0), dw2, g32.sum(0))


def _act_grad(name: str, v):
    """d act / d v in fp32, as autodiff of ``_act_xla``."""
    if name == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(v * 2.0**-0.5))
        return cdf + v * torch.exp(-0.5 * v * v) * (2.0 * torch.pi) ** -0.5
    if name == "quick_gelu":
        sig = torch.sigmoid(1.702 * v)
        return sig + v * 1.702 * sig * (1.0 - sig)
    raise ValueError(name)


def _check_args(what, x, named, dtypes, shapes):
    """Device, dtype, contiguity, alignment and shape checks for a launch."""
    for key, t in named.items():
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{what}: {key} is on {t.device}, x on {x.device}")
        if t.dtype != dtypes[key]:
            raise ValueError(f"{what}: {key} must be {dtypes[key]}, got {t.dtype}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{what}: {key} must have shape {shapes[key]}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {key} must be contiguous and 16-byte "
                             "aligned")


def _mask_scratch(mask):
    """The attention cores' scratch for the mask laid out by thread, or
    None without a mask."""
    if mask is None:
        return None
    return torch.empty(_MAX_LEN * _MAX_LEN, dtype=torch.float32,
                       device=mask.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def check_device(what: str, t) -> None:
    """Raise for a device that has neither a kernel nor the plain version
    (the custom ops would answer a meta tensor with their fake
    implementation)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {t.device}")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _attn_launch_checks(what, x, num_heads, mask, gate,
                        partial: bool = False):
    """Raise unless the kernel takes the stream; in the partial mode the
    stream of its ``num_heads`` heads, [B, L, 64 num_heads], inside a
    model width D that is a multiple of 64."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    mshape = None if mask is None else tuple(mask.shape)
    shape = tuple(x.shape)
    if partial and len(shape) == 3:
        if shape[-1] % _TILE or num_heads * _HEAD_DIM > shape[-1]:
            raise ValueError(
                f"{what}: no kernel for {num_heads} local heads of 64 in "
                f"model width {shape[-1]}")
        shape = shape[:2] + (num_heads * _HEAD_DIM,)
    if not gate(shape, num_heads, x.dtype, mshape):
        raise ValueError(
            f"{what}: no kernel for stream {tuple(x.shape)} {x.dtype} with "
            f"{num_heads} heads and mask {mshape} (needs bf16, head dim 64, "
            f"D % 64 == 0, L <= {_MAX_LEN}, mask None or [L, L])")


def _no_grad_partial(what, *tensors):
    if _needs_grad(*tensors):
        raise ValueError(
            f"{what}: the partial mode has no autograd of its own; "
            "parallel/tensor_parallel.py trains through it")


def fused_attn_half(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                    mask=None, num_heads: int = 8, eps: float = 1e-5,
                    partial: bool = False):
    """y = x + out_proj(MHA(LN(x))): the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor (see the module doc); differentiable
    through ``_FusedAttnHalf`` when an input requires grad.

    x [B, L, D] bf16; ln_scale/ln_bias [D] fp32; wqkv [D, 3D] bf16 (flax
    Dense layout [in, out]); bqkv [3D] fp32; wout [D, D] bf16; bout [D]
    fp32; mask None or an additive [L, L] fp32 mask (it gets no
    gradient). ``partial``: the fp32 term of ``num_heads`` local heads
    (module doc), wqkv [D, 3 Dl], bqkv [3 Dl], wout [Dl, D], bout
    unread."""
    args = (x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, mask, num_heads,
            eps)
    check_device("fused_attn_half", x)
    if partial:
        _no_grad_partial("fused_attn_half", x, ln_scale, ln_bias, wqkv, bqkv,
                         wout)
        return _attn_half_fwd(*args, partial=True)
    if _needs_grad(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout):
        return _FusedAttnHalf.apply(*args)
    return fused_attn_half_op(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                              mask, int(num_heads), float(eps))


def _attn_half_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, mask,
                   num_heads, eps, partial: bool = False):
    if x.device.type == "cpu":
        return reference_attn_half(x, ln_scale, ln_bias, wqkv, bqkv, wout,
                                   bout, mask, num_heads, eps, partial)
    what = "fused_attn_half"
    _attn_launch_checks(what, x, num_heads, mask, supported, partial)
    b, l, d = x.shape
    dl = num_heads * _HEAD_DIM if partial else d
    bf, f32 = torch.bfloat16, torch.float32
    named = dict(x=x, ln_scale=ln_scale, ln_bias=ln_bias, wqkv=wqkv,
                 bqkv=bqkv, wout=wout, bout=None if partial else bout,
                 mask=mask)
    dtypes = dict(x=bf, ln_scale=f32, ln_bias=f32, wqkv=bf, bqkv=f32,
                  wout=bf, bout=f32, mask=f32)
    shapes = dict(x=(b, l, d), ln_scale=(d,), ln_bias=(d,),
                  wqkv=(d, 3 * dl), bqkv=(3 * dl,), wout=(dl, d), bout=(d,),
                  mask=(l, l))
    _check_args(what, x, named, dtypes, shapes)
    n = b * l
    xn = torch.empty((n, d), dtype=bf, device=x.device)
    qkv = torch.empty((n, 3 * dl), dtype=bf, device=x.device)
    att = torch.empty((n, dl), dtype=bf, device=x.device)
    mask_ws = _mask_scratch(mask)
    out = torch.empty((b, l, d), dtype=f32 if partial else bf,
                      device=x.device)
    lib = cuda_build.load("fused_attn_half")
    err = lib.xtag_fused_attn_half(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        wqkv.data_ptr(), bqkv.data_ptr(), wout.data_ptr(),
        None if partial else bout.data_ptr(),
        _ptr(mask), xn.data_ptr(), qkv.data_ptr(), att.data_ptr(),
        _ptr(mask_ws), out.data_ptr(),
        b, l, d, num_heads, int(partial), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, what)
    fused_attn_half.launches += 1
    return out


fused_attn_half.launches = 0


@torch.library.custom_op("xtagclip_tpu_torch::fused_attn_half",
                         mutates_args=())
def fused_attn_half_op(x: torch.Tensor, ln_scale: torch.Tensor,
                       ln_bias: torch.Tensor, wqkv: torch.Tensor,
                       bqkv: torch.Tensor, wout: torch.Tensor,
                       bout: torch.Tensor, mask: Optional[torch.Tensor],
                       num_heads: int, eps: float) -> torch.Tensor:
    """The attention half's forward as a custom op: the kernel on a CUDA
    tensor (or a raise), the plain version on a CPU tensor."""
    return _attn_half_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                          mask, num_heads, eps)


@fused_attn_half_op.register_fake
def _fused_attn_half_fake(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                          mask, num_heads, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def fused_attn_half_bwd(x, g, ln_scale, ln_bias, wqkv, bqkv, wout,
                        mask=None, num_heads: int = 8, eps: float = 1e-5,
                        partial: bool = False):
    """Backward of the attention half from x and the output cotangent g:
    (dx, dqkv, dwout, dbout, dls, dlb) as ``reference_attn_half_bwd``
    returns them (``partial`` as there). The CUDA kernel on a CUDA tensor
    (shapes in ``supported_bwd``, else it raises), the plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return reference_attn_half_bwd(x, g, ln_scale, ln_bias, wqkv, bqkv,
                                       wout, mask, num_heads, eps, partial)
    what = "fused_attn_half_bwd"
    _attn_launch_checks(what, x, num_heads, mask, supported_bwd, partial)
    b, l, d = x.shape
    dl = num_heads * _HEAD_DIM if partial else d
    bf, f32 = torch.bfloat16, torch.float32
    named = dict(x=x, g=g, ln_scale=ln_scale, ln_bias=ln_bias, wqkv=wqkv,
                 bqkv=bqkv, wout=wout, mask=mask)
    dtypes = dict(x=bf, g=bf, ln_scale=f32, ln_bias=f32, wqkv=bf, bqkv=f32,
                  wout=bf, mask=f32)
    shapes = dict(x=(b, l, d), g=(b, l, d), ln_scale=(d,), ln_bias=(d,),
                  wqkv=(d, 3 * dl), bqkv=(3 * dl,), wout=(dl, d),
                  mask=(l, l))
    _check_args(what, x, named, dtypes, shapes)
    n = b * l
    dev = x.device
    scratch = [torch.empty((n, w), dtype=bf, device=dev)
               for w in (d, 3 * dl, dl, dl, d)]  # xn, qkv, datt, att, dxn
    stats = torch.empty(2 * n, dtype=f32, device=dev)
    col_ws = torch.empty(_COL_SPLITS * 3 * d, dtype=f32, device=dev)
    mask_ws = _mask_scratch(mask)
    dx = torch.empty((b, l, d), dtype=f32 if partial else bf, device=dev)
    dqkv = torch.empty((b, l, 3 * dl), dtype=bf, device=dev)
    dwout = torch.empty((dl, d), dtype=f32, device=dev)
    dbout, dls, dlb = (torch.empty(d, dtype=f32, device=dev)
                       for _ in range(3))
    lib = cuda_build.load("fused_attn_half_bwd")
    err = lib.xtag_fused_attn_half_bwd(
        x.data_ptr(), g.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        wqkv.data_ptr(), bqkv.data_ptr(), wout.data_ptr(),
        _ptr(mask), *(t.data_ptr() for t in scratch), stats.data_ptr(),
        col_ws.data_ptr(), _ptr(mask_ws), dx.data_ptr(), dqkv.data_ptr(),
        dwout.data_ptr(), dbout.data_ptr(), dls.data_ptr(), dlb.data_ptr(),
        b, l, d, num_heads, int(partial), float(eps),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, err, what)
    fused_attn_half_bwd.launches += 1
    return dx, dqkv, dwout, dbout, dls, dlb


fused_attn_half_bwd.launches = 0


class _FusedAttnHalf(torch.autograd.Function):
    """The attention half under autograd: the forward kernel, saving only x,
    the weights and the mask (the zero-residual pairing of :1089-1094), and
    the backward kernel plus the two weight-grad products (:1114-1131)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, mask,
                num_heads, eps):
        if x.device.type != "cpu":  # raise now, not in the backward
            _attn_launch_checks("fused_attn_half_bwd", x, num_heads, mask,
                                supported_bwd)
        ctx.save_for_backward(x, ln_scale, ln_bias, wqkv, bqkv, wout, mask)
        ctx.num_heads, ctx.eps, ctx.bout_dtype = num_heads, eps, bout.dtype
        return _attn_half_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                              mask, num_heads, eps)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, wqkv, bqkv, wout, mask = ctx.saved_tensors
        dx, dqkv, dwout, dbout, dls, dlb = fused_attn_half_bwd(
            x, g.contiguous(), ln_scale, ln_bias, wqkv, bqkv, wout, mask,
            ctx.num_heads, ctx.eps)
        xn = _layer_norm_rounded(x.float(), ln_scale, ln_bias, ctx.eps,
                                 x.dtype).reshape(-1, x.shape[-1])
        dqkv2 = dqkv.reshape(-1, dqkv.shape[-1])
        with _full_fp32_matmul():  # fp32 accumulation, one rounding
            dwqkv = torch.matmul(xn.t(), dqkv2)
        dbqkv = dqkv2.float().sum(0)
        return (dx, dls.to(ln_scale.dtype), dlb.to(ln_bias.dtype),
                dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype),
                dwout.to(wout.dtype), dbout.to(ctx.bout_dtype),
                None, None, None)


def fused_mlp_half(x, ln_scale, ln_bias, w1, b1, w2, b2,
                   act_name: str, eps: float = 1e-5, partial: bool = False):
    """y = x + c_proj(act(c_fc(LN(x)))): the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor (see the module doc); differentiable
    through ``_FusedMLPHalf`` when an input requires grad.

    x [..., D] bf16; w1 [D, Hd], w2 [Hd, D] bf16 (flax layout [in, out]);
    ln_scale/ln_bias/b2 [D], b1 [Hd] fp32; act_name gelu|quick_gelu.
    ``partial``: the fp32 term of a hidden slice (module doc), b2
    unread."""
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2, act_name, eps)
    check_device("fused_mlp_half", x)
    if partial:
        _no_grad_partial("fused_mlp_half", x, ln_scale, ln_bias, w1, b1, w2)
        return _mlp_half_fwd(*args, partial=True)
    if _needs_grad(x, ln_scale, ln_bias, w1, b1, w2, b2):
        return _FusedMLPHalf.apply(*args)
    return fused_mlp_half_op(x, ln_scale, ln_bias, w1, b1, w2, b2, act_name,
                             float(eps))


def _mlp_half_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, act_name, eps,
                  partial: bool = False):
    if x.device.type == "cpu":
        return reference_mlp_half(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                  act_name, eps, partial)
    what = "fused_mlp_half"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    d = x.shape[-1]
    hd = w1.shape[-1]
    if not supported_mlp(x.shape, hd, act_name, x.dtype):
        raise ValueError(
            f"{what}: no kernel for rows {tuple(x.shape)} {x.dtype}, hidden "
            f"width {hd}, act {act_name!r} (needs bf16, gelu|quick_gelu, "
            "D and hidden width multiples of 64)")
    bf, f32 = torch.bfloat16, torch.float32
    named = dict(x=x, ln_scale=ln_scale, ln_bias=ln_bias, w1=w1, b1=b1,
                 w2=w2, b2=None if partial else b2)
    dtypes = dict(x=bf, ln_scale=f32, ln_bias=f32, w1=bf, b1=f32, w2=bf,
                  b2=f32)
    shapes = dict(x=tuple(x.shape), ln_scale=(d,), ln_bias=(d,), w1=(d, hd),
                  b1=(hd,), w2=(hd, d), b2=(d,))
    _check_args(what, x, named, dtypes, shapes)
    n = x.numel() // d
    xn = torch.empty((n, d), dtype=bf, device=x.device)
    hid = torch.empty((n, hd), dtype=bf, device=x.device)
    out = torch.empty(x.shape, dtype=f32 if partial else bf, device=x.device)
    lib = cuda_build.load("fused_mlp_half")
    err = lib.xtag_fused_mlp_half(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        None if partial else b2.data_ptr(),
        xn.data_ptr(), hid.data_ptr(), out.data_ptr(),
        n, d, hd, ACTIVATIONS[act_name], int(partial), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, what)
    fused_mlp_half.launches += 1
    return out


fused_mlp_half.launches = 0


@torch.library.custom_op("xtagclip_tpu_torch::fused_mlp_half",
                         mutates_args=())
def fused_mlp_half_op(x: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                      act_name: str, eps: float) -> torch.Tensor:
    """The MLP half's forward as a custom op: the kernel on a CUDA tensor
    (or a raise), the plain version on a CPU tensor."""
    return _mlp_half_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, act_name, eps)


@fused_mlp_half_op.register_fake
def _fused_mlp_half_fake(x, ln_scale, ln_bias, w1, b1, w2, b2, act_name,
                         eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


class _FusedMLPHalf(torch.autograd.Function):
    """The MLP half under autograd: the forward kernel, saving x and the
    weights, and ``mlp_half_bwd``."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, act_name, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2)
        ctx.act_name, ctx.eps, ctx.b2_dtype = act_name, eps, b2.dtype
        return _mlp_half_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, act_name,
                             eps)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, w1, b1, w2 = ctx.saved_tensors
        dx, dls, dlb, dw1, db1, dw2, db2 = mlp_half_bwd(
            x, g, ln_scale, ln_bias, w1, b1, w2, ctx.act_name, ctx.eps)
        return (dx, dls.to(ln_scale.dtype), dlb.to(ln_bias.dtype), dw1,
                db1.to(b1.dtype), dw2, db2.to(ctx.b2_dtype), None, None)


# matmul FLOPs for torch.utils.flop_counter.FlopCounterMode, which sees a
# custom op whole: the same count as the plain chain's matmuls (LayerNorm,
# softmax and the activation are not counted there either)
@register_flop_formula(torch.ops.xtagclip_tpu_torch.fused_attn_half)
def _attn_half_flops(x_shape, ln_scale, ln_bias, wqkv_shape, *args,
                     out_shape=None, **kwargs) -> int:
    b, l, d = x_shape
    return 2 * b * l * d * wqkv_shape[1] + 4 * b * l * l * d \
        + 2 * b * l * d * d


@register_flop_formula(torch.ops.xtagclip_tpu_torch.fused_mlp_half)
def _mlp_half_flops(x_shape, ln_scale, ln_bias, w1_shape, *args,
                    out_shape=None, **kwargs) -> int:
    n = math.prod(x_shape[:-1])
    return 4 * n * w1_shape[0] * w1_shape[1]
