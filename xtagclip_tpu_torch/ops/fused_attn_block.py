"""The two fused block halves: hand-written CUDA kernels and their plain
PyTorch versions.

Port of xtagclip_tpu/ops/fused_attn_block.py. Each half exists twice:

- ``fused_attn_half`` / ``fused_mlp_half``: the wrappers. On a CUDA tensor
  they launch the sm_90a kernel of ``csrc/fused_attn_half.cu`` /
  ``csrc/fused_mlp_half.cu`` (built on first use, ops/cuda_build.py) or
  raise: a shape the kernel cannot take, a wrong dtype, a build or launch
  failure all raise, none switches to the plain version. On a CPU tensor
  they run the plain version, because there is no kernel to run there.
  Each counts its kernel launches in ``<wrapper>.launches``.
- ``reference_attn_half`` / ``reference_mlp_half``: the plain versions,
  counterparts of ``_reference_chain`` (:977) and ``_reference_mlp_chain``
  (:877). Same rounding points as the kernels; every matmul in fp32 on
  upcast operands with TF32 off.

Numerics contract (fused_attn_block.py:20-25): LN statistics in fp32, the
normalized stream rounded to bf16; q/k/v, out, c_fc and c_proj products
accumulated in fp32 with fp32 biases; scores and softmax in fp32, scaled
by dh^-0.5 after the dot, mask added after the scale, probabilities
rounded to bf16 for P @ V; residual add in fp32, one rounding at the end.
The MLP's gelu is the exact erf gelu of the XLA path (``_act_xla``).

The kernels are inference-only: called with inputs that require grad
while autograd is on, they raise.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

from xtagclip_tpu_torch.ops import cuda_build

ACTIVATIONS = {"gelu": 0, "quick_gelu": 1}
_HEAD_DIM = 64
_MAX_LEN = 128
_TILE = 64


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


def _layer_norm_rounded(x32, ln_scale, ln_bias, eps, dtype):
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    xn32 = (x32 - mean) * torch.rsqrt(var + eps)
    return (xn32 * ln_scale.float() + ln_bias.float()).to(dtype)


def reference_attn_half(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                        mask=None, num_heads: int = 8, eps: float = 1e-5):
    """Plain y = x + out_proj(MHA(LN(x))) over [B, L, D] (the composed chain
    the kernel replaces)."""
    with _full_fp32_matmul():
        b, l, d = x.shape
        dh = d // num_heads
        x32 = x.float()
        xn = _layer_norm_rounded(x32, ln_scale, ln_bias, eps, x.dtype)
        qkv = (xn.float() @ wqkv.float() + bqkv.float()).to(x.dtype)

        def heads(t):  # [B, L, D] -> [B, H, L, dh]
            return t.reshape(b, l, num_heads, dh).transpose(1, 2).float()

        q, k, v = (heads(t) for t in qkv.split(d, dim=-1))
        s = (q @ k.transpose(-1, -2)) * dh**-0.5
        if mask is not None:
            s = s + mask.float()
        p = torch.softmax(s, dim=-1)
        o = (p.to(x.dtype).float() @ v).to(x.dtype)
        att = o.transpose(1, 2).reshape(b, l, d)
        y = att.float() @ wout.float() + bout.float()
        return (x32 + y).to(x.dtype)


def _act(name: str, v):
    if name == "gelu":
        return F.gelu(v)
    if name == "quick_gelu":
        return v * torch.sigmoid(1.702 * v)
    raise ValueError(name)


def reference_mlp_half(x, ln_scale, ln_bias, w1, b1, w2, b2,
                       act_name: str, eps: float = 1e-5):
    """Plain y = x + c_proj(act(c_fc(LN(x)))) over [..., D] rows."""
    with _full_fp32_matmul():
        x32 = x.float()
        xn = _layer_norm_rounded(x32, ln_scale, ln_bias, eps, x.dtype)
        hid = _act(act_name, xn.float() @ w1.float() + b1.float())
        y = hid.to(x.dtype).float() @ w2.float() + b2.float()
        return (x32 + y).to(x.dtype)


def _check_args(what, x, named, dtypes, shapes):
    """Device, dtype, contiguity, alignment and shape checks for a launch."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in named.values() if t is not None):
        raise RuntimeError(
            f"{what}: the kernel is inference-only; call it under "
            "torch.no_grad() or torch.inference_mode()")
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


def fused_attn_half(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                    mask=None, num_heads: int = 8, eps: float = 1e-5):
    """y = x + out_proj(MHA(LN(x))): the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor (see the module doc).

    x [B, L, D] bf16; ln_scale/ln_bias [D] fp32; wqkv [D, 3D] bf16 (flax
    Dense layout [in, out]); bqkv [3D] fp32; wout [D, D] bf16; bout [D]
    fp32; mask None or an additive [L, L] fp32 mask."""
    if x.device.type == "cpu":
        return reference_attn_half(x, ln_scale, ln_bias, wqkv, bqkv, wout,
                                   bout, mask, num_heads, eps)
    what = "fused_attn_half"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    mshape = None if mask is None else tuple(mask.shape)
    if not supported(x.shape, num_heads, x.dtype, mshape):
        raise ValueError(
            f"{what}: no kernel for stream {tuple(x.shape)} {x.dtype} with "
            f"{num_heads} heads and mask {mshape} (needs bf16, head dim 64, "
            f"D % 64 == 0, L <= {_MAX_LEN}, mask None or [L, L])")
    b, l, d = x.shape
    bf, f32 = torch.bfloat16, torch.float32
    named = dict(x=x, ln_scale=ln_scale, ln_bias=ln_bias, wqkv=wqkv,
                 bqkv=bqkv, wout=wout, bout=bout, mask=mask)
    dtypes = dict(x=bf, ln_scale=f32, ln_bias=f32, wqkv=bf, bqkv=f32,
                  wout=bf, bout=f32, mask=f32)
    shapes = dict(x=(b, l, d), ln_scale=(d,), ln_bias=(d,), wqkv=(d, 3 * d),
                  bqkv=(3 * d,), wout=(d, d), bout=(d,), mask=(l, l))
    _check_args(what, x, named, dtypes, shapes)
    n = b * l
    xn = torch.empty((n, d), dtype=bf, device=x.device)
    qkv = torch.empty((n, 3 * d), dtype=bf, device=x.device)
    att = torch.empty((n, d), dtype=bf, device=x.device)
    out = torch.empty_like(x)
    lib = cuda_build.load("fused_attn_half")
    err = lib.xtag_fused_attn_half(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        wqkv.data_ptr(), bqkv.data_ptr(), wout.data_ptr(), bout.data_ptr(),
        None if mask is None else mask.data_ptr(),
        xn.data_ptr(), qkv.data_ptr(), att.data_ptr(), out.data_ptr(),
        b, l, d, num_heads, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, what)
    fused_attn_half.launches += 1
    return out


fused_attn_half.launches = 0


def fused_mlp_half(x, ln_scale, ln_bias, w1, b1, w2, b2,
                   act_name: str, eps: float = 1e-5):
    """y = x + c_proj(act(c_fc(LN(x)))): the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor (see the module doc).

    x [..., D] bf16; w1 [D, Hd], w2 [Hd, D] bf16 (flax layout [in, out]);
    ln_scale/ln_bias/b2 [D], b1 [Hd] fp32; act_name gelu|quick_gelu."""
    if x.device.type == "cpu":
        return reference_mlp_half(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                  act_name, eps)
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
                 w2=w2, b2=b2)
    dtypes = dict(x=bf, ln_scale=f32, ln_bias=f32, w1=bf, b1=f32, w2=bf,
                  b2=f32)
    shapes = dict(x=tuple(x.shape), ln_scale=(d,), ln_bias=(d,), w1=(d, hd),
                  b1=(hd,), w2=(hd, d), b2=(d,))
    _check_args(what, x, named, dtypes, shapes)
    n = x.numel() // d
    xn = torch.empty((n, d), dtype=bf, device=x.device)
    hid = torch.empty((n, hd), dtype=bf, device=x.device)
    out = torch.empty_like(x)
    lib = cuda_build.load("fused_mlp_half")
    err = lib.xtag_fused_mlp_half(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        xn.data_ptr(), hid.data_ptr(), out.data_ptr(),
        n, d, hd, ACTIVATIONS[act_name], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, what)
    fused_mlp_half.launches += 1
    return out


fused_mlp_half.launches = 0
