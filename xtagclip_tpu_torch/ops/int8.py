"""Int8 weight-quantized linear ops (port of xtagclip_tpu/ops/int8.py:20-79,
the JAX package's answer to the reference's ``--use-bnb-linear``, which is
a no-op flag in both packages).

Per-output-column symmetric weight quantization and per-row activation
quantization to int8 in [-127, 127] (round half to even, as jnp.round);
the int8 x int8 product accumulates in int32, then one scale multiply in
fp32. JAX has no Pallas kernel here (XLA's dot_general), so this is plain
PyTorch: on a CUDA tensor the int32 product is ``torch._int_mm``
(cuBLASLt), which takes M > 16 rows and K, N multiples of 8; any other
shape raises on the card rather than falling back. On the CPU it is an
int32 matmul.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (int8 values [K, N], per-column fp32 scales [N])."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., K] float -> (int8 values, per-row fp32 scales [..., 1])."""
    x = x.float()
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 127.0,
                        min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_dot(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """[..., K] int8 @ [K, N] int8 -> [..., N] int32, exact."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_dot takes int8 operands, got {x_q.dtype} and "
                        f"{w_q.dtype}")
    lead, k = x_q.shape[:-1], x_q.shape[-1]
    x2 = x_q.reshape(-1, k)
    if x_q.is_cuda:
        m, n = x2.shape[0], w_q.shape[1]
        if m <= 16 or k % 8 or n % 8:
            raise ValueError(
                f"int8_dot on the card: torch._int_mm takes M > 16 rows and "
                f"K, N multiples of 8, got M={m}, K={k}, N={n}")
        acc = torch._int_mm(x2.contiguous(), w_q.contiguous())
    else:
        acc = x2.to(torch.int32) @ w_q.to(torch.int32)
    return acc.reshape(*lead, w_q.shape[1])


def int8_matmul(x_q, x_scale, w_q, w_scale, out_dtype=torch.float32):
    """(int8 x, row scales) @ (int8 w, column scales): the int32 product
    times both scales, in fp32."""
    acc = int8_dot(x_q, w_q)
    return (acc.float() * x_scale * w_scale).to(out_dtype)


def int8_dense_apply(params: Dict[str, Any], x: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
    """Apply a quantized Dense dict ``{kernel_q, kernel_scale[, bias]}``."""
    out_dtype = out_dtype or x.dtype
    x_q, x_s = quantize_activation(x)
    y = int8_matmul(x_q, x_s, params["kernel_q"], params["kernel_scale"])
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(out_dtype)


def quantize_dense_tree(params: Dict[str, Any],
                        predicate=None) -> Dict[str, Any]:
    """Rewrite every ``{'kernel': 2-D, ...}`` subtree of a nested dict
    into its int8 form (``kernel_q``, ``kernel_scale``, ``bias`` kept);
    ``predicate(path_tuple)`` picks which (default: every 2-D kernel)."""

    def rec(node, path):
        if isinstance(node, dict):
            kernel = node.get("kernel")
            if isinstance(kernel, torch.Tensor) and kernel.dim() == 2 and \
                    (predicate is None or predicate(path)):
                q, s = quantize_weight(kernel)
                out = {"kernel_q": q, "kernel_scale": s}
                if "bias" in node:
                    out["bias"] = node["bias"]
                return out
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        return node

    return rec(params, ())
