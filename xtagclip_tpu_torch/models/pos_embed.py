"""Position-embedding resizing on checkpoint load (port of
xtagclip_tpu/models/pos_embed.py:39-72, the reference's model.py:1065-1128).

The JAX package resizes with ``jax.image.resize``, which is
``scale_and_translate``, not ``torch.nn.functional.interpolate``:

- bicubic is the Keys cubic with a = -0.5 (torch's bicubic uses -0.75);
- samples sit at half-pixel centres, (i + 0.5) / scale - 0.5;
- with antialias, a downsample widens the kernel by 1 / scale;
- each output sample's weights cover in-bounds inputs only and are
  renormalised to sum 1 (torch clamps the index instead); a sample
  outside [-0.5, n - 0.5] gets no weight.

Here each axis gets its weight matrix [n_in, n_out] in float64
(``_weight_mat``, as ``compute_weight_mat`` builds it) and the table is
contracted with one matrix per resized axis. Linear is the triangle
kernel under the same renormalisation, without antialias.
"""

from __future__ import annotations

import math

import numpy as np


def _keys_cubic(x):
    """The Keys cubic kernel at a = -0.5 over |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _weight_mat(n_in: int, n_out: int, kernel, antialias: bool) -> np.ndarray:
    """[n_in, n_out] resampling weights of one axis (module doc)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = kernel(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize_vision_pos_embed(pos, new_grid, num_prefix_tokens: int = 1,
                            antialias: bool = True) -> np.ndarray:
    """Bicubic-resize a [L, D] learnable vision table to a new token grid;
    the first ``num_prefix_tokens`` rows (the cls row) pass through."""
    pos = np.asarray(pos)
    dim = pos.shape[1]
    prefix, grid = pos[:num_prefix_tokens], pos[num_prefix_tokens:]
    old = int(math.sqrt(grid.shape[0]))
    if old * old != grid.shape[0]:
        raise ValueError(f"non-square source grid of {grid.shape[0]} rows")
    new_h, new_w = new_grid
    if (old, old) == (new_h, new_w):
        return pos
    wh = _weight_mat(old, new_h, _keys_cubic, antialias)
    ww = _weight_mat(old, new_w, _keys_cubic, antialias)
    img = grid.astype(np.float64).reshape(old, old, dim)
    out = np.einsum("hwd,hH,wW->HWd", img, wh, ww)
    return np.concatenate([prefix, out.reshape(new_h * new_w, dim)],
                          axis=0).astype(pos.dtype)


def resize_text_pos_embed(pos, new_len: int) -> np.ndarray:
    """Linear-resize a [L, D] text table to ``new_len`` rows."""
    pos = np.asarray(pos)
    if pos.shape[0] == new_len:
        return pos
    w = _weight_mat(pos.shape[0], new_len, _triangle, antialias=False)
    return (w.T @ pos.astype(np.float64)).astype(pos.dtype)
