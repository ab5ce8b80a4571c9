"""The PyTorch port's fused block halves (xtagclip_tpu_torch/ops).

On the CPU the wrappers run their plain versions; these tests hold the
plain versions to the JAX package's composed chains (the functions the
Pallas kernels are tested against) on the same numpy inputs, in bf16, at
the kernel bar of tests/test_fused_attn_block.py: atol = max|ref|/128
(one bf16 ULP at output scale), rtol = 1e-2. The CUDA kernels themselves
are held to the plain versions on the card by tests/test_torch_kernels.py
(skipped without a CUDA device) and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtagclip_tpu.ops import fused_attn_block as jfab
from xtagclip_tpu.ops.preprocess import normalize_images as jnormalize
from xtagclip_tpu_torch.ops import fused_attn_block as fab
from xtagclip_tpu_torch.ops.preprocess import normalize_images

torch.set_num_threads(1)


def _attn_inputs(b, l, d, seed):
    """numpy inputs: x, ln scale/bias, wqkv, bqkv, wout, bout."""
    rng = np.random.default_rng(seed)
    f = lambda s, scale=1.0: (rng.standard_normal(s) * scale).astype(  # noqa: E731
        np.float32)
    return (f((b, l, d)), f(d), f(d), f((d, 3 * d), 0.2), f(3 * d),
            f((d, d), 0.2), f(d))


def _mlp_inputs(b, l, d, h, seed):
    rng = np.random.default_rng(seed)
    f = lambda s, scale=1.0: (rng.standard_normal(s) * scale).astype(  # noqa: E731
        np.float32)
    return (f((b, l, d)), f(d), f(d), f((d, h), 0.2), f(h), f((h, d), 0.1),
            f(d))


# bf16 for the stream and the weight matrices, fp32 for LN params and biases
_ATTN_BF16 = (True, False, False, True, False, True, False)
_MLP_BF16 = (True, False, False, True, False, True, False)


def _to_jax(arrs, bf16_mask):
    return [jnp.asarray(a, jnp.bfloat16 if m else jnp.float32)
            for a, m in zip(arrs, bf16_mask)]


def _to_torch(arrs, bf16_mask):
    return [torch.from_numpy(a).to(torch.bfloat16 if m else torch.float32)
            for a, m in zip(arrs, bf16_mask)]


def _causal(l):
    return np.triu(np.full((l, l), -np.inf, np.float32), k=1)


def _assert_kernel_bar(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    tol = float(np.abs(ref).max()) / 128
    np.testing.assert_allclose(out, ref, atol=tol, rtol=1e-2)


@pytest.mark.parametrize("l", [16, 50])
@pytest.mark.parametrize("causal", [False, True])
def test_reference_attn_half_matches_jax_chain(l, causal):
    arrs = _attn_inputs(2, l, 128, seed=l + causal)
    mask = _causal(l) if causal else None
    ref = jfab._reference_chain(*_to_jax(arrs, _ATTN_BF16), 2, 1e-5,
                                mask=None if mask is None
                                else jnp.asarray(mask))
    out = fab.reference_attn_half(
        *_to_torch(arrs, _ATTN_BF16),
        None if mask is None else torch.from_numpy(mask), 2, 1e-5)
    assert out.dtype == torch.bfloat16 and out.shape == (2, l, 128)
    _assert_kernel_bar(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("l", [16, 50])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_reference_mlp_half_matches_jax_chain(l, act):
    arrs = _mlp_inputs(2, l, 128, 512, seed=7 + l)
    ref = jfab._reference_mlp_chain(*_to_jax(arrs, _MLP_BF16), act, 1e-5)
    out = fab.reference_mlp_half(*_to_torch(arrs, _MLP_BF16), act, 1e-5)
    assert out.dtype == torch.bfloat16 and out.shape == (2, l, 128)
    _assert_kernel_bar(out.float().numpy(), np.asarray(ref, np.float32))


def test_wrappers_run_plain_versions_on_cpu():
    """On a CPU tensor the wrapper IS the plain version, and counts no
    kernel launch."""
    attn = _to_torch(_attn_inputs(2, 16, 128, seed=3), _ATTN_BF16)
    mlp = _to_torch(_mlp_inputs(2, 16, 128, 512, seed=4), _MLP_BF16)
    before = (fab.fused_attn_half.launches, fab.fused_mlp_half.launches)
    mask = torch.from_numpy(_causal(16))
    torch.testing.assert_close(
        fab.fused_attn_half(*attn, mask, 2, 1e-5),
        fab.reference_attn_half(*attn, mask, 2, 1e-5), rtol=0, atol=0)
    torch.testing.assert_close(
        fab.fused_mlp_half(*mlp, "gelu", 1e-5),
        fab.reference_mlp_half(*mlp, "gelu", 1e-5), rtol=0, atol=0)
    assert (fab.fused_attn_half.launches,
            fab.fused_mlp_half.launches) == before


def test_wrappers_never_fall_back_off_cpu():
    """A non-CPU tensor without a kernel raises; nothing switches to the
    plain version."""
    attn = [t.to("meta") for t in
            _to_torch(_attn_inputs(1, 16, 128, seed=5), _ATTN_BF16)]
    with pytest.raises(ValueError, match="no kernel for device"):
        fab.fused_attn_half(*attn, None, 2, 1e-5)
    mlp = [t.to("meta") for t in
           _to_torch(_mlp_inputs(1, 16, 128, 512, seed=6), _MLP_BF16)]
    with pytest.raises(ValueError, match="no kernel for device"):
        fab.fused_mlp_half(*mlp, "gelu", 1e-5)
    images = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        normalize_images(images, dtype=torch.bfloat16)


@pytest.mark.parametrize("shape,heads,dtype,mask_shape,ok", [
    ((32, 50, 768), 12, torch.bfloat16, None, True),       # ViT-B/32 vision
    ((512, 77, 512), 8, torch.bfloat16, (77, 77), True),   # text, causal
    ((32, 50, 768), 12, torch.float32, None, False),       # fp32 stays plain
    ((32, 197, 768), 12, torch.bfloat16, None, False),     # L > 128
    ((32, 50, 1280), 16, torch.bfloat16, None, False),     # dh 80
    ((32, 77, 512), 8, torch.bfloat16, (1, 77), False),    # not an [L, L] mask
])
def test_attn_supported_gate(shape, heads, dtype, mask_shape, ok):
    assert fab.supported(shape, heads, dtype, mask_shape) is ok


@pytest.mark.parametrize("width,act,dtype,ok", [
    (3072, "gelu", torch.bfloat16, True),
    (3072, "quick_gelu", torch.bfloat16, True),
    (3072, "relu", torch.bfloat16, False),
    (3072, "gelu", torch.float32, False),
    (3000, "gelu", torch.bfloat16, False),
])
def test_mlp_supported_gate(width, act, dtype, ok):
    assert fab.supported_mlp((1600, 768), width, act, dtype) is ok


def test_normalize_images_matches_jax():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    ref = np.asarray(jnormalize(jnp.asarray(u8)))
    out = normalize_images(torch.from_numpy(u8))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    bf = normalize_images(torch.from_numpy(u8), dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16

