"""Flash attention (#6) under an additive [L, L] mask and at head dim 256,
on the CPU: the plain versions against JAX's
``models/layers.py::dot_product_attention`` (:103; fp32, 1e-5), the
wrapper, its autograd Function and its custom op on a CPU tensor, and the
routing in models/layers.py (``flash_takes``): a masked self-attention at
a head dim of JAX's fused half goes to #6, one at another head dim (or a
[B, 1, L, L] mask) stays on the plain core, and no built-in config
changes route. Two masked blocks, dh 128 at L = 77 and dh 64 at L = 160,
against JAX's block on the same weights (jitted): fp32 within 1e-3, and
bf16 at the kernel bar (atol max|ref| / 128, rtol 1e-2) against JAX's
non-fused block, the composition the port's route follows.

The CUDA kernels themselves run only on the card: ``chip_smoke.py``'s
kernel rows hold them to these plain versions there.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from xtagclip_tpu.models.layers import ResidualAttentionBlock as JBlock
from xtagclip_tpu.models.layers import dot_product_attention
from xtagclip_tpu_torch import factory
from xtagclip_tpu_torch.convert.from_jax import load_jax_params
from xtagclip_tpu_torch.models import layers
from xtagclip_tpu_torch.models.layers import ResidualAttentionBlock
from xtagclip_tpu_torch.models.text import build_causal_mask
from xtagclip_tpu_torch.ops import flash_attn as fa

sys.path.insert(0, os.path.dirname(__file__))
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)


def _mask(kind, l, seed=0):
    m = np.zeros((l, l), np.float32)
    if kind in ("causal", "one_row"):
        m = np.triu(np.full((l, l), -np.inf, np.float32), 1)
    if kind == "one_row":  # a row with no key
        m[3] = -np.inf
    if kind == "first_tile":  # rows past 64 see no key of the first tile
        m[64:, :64] = -np.inf
    if kind == "random":
        m = np.random.default_rng(seed).standard_normal((l, l)).astype(
            np.float32)
    return None if kind == "none" else m


# (B, H, L, dh, mask)
CASES = [(2, 3, 77, 128, "causal"), (2, 2, 160, 64, "causal"),
         (2, 2, 77, 80, "causal"), (1, 2, 96, 256, "none"),
         (1, 2, 96, 256, "causal"), (2, 2, 50, 104, "random"),
         (2, 2, 130, 64, "first_tile"), (1, 2, 40, 64, "one_row")]


def _qkv(b, h, l, dh, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, l, dh)).astype(np.float32)
            for _ in range(4)]


def _jax_fwd(q, k, v, m):
    return dot_product_attention(q, k, v, None if m is None
                                 else jnp.asarray(m))[0]


@pytest.mark.parametrize("b,h,l,dh,kind", CASES)
def test_plain_forward_matches_jax(b, h, l, dh, kind):
    q, k, v, _ = _qkv(b, h, l, dh)
    m = _mask(kind, l)
    want = np.asarray(jax.jit(_jax_fwd)(q, k, v, m))
    tm = None if m is None else torch.from_numpy(m)
    got = fa.reference_flash_mha(*(torch.from_numpy(t) for t in (q, k, v)),
                                 "bhld", mask=tm).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)
    assert np.isnan(got).any() == (kind == "one_row")


@pytest.mark.parametrize("b,h,l,dh,kind", [c for c in CASES
                                           if c[-1] != "one_row"])
def test_plain_backward_matches_jax(b, h, l, dh, kind):
    q, k, v, do = _qkv(b, h, l, dh, seed=2)
    m = _mask(kind, l)
    out, vjp = jax.vjp(lambda *a: _jax_fwd(*a, m), q, k, v)
    want = vjp(jnp.asarray(do))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = fa.reference_flash_mha_bwd(
        *t, torch.from_numpy(np.array(out)), torch.from_numpy(do), "bhld",
        mask=None if m is None else torch.from_numpy(m))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_wrapper_and_function_on_the_cpu():
    """The wrapper runs the plain version on a CPU tensor, in the model's
    [B, L, H, dh] layout; under grad the Function's backward is the plain
    backward with the same mask; a bf16 mask reads as its fp32 values."""
    b, h, l, dh = 2, 2, 70, 128
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2).contiguous()
                   for a in _qkv(b, h, l, dh, seed=3))
    m = build_causal_mask(l)
    out = fa.flash_mha(q, k, v, mask=m)
    torch.testing.assert_close(out, fa.reference_flash_mha(q, k, v, mask=m),
                               rtol=0, atol=0)
    torch.testing.assert_close(fa.flash_mha(q, k, v, mask=m.bfloat16()), out,
                               rtol=0, atol=0)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_mha(*leaves, mask=m).backward(do)
    want = fa.reference_flash_mha_bwd(q, k, v, out, do, mask=m)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
    assert not torch.equal(out, fa.flash_mha(q, k, v))
    # the custom op takes the mask, and its fake gives the output's shape
    op = torch.ops.xtagclip_tpu_torch.flash_mha
    torch.testing.assert_close(op(q, k, v, "blhd", m), out, rtol=0, atol=0)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(t) for t in (q, k, v)), "blhd",
                  mode.from_tensor(m))
    assert fake.shape == q.shape and fake.dtype == q.dtype


def test_supported_and_flash_takes():
    m = torch.zeros(77, 77)
    assert fa.supported(77, 77, m, 128) and fa.supported(77, 77, None, 256)
    assert fa.supported(77, 77, m, 256) and 256 in fa.HEAD_DIMS
    assert not fa.supported(77, 77, torch.zeros(2, 1, 77, 77), 64)
    assert not fa.supported(77, 77, torch.zeros(76, 77), 64)
    assert not fa.supported(77, 77, None, 48)
    for dh in layers.JAX_FUSED_HEAD_DIMS:
        assert layers.flash_takes(77, m, dh)
    # masked at a head dim JAX's fused half refuses: XLA's attention there
    assert not layers.flash_takes(77, m, 72)
    assert not layers.flash_takes(96, torch.zeros(96, 96), 256)
    assert layers.flash_takes(96, None, 256) and layers.flash_takes(
        77, None, 72)


@pytest.mark.parametrize("width,heads,l,ls", [
    (512, 4, 77, None),    # causal text at dh 128
    (320, 4, 77, None),    # dh 80
    (256, 4, 160, None),   # dh 64 past the fused half's 128 keys
    (256, 4, 77, 1e-5),    # a LayerScale causal block
])
def test_gap_streams_take_flash_attention(width, heads, l, ls):
    """The masked streams the port's card path once refused take #6 now:
    ``_check_kernels_take`` lets them through and the core is flash's."""
    blk = ResidualAttentionBlock(width, heads, ls_init_value=ls)
    mask = build_causal_mask(l)
    shape = (2, l, width)
    route = blk.route(shape, mask)
    assert route == "non_fused"
    blk._check_kernels_take(shape, mask, route)
    assert layers.flash_takes(l, mask, width // heads)


def test_streams_no_kernel_takes_still_raise():
    blk = ResidualAttentionBlock(192, 4)  # dh 48: no kernel, no mask
    with pytest.raises(ValueError, match="no kernel for stream"):
        blk._check_kernels_take((2, 200, 192), None, "non_fused")
    # a masked dh-72 stream (ViTamin-XL's text) keeps the plain core
    blk = ResidualAttentionBlock(1152, 16)
    blk._check_kernels_take((2, 77, 1152), build_causal_mask(77),
                            "non_fused")


def test_no_builtin_config_changes_route():
    """Every built-in config's residual blocks on their own streams (the
    text towers causal at their context length): no tower has head dim
    256, and a masked stream off the fused halves has a head dim JAX's
    fused half refuses, so its core stays the plain attention; the
    unmasked cores were flash attention's before and are now."""
    from xtagclip_tpu_torch.models.coca import MultimodalTransformer

    masked = 0
    for name in factory.list_builtin_models():
        cfg = factory.get_model_config(name)
        t = cfg.get("text_cfg", {})
        ctx = t.get("context_length", 77)
        model = factory.create_model(name, device="meta", skip_init=True)
        for n, m in model.named_modules():
            if not isinstance(m, ResidualAttentionBlock):
                continue
            d = m.attn.out_proj.kernel.shape[0]
            dh = d // m.heads
            assert dh != 256, (name, n)
            causal = (n.startswith("text.") and not t.get("no_causal_mask")
                      ) or isinstance(model.get_submodule(n.split(".")[0]),
                                      MultimodalTransformer)
            if not causal or m.is_cross_attention:
                continue
            mask = torch.empty(ctx, ctx)
            if m.route((1, ctx, d), mask) == "non_fused":
                masked += 1
                assert not layers.flash_takes(ctx, mask, dh), (name, n, dh)
    assert masked > 0  # ViTamin-XL's causal text at dh 72 and the like


def _jax_params(jblk, seed, x, mask):
    params = jax.jit(lambda a: jblk.init(jax.random.PRNGKey(0), a,
                                         attn_mask=mask))(x)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (1.0 if p[-1].key == "scale" else 0.0)
        + (rng.standard_normal(a.shape) * 0.1).astype(np.float32), params)


@pytest.mark.parametrize("width,heads,l", [(256, 2, 77), (128, 2, 160)])
def test_masked_block_matches_jax(width, heads, l):
    """A causal block at dh 128 (L = 77) and at dh 64 (L = 160), both off
    the port's fused halves: the core is #6's plain version under the
    mask. fp32 within 1e-3 of JAX's block; bf16 at the kernel bar against
    JAX's non-fused block (XTAG_FUSED_BLOCK=0: its adds and products
    round where the port's non-fused route rounds them)."""
    x = np.random.default_rng(5).standard_normal((2, l, width)).astype(
        np.float32)
    mask = np.triu(np.full((l, l), -np.inf, np.float32), 1)
    tmask = torch.from_numpy(mask)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        xj = jnp.asarray(x, jdt)
        jblk = JBlock(num_heads=heads, dtype=jdt)
        params = _jax_params(jblk, 6, xj, jnp.asarray(mask))
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("XTAG_FUSED_BLOCK", "0")
            ref = np.asarray(jax.jit(lambda p, a: jblk.apply(
                {"params": p}, a, attn_mask=jnp.asarray(mask)))(params, xj),
                np.float32)
        blk = ResidualAttentionBlock(width, heads)
        load_jax_params(blk, jax.tree.map(np.asarray, params))
        assert blk.route(x.shape, tmask) == "non_fused"
        with torch.inference_mode():
            out = blk(torch.from_numpy(x).to(dtype), attn_mask=tmask)
        out = out.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)
        else:
            np.testing.assert_allclose(out, ref, rtol=1e-2,
                                       atol=np.abs(ref).max() / 128)
