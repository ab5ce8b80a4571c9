"""The port's CUDA kernels against their plain versions, on the card.

Every test here but one needs a CUDA device and skips without one (the
one checks on the CPU that the precision bars below separate fp32 sums
from bf16 ones). The file
imports nothing of JAX, so it runs on a machine with a card and torch
only (conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Bar: atol = max|ref|/128 (one bf16 ULP at output scale), rtol = 1e-2, the
bar tests/test_fused_attn_block.py applies to the Pallas kernels, for
each output of each kernel (flash attention's forward and backward, the
fused MLP and the fused block halves). Flash attention's forward and
backward are also held at every edge of their 64-row tiles (L = 1, 63,
64, 65) and at the model lengths, at head dim 64 and 128, the forward's
fp32 log-sum-exp within 1e-4 of logsumexp of the plain scores; the fused
MLP at rows short of, at and past its 128-row tiles and at widths that
end on half a 128-column tile; the MLP half at every row count of the
main paths and under a large residual; the attention half and its
backward at key counts on both sides of their 64- and 128-key tiles
(L = 16, 17, 63, 64, 65, 80, 127, 128, with and without the causal mask)
and at a precompute chunk (B = 512, L = 77). Tighter, where the
backward's design rests on precision: its dQ, dK and dV near the plain
version's bits (ds taken in fp32), and gemm_sm90.cuh's modes
as the backward runs them (B read K-major; A read M-major with an fp32
output at a ragged K = B L) against fp32 products of the same bf16
operands, read from the backward's own buffers. The flash backward, the MLP half, the
attention half and its backward repeat bit for bit. Gradients through a whole block,
kernels on against kernels off: cosine >= 0.999 per tensor. The image normalize
against its plain version (the kernel's one FMA against a multiply and
an add): bf16 within one bf16 ULP on every element, fp32 within one fp32
ulp at the operands' scale (2^-22). The forward kernels' custom ops:
``torch.library.opcheck`` of each, and each captured in a CUDA graph and
replayed on fresh inputs, bit for bit an eager launch.
"""

import numpy as np
import pytest
import torch

from xtagclip_tpu_torch.models.layers import (
    ResidualAttentionBlock,
    set_use_kernels,
)
from xtagclip_tpu_torch.ops import flash_attn, fused_mlp, preprocess
from xtagclip_tpu_torch.ops import fused_attn_block as fab

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _tensors(shapes, seed, device):
    """bf16 for names starting with 'w' or 'x', fp32 otherwise."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, scale) in shapes.items():
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        dt = torch.bfloat16 if name[0] in "wx" else torch.float32
        out[name] = torch.from_numpy(a).to(device=device, dtype=dt)
    return out


def _attn_args(b, l, d, seed, device):
    t = _tensors({"x": ((b, l, d), 1.0), "g": (d, 0.1), "lb": (d, 0.1),
                  "wqkv": ((d, 3 * d), d**-0.5), "bqkv": (3 * d, 0.1),
                  "wout": ((d, d), d**-0.5), "bout": (d, 0.1)}, seed, device)
    t["g"] = t["g"] + 1
    return [t[k] for k in ("x", "g", "lb", "wqkv", "bqkv", "wout", "bout")]


def _mlp_args(n, d, h, seed, device):
    t = _tensors({"x": ((n, d), 1.0), "g": (d, 0.1), "lb": (d, 0.1),
                  "w1": ((d, h), d**-0.5), "b1": (h, 0.1),
                  "w2": ((h, d), h**-0.5), "b2": (d, 0.1)}, seed, device)
    t["g"] = t["g"] + 1
    return [t[k] for k in ("x", "g", "lb", "w1", "b1", "w2", "b2")]


def _assert_kernel_bar(out, ref):
    out, ref = out.float().cpu(), ref.float().cpu()
    assert torch.isfinite(out).all()
    tol = ref.abs().max().item() / 128
    torch.testing.assert_close(out, ref, atol=tol, rtol=1e-2)


@pytest.mark.parametrize("b,l,d,h,causal", [
    (32, 50, 768, 12, False),   # ViT-B/32 vision blocks
    (32, 77, 512, 8, True),     # text blocks, causal mask
    (512, 77, 512, 8, True),    # a precompute chunk's text blocks
    (3, 1, 128, 2, False),      # one token
    (2, 128, 64, 1, True),      # longest L the kernel takes
    (5, 33, 192, 3, False),     # ragged L, odd batch
])
def test_attn_kernel_matches_plain(cuda, b, l, d, h, causal):
    args = _attn_args(b, l, d, seed=l, device=cuda)
    mask = (torch.triu(torch.full((l, l), float("-inf"), device=cuda), 1)
            if causal else None)
    with torch.inference_mode():
        before = fab.fused_attn_half.launches
        out = fab.fused_attn_half(*args, mask, h, 1e-5)
        assert fab.fused_attn_half.launches == before + 1
        ref = fab.reference_attn_half(*args, mask, h, 1e-5)
    torch.cuda.synchronize()
    _assert_kernel_bar(out, ref)


@pytest.mark.parametrize("n", [1, 37, 1600, 2464, 39424])
@pytest.mark.parametrize("d,h", [(768, 3072), (512, 2048), (64, 256)])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_mlp_kernel_matches_plain(cuda, n, d, h, act):
    """Every row count the main paths give #2 (one row, a ragged 37, the
    ViT-B-32 vision and text rows of a serve batch, a 512-prompt precompute
    chunk) at every width, so both the 128- and 64-wide output tiles run."""
    args = _mlp_args(n, d, h, seed=n, device=cuda)
    with torch.inference_mode():
        before = fab.fused_mlp_half.launches
        out = fab.fused_mlp_half(*args, act, 1e-5)
        assert fab.fused_mlp_half.launches == before + 1
        ref = fab.reference_mlp_half(*args, act, 1e-5)
    torch.cuda.synchronize()
    _assert_kernel_bar(out, ref)


@pytest.mark.parametrize("n,d,h", [(1600, 768, 3072), (2464, 512, 2048)])
def test_mlp_kernel_matches_plain_with_large_residual(cuda, n, d, h):
    """A residual stream 100x the MLP's output (LN takes its scale away):
    the epilogue adds x + (acc + b2) in fp32 and rounds once."""
    args = _mlp_args(n, d, h, seed=n + 5, device=cuda)
    args[0] = (args[0].float() * 100).bfloat16()
    with torch.inference_mode():
        out = fab.fused_mlp_half(*args, "gelu", 1e-5)
        ref = fab.reference_mlp_half(*args, "gelu", 1e-5)
    torch.cuda.synchronize()
    _assert_kernel_bar(out, ref)


def test_mlp_kernel_repeats_bit_for_bit(cuda):
    args = _mlp_args(2464, 512, 2048, seed=11, device=cuda)
    with torch.inference_mode():
        a = fab.fused_mlp_half(*args, "gelu", 1e-5)
        b = fab.fused_mlp_half(*args, "gelu", 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("b,l,d,h,causal", [
    (32, 50, 768, 12, False),   # ViT-B/32 vision blocks
    (32, 77, 512, 8, True),     # text blocks, causal mask
    (3, 1, 128, 2, False),      # one token
    (2, 128, 64, 1, True),      # longest L supported_bwd takes
    (5, 33, 192, 3, False),     # ragged L, odd batch
])
def test_attn_bwd_kernel_matches_plain(cuda, b, l, d, h, causal):
    args = _attn_args(b, l, d, seed=100 + l, device=cuda)
    x, ln_g, ln_b, wqkv, bqkv, wout, _ = args
    g = _tensors({"x": ((b, l, d), 1.0)}, 7 + l, cuda)["x"]
    mask = (torch.triu(torch.full((l, l), float("-inf"), device=cuda), 1)
            if causal else None)
    assert fab.supported_bwd((b, l, d), h, mask_shape=None if mask is None
                             else (l, l))
    bwd_args = (x, g, ln_g, ln_b, wqkv, bqkv, wout, mask, h, 1e-5)
    before = fab.fused_attn_half_bwd.launches
    outs = fab.fused_attn_half_bwd(*bwd_args)
    assert fab.fused_attn_half_bwd.launches == before + 1
    refs = fab.reference_attn_half_bwd(*bwd_args)
    torch.cuda.synchronize()
    shapes = [(b, l, d), (b, l, 3 * d), (d, d), (d,), (d,), (d,)]
    for out, ref, shape in zip(outs, refs, shapes):
        assert tuple(out.shape) == shape and out.dtype == ref.dtype
        _assert_kernel_bar(out, ref)


# key counts at the edges of the attention cores' key tiles (64 and 128
# keys) and of their 16-key wgmma steps
KEY_TILE_LENGTHS = [16, 17, 63, 64, 65, 80, 127, 128]


def _causal(l, device):
    return torch.triu(torch.full((l, l), float("-inf"), device=device), 1)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", KEY_TILE_LENGTHS)
def test_attn_kernel_matches_plain_at_key_tiles(cuda, l, causal):
    args = _attn_args(2, l, 128, seed=200 + l, device=cuda)
    mask = _causal(l, cuda) if causal else None
    with torch.inference_mode():
        out = fab.fused_attn_half(*args, mask, 2, 1e-5)
        ref = fab.reference_attn_half(*args, mask, 2, 1e-5)
    torch.cuda.synchronize()
    _assert_kernel_bar(out, ref)


def _attn_bwd_args(b, l, d, h, causal, seed, device):
    x, ln_g, ln_b, wqkv, bqkv, wout, _ = _attn_args(b, l, d, seed, device)
    g = _tensors({"x": ((b, l, d), 1.0)}, seed + 1, device)["x"]
    mask = _causal(l, device) if causal else None
    return (x, g, ln_g, ln_b, wqkv, bqkv, wout, mask, h, 1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", KEY_TILE_LENGTHS)
def test_attn_bwd_kernel_matches_plain_at_key_tiles(cuda, l, causal):
    bwd_args = _attn_bwd_args(2, l, 128, 2, causal, 300 + l, cuda)
    outs = fab.fused_attn_half_bwd(*bwd_args)
    refs = fab.reference_attn_half_bwd(*bwd_args)
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert out.dtype == ref.dtype
        _assert_kernel_bar(out, ref)


def test_attn_kernels_repeat_bit_for_bit(cuda):
    """No atomics in the attention half or its backward: two launches on
    the same inputs give the same bits, every output."""
    args = _attn_args(32, 77, 512, seed=13, device=cuda)
    bwd_args = _attn_bwd_args(32, 77, 512, 8, True, 13, cuda)
    with torch.inference_mode():
        fwd = [fab.fused_attn_half(*args, _causal(77, cuda), 8, 1e-5)
               for _ in range(2)]
        bwd = [fab.fused_attn_half_bwd(*bwd_args) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(fwd[0], fwd[1])
    assert all(torch.equal(a, b) for a, b in zip(*bwd))


def _bf16_ulps(out, ref):
    """|out - ref| per element in bf16 ULPs at the element's scale,
    taken no lower than max|ref| / 8 (an element far below the output's
    scale is a difference of larger terms)."""
    out, ref = out.float(), ref.float()
    scale = ref.abs().clamp_min(ref.abs().max() / 8)
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale).exponent - 8)
    return (out - ref).abs() / ulp


# (most bf16 ULPs an element may differ by, largest share of elements
# whose bits may differ) for a bf16 output against one that rounds the
# same sums in fp32 in another order. A product of the same bf16 operands
# rounds once: one ULP. The backward's dQ, dK and dV, whose plain version
# also rounds its own qkv, datt, dp and p on the way, move further where
# one of those flips. test_precision_bars_separate_exact_sums_from_bf16_ones
# holds both bars: float64 arithmetic passes them, and one bf16 rounding
# where a sum takes fp32 (a bf16 ds in dQ and dK, a bf16 partial sum)
# fails them: it moves a large share of the elements.
PRODUCT_BAR = (1.0, 0.01)
DQKV_BAR = (4.0, 0.05)


def _near_bits(out, ref, max_ulps, max_share):
    assert out.dtype == ref.dtype == torch.bfloat16
    return (_bf16_ulps(out, ref).max().item() <= max_ulps
            and (out != ref).float().mean().item() <= max_share)


def _dwout_near(out, ref, k):
    """An fp32 sum of k products against the same sum in another order:
    within 1e-5 sqrt(k) max|ref|. A bf16 rounding on the way is up to
    2^-9 of the largest elements."""
    return (out - ref).abs().max().item() <= 1e-5 * k**0.5 * ref.abs().max().item()


def _dqkv_float64(x, g, ln_g, ln_b, wqkv, bqkv, wout, mask, h, eps,
                  ds_bf16=False):
    """dqkv of reference_attn_half_bwd's arithmetic and rounding points in
    float64 (another order, more precision), with ds rounded to one bf16
    where ds_bf16."""
    b, l, d = x.shape
    dh, f64, bf = d // h, torch.float64, torch.bfloat16
    rstd, xhat = fab._ln_stats(x.float(), eps)
    xn = (xhat * ln_g.float() + ln_b.float()).to(bf)
    qkv = (xn.to(f64) @ wqkv.to(f64) + bqkv.to(f64)).to(bf)

    def heads(t):
        return t.reshape(b, l, h, dh).transpose(1, 2).to(f64)

    q, k, v = (heads(t) for t in qkv.split(d, dim=-1))
    do = heads((g.to(f64) @ wout.to(f64).t()).to(bf))
    s = (q @ k.transpose(-1, -2)) * dh**-0.5
    p = torch.softmax(s if mask is None else s + mask.to(f64), dim=-1)
    dp = (do @ v.transpose(-1, -2)).to(bf).to(f64)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * dh**-0.5
    if ds_bf16:
        ds = ds.to(bf).to(f64)
    dv = p.to(bf).to(f64).transpose(-1, -2) @ do
    return torch.cat([t.to(bf).transpose(1, 2).reshape(b, l, d)
                      for t in (ds @ k, ds.transpose(-1, -2) @ q, dv)], -1)


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("k", [37, 2464])
def test_precision_bars_separate_exact_sums_from_bf16_ones(k, planted):
    """Runs on the CPU: the bars below pass arithmetic that keeps every
    sum in fp32 or better and fail one bf16 rounding planted where a sum
    takes fp32. The backward's dQ, dK (ds as one bf16 when planted) and
    dV at two key tiles; a product of K = k bf16 operands (summed as two
    bf16 halves when planted) and an fp32 one (rounded to bf16)."""
    for l, causal in ((65, False), (128, True)):
        args = _attn_bwd_args(2, l, 128, 2, causal, 500 + l, "cpu")
        ref = fab.reference_attn_half_bwd(*args)[1].split(128, -1)
        out = _dqkv_float64(*args, ds_bf16=planted).split(128, -1)
        held = [_near_bits(o, r, *DQKV_BAR) for o, r in zip(out, ref)]
        assert held == [not planted, not planted, True]
    rng = np.random.default_rng(k)
    a, w = (torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32))
            .bfloat16().double() for rows in (192, 256))
    with fab._full_fp32_matmul():
        prod = a.float() @ w.float().t()
    if planted:
        half = k // 2
        out = sum((a[:, i].float() @ w[:, i].float().t()).bfloat16().float()
                  for i in (slice(0, half), slice(half, k)))
        out32 = prod.bfloat16().float()
    else:
        out = out32 = (a @ w.t()).float()
    assert _near_bits(out.bfloat16(), prod.bfloat16(), *PRODUCT_BAR) != planted
    assert _dwout_near(out32, prod, k) != planted


def _attn_bwd_buffers(x, g, ln_g, ln_b, wqkv, bqkv, wout, mask, h, eps):
    """The backward's C entry point with buffers of the test's own, so the
    products it leaves in its scratch can be read: {datt, att, dxn, dqkv,
    dwout}."""
    from xtagclip_tpu_torch.ops import cuda_build

    b, l, d = x.shape
    n, dev = b * l, x.device
    bf, f32 = torch.bfloat16, torch.float32
    buf = {k: torch.empty((n, w), dtype=bf, device=dev) for k, w in (
        ("xn", d), ("qkv", 3 * d), ("datt", d), ("att", d), ("dxn", d))}
    stats = torch.empty(2 * n, dtype=f32, device=dev)
    partial = torch.empty(fab._COL_SPLITS * 3 * d, dtype=f32, device=dev)
    mask_ws = fab._mask_scratch(mask)
    dx = torch.empty_like(x)
    buf["dqkv"] = torch.empty((n, 3 * d), dtype=bf, device=dev)
    buf["dwout"] = torch.empty((d, d), dtype=f32, device=dev)
    sums = [torch.empty(d, dtype=f32, device=dev) for _ in range(3)]
    lib = cuda_build.load("fused_attn_half_bwd")
    err = lib.xtag_fused_attn_half_bwd(
        x.data_ptr(), g.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(),
        wqkv.data_ptr(), bqkv.data_ptr(), wout.data_ptr(), fab._ptr(mask),
        *(buf[k].data_ptr() for k in ("xn", "qkv", "datt", "att", "dxn")),
        stats.data_ptr(), partial.data_ptr(), fab._ptr(mask_ws),
        dx.data_ptr(), buf["dqkv"].data_ptr(), buf["dwout"].data_ptr(),
        *(t.data_ptr() for t in sums), b, l, d, h, float(eps),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, err, "xtag_fused_attn_half_bwd")
    torch.cuda.synchronize()
    return buf


# the backward's shapes on the main path, and ragged K = B L of dwout
# (2 * 17 = 34 and 37, below one 64-deep k-step; 2464)
BWD_PRODUCT_SHAPES = [
    (32, 50, 768, 12, False),   # ViT-B/32 vision blocks, K = 1600
    (32, 77, 512, 8, True),     # text blocks, K = 2464
    (2, 17, 128, 2, True),
    (1, 37, 192, 3, False),
]


@pytest.mark.parametrize("b,l,d,h,causal", BWD_PRODUCT_SHAPES)
def test_attn_bwd_products_match_fp32_products(cuda, b, l, d, h, causal):
    """gemm_sm90.cuh's modes as the backward runs them, read from its own
    buffers, against the fp32 product of the same bf16 operands: datt = g
    wout^T (K = D) and dxn = dqkv wqkv^T (K = 3D), B read K-major, each
    within PRODUCT_BAR of the rounded fp32 product; dwout = att^T g, A
    read M-major at the ragged K = B L, fp32 out, within 1e-5 sqrt(K)
    max|ref|."""
    x, g, ln_g, ln_b, wqkv, bqkv, wout, mask, h, eps = _attn_bwd_args(
        b, l, d, h, causal, 400 + l, cuda)
    buf = _attn_bwd_buffers(x, g, ln_g, ln_b, wqkv, bqkv, wout, mask, h, eps)
    g2 = g.reshape(-1, d).float()
    with fab._full_fp32_matmul():
        datt = (g2 @ wout.float().t()).bfloat16()
        dxn = (buf["dqkv"].float() @ wqkv.float().t()).bfloat16()
        dwout = buf["att"].float().t() @ g2
    assert _near_bits(buf["datt"], datt, *PRODUCT_BAR)
    assert _near_bits(buf["dxn"], dxn, *PRODUCT_BAR)
    assert _dwout_near(buf["dwout"], dwout, b * l)


@pytest.mark.parametrize("b,l,d,h,causal", [
    (2, 17, 128, 2, False),
    (2, 64, 128, 2, True),
    (2, 65, 128, 2, False),
    (2, 128, 128, 2, True),
    (32, 50, 768, 12, False),   # ViT-B/32 vision blocks
    (32, 77, 512, 8, True),     # text blocks
])
def test_attn_bwd_dqkv_near_plain_bits(cuda, b, l, d, h, causal):
    """dQ = ds K and dK = ds^T Q take ds in fp32, as the plain version
    does (the core's three bf16 terms hi + mid + lo carry it), and dV =
    P^T dO sums bf16 products in fp32: each within DQKV_BAR of the plain
    version's, which one bf16 ds fails."""
    args = _attn_bwd_args(b, l, d, h, causal, 500 + l, cuda)
    dqkv = fab.fused_attn_half_bwd(*args)[1]
    ref = fab.reference_attn_half_bwd(*args)[1]
    torch.cuda.synchronize()
    for part, part_ref in zip(dqkv.split(d, -1), ref.split(d, -1)):
        assert _near_bits(part, part_ref, *DQKV_BAR)


def _cos(a, b):
    a, b = a.float().flatten(), b.float().flatten()
    return (a @ b / (a.norm() * b.norm()).clamp_min(1e-30)).item()


@pytest.mark.parametrize("causal", [False, True])
def test_block_gradients_kernels_vs_plain(cuda, causal):
    """One block, bf16 stream over fp32 parameters: autograd through the
    two Functions (kernels) against autograd through the plain halves."""
    torch.manual_seed(0)
    blk = ResidualAttentionBlock(256, 4).to(cuda)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            p.copy_(torch.randn_like(p) * (0.05 if p.dim() == 2 else 0.1)
                    + (1.0 if name.endswith("ln_1.scale")
                       or name.endswith("ln_2.scale") else 0.0))
    x0 = torch.randn(4, 50, 256, device=cuda).bfloat16()
    ct = torch.randn(4, 50, 256, device=cuda).bfloat16()
    mask = (torch.triu(torch.full((50, 50), float("-inf"), device=cuda), 1)
            if causal else None)

    def grads(use_kernels):
        set_use_kernels(blk, use_kernels)
        blk.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_(True)
        blk(x, attn_mask=mask).backward(ct)
        return [x.grad] + [p.grad for p in blk.parameters()]

    before = (fab.fused_attn_half.launches, fab.fused_attn_half_bwd.launches,
              fab.fused_mlp_half.launches)
    on = grads(True)
    after = (fab.fused_attn_half.launches, fab.fused_attn_half_bwd.launches,
             fab.fused_mlp_half.launches)
    off = grads(False)
    torch.cuda.synchronize()
    assert tuple(a - b_ for a, b_ in zip(after, before)) == (1, 1, 1)
    for a, r in zip(on, off):
        assert a.dtype == r.dtype and torch.isfinite(a).all()
        assert _cos(a, r) >= 0.999


# flash attention (kernel #6): the GAP tower's shape, ragged L, dh = 128
FLASH_SHAPES = [
    (32, 12, 256, 64),   # ViT-B-16 at 256 px, cls-free: the main path
    (1, 12, 128, 64),
    (1, 12, 197, 64),    # ViT-B-16 at 224 px with its class token
    (1, 12, 257, 64),    # ViT-L-14 length
    (1, 12, 384, 64),
    (2, 4, 256, 128),    # head dim 128
    (3, 2, 1, 64),       # one token
]


def _flash_inputs(b, h, l, dh, layout, seed, device):
    """q, k, v as the model makes them: column slices of one [B, L, 3 H dh]
    projection (blhd views with row stride 3 H dh), or bhld tensors."""
    rng = np.random.default_rng(seed)
    if layout == "blhd":
        qkv = torch.from_numpy(rng.standard_normal(
            (b, l, 3 * h * dh)).astype(np.float32)).to(device, torch.bfloat16)
        return [t.reshape(b, l, h, dh) for t in qkv.split(h * dh, dim=-1)]
    return [torch.from_numpy(rng.standard_normal((b, h, l, dh)).astype(
        np.float32)).to(device, torch.bfloat16) for _ in range(3)]


@pytest.mark.parametrize("b,h,l,dh", FLASH_SHAPES)
@pytest.mark.parametrize("layout", ["blhd", "bhld"])
def test_flash_kernels_match_plain(cuda, b, h, l, dh, layout):
    q, k, v = _flash_inputs(b, h, l, dh, layout, seed=l + dh, device=cuda)
    before = (flash_attn.flash_mha.launches, flash_attn.flash_mha_bwd.launches)
    with torch.inference_mode():
        out = flash_attn.flash_mha(q, k, v, layout=layout)
        ref = flash_attn.reference_flash_mha(q, k, v, layout=layout)
    torch.cuda.synchronize()
    _assert_kernel_bar(out, ref)
    o, lse = flash_attn._flash_fwd(q, k, v, layout, with_lse=True)
    do = torch.randn(o.shape, device=cuda).bfloat16()
    grads = flash_attn.flash_mha_bwd(q, k, v, o, lse, do, layout)
    refs = flash_attn.reference_flash_mha_bwd(q, k, v, o, do, layout)
    torch.cuda.synchronize()
    assert (flash_attn.flash_mha.launches, flash_attn.flash_mha_bwd.launches
            ) == (before[0] + 2, before[1] + 1)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.shape == q.shape and g.dtype == torch.bfloat16
        if l == 1 and name != "dv":
            # one key: the softmax is constant, so dq and dk are 0 in exact
            # arithmetic and both sides hold rounding noise (~1e-8)
            assert g.float().abs().max().item() <= 1e-5
        else:
            _assert_kernel_bar(g, r)


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("l", [1, 63, 64, 65, 197, 256, 257, 384])
@pytest.mark.parametrize("layout", ["blhd", "bhld"])
def test_flash_fwd_kernel_and_lse_match_plain(cuda, dh, l, layout):
    """The forward alone at every edge of its 64-key tiles (one key, one
    short of a tile, a tile, one past it) and the model's lengths: the
    output at the bar, and the fp32 log-sum-exp the backward reads against
    logsumexp of the plain fp32 scores within 1e-4 (the kernel sums the
    same exponentials in another order)."""
    b, h = 2, 3
    q, k, v = _flash_inputs(b, h, l, dh, layout, seed=7 * l + dh, device=cuda)
    before = flash_attn.flash_mha.launches
    with torch.inference_mode():
        o, lse = flash_attn._flash_fwd(q, k, v, layout, with_lse=True)
        ref = flash_attn.reference_flash_mha(q, k, v, layout=layout)
    torch.cuda.synchronize()
    assert flash_attn.flash_mha.launches == before + 1
    assert o.shape == q.shape and lse.shape == (b, h, l)
    _assert_kernel_bar(o, ref)
    qh, kh = (flash_attn._bhld(t, layout).float() for t in (q, k))
    s = (qh @ kh.transpose(-1, -2)) * dh**-0.5
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), rtol=1e-5,
                               atol=1e-4)


def _flash_slices(b, h, l, dh, layout, seed, device):
    """q, k, v as strided column-slice views in either layout: slices of
    one [B, L, 3 H dh] projection (blhd) or of one [B, H, L, 3 dh] tensor
    (bhld)."""
    if layout == "blhd":
        return _flash_inputs(b, h, l, dh, layout, seed, device)
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, h, l, 3 * dh)).astype(
        np.float32)).to(device, torch.bfloat16)
    return list(qkv.split(dh, dim=-1))


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("l", [1, 63, 64, 65, 197, 256, 257, 384])
@pytest.mark.parametrize("layout", ["blhd", "bhld"])
def test_flash_bwd_kernel_matches_plain(cuda, dh, l, layout):
    """The backward alone at every length the forward is held at, both
    head dims and both layouts, q, k, v strided column slices: dq, dk, dv
    at the bar (for one key, dq and dk are 0 up to rounding noise)."""
    b, h = 2, 3
    q, k, v = _flash_slices(b, h, l, dh, layout, seed=5 * l + dh, device=cuda)
    assert q.stride(-1) == 1 and not q.is_contiguous()
    o, lse = flash_attn._flash_fwd(q, k, v, layout, with_lse=True)
    do = torch.from_numpy(np.random.default_rng(l).standard_normal(
        tuple(o.shape)).astype(np.float32)).to(cuda, torch.bfloat16)
    before = flash_attn.flash_mha_bwd.launches
    grads = flash_attn.flash_mha_bwd(q, k, v, o, lse, do, layout)
    refs = flash_attn.reference_flash_mha_bwd(q, k, v, o, do, layout)
    torch.cuda.synchronize()
    assert flash_attn.flash_mha_bwd.launches == before + 1
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.shape == q.shape and g.dtype == torch.bfloat16
        if l == 1 and name != "dv":
            assert g.float().abs().max().item() <= 1e-5
        else:
            _assert_kernel_bar(g, r)


def test_flash_bwd_kernel_repeats_bit_for_bit(cuda):
    """No atomics: two launches on the same inputs give the same bits."""
    q, k, v = _flash_inputs(4, 12, 256, 64, "blhd", seed=9, device=cuda)
    o, lse = flash_attn._flash_fwd(q, k, v, "blhd", with_lse=True)
    do = torch.randn(o.shape, device=cuda).bfloat16()
    first = flash_attn.flash_mha_bwd(q, k, v, o, lse, do)
    second = flash_attn.flash_mha_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_function_grads_match_plain_bwd(cuda, dh):
    """Gradients through ``_FlashMHA`` (the forward kernel's output and
    lse feeding the backward kernels) against the plain backward."""
    q, k, v = (t.detach().requires_grad_(True) for t in _flash_inputs(
        2, 4, 197, dh, "blhd", seed=dh, device=cuda))
    ct = torch.randn(q.shape, device=cuda).bfloat16()
    before = (flash_attn.flash_mha.launches, flash_attn.flash_mha_bwd.launches)
    o = flash_attn.flash_mha(q, k, v)
    got = torch.autograd.grad(o, (q, k, v), ct)
    torch.cuda.synchronize()
    assert (flash_attn.flash_mha.launches, flash_attn.flash_mha_bwd.launches
            ) == (before[0] + 1, before[1] + 1)
    refs = flash_attn.reference_flash_mha_bwd(q.detach(), k.detach(),
                                              v.detach(), o.detach(), ct)
    for g, r in zip(got, refs):
        assert g.dtype == torch.bfloat16
        _assert_kernel_bar(g, r)


@pytest.mark.parametrize("n", [1, 37, 127, 8192, 8256])
@pytest.mark.parametrize("d,h", [(768, 3072), (512, 2048), (64, 256),
                                 (832, 3328)])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_fused_mlp_kernel_matches_plain(cuda, n, d, h, act):
    """Rows short of, at and past the GEMM's 128-row tiles, widths whose
    column count is a whole number of 128-column tiles or ends on a half
    tile (832 = 6.5 x 128; 64)."""
    x, _, _, w1, b1, w2, b2 = _mlp_args(n, d, h, seed=n + 1, device=cuda)
    with torch.inference_mode():
        before = fused_mlp.fused_mlp.launches
        out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, act)
        assert fused_mlp.fused_mlp.launches == before + 1
        ref = fused_mlp.reference_fused_mlp(x, w1, b1, w2, b2, act)
    torch.cuda.synchronize()
    _assert_kernel_bar(out, ref)


def test_gap_block_gradients_kernels_vs_plain(cuda):
    """One block off the fused halves (L = 256, bf16 stream over fp32
    parameters): autograd through flash attention's Function and the
    fused MLP's against autograd through their plain versions."""
    torch.manual_seed(1)
    blk = ResidualAttentionBlock(256, 4).to(cuda)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            p.copy_(torch.randn_like(p) * (0.05 if p.dim() == 2 else 0.1)
                    + (1.0 if name.endswith("scale") else 0.0))
    x0 = torch.randn(4, 256, 256, device=cuda).bfloat16()
    ct = torch.randn(4, 256, 256, device=cuda).bfloat16()
    assert not blk.takes_fused_halves(x0.shape)

    def grads(use_kernels):
        set_use_kernels(blk, use_kernels)
        blk.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_(True)
        blk(x).backward(ct)
        return [x.grad] + [p.grad for p in blk.parameters()]

    wrappers = (flash_attn.flash_mha, flash_attn.flash_mha_bwd,
                fused_mlp.fused_mlp, fab.fused_attn_half)
    before = [w.launches for w in wrappers]
    on = grads(True)
    after = [w.launches for w in wrappers]
    off = grads(False)
    torch.cuda.synchronize()
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, 1, 0]
    for a, r in zip(on, off):
        assert a.dtype == r.dtype and torch.isfinite(a).all()
        assert _cos(a, r) >= 0.999


def test_flash_and_mlp_raise_instead_of_falling_back(cuda):
    q, k, v = _flash_inputs(1, 2, 64, 64, "bhld", seed=3, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        flash_attn.flash_mha(q.float(), k.float(), v.float(), layout="bhld")
    q80 = torch.zeros((1, 2, 64, 80), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attn.flash_mha(q80, q80, q80, layout="bhld")
    with pytest.raises(ValueError, match="contiguous head dim"):
        flash_attn.flash_mha(q.transpose(2, 3), k.transpose(2, 3),
                             v.transpose(2, 3), layout="bhld")
    x, _, _, w1, b1, w2, b2 = _mlp_args(16, 96, 256, seed=4, device=cuda)
    with pytest.raises(ValueError, match="multiples of 64"):
        fused_mlp.fused_mlp(x, w1, b1, w2, b2, "gelu")
    blk = ResidualAttentionBlock(256, 4).to(cuda).bfloat16()
    mask = torch.zeros((256, 256), device=cuda)
    with pytest.raises(ValueError, match="neither the fused attention half"):
        blk(torch.zeros((1, 256, 256), device=cuda, dtype=torch.bfloat16),
            attn_mask=mask)


def test_kernels_raise_instead_of_falling_back(cuda):
    args = _attn_args(2, 197, 768, seed=1, device=cuda)
    with torch.inference_mode(), pytest.raises(ValueError, match="197"):
        fab.fused_attn_half(*args, None, 12, 1e-5)
    fp32 = [a.float() for a in args]
    with torch.inference_mode(), pytest.raises(ValueError, match="float32"):
        fab.fused_attn_half(*fp32, None, 12, 1e-5)
    margs = _mlp_args(16, 768, 3072, seed=2, device=cuda)
    margs[3] = margs[3].t().contiguous().t()      # a non-contiguous w1
    with torch.inference_mode(), pytest.raises(ValueError, match="contiguous"):
        fab.fused_mlp_half(*margs, "gelu", 1e-5)
    # under grad, a shape the backward kernel cannot take raises at once
    args[0].requires_grad_(True)
    with pytest.raises(ValueError, match="fused_attn_half_bwd.*197"):
        fab.fused_attn_half(*args, None, 12, 1e-5)
    x, ln_g, ln_b, wqkv, bqkv, wout, _ = _attn_args(2, 197, 768, seed=1,
                                                     device=cuda)
    with pytest.raises(ValueError, match="197"):
        fab.fused_attn_half_bwd(x, x, ln_g, ln_b, wqkv, bqkv, wout, None,
                                12, 1e-5)


def _ordered(t):
    """Monotonic integer keys of fp32 values (bf16 widened exactly): the
    difference of two keys counts fp32 ulps between them."""
    bits = t.float().contiguous().view(torch.int32).long()
    return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


@pytest.mark.parametrize("shape", [(32, 224, 224, 3),   # the main path's batch
                                   (5, 33, 47, 3),      # odd element count
                                   (1, 224, 224, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("offset", [0, 1])            # 1: a misaligned base
def test_normalize_kernel_matches_plain(cuda, shape, dtype, offset):
    rng = np.random.default_rng(sum(shape) + offset)
    n = int(np.prod(shape))
    flat = torch.from_numpy(rng.integers(0, 256, n + offset, dtype=np.uint8))
    images = flat.to(cuda)[offset:].view(shape)
    before = preprocess.normalize_images.launches
    out = preprocess.normalize_images(images, dtype=dtype)
    assert preprocess.normalize_images.launches == before + 1
    ref = preprocess.normalize_images_reference(images, dtype=dtype)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == images.shape
    assert torch.isfinite(out).all()
    if dtype == torch.bfloat16:
        ulps = (_ordered(out) - _ordered(ref)).abs() >> 16
        assert ulps.max().item() <= 1
    else:
        # the product's rounding, which the FMA skips, is one ulp of the
        # operands (|x * scale|, |bias| < 4), not of a result near zero
        assert (out - ref).abs().max().item() <= 2.0**-22


def test_normalize_kernel_raises_instead_of_falling_back(cuda):
    images = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="uint8"):
        preprocess.normalize_images(images.float())
    with pytest.raises(ValueError, match=r"\[B, H, W, 3\]"):
        preprocess.normalize_images(images[..., :2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        preprocess.normalize_images(images.transpose(1, 2))
    with pytest.raises(ValueError, match="float16"):
        preprocess.normalize_images(images, dtype=torch.float16)


# -- the forward kernels as custom ops: opcheck and CUDA graphs --------------

_OP_WRAPPERS = {"fused_attn_half": fab.fused_attn_half,
                "fused_attn_half_causal": fab.fused_attn_half,
                "fused_mlp_half": fab.fused_mlp_half,
                "fused_mlp": fused_mlp.fused_mlp,
                "flash_mha": flash_attn.flash_mha,
                "normalize_images": preprocess.normalize_images}


def _op_case(name, seed, device):
    """(custom op, its arguments) at a served shape (a smaller batch)."""
    if name == "fused_attn_half":
        return fab.fused_attn_half_op, (
            *_attn_args(4, 50, 768, seed, device), None, 12, 1e-5)
    if name == "fused_attn_half_causal":
        return fab.fused_attn_half_op, (
            *_attn_args(4, 77, 512, seed, device), _causal(77, device), 8,
            1e-5)
    if name == "fused_mlp_half":
        return fab.fused_mlp_half_op, (
            *_mlp_args(200, 768, 3072, seed, device), "gelu", 1e-5)
    if name == "fused_mlp":
        x, _, _, w1, b1, w2, b2 = _mlp_args(512, 768, 3072, seed, device)
        return fused_mlp.fused_mlp_op, (x, w1, b1, w2, b2, "quick_gelu")
    if name == "flash_mha":
        return flash_attn.flash_mha_op, (
            *_flash_inputs(2, 12, 256, 64, "blhd", seed, device), "blhd")
    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.randint(0, 256, (4, 224, 224, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    return preprocess.normalize_images_op, (
        images, [0.48145466, 0.4578275, 0.40821073],
        [0.26862954, 0.26130258, 0.27577711], torch.bfloat16)


@pytest.mark.parametrize("name", sorted(_OP_WRAPPERS))
def test_custom_op_opcheck(cuda, name):
    """Schema, fake implementation and dispatch of each forward op
    (torch.library.opcheck)."""
    op, args = _op_case(name, 910, cuda)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name", sorted(_OP_WRAPPERS))
def test_custom_op_replays_as_cuda_graph(cuda, name):
    """Each forward kernel captured in a CUDA graph, replayed on fresh
    inputs copied into the captured buffers: bit for bit an eager launch
    on those inputs. The capture counts one launch, the replay none."""
    op, static = _op_case(name, 920, cuda)
    _, fresh = _op_case(name, 921, cuda)
    wrapper = _OP_WRAPPERS[name]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op(*static)  # first use: the library loads, the attributes are set
    torch.cuda.current_stream().wait_stream(side)
    before = wrapper.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = op(*static)
    assert wrapper.launches == before + 1
    for s, f in zip(static, fresh):
        if isinstance(s, torch.Tensor):
            s.copy_(f)
    graph.replay()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = op(*fresh)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
