"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports nothing of JAX, so it runs on a machine with a card and torch
only (conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Bar: atol = max|ref|/128 (one bf16 ULP at output scale), rtol = 1e-2, the
bar tests/test_fused_attn_block.py applies to the Pallas kernels.
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("n,d,h", [(1600, 768, 3072), (2464, 512, 2048),
                                   (37, 64, 256)])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_mlp_kernel_matches_plain(cuda, n, d, h, act):
    args = _mlp_args(n, d, h, seed=n, device=cuda)
    with torch.inference_mode():
        before = fab.fused_mlp_half.launches
        out = fab.fused_mlp_half(*args, act, 1e-5)
        assert fab.fused_mlp_half.launches == before + 1
        ref = fab.reference_mlp_half(*args, act, 1e-5)
    torch.cuda.synchronize()
    _assert_kernel_bar(out, ref)


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
    margs = _mlp_args(16, 768, 3072, seed=2, device=cuda)
    margs[3].requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference-only"):
        fab.fused_mlp_half(*margs, "gelu", 1e-5)
