"""The port's int8 linear ops (ops/int8.py) against the JAX package's, on
the CPU, on seeded numpy inputs.

Bars: the int8 values, the scales and the int32 sums equal JAX's exactly;
the scaled outputs within fp32 rounding (rtol 1e-6 on the product of an
int32 sum and two fp32 scales); and JAX's own accuracy bars against the
fp32 product (tests/test_int8.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from xtagclip_tpu.ops import int8 as j8
from xtagclip_tpu_torch.ops import int8 as t8
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def xw():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    # rows and columns of zeros take the 1e-12 floor of the scale
    x[0, 3] = 0.0
    w[:, 5] = 0.0
    return x, w


def test_quantized_values_and_scales_equal_jax(xw):
    x, w = xw
    for fn in ("quantize_weight", "quantize_activation"):
        arr = w if fn == "quantize_weight" else x
        jq, js = getattr(j8, fn)(jnp.asarray(arr))
        tq, ts = getattr(t8, fn)(torch.from_numpy(arr))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(_np(tq), np.asarray(jq), err_msg=fn)
        np.testing.assert_array_equal(_np(ts), np.asarray(js), err_msg=fn)


def test_int32_sums_exact_and_outputs_within_fp32_rounding(xw):
    x, w = xw
    jxq, jxs = j8.quantize_activation(jnp.asarray(x))
    jwq, jws = j8.quantize_weight(jnp.asarray(w))
    want_acc = lax.dot_general(jxq, jwq, (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    txq, txs = t8.quantize_activation(torch.from_numpy(x))
    twq, tws = t8.quantize_weight(torch.from_numpy(w))
    acc = t8.int8_dot(txq, twq)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(_np(acc), np.asarray(want_acc))
    want = np.asarray(j8.int8_matmul(jxq, jxs, jwq, jws))
    got = _np(t8.int8_matmul(txq, txs, twq, tws))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # JAX's accuracy bar against the fp32 product (tests/test_int8.py)
    ref = x @ w
    rel = np.abs(got - ref) / (np.abs(ref).mean() + 1e-6)
    assert np.median(rel) < 0.02


def test_dense_tree_and_apply_match_jax(xw):
    x, w = xw
    bias = np.linspace(-1, 1, 128).astype(np.float32)
    tree = {"layer": {"kernel": w, "bias": bias},
            "ln": {"scale": np.ones(256, np.float32)},
            "skip": {"kernel": w}}
    pred = lambda path: path != ("skip",)  # noqa: E731
    jq = j8.quantize_dense_tree(tree, pred)
    tq = t8.quantize_dense_tree(
        {k: {n: torch.from_numpy(v) for n, v in d.items()}
         for k, d in tree.items()}, pred)
    assert set(tq["layer"]) == {"kernel_q", "kernel_scale", "bias"}
    assert set(tq["ln"]) == {"scale"} and set(tq["skip"]) == {"kernel"}
    np.testing.assert_array_equal(_np(tq["layer"]["kernel_q"]),
                                  np.asarray(jq["layer"]["kernel_q"]))
    want = np.asarray(j8.int8_dense_apply(jq["layer"], jnp.asarray(x)))
    got = _np(t8.int8_dense_apply(tq["layer"], torch.from_numpy(x)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ref = x @ w + bias
    assert np.abs(got - ref).mean() / np.abs(ref).mean() < 0.05


def test_int8_dot_refuses_other_dtypes():
    with pytest.raises(TypeError, match="int8"):
        t8.int8_dot(torch.zeros(4, 8), torch.zeros(8, 8, dtype=torch.int8))
