"""The port's T5 (mT5) and M2M100 (NLLB) text trunks (models/t5.py,
models/m2m100.py), their converters (convert/hf_t5.py,
convert/hf_m2m100.py) and the HF text tower's dispatch to them
(models/hf_text.py) against the JAX package and ``transformers`` on the
CPU.

Toy trunks with padded ids: the port against JAX on JAX's params carried
by convert/from_jax.py (fp32 within 1e-3, the module bar), against
``transformers``' ``T5EncoderModel`` and M2M100 encoder built from a
config in-process (no download) through the port's converters (2e-4,
tests/test_hf_t5_m2m.py's bar), the bucket function against HF's exactly,
the converted trees against JAX's exactly, and a ``.pt`` of each through
convert/loader.py.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtagclip_tpu.convert.hf_m2m100 import (
    convert_hf_m2m100_state_dict as j_m2m_convert,
)
from xtagclip_tpu.convert.hf_t5 import convert_hf_t5_state_dict as j_t5_convert
from xtagclip_tpu.models import hf_text as jhf_text
from xtagclip_tpu.models import m2m100 as jm2m
from xtagclip_tpu.models import t5 as jt5
from xtagclip_tpu_torch.convert.from_jax import load_jax_params
from xtagclip_tpu_torch.convert.hf_m2m100 import convert_hf_m2m100_state_dict
from xtagclip_tpu_torch.convert.hf_t5 import convert_hf_t5_state_dict
from xtagclip_tpu_torch.convert.loader import load_checkpoint_into
from xtagclip_tpu_torch.models import hf_text, m2m100, t5

sys.path.insert(0, os.path.dirname(__file__))
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401
from torch_zoo import randomize, tree_equal  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)
T5_KW = dict(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=3,
             num_heads=4)
M2M_KW = dict(vocab_size=256, d_model=64, num_layers=2, num_heads=4,
              ffn_dim=128, max_position_embeddings=64, pad_token_id=1)


def _ids(pad, lo, length=20, valid=15, seed=0):
    ids = np.random.default_rng(seed).integers(lo, 256, size=(2, length))
    ids[0, valid:] = pad
    ids[1, valid - 4:] = pad
    return ids.astype(np.int32), (ids != pad).astype(np.int32)


def test_t5_stack_matches_jax_with_padding():
    ids, mask = _ids(0, 2)
    jstack = jt5.T5EncoderStack(dropout=0.0, **T5_KW)
    params = randomize(jstack.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                   attention_mask=jnp.asarray(mask))
                       ["params"], 1)
    want = jax.jit(lambda p, i, m: jstack.apply({"params": p}, i,
                                                attention_mask=m))(
        params, ids, mask)
    stack = t5.T5EncoderStack(dropout=0.0, **T5_KW)
    load_jax_params(stack, params)
    with torch.no_grad():
        got = stack(torch.from_numpy(ids).long(),
                    torch.from_numpy(mask).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_m2m100_encoder_matches_jax_with_padding():
    ids, mask = _ids(1, 4, length=18, valid=14)
    jenc = jm2m.M2M100Encoder(dropout=0.0, **M2M_KW)
    params = randomize(jenc.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                 attention_mask=jnp.asarray(mask))
                       ["params"], 1)
    want = jax.jit(lambda p, i, m: jenc.apply({"params": p}, i,
                                              attention_mask=m))(
        params, ids, mask)
    enc = m2m100.M2M100Encoder(dropout=0.0, **M2M_KW)
    load_jax_params(enc, params)
    with torch.no_grad():
        got = enc(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        m2m100.sinusoidal_positions(66, 64, 1),
        jm2m.sinusoidal_positions(66, 64, 1))


def _hf_t5():
    from transformers import T5Config, T5EncoderModel

    cfg = T5Config(vocab_size=256, d_model=64, d_kv=16, d_ff=128,
                   num_layers=3, num_heads=4,
                   relative_attention_num_buckets=32,
                   relative_attention_max_distance=128, dropout_rate=0.0,
                   feed_forward_proj="gated-gelu")
    torch.manual_seed(0)
    return T5EncoderModel(cfg).eval()


def _hf_m2m():
    from transformers import M2M100Config, M2M100Model

    cfg = M2M100Config(vocab_size=256, d_model=64, encoder_layers=2,
                       decoder_layers=1, encoder_attention_heads=4,
                       decoder_attention_heads=4, encoder_ffn_dim=128,
                       decoder_ffn_dim=128, max_position_embeddings=64,
                       dropout=0.0, attention_dropout=0.0,
                       scale_embedding=True, pad_token_id=1)
    torch.manual_seed(0)
    return M2M100Model(cfg).eval()


def test_t5_encoder_parity_vs_transformers():
    tm = _hf_t5()
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = convert_hf_t5_state_dict(sd)
    tree_equal(params, j_t5_convert(sd))
    ids, mask = _ids(0, 2)
    stack = t5.T5EncoderStack(dropout=0.0, **T5_KW)
    load_jax_params(stack, params)
    with torch.no_grad():
        want = tm(input_ids=torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask).long()
                  ).last_hidden_state.numpy()
        got = stack(torch.from_numpy(ids).long(),
                    torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_t5_relative_bucket_matches_hf():
    from transformers.models.t5.modeling_t5 import T5Attention

    rel = torch.arange(-200, 201).reshape(1, -1)
    want = T5Attention._relative_position_bucket(
        rel, bidirectional=True, num_buckets=32, max_distance=128)
    assert torch.equal(t5.relative_position_bucket(rel, 32, 128), want)
    np.testing.assert_array_equal(
        np.asarray(jt5.relative_position_bucket(jnp.asarray(rel.numpy()),
                                                32, 128)), want.numpy())


def test_m2m100_encoder_parity_vs_transformers():
    tm = _hf_m2m()
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = convert_hf_m2m100_state_dict(sd)
    tree_equal(params, j_m2m_convert(sd))
    ids, mask = _ids(1, 4, length=18, valid=14)
    enc = m2m100.M2M100Encoder(dropout=0.0, **M2M_KW)
    load_jax_params(enc, params)
    with torch.no_grad():
        want = tm.get_encoder()(
            input_ids=torch.from_numpy(ids).long(),
            attention_mask=torch.from_numpy(mask).long()
        ).last_hidden_state.numpy()
        got = enc(torch.from_numpy(ids).long(),
                  torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_dropout_is_seeded_and_off_without_a_generator():
    for trunk, ids in ((t5.T5EncoderStack(**T5_KW), _ids(0, 2)[0]),
                       (m2m100.M2M100Encoder(**M2M_KW), _ids(1, 4)[0])):
        from xtagclip_tpu_torch.factory import init_params

        init_params(trunk, torch.Generator().manual_seed(0))
        ids = torch.from_numpy(ids).long()
        with torch.no_grad():
            plain = [trunk(ids) for _ in range(2)]
            seeded = [trunk(ids, generator=torch.Generator().manual_seed(s))
                      for s in (4, 4, 5)]
        assert torch.equal(plain[0], plain[1])
        assert torch.equal(seeded[0], seeded[1])
        assert not torch.equal(seeded[0], seeded[2])
        assert not torch.equal(seeded[0], plain[0])


# -- the HF tower's dispatch ---------------------------------------------

def test_unknown_hf_arch_raises():
    """An unknown family raises as JAX's does, never a silent BERT."""
    for resolve in (hf_text.resolve_hf_config, jhf_text.resolve_hf_config):
        with pytest.raises(NotImplementedError, match="unknown architecture"):
            resolve("totally/unknown-model-v9")


TOY_CONFIGS = {
    "mt5": dict(model_type="mt5", vocab_size=128, d_model=32, num_layers=1,
                num_heads=2, d_kv=16, d_ff=64, pad_token_id=0),
    "m2m_100": dict(model_type="m2m_100", vocab_size=128, d_model=32,
                    encoder_layers=1, encoder_attention_heads=2,
                    encoder_ffn_dim=64, max_position_embeddings=32,
                    pad_token_id=1),
}


@pytest.mark.parametrize("family", sorted(TOY_CONFIGS))
@pytest.mark.parametrize("pooler,proj", [("mean_pooler", "linear"),
                                         ("cls_pooler", "mlp")])
def test_hf_text_encoder_matches_jax(family, pooler, proj, tmp_path):
    """HFTextEncoder on a local config.json of each family, both poolers
    that the zoo's configs name (mt5 mean, NLLB cls) and both
    projections; dropout off on both sides."""
    d = tmp_path / family
    d.mkdir()
    (d / "config.json").write_text(json.dumps(TOY_CONFIGS[family]))
    pad = TOY_CONFIGS[family]["pad_token_id"]
    ids = _ids(pad, 2, length=8, valid=6)[0] % 128
    ids[:, 0] = 5
    jenc = jhf_text.HFTextEncoder(model_name=str(d), output_dim=16,
                                  proj_type=proj, pooler_type=pooler)
    params = randomize(jenc.init(jax.random.PRNGKey(0), jnp.asarray(ids))
                       ["params"], 3)
    want = jax.jit(lambda p, i: jenc.apply({"params": p}, i))(params, ids)
    enc = hf_text.HFTextEncoder(str(d), 16, proj_type=proj,
                                pooler_type=pooler)
    load_jax_params(enc, params)
    with torch.no_grad():
        got = enc(torch.from_numpy(ids).long())
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _write_pt(path, sd, prefix):
    torch.save({prefix + k: torch.from_numpy(np.asarray(v)) for k, v in
                sd.items()}, path)


@pytest.mark.parametrize("family", ["t5", "m2m100"])
def test_hf_encoder_ptloads_through_the_loader(family, tmp_path):
    """open_clip keeps the HF encoder alone under ``text.transformer.``
    (no ``encoder.``): its keys load every trunk parameter exactly."""
    tm = _hf_t5() if family == "t5" else _hf_m2m()
    full = {k: v.numpy() for k, v in tm.state_dict().items()}
    enc_sd = {k[len("encoder."):]: v for k, v in full.items()
              if k.startswith("encoder.")}
    path = tmp_path / f"{family}.pt"
    _write_pt(path, enc_sd, "text.transformer.")
    holder = torch.nn.Module()
    holder.text = torch.nn.Module()
    holder.text.transformer = (
        t5.T5EncoderStack(dropout=0.0, **T5_KW) if family == "t5"
        else m2m100.M2M100Encoder(dropout=0.0, **M2M_KW))
    load_checkpoint_into(holder, str(path))
    convert = (convert_hf_t5_state_dict if family == "t5"
               else convert_hf_m2m100_state_dict)
    want = torch.nn.Module()
    want.text = torch.nn.Module()
    want.text.transformer = (
        t5.T5EncoderStack(dropout=0.0, **T5_KW) if family == "t5"
        else m2m100.M2M100Encoder(dropout=0.0, **M2M_KW))
    load_jax_params(want.text.transformer, convert(full))
    theirs = dict(want.named_parameters())
    for n, p in holder.named_parameters():
        assert torch.equal(p, theirs[n]), n
