"""The port's BERT trunk (models/bert.py), HF text tower
(models/hf_text.py) and HF BERT converter (convert/hf_bert.py) against the
JAX package, and the trunk against transformers' ``BertModel``, on the
CPU at toy geometry (hidden 64, 2 layers, 4 heads), with padded rows.

Configs are written in the test as local config.json files, as
tests/test_hf_t5_m2m.py writes them; nothing is downloaded.

Bars: fp32 outputs within 1e-3 (BASELINE.md:18), within 1e-4 against
transformers (the bar of tests/test_towers.py:19); configs and converted
trees exactly.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# imported at collection (tests/test_torch_hf_tokenize.py says why)
import transformers  # noqa: F401

from xtagclip_tpu.convert import hf_bert as jhf_bert
from xtagclip_tpu.models import bert as jbert
from xtagclip_tpu.models import hf_text as jhf_text
from xtagclip_tpu_torch.convert import hf_bert
from xtagclip_tpu_torch.convert.from_jax import _flatten, load_jax_params
from xtagclip_tpu_torch.models import bert, hf_text
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=1e-3)
TOY = dict(vocab_size=120, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, max_position_embeddings=40)


def _ids(pad_id, b=3, length=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(pad_id + 2, 120, (b, length)).astype(np.int32)
    ids[0, 9:] = pad_id
    ids[1, 5:] = pad_id
    return ids


def _noisy(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: np.asarray(v) + 0.05 * rng.standard_normal(
        v.shape).astype(np.float32), params)


@pytest.mark.parametrize("roberta", [False, True])
@pytest.mark.parametrize("pooler", [False, True])
def test_bert_matches_jax(roberta, pooler):
    pad = 1 if roberta else 0
    kw = dict(TOY, pad_token_id=pad, roberta_positions=roberta,
              add_pooling_layer=pooler)
    jmodel = jbert.BertModel(**kw)
    ids = _ids(pad)
    params = _noisy(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))[
        "params"], 1)
    seq, pooled = jax.jit(lambda p, i: jmodel.apply({"params": p}, i))(
        params, ids)
    model = bert.BertModel(**kw)
    load_jax_params(model, params)
    with torch.no_grad():
        got_seq, got_pooled = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(seq), **TOL)
    if pooler:
        np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled),
                                   **TOL)
    else:
        assert got_pooled is None and pooled is None


def test_bert_matches_transformers():
    from transformers import BertConfig
    from transformers import BertModel as TorchBert

    cfg = BertConfig(vocab_size=120, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     max_position_embeddings=40, hidden_act="gelu")
    torch.manual_seed(0)
    ref = TorchBert(cfg, add_pooling_layer=True).eval()
    sd = {k: v.numpy() for k, v in ref.state_dict().items()}
    model = bert.BertModel(**TOY, add_pooling_layer=True)
    load_jax_params(model, hf_bert.convert_hf_bert_state_dict(sd))
    ids = _ids(0)
    mask = (ids != 0).astype(np.int64)
    with torch.no_grad():
        want = ref(input_ids=torch.from_numpy(ids).long(),
                   attention_mask=torch.from_numpy(mask))
        got_seq, got_pooled = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got_seq.numpy(),
                               want.last_hidden_state.numpy(), atol=1e-4)
    np.testing.assert_allclose(got_pooled.numpy(),
                               want.pooler_output.numpy(), atol=1e-4)


def test_hf_bert_converter_matches_jax():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    sd = chip_smoke.biomedclip_state_dict(
        np.random.default_rng(6), width=32, layers=1, patch=8, image_size=16,
        embed_dim=48, vocab=120, hidden=64, text_layers=2, intermediate=128,
        max_positions=40)
    sd["text.transformer.embeddings.position_ids"] = np.arange(
        40, dtype=np.int64)[None]
    got = dict(_flatten(hf_bert.convert_hf_bert_state_dict(
        sd, prefix="text.transformer.")))
    want = dict(_flatten(jhf_bert.convert_hf_bert_state_dict(
        sd, prefix="text.transformer.")))
    assert set(got) == set(want) and "pooler.kernel" in got
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _config_dir(root, model_type, **extra):
    root.mkdir(parents=True, exist_ok=True)
    c = dict(model_type=model_type, vocab_size=120, hidden_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, max_position_embeddings=40, **extra)
    (root / "config.json").write_text(json.dumps(c))
    return str(root)


@pytest.mark.parametrize("pooler", hf_text.POOLERS)
@pytest.mark.parametrize("proj", ["linear", "mlp"])
@pytest.mark.parametrize("family", ["bert", "roberta"])
def test_hf_text_encoder_matches_jax(tmp_path, pooler, proj, family):
    name = _config_dir(tmp_path / f"toy-{family}", family)
    jmodel = jhf_text.HFTextEncoder(model_name=name, output_dim=48,
                                    proj_type=proj, pooler_type=pooler)
    pad = 1 if family == "roberta" else 0
    ids = _ids(pad, seed=2)
    params = _noisy(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))[
        "params"], 3)
    pooled, tokens = jax.jit(lambda p, i: jmodel.apply({"params": p}, i))(
        params, ids)
    model = hf_text.HFTextEncoder(name, 48, proj_type=proj,
                                  pooler_type=pooler)
    assert model.pad_token_id == pad
    load_jax_params(model, params)
    with torch.no_grad():
        got_pooled, got_tokens = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled), **TOL)
    np.testing.assert_allclose(got_tokens.numpy(), np.asarray(tokens), **TOL)


@pytest.mark.parametrize("name", [
    "hf-hub:microsoft/BiomedNLP-BiomedBERT-base-uncased-abstract",
    "roberta-base", "roberta-large", "xlm-roberta-large",
    "bert-base-uncased"])
def test_resolve_hf_config_matches_jax(name):
    assert hf_text.resolve_hf_config(name) == jhf_text.resolve_hf_config(name)


def test_resolve_hf_config_reads_a_local_config(tmp_path):
    path = _config_dir(tmp_path / "pubmed-bert", "bert", pad_token_id=3)
    assert hf_text.resolve_hf_config(path) == \
        jhf_text.resolve_hf_config(path)
    assert hf_text.resolve_hf_config(path)["pad_token_id"] == 3


@pytest.mark.parametrize("name", ["google/mt5-base", "t5-small",
                                  "facebook/nllb-200-distilled-600M",
                                  "facebook/m2m100_418M"])
def test_t5_and_m2m100_raise_and_name_item_8(name):
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        hf_text.HFTextEncoder(name, 512)


@pytest.mark.parametrize("model_type", ["t5", "mt5", "m2m_100"])
def test_local_t5_and_m2m100_configs_raise(tmp_path, model_type):
    path = _config_dir(tmp_path / "toy", model_type)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        hf_text.resolve_hf_config(path)


def test_dropout_is_seeded_and_off_without_a_generator():
    model = bert.BertModel(**TOY)
    from xtagclip_tpu_torch.factory import init_params

    init_params(model, torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_ids(0)).long()
    with torch.no_grad():
        plain = [model(ids)[0] for _ in range(2)]
        seeded = [model(ids, generator=torch.Generator().manual_seed(s))[0]
                  for s in (4, 4, 5)]
    assert torch.equal(plain[0], plain[1])
    assert torch.equal(seeded[0], seeded[1])
    assert not torch.equal(seeded[0], seeded[2])
    assert not torch.equal(seeded[0], plain[0])
