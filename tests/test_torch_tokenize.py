"""The PyTorch port's tokenizer and prompt table against the JAX package's.

The port splits words with the standard library's ``re`` instead of the
``regex`` module (tokenize/bpe.py); its ids must equal the JAX
tokenizer's on everything the serving path tokenizes (tag list,
templates, class words) and on random printable ASCII, and its scar
PromptTable must equal the JAX table for all five templates.
"""

import string

import numpy as np
import pytest
import torch

from xtagclip_tpu.tokenize.bpe import SimpleTokenizer as JaxTokenizer
from xtagclip_tpu.tokenize.prompts import PromptTable as JaxPromptTable
from xtagclip_tpu.train import metadata as jax_metadata
from xtagclip_tpu_torch.tokenize.bpe import SimpleTokenizer
from xtagclip_tpu_torch.tokenize.prompts import (
    PROMPT_TEMPLATES,
    TEMPLATE_ORDER,
    PromptTable,
)
from xtagclip_tpu_torch.train import metadata
from xtagclip_tpu_torch.utils.assets import read_tag_list

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tokenizers():
    return JaxTokenizer(), SimpleTokenizer()


def _texts():
    texts = list(read_tag_list())
    texts += list(PROMPT_TEMPLATES.values())
    texts += metadata.SCAR_CLASSNAMES + metadata.PATHMNIST_CLASSNAMES
    texts += metadata.MEDICALMNIST_CLASSNAMES
    texts += metadata.SIMPLE_SCAR_TEMPLATES
    texts += metadata.SIMPLE_MEDICALMNIST_TEMPLATES
    texts += ["it's a photo of 3 keloids, aren't they? 42%_done!",
              "snake_case and CamelCase... 1,000,000 $5.00 (x)"]
    return texts


def test_ids_match_jax_tokenizer(tokenizers):
    jtok, tok = tokenizers
    texts = _texts()
    for t in texts:
        assert tok.encode(t) == jtok.encode(t), t
    np.testing.assert_array_equal(tok(texts), jtok(texts))


def test_ascii_fuzz_matches_jax_tokenizer(tokenizers):
    jtok, tok = tokenizers
    rng = np.random.default_rng(0)
    alphabet = np.array(list(string.printable))
    for _ in range(400):
        s = "".join(rng.choice(alphabet, size=int(rng.integers(1, 40))))
        assert tok.encode(s) == jtok.encode(s), repr(s)


def test_context_truncation_keeps_eot(tokenizers):
    jtok, tok = tokenizers
    long = " ".join(["keloid"] * 100)
    out = tok(long, context_length=16)
    np.testing.assert_array_equal(out, jtok(long, context_length=16))
    assert out.shape == (1, 16) and out[0, -1] == tok.eot_token_id


def test_metadata_matches_jax():
    for name in ("SCAR_CLASSNAMES", "SIMPLE_SCAR_TEMPLATES",
                 "PATHMNIST_CLASSNAMES", "MEDICALMNIST_CLASSNAMES",
                 "SIMPLE_MEDICALMNIST_TEMPLATES"):
        assert getattr(metadata, name) == list(getattr(jax_metadata, name))


def test_scar_prompt_table_matches_jax(tokenizers):
    jtok, tok = tokenizers
    classes = metadata.SCAR_CLASSNAMES
    ours = PromptTable(classes, tokenizer=tok).table
    ref = JaxPromptTable(classes, tokenizer=jtok).table
    assert ours.shape == (len(TEMPLATE_ORDER), 3, 2304, 77)
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)


def test_prompt_table_single_template(tokenizers):
    _, tok = tokenizers
    pt = PromptTable(["Keloid scar"], tokenizer=tok, templates=["sentence_1"])
    assert pt.table.shape == (1, 1, 2304, 77)
