"""CLIPA's token-reduction tokenizers in the port (tokenize/masking.py)
against the JAX package's (xtagclip_tpu/tokenize/masking.py), on the CPU.

``simple``, ``random`` and ``shuffle`` draw from the global numpy and
stdlib generators in both packages, so under the same seeds the ids are
equal. The syntax mask: the port tags words with nltk only where nltk and
its data are already on disk, and never downloads (the JAX copy calls
``nltk.download`` when the data is missing); otherwise both take the
word-level front-truncation fallback. The JAX copy is only ever run here
with nltk hidden (``sys.modules["nltk"] = None``), so that it takes its
fallback without a download.
"""

import random

import numpy as np
import pytest

from xtagclip_tpu.tokenize import masking as jmasking
from xtagclip_tpu.tokenize.bpe import SimpleTokenizer as JTokenizer
from xtagclip_tpu_torch.factory import get_tokenizer
from xtagclip_tpu_torch.tokenize import masking
from xtagclip_tpu_torch.tokenize.bpe import SimpleTokenizer

LONG = ("a photo of a very large fluffy orange cat sitting on an old wooden "
        "table next to the window in the morning light")
TEXTS = [LONG, "a photo of a cat", "Dummy caption",
         "two dogs and three birds playing with a bright red ball " * 3]


@pytest.fixture(scope="module")
def tokenizers():
    return {n: (SimpleTokenizer(context_length=12, reduction_mask=n),
                JTokenizer(context_length=12, reduction_mask=n))
            for n in ("simple", "random", "shuffle")}


@pytest.mark.parametrize("mode", ["simple", "random", "shuffle"])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_reduction_masks_match_jax_under_the_same_seeds(tokenizers, mode,
                                                        seed):
    port, jax_tok = tokenizers[mode]
    np.random.seed(seed)
    random.seed(seed)
    got = port(TEXTS)
    np.random.seed(seed)
    random.seed(seed)
    want = jax_tok(TEXTS)
    assert got.dtype == np.int32 and got.shape == (len(TEXTS), 12)
    np.testing.assert_array_equal(got, want)
    # a long text keeps 10 of its tokens between SOT and EOT
    assert got[0, 0] == 49406 and got[0, 11] == 49407


def _front_truncated(tok, text, context_length):
    words = text.split()[: context_length - 2]
    ids = [tok.sot_token_id] + tok.encode(" ".join(words)) + [tok.eot_token_id]
    if len(ids) > context_length:
        ids = ids[:context_length]
        ids[-1] = tok.eot_token_id
    return ids + [0] * (context_length - len(ids))


def test_syntax_mask_fallback_matches_jax(monkeypatch):
    """With nltk hidden both packages front-truncate at the word level."""
    monkeypatch.setitem(__import__("sys").modules, "nltk", None)
    port = SimpleTokenizer(context_length=8, reduction_mask="syntax")
    want = jmasking.syntax_mask_tokenize(
        TEXTS, 8, port.sot_token_id, port.eot_token_id, port.encode)
    got = port(TEXTS)
    np.testing.assert_array_equal(got, want)
    for row, text in zip(got, TEXTS):
        assert list(row) == _front_truncated(port, text, 8)


def test_syntax_mask_never_downloads(monkeypatch):
    """Where nltk imports but its data is not on disk, the port takes the
    fallback and never calls nltk.download."""
    nltk = pytest.importorskip("nltk")
    if masking.nltk_tagger() is not None:
        pytest.skip("nltk's data is on disk here: the tagger path runs")

    def refuse(*args, **kwargs):
        raise AssertionError("nltk.download called")

    monkeypatch.setattr(nltk, "download", refuse)
    tok = get_tokenizer("ViT-H-14-CL8-SyntaxMask-GAP")
    assert tok.context_length == 8 and tok.reduction_fn is not None
    got = tok(TEXTS)
    for row, text in zip(got, TEXTS):
        assert list(row) == _front_truncated(tok, text, 8)


def test_syntax_tokenizer_looks_for_the_tagger_once(monkeypatch):
    """The tagger is looked up when the tokenizer is built, not on every
    batch: a failed ``import nltk`` is not cached by Python."""
    calls = []

    def tagger():
        calls.append(1)
        return None

    monkeypatch.setattr(masking, "nltk_tagger", tagger)
    tok = SimpleTokenizer(context_length=8, reduction_mask="syntax")
    for _ in range(3):
        got = tok(TEXTS)
    assert len(calls) == 1
    for row, text in zip(got, TEXTS):
        assert list(row) == _front_truncated(tok, text, 8)


def test_get_reduction_mask_fn_names():
    for name in ("simple", "random", "shuffle", "syntax"):
        assert callable(masking.get_reduction_mask_fn(name))
    with pytest.raises(AssertionError):
        masking.get_reduction_mask_fn("bogus")
    # no reduction: the plain tokenizer
    assert SimpleTokenizer().reduction_fn is None
