"""The port's HF tokenizer (tokenize/hf.py) against the JAX package's
``HFTokenizer`` on the CPU, over a WordPiece vocabulary written in the test
with BERT's special ids ([PAD] 0, [UNK] 100, [CLS] 101, [SEP] 102, [MASK]
103). Both call ``transformers``; the port resolves the name to a local
directory first and never lets ``transformers`` see a hub name. Nothing is
downloaded: the JAX tokenizer is always given a local directory.

Bar: the ids are equal, int32, for every text (ASCII, accents, punctuation,
CJK, control characters, words past 100 characters and past the vocabulary,
truncation at the BigVision config's context of 32, special tokens in the
text), with and without ``strip_sep_token``, cased and uncased.
"""

import json
import os
import sys

import numpy as np
import pytest
# Imported when the file is collected, which every test worker does before
# it runs any test: transformers then never first loads after a test has
# left a stub ftfy module without a __spec__ in sys.modules (its import
# probes ftfy's spec and fails on such a stub).
import transformers  # noqa: F401

from xtagclip_tpu.tokenize.hf import HFTokenizer as JaxHF
from xtagclip_tpu_torch import factory
from xtagclip_tpu_torch.tokenize import hf
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

SPECIALS = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
WORDS = ["a", "photo", "of", "the", "cat", "dog", "on", "grass", "red",
         "small", "house", "un", "##believ", "##able", "play", "##ing",
         "##s", "run", "cafe", "naive", "resume", "hello", "world", "x",
         "##x", "e", "##e", "new", "york", "it", "##'", "s", "lov", "##e",
         "Cat", "Photo", "Café"]
CHARS = ([chr(c) for c in range(33, 127)]
         + list("éèêëàâäïîôöùûüçñß") + list("中国猫狗日本語") + ["σ", "ς"])


def _vocab_dir(root, lower=True):
    tokens = list(dict.fromkeys(SPECIALS + WORDS + CHARS
                                + ["##" + c for c in "abcdefghijklmnop"]))
    root.mkdir(parents=True, exist_ok=True)
    (root / "vocab.txt").write_text("\n".join(tokens) + "\n",
                                    encoding="utf-8")
    (root / "tokenizer_config.json").write_text(json.dumps(
        {"do_lower_case": lower, "tokenizer_class": "BertTokenizer"}))
    return str(root)


TEXTS = {
    "ascii": ["a photo of the cat", "A Photo Of The Dog On Grass",
              "unbelievable playing runs", "zebra photo", ""],
    "accents": ["Café naïve résumé", "ÉCOLE élève", "Ångström"],
    "punctuation": ["hello, world!!", "it's a (red) cat-dog...",
                    "$%&: [cat] {dog}", "new york's ¿que? «si»"],
    "cjk": ["中国 cat中国dog", "日本語の猫", "猫狗"],
    "control": ["a\x00b\x07c​d cat", "cat\ttab\x0bdog",
                "�photo\x7f"],
    "long_words": ["x" * 101 + " cat", "xxxxx" * 20 + " cat",
                   "a" * 100 + " dog"],
    "truncation": [" ".join(["cat"] * 40), "photo " * 31 + "dog",
                   " ".join(["unbelievable"] * 12)],
    "specials": ["[MASK] a photo [SEP] of", "cat[CLS]dog", "[unused3] x"],
    "greek": ["ΟΔΟΣ", "σος"],
}


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    root = tmp_path_factory.mktemp("bert")
    return {True: _vocab_dir(root / "uncased"),
            False: _vocab_dir(root / "cased", lower=False)}


@pytest.mark.parametrize("kind", sorted(TEXTS))
@pytest.mark.parametrize("strip_sep", [False, True])
@pytest.mark.parametrize("lower", [True, False])
def test_ids_equal_jax(vocab, kind, strip_sep, lower):
    port = hf.HFTokenizer(vocab[lower], context_length=32,
                          strip_sep_token=strip_sep)
    jax = JaxHF(vocab[lower], context_length=32, strip_sep_token=strip_sep)
    got, want = port(TEXTS[kind]), jax(TEXTS[kind])
    assert got.dtype == want.dtype == np.int32
    assert got.shape == (len(TEXTS[kind]), 32)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == 101).all()
    assert (102 in got) != strip_sep or all(not t for t in TEXTS[kind])


def test_context_length_and_single_string(vocab):
    port = hf.HFTokenizer(vocab[True], context_length=77)
    jax = JaxHF(vocab[True], context_length=77)
    np.testing.assert_array_equal(port("a photo of the cat"),
                                  jax("a photo of the cat"))
    np.testing.assert_array_equal(port(["cat dog"], context_length=8),
                                  jax(["cat dog"], context_length=8))
    assert port("cat").shape == (1, 77)


def _hub_cache(root, vocab_src, rev="0123abcd", ref=True):
    repo = root / "models--bert-base-uncased"
    snap = repo / "snapshots" / rev
    snap.mkdir(parents=True)
    for name in ("vocab.txt", "tokenizer_config.json"):
        (snap / name).write_bytes(open(os.path.join(vocab_src, name),
                                       "rb").read())
    if ref:
        (repo / "refs").mkdir()
        (repo / "refs" / "main").write_text(rev)
    return str(snap)


def test_hub_cache_lookup_and_bigvision_tokenizer(vocab, tmp_path,
                                                  monkeypatch):
    """bert-base-uncased found under $HF_HUB_CACHE (refs/main's snapshot),
    as the ViT-H-14-CL32-GAP-BigVision config names it: context 32,
    strip_sep_token; the same ids as JAX's tokenizer on that snapshot."""
    snap = _hub_cache(tmp_path / "hub", vocab[True])
    (tmp_path / "hub" / "models--bert-base-uncased" / "snapshots"
     / "older").mkdir()
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert hf.resolve_tokenizer_dir("bert-base-uncased") == snap
    assert hf.resolve_tokenizer_dir("hf-hub:bert-base-uncased") == snap
    tok = factory.get_tokenizer("ViT-H-14-CL32-GAP-BigVision")
    assert isinstance(tok, hf.HFTokenizer) and tok.context_length == 32
    texts = TEXTS["ascii"] + TEXTS["truncation"]
    got = tok(texts)
    np.testing.assert_array_equal(
        got, JaxHF(snap, context_length=32, strip_sep_token=True)(texts))
    assert got.shape == (len(texts), 32) and 102 not in got


@pytest.mark.parametrize("where", ["hf_home", "home"])
def test_hub_cache_fallbacks(vocab, tmp_path, monkeypatch, where):
    """Without $HF_HUB_CACHE: $HF_HOME/hub, else ~/.cache/huggingface/hub;
    without refs/main the newest snapshot."""
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    if where == "hf_home":
        monkeypatch.setenv("HF_HOME", str(tmp_path / "hfh"))
        hub = tmp_path / "hfh" / "hub"
    else:
        monkeypatch.delenv("HF_HOME", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path / "user"))
        hub = tmp_path / "user" / ".cache" / "huggingface" / "hub"
    snap = _hub_cache(hub, vocab[True], ref=False)
    assert hf.hub_cache_dirs() == [str(hub)]
    assert hf.resolve_tokenizer_dir("bert-base-uncased") == snap


def test_nothing_found_raises_with_the_paths_tried(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError) as err:
        hf.HFTokenizer("bert-base-uncased")
    msg = str(err.value)
    assert "nothing is downloaded" in msg
    assert str(tmp_path / "empty" / "models--bert-base-uncased"
               / "snapshots") in msg
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="not in a hub cache"):
        factory.get_tokenizer("ViT-H-14-CL32-GAP-BigVision")


def test_sentencepiece_without_transformers_names_item_8(tmp_path,
                                                         monkeypatch):
    """Every HF vocabulary (a vocab.txt directory, a sentencepiece one,
    SigLipTokenizer) goes through transformers; without it they raise,
    naming the package."""
    (tmp_path / "spm").mkdir()
    monkeypatch.setitem(sys.modules, "transformers", None)
    for name in (str(tmp_path / "spm"), _vocab_dir(tmp_path / "bert")):
        with pytest.raises(ImportError, match="transformers package"):
            hf.HFTokenizer(name)
    with pytest.raises(ImportError, match="transformers package"):
        hf.SigLipTokenizer(str(tmp_path / "spm"))


def test_transformers_gets_a_local_directory_only(vocab, tmp_path,
                                                  monkeypatch):
    """A hub name reaches transformers as its snapshot directory, with
    local_files_only (transformers asks the hub about a name it is given
    even then)."""
    snap = _hub_cache(tmp_path / "hub", vocab[True])
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    seen = []
    real = transformers.AutoTokenizer.from_pretrained

    def spy(name, **kwargs):
        seen.append((name, kwargs))
        return real(name, **kwargs)

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", spy)
    hf.HFTokenizer("hf-hub:bert-base-uncased", context_length=32)
    hf.HFTokenizer(vocab[False], context_length=32)
    assert seen == [(snap, {"local_files_only": True}),
                    (vocab[False], {"local_files_only": True})]


def test_wordpiece_pieces(tmp_path):
    """Greedy longest match with ## continuations; no match anywhere in a
    word makes the whole word [UNK]; past 100 characters [UNK]; the same
    ids as JAX's tokenizer."""
    root = tmp_path / "pieces"
    root.mkdir()
    tokens = SPECIALS + list(dict.fromkeys(WORDS))
    (root / "vocab.txt").write_text("\n".join(tokens) + "\n")
    (root / "tokenizer_config.json").write_text(json.dumps(
        {"do_lower_case": False, "tokenizer_class": "BertTokenizer"}))
    port = hf.HFTokenizer(str(root), context_length=110)
    texts = ["unbelievable playing zzz", "x" * 101, "x" * 100]
    got = port(texts)
    np.testing.assert_array_equal(
        got, JaxHF(str(root), context_length=110)(texts))
    body = [[tokens[i] for i in row[1:] if i not in (0, 102)] for row in got]
    assert body[0] == ["un", "##believ", "##able", "play", "##ing", "[UNK]"]
    assert body[1] == ["[UNK]"]
    assert body[2] == ["x"] + ["##x"] * 99
    assert list(got[2, :2]) == [101, tokens.index("x")]
