r"""CLIP byte-pair-encoding tokenizer (copy of xtagclip_tpu/tokenize/bpe.py).

Behavioral contract mirrors the reference SimpleTokenizer
(open_clip src/open_clip/tokenizer.py:133-265): same vocab construction
from the 16e6 merges file (49,408 entries incl. <start_of_text>/<end_of_text>),
same cleaning (`lower`/`whitespace`/`canonicalize`), the same word splits, same
truncate-with-EOT padding-to-context-length semantics. Output is int32 numpy,
ready for torch.from_numpy.

One change against the JAX package's copy: the word-split pattern uses the
standard library's ``re`` instead of the third-party ``regex`` module,
which the card's machine may lack. ``[\p{L}]+`` becomes ``[^\W\d_]+``,
``[\p{N}]`` becomes ``\d`` and ``[^\s\p{L}\p{N}]+`` becomes
``(?:[^\s\w]|_)+``. The two split ASCII text identically
(tests/test_torch_tokenize.py); they can differ on rare non-ASCII numerals
such as superscripts, which ``\p{N}`` counts as numbers and ``\w`` as
word characters. ``reduction_mask`` selects one of CLIPA's token-reduction
tokenizers (tokenize/masking.py).
"""

from __future__ import annotations

import gzip
import html
import re
import string
from functools import lru_cache
from typing import List, Optional, Union

import numpy as np

from xtagclip_tpu_torch.tokenize.masking import get_reduction_mask_fn

from xtagclip_tpu_torch.utils.assets import asset_path

DEFAULT_CONTEXT_LENGTH = 77


@lru_cache()
def default_bpe() -> str:
    return str(asset_path("bpe_simple_vocab_16e6.txt.gz"))


@lru_cache()
def bytes_to_unicode():
    """Reversible mapping byte -> printable unicode char used by GPT-2 style BPE."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _pairs_of(word):
    return set(zip(word[:-1], word[1:]))


@lru_cache(maxsize=1)
def _fix_text():
    """ftfy.fix_text where ftfy is installed, else None; looked up once
    (a failed import searches sys.path again on every call)."""
    try:
        import ftfy
    except ImportError:
        return None
    return ftfy.fix_text


def basic_clean(text: str) -> str:
    # The reference routes through ftfy.fix_text; ftfy is an optional dependency
    # here (it only affects mojibake text, identity for clean input).
    fix = _fix_text()
    if fix is not None:
        text = fix(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return " ".join(text.split()).strip()


def canonicalize_text(text: str, *, keep_punctuation_exact_string=None) -> str:
    trans_punctuation = str.maketrans("", "", string.punctuation)
    text = text.replace("_", " ")
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(trans_punctuation)
            for part in text.split(keep_punctuation_exact_string)
        )
    else:
        text = text.translate(trans_punctuation)
    text = text.lower()
    return " ".join(text.split()).strip()


def get_clean_fn(clean: str):
    if clean == "canonicalize":
        return lambda x: canonicalize_text(basic_clean(x))
    if clean == "lower":
        return lambda x: whitespace_clean(basic_clean(x)).lower()
    if clean == "whitespace":
        return lambda x: whitespace_clean(basic_clean(x))
    raise ValueError(f"Invalid clean function ({clean}).")


class SimpleTokenizer:
    """OpenAI CLIP BPE tokenizer. Vocab size 49,408, context length 77."""

    def __init__(
        self,
        bpe_path: Optional[str] = None,
        additional_special_tokens: Optional[List[str]] = None,
        context_length: Optional[int] = DEFAULT_CONTEXT_LENGTH,
        clean: str = "lower",
        reduction_mask: str = "",
    ):
        bpe_path = bpe_path or default_bpe()
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        special_tokens = ["<start_of_text>", "<end_of_text>"]
        if additional_special_tokens:
            special_tokens += additional_special_tokens
        vocab.extend(special_tokens)
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {t: t for t in special_tokens}
        special = "|".join(special_tokens)
        self.pat = re.compile(
            special + r"""|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
            re.IGNORECASE,
        )
        self.vocab_size = len(self.encoder)
        self.all_special_ids = [self.encoder[t] for t in special_tokens]
        self.sot_token_id = self.all_special_ids[0]
        self.eot_token_id = self.all_special_ids[1]
        self.context_length = context_length
        self.clean_fn = get_clean_fn(clean)
        self.reduction_fn = (get_reduction_mask_fn(reduction_mask)
                             if reduction_mask else None)

    def bpe(self, token: str) -> str:
        cached = self.cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs_of(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs_of(word)
        merged = " ".join(word)
        self.cache[token] = merged
        return merged

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = self.clean_fn(text)
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, tokens) -> str:
        """Ids -> text (JAX bpe.py:186-192): byte-level BPE undone, invalid
        UTF-8 replaced, each ``</w>`` a space; special tokens come back as
        their names."""
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (bytearray(self.byte_decoder[c] for c in text)
                .decode("utf-8", errors="replace").replace("</w>", " "))

    def __call__(
        self,
        texts: Union[str, List[str]],
        context_length: Optional[int] = None,
    ) -> np.ndarray:
        """Tokenize into an int32 array of shape [n_texts, context_length]."""
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        assert context_length, "Please set a valid context length"

        if self.reduction_fn is not None:
            return self.reduction_fn(
                texts, context_length=context_length,
                sot_token_id=self.sot_token_id,
                eot_token_id=self.eot_token_id, encode_fn=self.encode)

        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token_id] + self.encode(text) + [self.eot_token_id]
            if len(tokens) > context_length:
                tokens = tokens[:context_length]
                tokens[-1] = self.eot_token_id
            result[i, : len(tokens)] = tokens
        return result


_tokenizer: Optional[SimpleTokenizer] = None


def _global_tokenizer() -> SimpleTokenizer:
    global _tokenizer
    if _tokenizer is None:
        _tokenizer = SimpleTokenizer()
    return _tokenizer


def tokenize(texts, context_length: int = DEFAULT_CONTEXT_LENGTH
             ) -> np.ndarray:
    """int32 [N, context_length] ids with the default vocabulary (JAX
    bpe.py:234)."""
    return _global_tokenizer()(texts, context_length=context_length)


def decode(output_ids) -> str:
    """Ids -> text with the default vocabulary (JAX bpe.py:238)."""
    return _global_tokenizer().decode(np.asarray(output_ids))
