"""CLIPA's token-reduction tokenizers (a copy of
xtagclip_tpu/tokenize/masking.py:18-124; the reference's tokenizer.py
:280-400): ``simple`` keeps a random contiguous block of the BPE tokens,
``random`` a random subset in order, ``shuffle`` a random subset in random
order, ``syntax`` the words ranked nouns > adjectives > verbs > the rest by
their POS tags. Each returns int32 numpy ids [n_texts, context_length].

The random strategies draw from the same global generators as the JAX
package (numpy's ``np.random.permutation``, the stdlib's
``random.randint``), so the same seeds give the same ids.

The syntax mask tags words with nltk only where nltk imports AND its data
(punkt, the perceptron tagger) is already on disk: it never calls
``nltk.download``, which the JAX copy does (:77-80), since no network is
assumed. Otherwise it takes the JAX copy's own fallback: the text's
whitespace words, front-truncated to context_length - 2 (ROADMAP Queue 3).
``get_reduction_mask_fn("syntax")`` looks for the tagger once, so a
tokenizer does not retry the import on every batch.
"""

from __future__ import annotations

import random as _random
from functools import partial
from typing import Callable

import numpy as np


def random_mask_tokenize(texts, context_length: int, sot_token_id: int,
                         eot_token_id: int, encode_fn: Callable,
                         shuffle: bool = False) -> np.ndarray:
    if isinstance(texts, str):
        texts = [texts]
    result = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        tokens = np.asarray(encode_fn(text), np.int32)
        num = len(tokens)
        if num > context_length - 2:
            keep = context_length - 2
            idx = np.random.permutation(num)[:keep]
            if not shuffle:
                idx = np.sort(idx)
            tokens = tokens[idx]
            num = keep
        result[i, 0] = sot_token_id
        result[i, 1: num + 1] = tokens
        result[i, num + 1] = eot_token_id
    return result


def simple_mask_tokenize(texts, context_length: int, sot_token_id: int,
                         eot_token_id: int, encode_fn: Callable) -> np.ndarray:
    if isinstance(texts, str):
        texts = [texts]
    result = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        tokens = list(encode_fn(text))
        num = len(tokens)
        if num > context_length - 2:
            keep = context_length - 2
            start = _random.randint(0, num - keep)
            tokens = tokens[start: start + keep]
        row = [sot_token_id] + tokens + [eot_token_id]
        result[i, : len(row)] = row
    return result


def _get_order(tag: str) -> int:
    if tag.startswith("NN"):
        return 1
    if tag.startswith("JJ"):
        return 2
    if tag.startswith("VB"):
        return 3
    return 4


def nltk_tagger():
    """nltk, if it imports and its tokenizer and tagger data are on disk;
    else None (nothing is downloaded)."""
    try:
        import nltk
    except ImportError:
        return None
    for res in ("tokenizers/punkt", "taggers/averaged_perceptron_tagger"):
        try:
            nltk.data.find(res)
        except LookupError:
            return None
    return nltk


def syntax_mask_tokenize(texts, context_length: int, sot_token_id: int,
                         eot_token_id: int, encode_fn: Callable,
                         tagger) -> np.ndarray:
    """``tagger`` is nltk_tagger()'s result (None: the fallback)."""
    if isinstance(texts, str):
        texts = [texts]
    nltk = tagger
    new_texts = []
    for text in texts:
        pos = None
        if nltk is not None:
            try:
                words = nltk.tokenize.word_tokenize(text)
                pos = nltk.pos_tag(words)
            except LookupError:
                nltk = None
        if pos is None:
            words = text.split()
        if pos is not None:
            order = [_get_order(t) for _, t in pos]
            keep_ids = sorted(np.argsort(np.asarray(order), kind="stable")
                              [: context_length - 2])
            words = [words[j] for j in keep_ids]
        else:  # fallback: plain front-truncation at the word level
            words = words[: context_length - 2]
        new_texts.append(" ".join(str(w) for w in words))

    result = np.zeros((len(new_texts), context_length), np.int32)
    for i, text in enumerate(new_texts):
        tokens = [sot_token_id] + list(encode_fn(text)) + [eot_token_id]
        if len(tokens) > context_length:
            tokens = tokens[:context_length]
            tokens[-1] = eot_token_id
        result[i, : len(tokens)] = tokens
    return result


def get_reduction_mask_fn(type: str):
    assert type in ("simple", "random", "shuffle", "syntax")
    if type == "simple":
        return simple_mask_tokenize
    if type == "random":
        return random_mask_tokenize
    if type == "shuffle":
        return partial(random_mask_tokenize, shuffle=True)
    return partial(syntax_mask_tokenize, tagger=nltk_tagger())
