"""Pseudo-prompt pre-tokenization (port of xtagclip_tpu/tokenize/prompts.py).

The reference renders predicted tags into one of 5 English templates and
re-tokenizes ON HOST inside forward() (reference model.py:513-548). The prompt
space is finite — one tag per category (sizes 3,4,3,4,4,4 -> 2304 combos) x
class word x template — so we pre-tokenize the whole space into an int32 table
[n_templates, n_classes, 2304, context_length] and forward() does a gather.

Tokenization is by *fragment splicing*: CLIP BPE segments on a regex whose
tokens never span a space or letter/punct boundary, so a sentence's ids equal
the concatenation of its fragments' ids. Building the table costs ~40 encode
calls instead of 34,560 full tokenizations. A tokenizer without
``encode``/``sot_token_id`` (tokenize/hf.py's ``HFTokenizer``, whose subword
merges may span fragment boundaries) builds the table by rendering every
prompt and batch-tokenizing it at its own context length, as JAX's
``_build_full`` does. Held equal to the JAX package's table in
tests/test_torch_tokenize.py and tests/test_torch_biomedclip.py.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import numpy as np

from xtagclip_tpu_torch.models.clip import (
    TAG_CATEGORY_OFFSETS,
    TAG_CATEGORY_SIZES,
)
from xtagclip_tpu_torch.tokenize.bpe import SimpleTokenizer
from xtagclip_tpu_torch.utils.assets import read_tag_list

# Template text, exactly as rendered by the reference (model.py:530-541).
# {c} = class word, {t0}..{t5} = the six per-category tags.
PROMPT_TEMPLATES = {
    "sentence_1": "A {c} with a {t0}, exhibiting a {t1} and {t2}. It has a {t3}, with {t4} and {t5}.",
    "sentence_2": "This is an image of {c} with a {t0}, exhibiting a {t1} and {t2}. It has a {t3}, with {t4} and {t5}.",
    "sentence_3": "{c} with a {t0}, exhibiting a {t1} and {t2}. It has a {t3}, with {t4} and {t5} presented in image",
    "sentence_4": "a photo of {c} with a {t0}, exhibiting a {t1} and {t2}. It has a {t3}, with {t4} and {t5}.",
    "itemization": "A {c}, Width: {t0}, Color: {t1}, Pigmentation: {t2}, Surface: {t3}, Irregular Color: {t4}, Irregular Height: {t5}.",
}
TEMPLATE_ORDER = ["sentence_1", "sentence_2", "sentence_3", "sentence_4", "itemization"]


def render_prompt(template: str, class_word: str, tags: Sequence[str]) -> str:
    return PROMPT_TEMPLATES[template].format(
        c=class_word, t0=tags[0], t1=tags[1], t2=tags[2], t3=tags[3],
        t4=tags[4], t5=tags[5])


def _split_template(template_text: str) -> List[str]:
    """Split template into literal fragments around the {c}/{tN} slots.
    Returns [lit0, slot0, lit1, slot1, ...] where slots are '{c}' etc."""
    import re

    parts = re.split(r"(\{(?:c|t\d)\})", template_text)
    return [p for p in parts if p != ""]


class PromptTable:
    """Pre-tokenized pseudo-prompt lookup table."""

    def __init__(
        self,
        class_words: Sequence[str],
        tokenizer: Optional[SimpleTokenizer] = None,
        templates: Sequence[str] = tuple(TEMPLATE_ORDER),
        tag_list: Optional[Sequence[str]] = None,
    ):
        self.tokenizer = tokenizer or SimpleTokenizer()
        self.class_words = list(class_words)
        self.templates = list(templates)
        self.tag_list = list(tag_list) if tag_list is not None else read_tag_list()
        self.context_length = self.tokenizer.context_length
        self.table = self._build()  # [T, C, K, ctx] int32

    def _build(self) -> np.ndarray:
        tok = self.tokenizer
        if not (hasattr(tok, "encode") and hasattr(tok, "sot_token_id")):
            return self._build_full()
        ctx = self.context_length
        sizes = TAG_CATEGORY_SIZES
        offsets = TAG_CATEGORY_OFFSETS
        n_combos = int(np.prod(sizes))

        # ids for every tag phrase and class word, encoded once
        tag_ids = [tok.encode(t) for t in self.tag_list]
        class_ids = [tok.encode(c) for c in self.class_words]

        out = np.zeros(
            (len(self.templates), len(self.class_words), n_combos, ctx),
            dtype=np.int32,
        )
        for ti, tname in enumerate(self.templates):
            frags = _split_template(PROMPT_TEMPLATES[tname])
            # encode literals once per template
            lit_ids = {
                i: tok.encode(f)
                for i, f in enumerate(frags)
                if not (f.startswith("{") and f.endswith("}"))
            }
            for ci in range(len(self.class_words)):
                for combo, choice in enumerate(
                    itertools.product(*[range(s) for s in sizes])
                ):
                    ids: List[int] = [tok.sot_token_id]
                    for i, f in enumerate(frags):
                        if i in lit_ids:
                            ids.extend(lit_ids[i])
                        elif f == "{c}":
                            ids.extend(class_ids[ci])
                        else:
                            cat = int(f[2])  # '{t3}' -> 3
                            ids.extend(tag_ids[offsets[cat] + choice[cat]])
                    ids.append(tok.eot_token_id)
                    if len(ids) > ctx:
                        ids = ids[:ctx]
                        ids[-1] = tok.eot_token_id
                    out[ti, ci, combo, : len(ids)] = ids
        return out

    def _build_full(self) -> np.ndarray:
        """Render and batch-tokenize every (template, class, combo) prompt
        with the tokenizer's own ``__call__`` (prompts.py:126-150)."""
        sizes = TAG_CATEGORY_SIZES
        combos = list(itertools.product(*[range(s) for s in sizes]))
        out = np.zeros((len(self.templates), len(self.class_words),
                        len(combos), self.context_length), dtype=np.int32)
        for ti, tname in enumerate(self.templates):
            for ci, cw in enumerate(self.class_words):
                prompts = [
                    render_prompt(tname, cw, [
                        self.tag_list[TAG_CATEGORY_OFFSETS[cat] + choice[cat]]
                        for cat in range(len(sizes))])
                    for choice in combos]
                out[ti, ci] = np.asarray(self.tokenizer(prompts), np.int32)
        return out

    def template_index(self, prompt_template_setting: str, rng=None) -> int:
        """The table row of ``--prompt-template-setting`` (JAX
        prompts.py:152-158): a template's row, or for ``"total"`` one drawn
        uniformly from ``rng``, a ``numpy.random.Generator`` (a fresh
        unseeded one when None, as JAX's; the reference draws one per step,
        model.py:523-527)."""
        if prompt_template_setting == "total":
            rng = rng or np.random.default_rng()
            return int(rng.integers(len(self.templates)))
        return self.templates.index(prompt_template_setting)


def tag_indices_to_words(global_idx, tag_list: Optional[Sequence[str]] = None):
    """[B, 6] global tag indices -> reference-format 'tag,tag,...' strings."""
    tags = list(tag_list) if tag_list is not None else read_tag_list()
    return [",".join(tags[i] for i in row) for row in np.asarray(global_idx)]
