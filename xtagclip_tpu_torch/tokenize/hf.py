"""HuggingFace-vocabulary tokenizers (port of xtagclip_tpu/tokenize/hf.py;
reference tokenizer.py:403-521): ``HFTokenizer`` and ``SigLipTokenizer``,
int32 ids of ``context_length`` with the BPE tokenizer's cleaning options.

Both call ``transformers`` (``AutoTokenizer``, ``T5TokenizerFast``) as the
JAX package does, with the same padding, truncation and
``strip_sep_token`` (the SEP id becomes 0); where it is not installed they
raise. They load only local files: a name is first resolved to a local
directory, and ``transformers`` is given that directory with
``local_files_only``. A directory is used as it is; a hub name
(``bert-base-uncased``, ``hf-hub:org/name``) is looked up under
``models--<org>--<name>/snapshots/<revision>/`` of ``$HF_HUB_CACHE``, else
``$HF_HOME/hub``, else ``~/.cache/huggingface/hub``, read when the tokenizer
is built. When nothing is found it raises and names the paths it tried.
(``transformers`` given a hub name asks the hub for the model's tags even
with ``local_files_only``, so it is never given one.)
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Union

import numpy as np

from xtagclip_tpu_torch.tokenize.bpe import get_clean_fn

DEFAULT_CONTEXT_LENGTH = 77


def hub_cache_dirs() -> List[str]:
    """The hub caches searched for a name, in order (module doc)."""
    if os.environ.get("HF_HUB_CACHE"):
        return [os.environ["HF_HUB_CACHE"]]
    if os.environ.get("HF_HOME"):
        return [os.path.join(os.environ["HF_HOME"], "hub")]
    return [os.path.join(os.path.expanduser("~"), ".cache", "huggingface",
                         "hub")]


def resolve_tokenizer_dir(name: str) -> str:
    """A local directory for tokenizer ``name``: the name itself where it
    is a directory, else its snapshot in a hub cache (the revision
    ``refs/main`` names, else the newest). Never downloads; raises with
    the paths tried."""
    name = name.replace("hf-hub:", "")
    if os.path.isdir(name):
        return name
    tried = []
    for cache in hub_cache_dirs():
        repo = os.path.join(cache, "models--" + name.replace("/", "--"))
        snaps = os.path.join(repo, "snapshots")
        tried.append(snaps)
        ref = os.path.join(repo, "refs", "main")
        if os.path.isfile(ref):
            with open(ref) as f:
                cand = os.path.join(snaps, f.read().strip())
            if os.path.isdir(cand):
                return cand
        if os.path.isdir(snaps):
            cands = [os.path.join(snaps, d) for d in os.listdir(snaps)]
            cands = [c for c in cands if os.path.isdir(c)]
            if cands:
                return max(cands, key=os.path.getmtime)
    raise FileNotFoundError(
        f"tokenizer {name!r}: not a local directory and not in a hub cache "
        f"(tried {name!r}, {', '.join(tried)}); nothing is downloaded: "
        "put the tokenizer's files in a directory and pass its path, or "
        "set HF_HUB_CACHE")


def _transformers(what: str):
    try:
        import transformers
    except ImportError as e:
        raise ImportError(
            f"{what} needs the transformers package, which is not "
            "installed") from e
    return transformers


class HFTokenizer:
    """A HuggingFace tokenizer's ids as int32 [N, context_length]:
    ``transformers``' AutoTokenizer on the resolved local directory
    (module doc)."""

    def __init__(self, tokenizer_name: str,
                 context_length: Optional[int] = DEFAULT_CONTEXT_LENGTH,
                 clean: str = "whitespace", strip_sep_token: bool = False,
                 language: Optional[str] = None, **kwargs):
        self.path = resolve_tokenizer_dir(tokenizer_name)
        tf = _transformers(f"tokenizer {tokenizer_name!r}")
        self.tokenizer = tf.AutoTokenizer.from_pretrained(
            self.path, local_files_only=True, **kwargs)
        set_lang = getattr(self.tokenizer, "set_src_lang_special_tokens",
                           None)
        if callable(set_lang):
            self.set_lang_fn = set_lang
            if language is not None:
                self.set_language(language)
        self.context_length = context_length
        self.clean_fn = get_clean_fn(clean)
        self.strip_sep_token = strip_sep_token

    def set_language(self, src_lang: str) -> None:
        """The source language of a tokenizer with a language hook
        (``set_src_lang_special_tokens``: NLLB's, M2M100's); without one
        it warns and changes nothing, as JAX's (tokenize/hf.py:63-67)."""
        if hasattr(self, "set_lang_fn"):
            self.set_lang_fn(src_lang)
        else:
            warnings.warn("Cannot set language for the tokenizer.")

    def save_pretrained(self, dest: str) -> None:
        """Write the tokenizer's files into ``dest`` (the HF export)."""
        self.tokenizer.save_pretrained(dest)

    def __call__(self, texts: Union[str, List[str]],
                 context_length: Optional[int] = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        assert context_length, "Please set a valid context length"
        texts = [self.clean_fn(t) for t in texts]
        out = self.tokenizer(texts, return_tensors="np",
                             max_length=context_length, padding="max_length",
                             truncation=True).input_ids
        sep = self.tokenizer.sep_token_id
        if self.strip_sep_token and sep is not None:
            out = np.where(out == sep, np.zeros_like(out), out)
        return out.astype(np.int32)


class SigLipTokenizer(HFTokenizer):
    """SigLIP's T5 sentencepiece tokenizer (reference tokenizer.py:464-521):
    canonical cleaning, padded to ``context_length`` with EOS ids; through
    ``transformers`` (module doc)."""

    def __init__(self, tokenizer_name: str,
                 context_length: Optional[int] = 64):
        tf = _transformers("SigLipTokenizer")
        self.path = resolve_tokenizer_dir(tokenizer_name)
        self.tokenizer = tf.T5TokenizerFast.from_pretrained(
            self.path, local_files_only=True)
        self.context_length = context_length
        self.clean_fn = get_clean_fn("canonicalize")
        self.strip_sep_token = False
