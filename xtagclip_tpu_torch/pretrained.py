"""Pretrained weight registry and resolution (port of
xtagclip_tpu/pretrained.py).

The (model, tag) -> {url, hf_hub, preprocess overrides} table (165 tags
over 84 models) is the JAX package's ``assets/pretrained_registry.json``,
read by file path. A tag resolves to a local file: a URL through a cache
directory (``XTAGCLIP_CACHE``, default ``~/.cache/xtagclip``) whose entry
is checked against the sha256 the reference carries in its URLs, a hub
repo through ``huggingface_hub`` (which reads its cache first, and only
its cache under ``HF_HUB_OFFLINE=1``). ``resolve_pretrained`` also takes
a URL, an ``hf-hub:<org>/<name>`` id or a local path. A fetch that cannot
reach its host raises.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import urllib.request
from functools import lru_cache
from typing import Dict, List, Optional

from xtagclip_tpu_torch.utils.assets import asset_path
from xtagclip_tpu_torch.utils.constants import (
    HF_SAFE_WEIGHTS_NAME,
    HF_WEIGHTS_NAME,
)


@lru_cache()
def _registry() -> Dict[str, Dict[str, dict]]:
    with open(asset_path("pretrained_registry.json")) as f:
        return json.load(f)


def list_pretrained(as_str: bool = False):
    """Every (model, tag), or ``"model tag"`` strings."""
    return [f"{model} {tag}" if as_str else (model, tag)
            for model, tags in _registry().items() for tag in tags]


def list_pretrained_models_by_tag(tag: str) -> List[str]:
    return [m for m, tags in _registry().items() if tag in tags]


def list_pretrained_tags_by_model(model: str) -> List[str]:
    return list(_registry().get(model, {}))


def _norm(tag: str) -> str:
    return tag.lower().replace("-", "_")


def is_pretrained_cfg(model: str, tag: str) -> bool:
    return _norm(tag) in {_norm(t) for t in _registry().get(model, {})}


def get_pretrained_cfg(model: str, tag: str) -> dict:
    """The registry entry of ``tag`` for ``model`` (case and ``-``/``_``
    folded), or {}."""
    for t, cfg in _registry().get(model, {}).items():
        if _norm(t) == _norm(tag):
            return dict(cfg)
    return {}


def get_pretrained_url(model: str, tag: str) -> str:
    return get_pretrained_cfg(model, tag).get("url", "")


def default_cache_dir() -> str:
    return os.path.expanduser(
        os.environ.get("XTAGCLIP_CACHE", "~/.cache/xtagclip"))


def expected_sha256_for_url(url: str, explicit: str = "") -> str:
    """The expected sha256 (whole or a prefix) of a weight URL: an explicit
    registry ``sha256`` wins; openaipublic URLs carry the whole hash as
    the second-to-last path component, mlfoundations release names end in
    ``-<hex prefix>``; other hosts give "" (nothing to check)."""
    if explicit:
        return explicit
    path = url.split("?")[0]
    if "openaipublic" in url:
        return path.split("/")[-2]
    if "mlfoundations" in url:
        stem = os.path.splitext(os.path.basename(path))[0]
        suffix = stem.rsplit("-", 1)[-1]
        if len(suffix) >= 6 and all(c in "0123456789abcdef" for c in suffix):
            return suffix
    return ""


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_pretrained_from_url(url: str, cache_dir: Optional[str] = None,
                                 expected_sha256: str = "") -> str:
    """The cached file of ``url``, fetched if absent: a cached file whose
    sha256 does not match is fetched again once; a fetch is written to
    ``<file>.part`` and moved into place only once it matches, and one that
    does not match is deleted and raises."""
    cache_dir = cache_dir or default_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    target = os.path.join(cache_dir, os.path.basename(url.split("?")[0]))
    expected = expected_sha256_for_url(url, expected_sha256)
    if os.path.exists(target):
        if not os.path.isfile(target):
            raise RuntimeError(f"{target} exists and is not a regular file")
        if not expected or _file_sha256(target).startswith(expected):
            return target
        logging.warning("%s exists but its sha256 does not match %s; "
                        "fetching it again", target, expected)
        os.remove(target)
    logging.info("fetching %s -> %s", url, target)
    tmp = target + ".part"
    urllib.request.urlretrieve(url, tmp)
    if expected and not _file_sha256(tmp).startswith(expected):
        os.remove(tmp)
        raise RuntimeError(
            f"fetched {url} but its sha256 does not match the expected "
            f"{expected}: a corrupted or tampered file")
    os.replace(tmp, target)
    return target


def download_pretrained_from_hf(model_id: str,
                                filename: Optional[str] = None,
                                cache_dir: Optional[str] = None) -> str:
    """The local path of ``filename`` in hub repo ``model_id``; without a
    filename, ``open_clip_model.safetensors``, then
    ``open_clip_pytorch_model.bin``. The hub cache is ``cache_dir``, else
    the one ``$HF_HUB_CACHE`` or ``$HF_HOME`` names, and
    ``$HF_HUB_OFFLINE`` keeps the lookup to it; both are read at the call
    (``huggingface_hub`` reads them when it is imported). Raises
    FileNotFoundError naming the last failure."""
    from huggingface_hub import hf_hub_download

    from xtagclip_tpu_torch.tokenize.hf import hub_cache_dirs

    offline = os.environ.get("HF_HUB_OFFLINE", "").upper() in (
        "1", "ON", "YES", "TRUE")
    last = None
    for fname in [filename] if filename else [HF_SAFE_WEIGHTS_NAME,
                                               HF_WEIGHTS_NAME]:
        try:
            return hf_hub_download(model_id, fname,
                                   cache_dir=cache_dir or hub_cache_dirs()[0],
                                   local_files_only=offline)
        except Exception as e:  # noqa: BLE001 (any hub error: try the next)
            last = e
    raise FileNotFoundError(f"could not fetch weights for {model_id}: {last}")


def resolve_pretrained(model: str, pretrained: str,
                       cache_dir: Optional[str] = None) -> str:
    """A tag, URL, ``hf-hub:`` id or local path -> a local checkpoint file."""
    if os.path.exists(pretrained):
        return pretrained
    if pretrained.startswith("hf-hub:"):
        return download_pretrained_from_hf(pretrained[len("hf-hub:"):],
                                           cache_dir=cache_dir)
    if pretrained.startswith(("http://", "https://")):
        return download_pretrained_from_url(pretrained, cache_dir)
    cfg = get_pretrained_cfg(model, pretrained)
    if not cfg:
        raise FileNotFoundError(
            f"no pretrained tag {pretrained!r} for model {model!r}; "
            f"available: {list_pretrained_tags_by_model(model)}")
    if cfg.get("hf_hub"):
        hub = cfg["hf_hub"].rstrip("/")
        if "/" in hub and not hub.endswith((".bin", ".pt", ".safetensors")):
            return download_pretrained_from_hf(hub, cache_dir=cache_dir)
        repo, _, fname = hub.rpartition("/")
        return download_pretrained_from_hf(repo, fname or None, cache_dir)
    if cfg.get("url"):
        return download_pretrained_from_url(
            cfg["url"], cache_dir, expected_sha256=cfg.get("sha256", ""))
    raise FileNotFoundError(
        f"pretrained cfg for {model}:{pretrained} has no source")
