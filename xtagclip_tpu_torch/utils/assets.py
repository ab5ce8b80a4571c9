"""Locate the data assets shipped with the JAX package, by file path.

The port shares the reference package's assets (BPE vocab, model configs,
tag lists, zero-shot metadata) but must not import that package (its
``__init__`` pulls in jax), so they are read from
``<repo or site-packages>/xtagclip_tpu/assets`` directly.
"""

from __future__ import annotations

from pathlib import Path

_ASSET_DIR = Path(__file__).resolve().parents[2] / "xtagclip_tpu" / "assets"


def asset_path(*parts: str) -> Path:
    p = _ASSET_DIR.joinpath(*parts)
    if not p.exists():
        raise FileNotFoundError(f"packaged asset not found: {p}")
    return p


def read_tag_list(name: str = "scar_tag_list.txt") -> list[str]:
    with open(asset_path("tagging", name), "r", encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]
