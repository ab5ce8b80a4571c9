"""Zero-shot class names and templates that the predict CLI reads
(counterpart of xtagclip_tpu/train/metadata.py, scar/pathmnist/medicalmnist
only), loaded from the shared zero_shot_metadata.json asset."""

from __future__ import annotations

import json
from functools import lru_cache

from xtagclip_tpu_torch.utils.assets import asset_path


@lru_cache()
def _meta() -> dict:
    with open(asset_path("zero_shot_metadata.json")) as f:
        return json.load(f)


_NAMES = {
    "SIMPLE_MEDICALMNIST_TEMPLATES": "simple_medicalmnist_templates",
    "SIMPLE_SCAR_TEMPLATES": "simple_scar_templates",
    "MEDICALMNIST_CLASSNAMES": "medicalmnist_classnames",
    "PATHMNIST_CLASSNAMES": "pathmnist_classnames",
    "SCAR_CLASSNAMES": "scar_classnames",
}


def __getattr__(name: str):
    if name in _NAMES:
        return list(_meta()[_NAMES[name]])
    raise AttributeError(name)
