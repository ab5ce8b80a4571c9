"""Zero-shot class names and templates (counterpart of
xtagclip_tpu/train/metadata.py), loaded from the shared
zero_shot_metadata.json asset. Templates are '{}'-format strings;
``format_template(t, classname)`` applies one."""

from __future__ import annotations

import json
from functools import lru_cache

from xtagclip_tpu_torch.utils.assets import asset_path


@lru_cache()
def _meta() -> dict:
    with open(asset_path("zero_shot_metadata.json")) as f:
        return json.load(f)


_NAMES = {
    "OPENAI_IMAGENET_TEMPLATES": "openai_imagenet_templates",
    "SIMPLE_IMAGENET_TEMPLATES": "simple_imagenet_templates",
    "IMAGENET_CLASSNAMES": "imagenet_classnames",
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


def format_template(template: str, classname: str) -> str:
    return (template.format(classname) if "{}" in template
            else template + classname)
