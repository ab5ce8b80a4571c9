"""Normalization constants and hub file names (a copy of
xtagclip_tpu/utils/constants.py)."""

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

HF_WEIGHTS_NAME = "open_clip_pytorch_model.bin"
HF_SAFE_WEIGHTS_NAME = "open_clip_model.safetensors"
HF_CONFIG_NAME = "open_clip_config.json"
