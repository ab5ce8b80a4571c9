"""Zero-shot scar classification with a prompt-ensemble classifier (port
of examples/zero_shot_classification.py):

    python -m xtagclip_tpu_torch.examples.zero_shot_classification \\
        [--model ViT-B-32] [--pretrained laion400m_e32] [--image x.png] \\
        [--device cuda]

Every (template x class) prompt is encoded, averaged over templates and
L2-normalized into a [D, C] classifier; one image (normalized on the
device; without ``--image``, a seeded synthetic input at the model's
resolution) is scored with 100 * img @ W, and the classes are printed by
probability.
"""

import argparse

import numpy as np
import torch

from xtagclip_tpu_torch.data.transforms import image_mean_std
from xtagclip_tpu_torch.factory import (
    cast_for_compute,
    create_model_and_transforms,
    get_tokenizer,
)
from xtagclip_tpu_torch.ops.preprocess import normalize_images
from xtagclip_tpu_torch.train.metadata import (
    SCAR_CLASSNAMES,
    SIMPLE_SCAR_TEMPLATES,
)
from xtagclip_tpu_torch.train.zero_shot import build_zero_shot_classifier


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ViT-B-32")
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--image", default=None, help="optional image file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model, _, preprocess = create_model_and_transforms(
        args.model, args.pretrained, precision="bf16", device=args.device)
    cast_for_compute(model, torch.bfloat16)
    model.eval()
    tokenizer = get_tokenizer(args.model)

    with torch.no_grad():
        classifier = build_zero_shot_classifier(
            model, tokenizer, classnames=SCAR_CLASSNAMES,
            templates=SIMPLE_SCAR_TEMPLATES)
        if args.image:
            from PIL import Image

            u8 = torch.from_numpy(np.asarray(preprocess(
                Image.open(args.image).convert("RGB")))[None]).to(args.device)
            mean, std = image_mean_std(model)
            img = normalize_images(u8, mean, std, dtype=torch.bfloat16)
        else:
            sz = model.model_cfg["vision_cfg"].get("image_size", 224)
            h, w = (sz, sz) if isinstance(sz, int) else sz
            img = torch.from_numpy(np.random.default_rng(0).normal(
                size=(1, h, w, 3)).astype(np.float32)).to(args.device,
                                                          torch.bfloat16)
        feats = model.encode_image(img, normalize=True)[0].float()
        probs = torch.softmax(100.0 * feats @ classifier, dim=-1)[0].cpu()
    for name, p in sorted(zip(SCAR_CLASSNAMES, probs.tolist()),
                          key=lambda t: -t[1]):
        print(f"{p:6.3f}  {name}")


if __name__ == "__main__":
    main()
