"""Batch image and text feature extraction to an .npz archive (port of
examples/feature_extraction.py):

    python -m xtagclip_tpu_torch.examples.feature_extraction \\
        [--model ViT-B-32] [--pretrained laion400m_e32] [--image-dir DIR] \\
        [--batch-size 32] [--out embeddings.npz] [--device cuda]

The model runs in bf16 on ``--device`` (default the card). Images of
``--image-dir`` are center-cropped uint8 on the host and normalized on the
device; without one it embeds a seeded batch of synthetic inputs (standard
normal, in place of normalized images, as the JAX example does). The
archive holds fp32 ``image_features``, ``text_features``, ``image_names``
and ``texts``.
"""

import argparse
import os

import numpy as np
import torch

from xtagclip_tpu_torch.data.transforms import image_mean_std
from xtagclip_tpu_torch.factory import (
    cast_for_compute,
    create_model_and_transforms,
    get_tokenizer,
)
from xtagclip_tpu_torch.ops.preprocess import normalize_images


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ViT-B-32")
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--image-dir", default=None,
                    help="directory of images; synthetic batch if omitted")
    ap.add_argument("--texts", nargs="*",
                    default=["a photo of a hypertrophic scar",
                             "a photo of a keloid scar"])
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--out", default="embeddings.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model, _, preprocess = create_model_and_transforms(
        args.model, args.pretrained, precision="bf16", device=args.device)
    cast_for_compute(model, torch.bfloat16)
    model.eval()
    tokenizer = get_tokenizer(args.model)

    if args.image_dir:
        from PIL import Image

        names = sorted(n for n in os.listdir(args.image_dir)
                       if n.lower().endswith((".jpg", ".jpeg", ".png",
                                              ".tif")))
        u8 = torch.from_numpy(np.stack([
            np.asarray(preprocess(Image.open(
                os.path.join(args.image_dir, n)).convert("RGB")))
            for n in names])).to(args.device)
        mean, std = image_mean_std(model)
        imgs = normalize_images(u8, mean, std, dtype=torch.bfloat16)
    else:
        names = [f"synthetic_{i}" for i in range(args.batch_size)]
        sz = model.model_cfg["vision_cfg"].get("image_size", 224)
        h, w = (sz, sz) if isinstance(sz, int) else sz
        imgs = torch.from_numpy(np.random.default_rng(0).normal(
            size=(args.batch_size, h, w, 3)).astype(np.float32)).to(
            args.device, torch.bfloat16)

    with torch.no_grad():
        img_feats = torch.cat([
            model.encode_image(imgs[i:i + args.batch_size],
                               normalize=True)[0].float()
            for i in range(0, len(imgs), args.batch_size)]).cpu().numpy()
        tokens = torch.from_numpy(
            np.asarray(tokenizer(args.texts), np.int64)).to(args.device)
        txt_feats = model.encode_text(tokens, normalize=True)[0].float() \
            .cpu().numpy()

    np.savez(args.out, image_features=img_feats, text_features=txt_feats,
             image_names=np.array(names), texts=np.array(args.texts))
    print(f"wrote {args.out}: image {img_feats.shape}, "
          f"text {txt_feats.shape}")


if __name__ == "__main__":
    main()
