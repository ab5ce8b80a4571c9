"""BiomedCLIP fine-tune baseline, BASELINE config 3's standalone script
(port of xtagclip_tpu/cli/baselines/biomedclip_baseline.py).

clip_baseline's fusion-head classifier over the BiomedCLIP image tower
(a timm ViT-B/16; the text tower, PubMedBERT, is not part of the
classifier) with the ``--lock-text-encoder`` switch (reference Config: bs
4, lr 5e-6, wd 1e-4, 100 epochs, patience 5; the best model saved to
best_biomedclip_scar_model.*). ``--pretrained`` is a local open_clip
BiomedCLIP ``.pt``, a URL, an ``hf-hub:`` id or a registry tag. As the
reference's fallback ladder, and JAX's, a failed build (a tag that does
not resolve included) logs a warning and trains a randomly initialized
ViT-B-32 instead (``FALLBACK_MODEL``).

    python -m xtagclip_tpu_torch.cli.baselines.biomedclip_baseline \\
        --train-root DIR --val-root DIR --pretrained biomedclip.pt
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from xtagclip_tpu_torch.cli.baselines.clip_baseline import build_classifier
from xtagclip_tpu_torch.cli.baselines.common import (
    ScarClassificationDataset,
    evaluate_supervised,
    plot_history,
    train_supervised,
)
from xtagclip_tpu_torch.data.loader import DataLoader
from xtagclip_tpu_torch.data.transforms import (
    PreprocessCfg,
    image_transform_eval,
    image_transform_train,
)
from xtagclip_tpu_torch.train.logger import setup_logging

DEFAULT_MODEL = "BiomedCLIP-PubMedBERT_256-vit_base_patch16_224"
FALLBACK_MODEL = "ViT-B-32"


def main(argv=None):
    p = argparse.ArgumentParser("biomedclip_baseline")
    p.add_argument("--train-root", required=True)
    p.add_argument("--val-root", required=True)
    p.add_argument("--train-csv", default=None)
    p.add_argument("--val-csv", default=None)
    p.add_argument("--model", default=DEFAULT_MODEL)
    p.add_argument("--pretrained", default=None,
                   help="local BiomedCLIP open_clip checkpoint")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-6)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--num-classes", type=int, default=3)
    p.add_argument("--lock-text-encoder", action="store_true", default=False)
    p.add_argument("--lock-image", action="store_true", default=False)
    p.add_argument("--output", default="biomedclip_classifier_results.png")
    p.add_argument("--ckpt", default="best_biomedclip_scar_model.pkl")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    setup_logging(None)

    try:
        model, img_size = build_classifier(
            args.model, args.pretrained, args.num_classes, args.lock_image,
            args.device)
    except Exception as e:  # the fallback ladder (biomedclip_baseline.py:216-374)
        logging.warning("BiomedCLIP build failed (%s); falling back to "
                        "%s random init", e, FALLBACK_MODEL)
        model, img_size = build_classifier(
            FALLBACK_MODEL, None, args.num_classes, args.lock_image,
            args.device)

    # the text tower is not in the classifier; --lock-text-encoder excludes
    # any text parameter from the trainable set, as JAX's mask does
    mask = {n: not ((args.lock_image and "visual" in n)
                    or (args.lock_text_encoder and "text" in n))
            for n, _ in model.named_parameters()}

    pp = PreprocessCfg(size=img_size)
    train_ds = ScarClassificationDataset(
        args.train_root, args.train_csv, image_transform_train(pp), True)
    val_ds = ScarClassificationDataset(
        args.val_root, args.val_csv, image_transform_eval(pp), False)
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True,
                              drop_last=True, num_workers=4)
    val_loader = DataLoader(val_ds, args.batch_size, num_workers=4)

    model, history = train_supervised(
        model, train_loader, val_loader, args.num_classes, lr=args.lr,
        weight_decay=args.wd, num_epochs=args.epochs, patience=args.patience,
        trainable_mask=mask, ckpt_path=args.ckpt, device=args.device,
        mean=pp.mean, std=pp.std)
    metrics = evaluate_supervised(model, val_loader, args.num_classes,
                                  args.device, pp.mean, pp.std)
    logging.info("final metrics: %s", json.dumps(metrics, default=float))
    plot_history(history, args.output)
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
