"""OpenCLIP fine-tune baseline (port of
xtagclip_tpu/cli/baselines/clip_baseline.py).

A CLIP image tower (default ViT-B-32, frozen with ``--lock-image``) and
the fusion head: an attribute MLP (22 -> 128, ReLU, dropout 0.3) joined
to the image feature, then 512 -> 256 -> num_classes (dropouts 0.5 and
0.3); cross-entropy, early stopping (patience 5), lr 5e-6, wd 1e-4,
batch 4 (the reference Config, clip_baseline.py:106-123). The model runs
in fp32, as JAX's; batches are normalized on ``--device`` (default cuda)
with the OpenAI mean and std, to fp32. Dropout masks come from a
``torch.Generator``.

    python -m xtagclip_tpu_torch.cli.baselines.clip_baseline \\
        --train-root DIR --val-root DIR [--pretrained laion400m_e32]
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import torch
import torch.nn.functional as F
from torch import nn

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
from xtagclip_tpu_torch.factory import (
    create_model,
    init_params,
    resolve_device,
)
from xtagclip_tpu_torch.models.layers import Dense, dropout
from xtagclip_tpu_torch.train.logger import setup_logging


class FusionHead(nn.Module):
    """[image feature, MLP(22 attributes)] -> MLP -> classes
    (clip_baseline.py:273-408 / biomedclip_baseline.py:376-392)."""

    def __init__(self, feat_dim: int, num_classes: int = 3):
        super().__init__()
        self.additional_fc = Dense(22, 128)
        self.fusion_fc1 = Dense(feat_dim + 128, 512)
        self.fusion_fc2 = Dense(512, 256)
        self.fusion_out = Dense(256, num_classes)

    def forward(self, img_feat, additional, generator=None):
        a = dropout(F.relu(self.additional_fc(additional)), 0.3, generator)
        x = torch.cat([img_feat, a], dim=-1)
        x = dropout(F.relu(self.fusion_fc1(x)), 0.5, generator)
        x = dropout(F.relu(self.fusion_fc2(x)), 0.3, generator)
        return self.fusion_out(x)


class Classifier(nn.Module):
    """A CLIP model's image tower and the fusion head ``head``."""

    def __init__(self, visual: nn.Module, feat_dim: int, num_classes: int,
                 lock_image: bool):
        super().__init__()
        self.visual = visual
        self.head = FusionHead(feat_dim, num_classes)
        self.lock_image = lock_image

    def forward(self, images, additional, train: bool = False,
                generator=None):
        """``train`` turns on the head's dropout (and the tower's train
        mode), with masks from ``generator``."""
        generator = generator if train else None
        feat, _ = self.visual(images, generator)
        if self.lock_image:
            feat = feat.detach()
        return self.head(feat, additional, generator)


def build_classifier(model_name: str, pretrained, num_classes: int,
                     lock_image: bool, device="cuda"):
    """(classifier, image size): the named model's image tower, with
    ``pretrained`` (``create_model``'s: a registry tag, URL, ``hf-hub:`` id
    or local file) loaded, and a fusion head of seeded init
    (clip_baseline.py:63-96)."""
    device = resolve_device(device)
    clip = create_model(model_name, pretrained, precision="fp32",
                        device=device)
    with device:
        model = Classifier(clip.visual, clip.embed_dim, num_classes,
                           lock_image)
    init_params(model.head, torch.Generator(device=device).manual_seed(0))
    img_size = clip.model_cfg["vision_cfg"].get("image_size", 224)
    return model, img_size


def main(argv=None):
    p = argparse.ArgumentParser("clip_baseline")
    p.add_argument("--train-root", required=True)
    p.add_argument("--val-root", required=True)
    p.add_argument("--train-csv", default=None)
    p.add_argument("--val-csv", default=None)
    p.add_argument("--model", default="ViT-B-32")
    p.add_argument("--pretrained", default=None,
                   help="registry tag (laion400m_e32), URL, hf-hub: id or "
                        "local open_clip checkpoint")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-6)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--num-classes", type=int, default=3)
    p.add_argument("--lock-image", action="store_true", default=False)
    p.add_argument("--output", default="clip_classifier_results.png")
    p.add_argument("--ckpt", default="best_clip_scar_model.pkl")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    setup_logging(None)

    model, img_size = build_classifier(args.model, args.pretrained,
                                       args.num_classes, args.lock_image,
                                       args.device)
    pp = PreprocessCfg(size=img_size)
    train_ds = ScarClassificationDataset(
        args.train_root, args.train_csv, image_transform_train(pp), True)
    val_ds = ScarClassificationDataset(
        args.val_root, args.val_csv, image_transform_eval(pp), False)
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True,
                              drop_last=True, num_workers=4)
    val_loader = DataLoader(val_ds, args.batch_size, num_workers=4)

    mask = None
    if args.lock_image:
        mask = {n: "visual" not in n for n, _ in model.named_parameters()}
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
