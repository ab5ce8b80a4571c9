"""ResNet-50 supervised baseline, BASELINE config 1 (port of
xtagclip_tpu/cli/baselines/resnet50_baseline.py).

A torchvision-style ResNet-50 backbone (models/standard_resnet.py, the
2048-d pooled feature) and an MLP head 2048 -> 512 -> 256 -> num_classes,
cross-entropy, early stopping (patience 15), the macro P/R/F1 report and
the result plot. ``--pretrained`` loads a local torchvision resnet50
``.pth`` (its ``fc`` dropped); nothing is downloaded. Batches are
normalized on ``--device`` (default cuda) with ImageNet's mean and std,
to fp32.

    python -m xtagclip_tpu_torch.cli.baselines.resnet50_baseline \\
        --train-root DIR --val-root DIR [--train-csv CSV --val-csv CSV]
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
from xtagclip_tpu_torch.convert.from_jax import load_jax_params
from xtagclip_tpu_torch.data.loader import DataLoader
from xtagclip_tpu_torch.data.transforms import (
    PreprocessCfg,
    image_transform_eval,
    image_transform_train,
)
from xtagclip_tpu_torch.factory import init_params, resolve_device
from xtagclip_tpu_torch.models.layers import Dense
from xtagclip_tpu_torch.models.standard_resnet import (
    convert_torchvision_resnet,
    resnet50,
)
from xtagclip_tpu_torch.train.logger import setup_logging
from xtagclip_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD


class ScarClassifier(nn.Module):
    """ResNet50 + MLP head (reference resnet50_baseline.py:190-215)."""

    def __init__(self, num_classes: int = 3):
        super().__init__()
        self.backbone = resnet50()
        self.head_fc1 = Dense(2048, 512)
        self.head_fc2 = Dense(512, 256)
        self.head_out = Dense(256, num_classes)

    def forward(self, images, additional=None, train: bool = False,
                generator=None):
        x = F.relu(self.head_fc1(self.backbone(images, train)))
        return self.head_out(F.relu(self.head_fc2(x)))


def load_torchvision_backbone(model: ScarClassifier, path: str) -> None:
    """A local torchvision resnet50 ``.pth`` into the backbone (its ``fc``
    dropped), parameters and BatchNorm statistics."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    params, stats = convert_torchvision_resnet(
        {k: v.numpy() for k, v in sd.items()})
    params.pop("fc", None)
    load_jax_params(model.backbone, params, stats)


def main(argv=None):
    p = argparse.ArgumentParser("resnet50_baseline")
    p.add_argument("--train-root", required=True)
    p.add_argument("--val-root", required=True)
    p.add_argument("--train-csv", default=None)
    p.add_argument("--val-csv", default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--patience", type=int, default=15)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=3)
    p.add_argument("--pretrained", default=None,
                   help="local torchvision resnet50 .pth")
    p.add_argument("--output", default="scar_classifier_results.png")
    p.add_argument("--ckpt", default="best_resnet50_scar_model.pkl")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    setup_logging(None)
    device = resolve_device(args.device)

    pp = PreprocessCfg(size=args.image_size, mean=IMAGENET_MEAN,
                       std=IMAGENET_STD)
    train_ds = ScarClassificationDataset(
        args.train_root, args.train_csv, image_transform_train(pp),
        is_train=True)
    val_ds = ScarClassificationDataset(
        args.val_root, args.val_csv, image_transform_eval(pp), is_train=False)
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True,
                              drop_last=True, num_workers=4)
    val_loader = DataLoader(val_ds, args.batch_size, num_workers=4)

    with device:
        model = ScarClassifier(num_classes=args.num_classes)
    init_params(model, torch.Generator(device=device).manual_seed(0))
    if args.pretrained:
        load_torchvision_backbone(model, args.pretrained)
        logging.info("loaded torchvision weights from %s", args.pretrained)

    model, history = train_supervised(
        model, train_loader, val_loader, args.num_classes, lr=args.lr,
        num_epochs=args.epochs, patience=args.patience, ckpt_path=args.ckpt,
        device=device, mean=pp.mean, std=pp.std)
    metrics = evaluate_supervised(model, val_loader, args.num_classes,
                                  device, pp.mean, pp.std)
    logging.info("final metrics: %s", json.dumps(metrics, default=float))
    plot_history(history, args.output)
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
