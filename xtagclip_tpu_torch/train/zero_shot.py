"""Zero-shot classifier building + scar/medmnist/imagenet zero-shot eval
(port of xtagclip_tpu/train/zero_shot.py; reference
zero_shot_classifier.py:21-68 and others/zero_shot_other.py:59-318).

The eval forward runs under ``torch.no_grad()`` with the model in eval
mode, so on the card its tower blocks go through the fused forward
kernels; each uint8 batch crosses to the card and is normalized there
(ops/preprocess.py). The text artifacts (``*_tagging_output.txt``,
``*_class_output.txt``, read by ``viz/``) and the ``--save-embed`` .npz
and .pt pair are written in the JAX package's formats.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from xtagclip_tpu_torch.data.loader import device_prefetch
from xtagclip_tpu_torch.ops.preprocess import normalize_images
from xtagclip_tpu_torch.tokenize.prompts import tag_indices_to_words
from xtagclip_tpu_torch.train import metadata
from xtagclip_tpu_torch.train.metadata import format_template
from xtagclip_tpu_torch.train.metrics import (
    accuracy_onehot,
    accuracy_topk,
    tag_batch_metrics,
    tags_to_binary,
)
from xtagclip_tpu_torch.utils.assets import read_tag_list


def _device(model) -> torch.device:
    return model.logit_scale.device


def _l2(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def build_zero_shot_classifier(model, tokenizer, classnames: Sequence[str],
                               templates: Sequence[str],
                               num_classes_per_batch: Optional[int] = 10
                               ) -> torch.Tensor:
    """Encode templates x classes (L2-normalized) -> mean over templates ->
    L2 -> [D, C] fp32 on the model's device."""
    texts = [format_template(t, c) for c in classnames for t in templates]
    tokens = torch.from_numpy(np.asarray(tokenizer(texts), np.int64)).to(
        _device(model))
    num_templates = len(templates)
    was_training = model.training
    model.eval()
    chunk = (num_classes_per_batch or len(classnames)) * num_templates
    feats = torch.cat([model.encode_text(tokens[i:i + chunk],
                                         normalize=True)[0].float()
                       for i in range(0, tokens.shape[0], chunk)])
    model.train(was_training)
    feats = feats.reshape(len(classnames), num_templates, -1).mean(dim=1)
    return (feats / feats.norm(dim=-1, keepdim=True)).T.contiguous()


def _pick_classnames_templates(data_key: str):
    key = data_key.lower()
    if "imagenet" in key:
        return metadata.IMAGENET_CLASSNAMES, metadata.OPENAI_IMAGENET_TEMPLATES
    if "scar" in key:
        return metadata.SCAR_CLASSNAMES, metadata.SIMPLE_SCAR_TEMPLATES
    if "pathmnist" in key:
        return (metadata.PATHMNIST_CLASSNAMES,
                metadata.SIMPLE_MEDICALMNIST_TEMPLATES)
    if "medicalmnist" in key:
        return (metadata.MEDICALMNIST_CLASSNAMES,
                metadata.SIMPLE_MEDICALMNIST_TEMPLATES)
    return metadata.IMAGENET_CLASSNAMES, metadata.OPENAI_IMAGENET_TEMPLATES


def make_eval_forward(model, fusion_scoring: bool = False,
                      tagging: bool = True):
    """The eval forward shared by run_scar_eval and the CLIs: encode_image
    -> tag head -> zero-shot logits (100 * img @ W) or the fusion-aware
    token-mix similarity (train_other_simple.py:442-455).

    Returns fn(images_u8 [B, H, W, 3] on the model's device, classifier
    [D, C]) -> (img_feat, logits fp32, tag_global). With ``tagging`` off,
    or for a model without a tag head (no ``tag_forward``), the tag head
    does not run and tag_global is None (JAX's predict without
    --use-tagging emits no tags). The picks stay on the device, so the
    forward can be captured as a CUDA graph."""
    picks = tagging and hasattr(model, "tag_forward")

    @torch.no_grad()
    def forward(images_u8, classifier):
        was_training = model.training
        model.eval()
        images = normalize_images(images_u8, dtype=model.dtype)
        img_feat, tokens = model.encode_image(images, normalize=True)
        tag_global = None
        if picks:
            _, tag_global = model.prepare_tag_indices(
                model.tag_forward(tokens))
        if fusion_scoring:
            tokens = tokens.float()
            g_sim = _l2(tokens.mean(dim=1)) @ classifier
            l_sim = (_l2(tokens) @ classifier).mean(dim=1)
            logits = 100.0 * (g_sim + l_sim) / 2.0
        else:
            logits = 100.0 * img_feat.float() @ classifier
        model.train(was_training)
        return img_feat, logits, tag_global

    return forward


def run_scar_eval(model, classifier: torch.Tensor, dataloader,
                  save_embed: bool = False,
                  save_embed_path: Optional[str] = None,
                  tagging_output_path: Optional[str] = None,
                  class_output_path: Optional[str] = None,
                  classnames: Optional[Sequence[str]] = None,
                  fusion_scoring: bool = False):
    """Eval loop over a Scar-style loader (image, label, additional,
    tokens, class_word, class_idx). Returns a metrics dict.

    The JAX eval's ``prompt_table`` argument is gone: the logits are
    100*img@W (or the fusion scoring) and the tag metrics come from the
    tag logits; the reference eval's pseudo-prompt text pass feeds neither
    (zero_shot_other.py:59-261)."""
    tag_list = read_tag_list()
    forward = make_eval_forward(model, fusion_scoring=fusion_scoring)

    n = 0
    top1 = top2 = 0.0
    class_counts = class_correct1 = None
    all_img_feats, all_labels = [], []
    tag_lines, class_lines = [], []
    tag_metric_accum = []

    for batch in device_prefetch(dataloader, _device(model)):
        images, label_vec, additional, _tokens, _words, _cidx = batch
        img_feat, logits, tag_global = forward(images, classifier)
        logits = logits.cpu().numpy()
        label_vec = label_vec.cpu().numpy()
        additional = additional.cpu().numpy()
        tag_global = tag_global.cpu().numpy()
        overall, counts, correct = accuracy_onehot(logits, label_vec,
                                                   topk=(1, 2))
        top1 += overall[0]
        top2 += overall[1]
        class_counts = counts if class_counts is None else class_counts + counts
        c1 = correct[1]
        class_correct1 = c1 if class_correct1 is None else class_correct1 + c1
        n += logits.shape[0]

        m = tag_batch_metrics(additional, tags_to_binary(tag_global))
        tag_metric_accum.append((logits.shape[0], m))

        pred_words = tag_indices_to_words(tag_global, tag_list)
        gt_words = [",".join(tag_list[i] for i in np.nonzero(row)[0])
                    for row in additional]
        tag_lines.extend(f"{g} - {p}" for g, p in zip(gt_words, pred_words))

        if class_output_path:
            names = list(classnames or [str(i)
                                        for i in range(logits.shape[1])])
            for row_logits, row_label in zip(logits, label_vec):
                gt_name = names[int(np.argmax(row_label))]
                pred_name = names[int(np.argmax(row_logits))]
                scores = ", ".join(f"{s:.6f}" for s in row_logits.tolist())
                class_lines.append(f"{gt_name} - {pred_name} - [{scores}]")

        if save_embed:
            all_img_feats.append(img_feat.float().cpu().numpy())
            all_labels.append(label_vec)

    def wavg(key_path):
        tot = sum(b for b, _ in tag_metric_accum)
        val = 0.0
        for b, m in tag_metric_accum:
            for p in key_path:
                m = m[p]
            val += b * m
        return val / max(tot, 1)

    metrics = {
        "top1": top1 / max(n, 1),
        "top2": top2 / max(n, 1),
        "n": n,
        "per_class_acc": (
            (class_correct1 / np.maximum(class_counts, 1)).tolist()
            if class_counts is not None else []),
        "tag_accuracy": wavg(("accuracy",)),
        "tag_precision": wavg(("precision",)),
        "tag_recall": wavg(("recall",)),
        "tag_f1": wavg(("f1",)),
    }
    for g in ["Width", "Color", "Pigmentation", "Surface", "Irregular Color",
              "Irregular Height"]:
        metrics[f"tag_{g.lower().replace(' ', '_')}_f1"] = wavg(
            ("groups", g, "f1"))

    if class_output_path and class_lines:
        with open(class_output_path, "w") as f:
            f.write("\n".join(class_lines) + "\n")
            f.write(f"\n전체 정확도: {metrics['top1']:.4f}\n")

    if tagging_output_path:
        with open(tagging_output_path, "w") as f:
            f.write("\n".join(tag_lines) + "\n")
            f.write(f"\n전체 태그 정확도: {metrics['tag_accuracy']:.4f}\n")
            f.write(f"정밀도: {metrics['tag_precision']:.4f} "
                    f"재현율: {metrics['tag_recall']:.4f} "
                    f"F1: {metrics['tag_f1']:.4f}\n")

    if save_embed and all_img_feats:
        img = np.concatenate(all_img_feats)
        labels = np.concatenate(all_labels)
        txt = classifier.T.float().cpu().numpy()
        path = save_embed_path or "dataset_embeddings.npz"
        np.savez(path, img_embeddings=img, txt_embeddings=txt, labels=labels)
        # the reference's .pt layout, for the viz tools
        torch.save({"img_embeddings": torch.from_numpy(img),
                    "txt_embeddings": torch.from_numpy(txt),
                    "labels": torch.from_numpy(labels),
                    "dataset_labels": list(classnames or [])},
                   os.path.splitext(path)[0] + ".pt")
        logging.info("saved embeddings to %s (%s images)", path, len(img))

    return metrics


def run_classification_eval(model, classifier, dataloader):
    """Plain (image, int_label) eval: top1/top5 counts / n."""

    @torch.no_grad()
    def forward(images_u8):
        images = normalize_images(images_u8, dtype=model.dtype)
        feats, _ = model.encode_image(images, normalize=True)
        return 100.0 * feats.float() @ classifier

    was_training = model.training
    model.eval()
    n = 0
    top1 = top5 = 0.0
    for images, target in device_prefetch(dataloader, _device(model)):
        logits = forward(images).cpu().numpy()
        k = min(5, logits.shape[1])
        accs = accuracy_topk(logits, target.cpu().numpy(), topk=(1, k))
        top1 += accs[0]
        top5 += accs[1]
        n += logits.shape[0]
    model.train(was_training)
    return {"top1": top1 / max(n, 1), "top5": top5 / max(n, 1), "n": n}


def train_data_eval(model, data: dict, args, tokenizer) -> dict:
    """Validation pass over the TRAIN split (reference
    train_other.py:290-496): top1/top2, per-class accuracy, grouped tag
    metrics, and the traindata_val_{tagging,class}_output.txt artifacts.
    The returned top1 drives the 'train_top1' best checkpoint."""
    if "scar_train" not in data:
        return {}
    classnames, templates = _pick_classnames_templates("scar_train")
    classifier = build_zero_shot_classifier(model, tokenizer, classnames,
                                            templates)
    tag_txt = cls_txt = None
    if getattr(args, "checkpoint_path", None):
        tag_txt = os.path.join(args.checkpoint_path,
                               "traindata_val_tagging_output.txt")
        cls_txt = os.path.join(args.checkpoint_path,
                               "traindata_val_class_output.txt")
    m = run_scar_eval(model, classifier, data["scar_train"].dataloader,
                      tagging_output_path=tag_txt,
                      class_output_path=cls_txt, classnames=classnames,
                      fusion_scoring=getattr(args, "use_fusion", False))
    return {f"train_data-{k}": v for k, v in m.items()}


def zero_shot_eval(model, data: dict, epoch: int, args, tokenizer) -> dict:
    """Dispatch over eval splits (reference zero_shot_other.py:263-318)."""
    results = {}
    for key in ("scar_val", "PathMNIST_val", "MedicalMNIST", "imagenet-val",
                "imagenet-v2"):
        if key not in data:
            continue
        classnames, templates = _pick_classnames_templates(key)
        classifier = build_zero_shot_classifier(model, tokenizer, classnames,
                                                templates)
        if key == "scar_val":
            out_txt = cls_txt = None
            if getattr(args, "checkpoint_path", None):
                out_txt = os.path.join(args.checkpoint_path,
                                       "val_data_tagging_output.txt")
                cls_txt = os.path.join(args.checkpoint_path,
                                       "val_data_class_output.txt")
            m = run_scar_eval(
                model, classifier, data[key].dataloader,
                save_embed=getattr(args, "save_embed", False),
                save_embed_path=(
                    f"dataset_embeddings_all_no_templete_{args.name}.npz"
                    if getattr(args, "name", None) else None),
                tagging_output_path=out_txt, class_output_path=cls_txt,
                classnames=classnames,
                fusion_scoring=getattr(args, "use_fusion", False))
        else:
            m = run_classification_eval(model, classifier,
                                        data[key].dataloader)
        results.update({f"{key}-{k}": v for k, v in m.items()})
    return results
