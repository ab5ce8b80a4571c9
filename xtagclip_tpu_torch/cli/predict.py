"""Batch inference CLI: images in, class/tag predictions out (JSONL).
Port of xtagclip_tpu/cli/predict.py, flag for flag, plus ``--device``.

    python -m xtagclip_tpu_torch.cli.predict \
        --model ViT-B-32 --pretrained /path/ckpt.pt \
        --input /dir/of/images --dataset scar --use-tagging \
        --output predictions.jsonl

Weights come from an open_clip ``.pt`` (``--pretrained``) and/or one of
the port's training checkpoint tags (``--resume``: a directory holding
``state.pt``, or that file); without either the model is a seeded random
init. Two heads:

- the zero-shot head (default): the prompt-ensemble classifier of
  ``--dataset``'s (or ``--template``'s) templates, logits 100 * img @ W
  or, with ``--fusion-scoring``, the token-mix similarity; tag picks with
  ``--use-tagging``;
- ``--fusion-classify`` (implies ``--use-tagging``): TQN fusion over the
  precomputed pseudo-prompt space (serving.py). ``--export-serving DIR``
  also writes the self-contained artifact (convert/serving.py), and
  ``--serving-artifact DIR`` serves from one with no model code or
  checkpoint.

Images are decoded and center-cropped on the host to uint8 and normalized
on the device. The last batch is zero-padded to ``--batch-size`` and the
padding rows are dropped on the host, so on the card every batch replays
one CUDA graph, captured at the first batch (serving.py::CudaGraphRunner).
``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch


def _parse_args(argv=None):
    p = argparse.ArgumentParser("xtagclip_tpu_torch prediction")
    p.add_argument("--model", default="ViT-B-32")
    p.add_argument("--pretrained", default=None,
                   help="local open_clip .pt (named tags are not ported)")
    p.add_argument("--resume", default=None,
                   help="checkpoint to load on top: one of the port's "
                        "checkpoint tags (a directory holding state.pt, or "
                        "that file) or an open_clip .pt")
    p.add_argument("--input", nargs="+", required=True,
                   help="image files, a directory, or a .csv")
    p.add_argument("--csv-img-key", default="filepath")
    p.add_argument("--dataset", default="scar",
                   choices=("scar", "pathmnist", "medicalmnist", "imagenet"),
                   help="class-name/template set for the zero-shot head")
    p.add_argument("--classnames", default=None,
                   help="comma-separated override of --dataset class names")
    p.add_argument("--template", default=None,
                   help="prompt template override, e.g. 'a photo of {}.'")
    p.add_argument("--use-tagging", action="store_true",
                   help="emit the 6 per-category tag picks (XTag head)")
    p.add_argument("--fusion-scoring", action="store_true",
                   help="token-mix similarity (train_other_simple.py:442-455)")
    p.add_argument("--fusion-classify", action="store_true",
                   help="classify via TQN fusion over the precomputed "
                        "pseudo-prompt space (serving.py; implies "
                        "--use-tagging)")
    p.add_argument("--prompt-template-setting", default="sentence_1",
                   help="template for --fusion-classify")
    p.add_argument("--serving-artifact", default=None,
                   help="run --fusion-classify from a serving artifact dir "
                        "(convert/serving.py serve_classify entry): no "
                        "model code or checkpoint is loaded")
    p.add_argument("--export-serving", default=None,
                   help="with --fusion-classify: write the serving artifact "
                        "(encode_image/encode_text/forward + serve_classify "
                        "with the precomputed prompt table baked in) to this "
                        "dir before predicting")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--precision", default="bf16")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    p.add_argument("--output", default="-", help="JSONL path ('-' = stdout)")
    p.add_argument("--save-embed", default=None,
                   help="optional .npz with fp32 image features")
    return p.parse_args(argv)


def _list_inputs(args):
    names = []
    for item in args.input:
        if os.path.isdir(item):
            exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif",
                    ".tiff", ".ppm", ".pgm")
            names.extend(
                os.path.join(item, n) for n in sorted(os.listdir(item))
                if n.lower().endswith(exts))
        elif item.lower().endswith(".csv"):
            import csv

            with open(item, newline="") as f:
                for i, row in enumerate(csv.DictReader(f)):
                    if args.csv_img_key not in row:
                        raise SystemExit(
                            f"predict: {item} row {i + 1} has no "
                            f"'{args.csv_img_key}' column (columns: "
                            f"{sorted(row)}); set --csv-img-key")
                    names.append(row[args.csv_img_key])
        else:
            names.append(item)
    if not names:
        raise SystemExit("predict: no input images found")
    return names


def _class_meta(args):
    from xtagclip_tpu_torch.train import metadata as M

    table = {
        "scar": (M.SCAR_CLASSNAMES, M.SIMPLE_SCAR_TEMPLATES),
        "pathmnist": (M.PATHMNIST_CLASSNAMES, M.SIMPLE_MEDICALMNIST_TEMPLATES),
        "medicalmnist": (M.MEDICALMNIST_CLASSNAMES,
                         M.SIMPLE_MEDICALMNIST_TEMPLATES),
        "imagenet": (M.IMAGENET_CLASSNAMES, M.OPENAI_IMAGENET_TEMPLATES),
    }
    classnames, templates = table[args.dataset]
    if args.classnames:
        classnames = [c.strip() for c in args.classnames.split(",")]
    if args.template:
        templates = [args.template]
    return list(classnames), list(templates)


def _from_artifact(args, classnames):
    """(serve step, host preprocess, class names) of a serving artifact."""
    if not args.fusion_classify:
        raise SystemExit("--serving-artifact requires --fusion-classify")
    from xtagclip_tpu_torch.convert.serving import load_serving, read_manifest
    from xtagclip_tpu_torch.data.transforms import (
        PreprocessCfg,
        image_transform_eval,
    )

    fns = load_serving(args.serving_artifact)
    if "serve_classify" not in fns:
        raise SystemExit(
            f"{args.serving_artifact} has no serve_classify entry — "
            "export it with --export-serving under --fusion-classify")
    manifest = read_manifest(args.serving_artifact)
    pp = manifest.get("preprocess") or {}
    fields = {f.name for f in dataclasses.fields(PreprocessCfg)}
    cfg = PreprocessCfg(**{k: v for k, v in pp.items() if k in fields})
    return (fns["serve_classify"], image_transform_eval(cfg),
            manifest.get("classnames") or classnames)


def _from_model(args, classnames, templates):
    """(serve step, host preprocess) of a model built here: the
    fusion-classify step or the zero-shot forward, as a CUDA graph on the
    card."""
    from xtagclip_tpu_torch.factory import (
        cast_for_compute,
        create_model_and_transforms,
        get_cast_dtype,
        get_model_preprocess_cfg,
        get_tokenizer,
        load_checkpoint,
    )
    from xtagclip_tpu_torch.serving import CudaGraphRunner

    model, _, preprocess = create_model_and_transforms(
        args.model, pretrained=args.pretrained, precision=args.precision,
        device=args.device, use_tagging=args.use_tagging,
        use_fusion=args.fusion_classify)
    if args.resume:
        load_checkpoint(model, args.resume)
    cast_for_compute(model, get_cast_dtype(args.precision))
    tokenizer = get_tokenizer(args.model)

    if args.fusion_classify:
        from xtagclip_tpu_torch.serving import (
            make_serve_classify,
            precompute_prompt_features,
        )
        from xtagclip_tpu_torch.tokenize.prompts import PromptTable

        # build + embed only the requested template's prompt rows
        ptable = PromptTable(classnames, tokenizer=tokenizer,
                             templates=[args.prompt_template_setting]).table
        table = precompute_prompt_features(model, ptable, template_id=0)
        if args.export_serving:
            from xtagclip_tpu_torch.convert.serving import save_serving

            manifest = save_serving(
                model, args.export_serving, model_name=args.model,
                serve_classify_table=table, classnames=classnames)
            sizes = ", ".join(
                "{}={:.1f}MB in {:.1f}s".format(k, v["bytes"] / 1e6,
                                                v["export_s"] + v["save_s"])
                for k, v in manifest["entries"].items())
            print(f"wrote serving artifact: {args.export_serving} ({sizes})")
        pp = get_model_preprocess_cfg(model)
        step = make_serve_classify(model, table, pp["mean"], pp["std"])
        return CudaGraphRunner(step), preprocess

    from xtagclip_tpu_torch.train.zero_shot import (
        build_zero_shot_classifier,
        make_eval_forward,
    )

    # the zero-shot [D, C] head is dead weight under --fusion-classify
    classifier = build_zero_shot_classifier(
        model, tokenizer, classnames=classnames, templates=templates)
    forward = make_eval_forward(model, fusion_scoring=args.fusion_scoring,
                                tagging=args.use_tagging)

    def step(images_u8):
        feats, logits, tags = forward(images_u8, classifier)
        return feats, tags, logits

    return CudaGraphRunner(step), preprocess


def main(argv=None):
    args = _parse_args(argv)
    names = _list_inputs(args)
    classnames, templates = _class_meta(args)
    if args.fusion_classify:
        args.use_tagging = True
    if args.serving_artifact:
        serve, preprocess, classnames = _from_artifact(args, classnames)
    else:
        serve, preprocess = _from_model(args, classnames, templates)

    from PIL import Image

    from xtagclip_tpu_torch.utils.assets import read_tag_list

    tag_list = read_tag_list()
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    bs = args.batch_size
    all_feats = [] if args.save_embed else None
    try:
        for start in range(0, len(names), bs):
            chunk = names[start:start + bs]
            imgs = np.stack([
                np.asarray(preprocess(Image.open(n).convert("RGB")))
                for n in chunk])
            if len(chunk) < bs:  # static shapes: pad, then drop on host
                pad = np.zeros((bs - len(chunk),) + imgs.shape[1:],
                               imgs.dtype)
                imgs = np.concatenate([imgs, pad])
            feats, tag_global, logits = serve(
                torch.from_numpy(imgs).to(args.device))
            logits = logits.float().cpu().numpy()[:len(chunk)]
            probs = np.exp(logits - logits.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            if all_feats is not None:
                all_feats.append(feats.float().cpu().numpy()[:len(chunk)])
            tags = None
            if args.use_tagging:
                tags = tag_global.cpu().numpy()[:len(chunk)]
            for j, name in enumerate(chunk):
                rec = {
                    "image": name,
                    "class": classnames[int(logits[j].argmax())],
                    "probs": {c: round(float(p), 4)
                              for c, p in zip(classnames, probs[j])},
                }
                if tags is not None:
                    rec["tags"] = [tag_list[t] for t in tags[j]]
                out.write(json.dumps(rec) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    if out is not sys.stdout:
        print(f"wrote {args.output} ({len(names)} predictions)")
    if all_feats is not None:
        np.savez(args.save_embed, image_features=np.concatenate(all_feats),
                 image_names=np.array(names))
        print(f"wrote {args.save_embed}")


if __name__ == "__main__":
    main()
