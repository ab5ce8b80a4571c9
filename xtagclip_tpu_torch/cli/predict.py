"""Batch inference CLI, the ``--fusion-classify`` serving path
(port of xtagclip_tpu/cli/predict.py).

    python -m xtagclip_tpu_torch.cli.predict --model ViT-B-32 \
        --fusion-classify --input /dir/of/images --output preds.jsonl

Images are decoded and center-cropped on the host to uint8, normalized on
the card, and classified by TQN fusion over the precomputed pseudo-prompt
space (serving.py). Not ported yet, each failing with a clear error: the
zero-shot (non-fusion) path, ``--serving-artifact``, ``--export-serving``,
and loading weights (``--pretrained``/``--resume``); the weights are a
seeded random init.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def _parse_args(argv=None):
    p = argparse.ArgumentParser("xtagclip_tpu_torch prediction")
    p.add_argument("--model", default="ViT-B-32")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--input", nargs="+", required=True,
                   help="image files, a directory, or a .csv")
    p.add_argument("--csv-img-key", default="filepath")
    p.add_argument("--dataset", default="scar",
                   choices=("scar", "pathmnist", "medicalmnist"),
                   help="class-name set")
    p.add_argument("--classnames", default=None,
                   help="comma-separated override of --dataset class names")
    p.add_argument("--fusion-classify", action="store_true",
                   help="classify via TQN fusion over the precomputed "
                        "pseudo-prompt space")
    p.add_argument("--prompt-template-setting", default="sentence_1")
    p.add_argument("--serving-artifact", default=None)
    p.add_argument("--export-serving", default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--precision", default="bf16")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    p.add_argument("--output", default="-", help="JSONL path ('-' = stdout)")
    p.add_argument("--save-embed", default=None,
                   help="optional .npz with fp32 image features")
    return p.parse_args(argv)


def _not_ported(args):
    if args.serving_artifact or args.export_serving:
        return "--serving-artifact / --export-serving"
    if args.pretrained or args.resume:
        return "--pretrained / --resume (checkpoint loading)"
    if not args.fusion_classify:
        return "the zero-shot path (run with --fusion-classify)"
    return None


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
                            f"'{args.csv_img_key}' column; set --csv-img-key")
                    names.append(row[args.csv_img_key])
        else:
            names.append(item)
    if not names:
        raise SystemExit("predict: no input images found")
    return names


def _classnames(args):
    from xtagclip_tpu_torch.train import metadata as M

    table = {"scar": M.SCAR_CLASSNAMES, "pathmnist": M.PATHMNIST_CLASSNAMES,
             "medicalmnist": M.MEDICALMNIST_CLASSNAMES}
    if args.classnames:
        return [c.strip() for c in args.classnames.split(",")]
    return list(table[args.dataset])


def main(argv=None):
    args = _parse_args(argv)
    missing = _not_ported(args)
    if missing:
        raise SystemExit(f"predict: {missing} is not ported yet")

    from PIL import Image

    from xtagclip_tpu_torch.factory import (
        cast_for_compute,
        create_model_and_transforms,
        get_cast_dtype,
        get_tokenizer,
    )
    from xtagclip_tpu_torch.ops.preprocess import normalize_images
    from xtagclip_tpu_torch.serving import (
        make_xtag_serve_step,
        precompute_prompt_features,
    )
    from xtagclip_tpu_torch.tokenize.prompts import PromptTable
    from xtagclip_tpu_torch.utils.assets import read_tag_list

    names = _list_inputs(args)
    classnames = _classnames(args)
    model, _, preprocess = create_model_and_transforms(
        args.model, precision=args.precision, device=args.device,
        use_tagging=True, use_fusion=True)
    dtype = get_cast_dtype(args.precision)
    cast_for_compute(model, dtype)
    ptable = PromptTable(classnames, tokenizer=get_tokenizer(args.model),
                         templates=[args.prompt_template_setting]).table
    serve = make_xtag_serve_step(
        model, precompute_prompt_features(model, ptable, template_id=0))
    tag_list = read_tag_list()

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    all_feats = [] if args.save_embed else None
    try:
        for start in range(0, len(names), args.batch_size):
            chunk = names[start:start + args.batch_size]
            imgs = np.stack([np.asarray(preprocess(Image.open(n)))
                             for n in chunk])
            images = normalize_images(
                torch.from_numpy(imgs).to(args.device), dtype=dtype)
            feats, tag_global, logits = serve(images)
            logits = logits.float().cpu().numpy()
            probs = np.exp(logits - logits.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            if all_feats is not None:
                all_feats.append(feats.float().cpu().numpy())
            tags = tag_global.cpu().numpy()
            for j, name in enumerate(chunk):
                rec = {
                    "image": name,
                    "class": classnames[int(logits[j].argmax())],
                    "probs": {c: round(float(p), 4)
                              for c, p in zip(classnames, probs[j])},
                    "tags": [tag_list[t] for t in tags[j]],
                }
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
