"""The XTag inference path on the card (port of examples/xtag_inference.py):

    python -m xtagclip_tpu_torch.examples.xtag_inference \\
        [--model ViT-B-32] [--pretrained laion400m_e32] [--batch-size 4] \\
        [--device cuda]

encode image -> tag head (44 label queries) -> per-category argmax ->
pseudo-prompt gather from the pre-tokenized table -> text tower over the
77-token prompts -> TQN fusion logits in both directions, in bf16 with the
kernels of both towers, on a seeded batch of synthetic inputs (standard
normal, in place of normalized images, as the JAX example does) scored
against class 0's prompts.
"""

import argparse

import numpy as np
import torch

from xtagclip_tpu_torch.factory import (
    cast_for_compute,
    create_model_and_transforms,
    get_tokenizer,
)
from xtagclip_tpu_torch.models.clip import num_combos
from xtagclip_tpu_torch.tokenize.prompts import PromptTable
from xtagclip_tpu_torch.train.metadata import SCAR_CLASSNAMES


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ViT-B-32")
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model, _, _ = create_model_and_transforms(
        args.model, args.pretrained, precision="bf16", device=args.device,
        use_tagging=True, use_fusion=True)
    cast_for_compute(model, torch.bfloat16)
    model.eval()
    tokenizer = get_tokenizer(args.model)

    # [templates, classes, combos, ctx], built once on the host
    table = torch.from_numpy(PromptTable(
        list(SCAR_CLASSNAMES), tokenizer=tokenizer).table.astype(
        np.int64)).to(args.device)
    print(f"prompt table: {tuple(table.shape)} ({num_combos()} tag combos)")

    b = args.batch_size
    sz = model.model_cfg["vision_cfg"].get("image_size", 224)
    h, w = (sz, sz) if isinstance(sz, int) else sz
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(b, h, w, 3)).astype(np.float32)).to(args.device,
                                                  torch.bfloat16)
    class_ids = torch.zeros(b, dtype=torch.long, device=args.device)
    with torch.no_grad():
        out = model(imgs, None, table, class_ids, 0, True)
    print("tag_logits:", tuple(out["tag_logits"].shape))
    print("tag_indices:", out["tag_indices"][0].cpu().numpy())
    print("fusion i2t:", tuple(out["i2t_cls"].shape),
          "t2i:", tuple(out["t2i_cls"].shape))


if __name__ == "__main__":
    main()
