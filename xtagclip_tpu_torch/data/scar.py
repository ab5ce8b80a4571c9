"""ScarDataset: the supervised data contract of XTag (port of
xtagclip_tpu/data/scar.py, reference others/dataloader_other.py:63-253).

- label_info.json-driven attribute mappings; CSV rows kept where
  ``Use == "yes"`` and every attribute column has a value;
- class multi-hot (3), attribute multi-hot (22 over categories
  [3,4,3,4,4,4]);
- 5 ground-truth prompt variants tokenized per item;
- optional bounding-box crop from bounding_box.json;
- returns (image, label(3,), additional(22,), prompt_tokens[5,ctx],
  class_word str, class_idx int).

The CSV is read with the stdlib ``csv`` module, not pandas. pandas'
``read_csv`` + ``dropna`` drops a row whose attribute cell is empty or
holds one of pandas' default NA words ("NaN", "NA", "null", ...); so does
this. Values are stripped and lowercased before
the mapping, and an unmapped value maps to -1, as in the JAX package.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

from xtagclip_tpu_torch.data.datasets import default_loader

CATEGORY_SIZE = [3, 4, 3, 4, 4, 4]
ADDITIONAL_COLUMNS = [
    "Width", "Color", "Pigmentation", "Surface", "Irregular_color",
    "Irregular_height",
]
CLASS_LIST = ["Others", "Hypertrophic scar", "Keloid scar"]

WIDTH_LABEL = ["Linear", "Widened", "Linear bulging"]
COLOR_LABEL = ["Normal", "Pink", "Red", "Purple"]
PIGMENTATION_LABEL = ["Normal", "Pigmented", "Hypopigmented"]
SURFACE_LABEL = ["Flat", "Hypertrophic", "Keloid", "Atrophic"]
IRREG_COLOR_LABEL = ["no", "mild", "moderate", "severe"]
IRREG_HEIGHT_LABEL = ["no", "mild", "moderate", "severe"]
_ATTR_LABELS = [WIDTH_LABEL, COLOR_LABEL, PIGMENTATION_LABEL, SURFACE_LABEL,
                IRREG_COLOR_LABEL, IRREG_HEIGHT_LABEL]

# GT prompt wording from dataloader_other.py:242-249
_GT_TEMPLATES = [
    "A {c} with a {t0} width, exhibiting a {t1} color and {t2} pigmentation. It has a {t3} surface, with {t4} irregular color and {t5} irregular height.",
    "This is an image of {c} with a {t0} width, exhibiting a {t1} color and {t2} pigmentation. It has a {t3} surface, with {t4} irregular color and {t5} irregular height.",
    "{c} with a {t0} width, exhibiting a {t1} color and {t2} pigmentation. It has a {t3} surface, with {t4} irregular color and {t5} irregular height presented in image",
    "a photo of {c} with a {t0} width, exhibiting a {t1} color and {t2} pigmentation. It has a {t3} surface, with {t4} irregular color and {t5} irregular height.",
    "A {c} photo, Width: {t0} width, Color: {t1} Color, Pigmentation: {t2} Pigmentation, Surface: {t3} Surface, Irregular color: {t4} Irregular Color, Irregular height: {t5} Irregular Height.",
]

# the strings pandas.read_csv reads as NaN by default (its na_values)
_NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})


def _is_na(value) -> bool:
    return value is None or value in _NA_VALUES


class ScarDataset:
    def __init__(self, root: str, csv_file=None, transform=None,
                 target_transform=None, additional_labels_transform=None,
                 loader=default_loader, is_train: bool = True,
                 tokenizer=None, prompt_template_setting=None):
        self.root = root
        self.transform = transform
        self.target_transform = target_transform
        self.additional_labels_transform = additional_labels_transform
        self.loader = loader
        self.is_train = is_train
        self.tokenizer = tokenizer

        with open(os.path.join(root, "label_info.json"), "r") as f:
            label_info = json.load(f)

        self.classes = ["1. Others", "2. Hypertrophic scar", "3. Keloid scar"]
        self.num_classes = len(self.classes)
        self.class_to_idx = {i + 1: i for i in range(self.num_classes)}

        if csv_file is None:
            suffix = "train" if is_train else "val"
            csv_file = os.path.join(root, f"updated_scar_label_{suffix}.csv")
        self._load(label_info, csv_file)
        self.bounding_box = self._load_bounding_box(
            os.path.join(root, "bounding_box.json"))

    def _load_bounding_box(self, path):
        try:
            with open(path, "r") as f:
                data = json.load(f)
        except FileNotFoundError:
            return None
        for shape in data.get("shapes", []):
            if shape.get("label") == "scar":
                (x1, y1), (x2, y2) = shape["points"]
                return (int(min(x1, x2)), int(min(y1, y2)),
                        int(max(x1, x2)), int(max(y1, y2)))
        return None

    def _process_class_label(self, x):
        x = str(x).strip()
        if "," in x:
            return [self.class_to_idx[int(i.strip())] for i in x.split(",")]
        try:
            xi = int(x)
        except ValueError:
            xi = int(x.split(".")[0])
        return [self.class_to_idx[xi]]

    def _load(self, label_info, csv_file):
        self.additional_mappings = {
            col: {val.lower(): idx for idx, val in enumerate(label_info[col])}
            for col in ADDITIONAL_COLUMNS if col in label_info}
        with open(csv_file, newline="") as f:
            reader = csv.DictReader(f)
            columns = reader.fieldnames or []
            rows = list(reader)
        if "Use" in columns:
            rows = [r for r in rows if r["Use"] == "yes"]
        present = [c for c in ADDITIONAL_COLUMNS if c in columns]
        rows = [r for r in rows if not any(_is_na(r[c]) for c in present)]

        self.imgs = [os.path.join(self.root, r["Name"].strip()) for r in rows]
        self.labels = []
        for r in rows:
            mapped = {}
            for col in ADDITIONAL_COLUMNS:
                if col in columns and col in self.additional_mappings:
                    mapped[col] = self.additional_mappings[col].get(
                        r[col].strip().lower(), -1)
                else:
                    mapped[col] = -1
            self.labels.append((self._process_class_label(r["Class"]), mapped))

    @staticmethod
    def dict_to_vector(additional_labels) -> np.ndarray:
        vec = np.zeros(sum(CATEGORY_SIZE), np.float32)
        pos = 0
        for i, col in enumerate(ADDITIONAL_COLUMNS):
            size = CATEGORY_SIZE[i]
            sel = additional_labels[col]
            if 0 <= sel < size:
                vec[pos + sel] = 1.0
            pos += size
        return vec

    @staticmethod
    def get_class_words(class_label) -> str:
        if len(class_label) == 1:
            return CLASS_LIST[class_label[0]]
        return " , ".join(CLASS_LIST[i] for i in class_label)

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, index):
        class_label, additional_labels = self.labels[index]
        image = self.loader(self.imgs[index])
        if self.bounding_box is not None:
            image = image.crop(self.bounding_box)
        if self.transform is not None:
            image = self.transform(image)
        if self.target_transform is not None:
            class_label = self.target_transform(class_label)
        if self.additional_labels_transform is not None:
            additional_labels = self.additional_labels_transform(
                additional_labels)

        label_vec = np.zeros(self.num_classes, np.float32)
        label_vec[class_label] = 1.0
        additional_vec = self.dict_to_vector(additional_labels)

        # reference parity (dataloader_other.py:235-240): an unmapped value
        # is -1, which indexes the LAST label word in the caption while
        # dict_to_vector leaves that group all-zero
        attr_words = [_ATTR_LABELS[i][additional_labels[c]]
                      for i, c in enumerate(ADDITIONAL_COLUMNS)]
        class_word = self.get_class_words(class_label)
        prompts = [
            t.format(c=class_word, t0=attr_words[0], t1=attr_words[1],
                     t2=attr_words[2], t3=attr_words[3], t4=attr_words[4],
                     t5=attr_words[5])
            for t in _GT_TEMPLATES
        ]
        tokens = np.stack([np.asarray(self.tokenizer(p)[0], np.int32)
                           for p in prompts])
        return (image, label_vec, additional_vec, tokens, class_word,
                int(class_label[0]))
