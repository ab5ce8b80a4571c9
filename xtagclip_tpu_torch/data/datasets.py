"""Generic datasets: CSV (image + caption), synthetic, image folder,
PathMNIST (port of xtagclip_tpu/data/datasets.py).

Contracts mirror reference open_clip_train/data.py:29-47 (CsvDataset),
:476-523 (SyntheticDataset) and others/dataloader_other.py:16-60
(PathMNIST '{class}-{id}.ext' directory listing). CSVs are read with the
stdlib ``csv`` module and PIL is imported only where an image is opened
or made.
"""

from __future__ import annotations

import csv
import os

import numpy as np

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp",
)


def default_loader(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


class CsvDataset:
    """CSV of (image path, caption); returns (image, token_row)."""

    def __init__(self, input_filename, transforms, img_key, caption_key,
                 sep="\t", tokenizer=None):
        with open(input_filename, newline="") as f:
            rows = list(csv.DictReader(f, delimiter=sep))
        self.images = [r[img_key] for r in rows]
        self.captions = [r[caption_key] for r in rows]
        self.transforms = transforms
        self.tokenize = tokenizer

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, idx):
        image = self.transforms(default_loader(str(self.images[idx])))
        texts = self.tokenize([str(self.captions[idx])])[0]
        return image, np.asarray(texts, dtype=np.int32)


class SyntheticDataset:
    """Blank image + 'Dummy caption' (reference data.py:476-523): the
    train-loop smoke test that needs no data on disk. Without a transform
    the image is a black uint8 array and PIL is not needed."""

    def __init__(self, transform=None, image_size=(224, 224),
                 caption="Dummy caption", dataset_size: int = 100,
                 tokenizer=None):
        self.transform = transform
        self.image_size = image_size
        self.caption = caption
        self.dataset_size = dataset_size
        self.tokenize = tokenizer
        if transform is not None:
            from PIL import Image

            self.preprocessed = transform(Image.new("RGB", image_size))
        else:
            self.preprocessed = np.zeros((*image_size, 3), np.uint8)

    def __len__(self):
        return self.dataset_size

    def __getitem__(self, idx):
        texts = self.tokenize([self.caption])[0]
        return self.preprocessed, np.asarray(texts, dtype=np.int32)


class ImageFolderDataset:
    """torchvision.ImageFolder equivalent: root/class_x/img.ext."""

    def __init__(self, root, transform=None, loader=default_loader):
        self.root = root
        self.transform = transform
        self.loader = loader
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target


class PathMNISTDataset:
    """Flat directory of '{class}-{id}.tif' files (dataloader_other.py:16-60)."""

    def __init__(self, root, transform=None, target_transform=None,
                 loader=default_loader):
        self.root = root
        self.transform = transform
        self.target_transform = target_transform
        self.loader = loader
        samples = []
        for fname in os.listdir(root):
            if fname.lower().endswith(IMG_EXTENSIONS) and "-" in fname:
                samples.append((os.path.join(root, fname), fname.split("-")[0]))
        if not samples:
            raise RuntimeError(
                f"Found 0 files in {root}. Supported: {','.join(IMG_EXTENSIONS)}")
        classes = sorted({s[1] for s in samples})
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.imgs = [(p, self.class_to_idx[c]) for p, c in samples]

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, idx):
        path, target = self.imgs[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target
