"""Dataset dispatch: get_data / get_data_other (port of
xtagclip_tpu/data/registry.py; reference open_clip_train/data.py:526-564
and others/data_other.py:93-115).

The train split is divided among the data ranks (``args.data_rank`` of
``args.data_size``, set by core/mesh.py ``init_distributed``: each rank
reads ``idx[rank::world]`` of the epoch's order, and the ranks of a
model group read the same rows); the val and eval
splits are read whole by every rank, as in JAX (registry.py:25-35).
``--dataset-type webdataset`` (or ``auto`` on a ``.tar``) reads tar shards
(data/wds.py).
"""

from __future__ import annotations

from xtagclip_tpu_torch.core.mesh import data_rank_of, data_size_of
from xtagclip_tpu_torch.data.datasets import (
    CsvDataset,
    ImageFolderDataset,
    PathMNISTDataset,
    SyntheticDataset,
)
from xtagclip_tpu_torch.data.loader import DataInfo, DataLoader
from xtagclip_tpu_torch.data.scar import ScarDataset
from xtagclip_tpu_torch.data.wds import get_wds_dataset


def _loader(dataset, args, is_train: bool) -> DataInfo:
    return DataInfo(dataloader=DataLoader(
        dataset, batch_size=args.batch_size, shuffle=is_train,
        drop_last=is_train, num_workers=getattr(args, "workers", 8),
        seed=getattr(args, "seed", 0),
        rank=data_rank_of(args) if is_train else 0,
        world_size=data_size_of(args) if is_train else 1))


def get_csv_dataset(args, preprocess_fn, is_train, epoch=0, tokenizer=None):
    input_filename = args.train_data if is_train else args.val_data
    assert input_filename
    dataset = CsvDataset(input_filename, preprocess_fn,
                         img_key=args.csv_img_key,
                         caption_key=args.csv_caption_key,
                         sep=args.csv_separator, tokenizer=tokenizer)
    return _loader(dataset, args, is_train)


def get_synthetic_dataset(args, preprocess_fn, is_train, epoch=0,
                          tokenizer=None):
    cfg = getattr(preprocess_fn, "cfg", None)
    hw = cfg.size_hw if cfg is not None else (224, 224)
    dataset = SyntheticDataset(transform=preprocess_fn, image_size=hw,
                               dataset_size=args.train_num_samples or 512,
                               tokenizer=tokenizer)
    return _loader(dataset, args, is_train)


def get_dataset_fn(data_path, dataset_type):
    if dataset_type == "synthetic":
        return get_synthetic_dataset
    if dataset_type == "csv":
        return get_csv_dataset
    if dataset_type == "webdataset":
        return get_wds_dataset
    if dataset_type == "auto":
        ext = (data_path or "").split(".")[-1]
        if ext in ("csv", "tsv"):
            return get_csv_dataset
        if ext in ("tar",):
            return get_wds_dataset
        raise ValueError(f"cannot infer dataset type from {data_path}")
    raise ValueError(f"Unsupported dataset type: {dataset_type}")


def get_data(args, preprocess_fns, epoch: int = 0, tokenizer=None) -> dict:
    preprocess_train, preprocess_val = preprocess_fns
    data = {}
    if args.train_data or args.dataset_type == "synthetic":
        data["train"] = get_dataset_fn(args.train_data, args.dataset_type)(
            args, preprocess_train, is_train=True, epoch=epoch,
            tokenizer=tokenizer)
    if args.val_data:
        data["val"] = get_dataset_fn(args.val_data, args.dataset_type)(
            args, preprocess_val, is_train=False, tokenizer=tokenizer)
    for key, path in (("imagenet-val", getattr(args, "imagenet_val", None)),
                      ("imagenet-v2", getattr(args, "imagenet_v2", None))):
        if path:
            data[key] = _loader(ImageFolderDataset(
                path, transform=preprocess_val), args, is_train=False)
    return data


def get_scardata(args, preprocess, is_train: bool, tokenizer=None) -> DataInfo:
    root = args.train_data if is_train else args.val_data
    csv_file = getattr(args, "scar_train_csv" if is_train else "scar_val_csv",
                       None)
    ds = ScarDataset(root, csv_file=csv_file, transform=preprocess,
                     is_train=is_train, tokenizer=tokenizer,
                     prompt_template_setting=getattr(
                         args, "prompt_template_setting", None))
    return _loader(ds, args, is_train)


def get_pathmnist(args, preprocess, split_path, tokenizer=None) -> DataInfo:
    ds = PathMNISTDataset(split_path, transform=preprocess)
    return _loader(ds, args, is_train=False)


def get_data_other(args, preprocess_fns, epoch: int = 0,
                   tokenizer=None) -> dict:
    """Path-keyed dispatch (reference data_other.py:93-115): substrings
    'scar' / 'PathMNIST' / 'MedicalMNIST' in the data paths pick the
    dataset."""
    preprocess_train, preprocess_val = preprocess_fns
    data = {}
    train_path = args.train_data or ""
    val_path = args.val_data or ""
    if "scar" in train_path.lower():
        data["scar_train"] = get_scardata(args, preprocess_train,
                                          is_train=True, tokenizer=tokenizer)
    if "scar" in val_path.lower():
        data["scar_val"] = get_scardata(args, preprocess_val, is_train=False,
                                        tokenizer=tokenizer)
    if "pathmnist" in val_path.lower():
        data["PathMNIST_val"] = get_pathmnist(args, preprocess_val, val_path,
                                              tokenizer=tokenizer)
    if "medicalmnist" in val_path.lower():
        ds = ImageFolderDataset(val_path, transform=preprocess_val)
        data["MedicalMNIST"] = _loader(ds, args, is_train=False)
    if not data:
        raise ValueError(
            f"get_data_other: no dataset recognised in paths "
            f"train={train_path!r} val={val_path!r}")
    return data
