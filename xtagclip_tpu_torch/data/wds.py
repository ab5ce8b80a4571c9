"""WebDataset tar shards, read with the standard library (port of
xtagclip_tpu/data/wds.py; reference open_clip_train/data.py:74-443).

``--dataset-type webdataset`` (the CLIPA recipe's scripts/h14_*.sh):
brace-expanded shard lists joined by '::', a per-epoch seeded shard
shuffle (detshuffle2), the node split, (image, caption) samples grouped by
key with a log-and-continue handler for corrupt members, optional weighted
resampling (``--dataset-resampled`` with
``--train-data-upsampling-factors``), a shuffle buffer, per-rank ceiling
val batches and a partial last val batch. The reader, the sample order and
the batches are the JAX package's.

``WdsLoader`` yields (uint8 [B, H, W, 3] images, int32 [B, ctx] ids)
batches, the form of data/loader.py's, so the trainer's step and the
device normalize see what they see from any other dataset. A background
thread decodes up to ``PREFETCH`` batches ahead of the consumer, one
sample at a time in stream order, so the seeded crops and shuffle draws
are those of the JAX loader. With ``--native-decode`` the JPEG decode and
crop run in the native library (data/native.py: a random resized crop for
training, resize + center crop for eval); a sample it cannot decode, a
pixel augmentation it does not implement, a non-shortest eval resize mode
or a library that is not built all take the PIL transform, as in JAX.
``decode`` names the route and ``decoded`` counts the samples each route
decoded.
"""

from __future__ import annotations

import io
import itertools
import json
import logging
import math
import os
import random
import re
import tarfile
import warnings
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from xtagclip_tpu_torch.data.loader import DataInfo, background

IMG_EXTS = ("jpg", "jpeg", "png", "webp", "bmp", "tif", "tiff", "ppm", "pgm")
TXT_EXTS = ("txt", "text", "caption")


def expand_urls(urls) -> List[str]:
    """Brace expansion: 'shards-{0000..0009}.tar' -> 10 paths; '::' joins."""
    if isinstance(urls, (list, tuple)):
        return list(
            itertools.chain.from_iterable(expand_urls(u) for u in urls)
        )
    out = []
    for part in str(urls).split("::"):
        m = re.search(r"\{(\d+)\.\.(\d+)\}", part)
        if m:
            lo, hi = m.group(1), m.group(2)
            width = len(lo)
            for i in range(int(lo), int(hi) + 1):
                out.append(part[: m.start()] + str(i).zfill(width)
                           + part[m.end():])
        else:
            out.append(part)
    return out


def get_dataset_size(shards) -> tuple:
    """Total sample count from sibling __len__/sizes.json files
    (reference data.py:74-97)."""
    shards_list = expand_urls(shards)
    dirname = os.path.dirname(shards_list[0]) if shards_list else ""
    total = None
    sizes_path = os.path.join(dirname, "sizes.json")
    len_path = os.path.join(dirname, "__len__")
    if os.path.exists(sizes_path):
        with open(sizes_path) as f:
            sizes = json.load(f)
        total = sum(int(sizes.get(os.path.basename(s), 0))
                    for s in shards_list)
    elif os.path.exists(len_path):
        with open(len_path) as f:
            total = int(f.read())
    return total, len(shards_list)


def log_and_continue(exn) -> bool:
    """Corrupt-sample handler (reference data.py:180-185)."""
    logging.warning("Handling webdataset error (%r). Ignoring.", exn)
    return True


def _iter_tar_samples(path: str, handler=log_and_continue):
    """Group tar members by key -> dict of ext -> bytes."""
    try:
        tf = tarfile.open(path)
    except (OSError, tarfile.TarError) as e:
        if handler(e):
            return
        raise
    current_key = None
    sample = {}
    try:
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            key, _, ext = name.rpartition(".")
            if key != current_key:
                if current_key is not None and sample:
                    yield current_key, sample
                current_key, sample = key, {}
            try:
                sample[ext.lower()] = tf.extractfile(member).read()
            except (OSError, tarfile.TarError) as e:
                if not handler(e):
                    raise
        if current_key is not None and sample:
            yield current_key, sample
    finally:
        tf.close()


@dataclass
class WdsConfig:
    shards: List[str]
    resampled: bool = False
    weights: Optional[List[float]] = None
    seed: int = 0
    epoch: int = 0
    rank: int = 0
    world_size: int = 1
    worker_id: int = 0
    num_workers_split: int = 1


class WebDatasetReader:
    """Iterable (image_bytes, caption) stream over tar shards."""

    def __init__(self, cfg: WdsConfig, handler=log_and_continue):
        self.cfg = cfg
        self.handler = handler
        self._epoch = cfg.epoch

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _shards_for_epoch(self) -> List[str]:
        cfg = self.cfg
        rng = random.Random(cfg.seed + self._epoch)  # detshuffle2 semantics
        if cfg.resampled:
            # per-rank/worker seed (reference ResampledShards2 worker_seed):
            # identical seeds would make every rank/worker draw the SAME shard
            # sequence and train on duplicated data.
            rng = random.Random(
                (cfg.seed, self._epoch, cfg.rank, cfg.worker_id).__hash__()
            )
            weights = cfg.weights or [1.0] * len(cfg.shards)
            n = max(len(cfg.shards), 1)
            return rng.choices(cfg.shards, weights=weights, k=n)
        shards = list(cfg.shards)
        rng.shuffle(shards)
        # split_by_node then split_by_worker
        shards = shards[cfg.rank :: max(cfg.world_size, 1)]
        shards = shards[cfg.worker_id :: max(cfg.num_workers_split, 1)]
        return shards

    def __iter__(self) -> Iterator[tuple]:
        for shard in self._shards_for_epoch():
            for key, sample in _iter_tar_samples(shard, self.handler):
                img = txt = None
                for ext, data in sample.items():
                    if ext in IMG_EXTS:
                        img = data
                    elif ext in TXT_EXTS:
                        txt = data.decode("utf-8", errors="replace")
                    elif ext == "json":
                        try:
                            meta = json.loads(data)
                            txt = txt or meta.get("caption") or meta.get("txt")
                        except json.JSONDecodeError:
                            pass
                if img is not None and txt is not None:
                    yield key, img, txt


class WdsLoader:
    """Decoding + batching loader over a WebDatasetReader (module doc)."""

    PREFETCH = 2  # decoded batches queued ahead of the consumer

    def __init__(self, reader: WebDatasetReader, transform, tokenizer,
                 batch_size: int, num_batches: int, shuffle_buffer: int = 1000,
                 seed: int = 0, native_decode: bool = False,
                 native_target: int = 224, native_train: bool = False,
                 loop_stream: bool = True):
        self.reader = reader
        self.transform = transform
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.num_samples = num_batches * batch_size
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self._epoch = 0
        self.native_target = native_target
        self.native_train = native_train
        self.loop_stream = loop_stream
        self.native_decode = False
        self.decode = "PIL"
        self.decoded = {"native": 0, "PIL": 0}
        if native_decode:
            self.native_decode, self.decode = self._native_route(transform)
        logging.info("webdataset loader: %s decode", self.decode)
        self.native_rrc_scale = (0.9, 1.0)
        self.native_rrc_ratio = (3.0 / 4.0, 4.0 / 3.0)
        if self.native_decode and native_train and transform is not None:
            aug = getattr(transform, "aug", None)
            if aug is not None:
                self.native_rrc_scale = tuple(aug.scale)
                if aug.ratio is not None:
                    self.native_rrc_ratio = tuple(aug.ratio)

    def _native_route(self, transform):
        """(use the native decode, the route's name): the native train path
        is a random resized crop only, and the native eval path a
        shortest-edge resize + center crop, so a pixel augmentation or
        another eval resize mode takes the PIL transform (JAX
        wds.py:209-250)."""
        from xtagclip_tpu_torch.data.native import decode_route

        route = decode_route()
        if route != "native":
            warnings.warn(f"--native-decode: {route}")
            return False, route
        aug = getattr(transform, "aug", None)
        if self.native_train and aug is not None and (
                aug.color_jitter is not None or aug.color_jitter_prob
                or aug.gray_scale_prob):
            why = ("color_jitter/gray_scale augmentations have no native "
                   "implementation")
            warnings.warn(f"--native-decode: {why}; using the PIL transform "
                          "for training samples")
            return False, f"PIL ({why})"
        cfg = getattr(transform, "cfg", None)
        if not self.native_train and cfg is not None and getattr(
                cfg, "resize_mode", "shortest") != "shortest":
            why = (f"resize_mode={cfg.resize_mode!r} has no native "
                   "implementation")
            warnings.warn(f"--native-decode: {why}; using the PIL transform "
                          "for eval")
            return False, f"PIL ({why})"
        return True, "native"

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        self.reader.set_epoch(epoch)

    def __len__(self):
        return self.num_batches

    def _decode_one(self, img_bytes, np_rng):
        """One sample's uint8 crop: the native decode where it is on and
        succeeds, else the PIL transform."""
        from PIL import Image

        arr = None
        if self.native_decode and self.native_train:
            from xtagclip_tpu_torch.data.native import (
                decode_rrc,
                sample_rrc_boxes,
            )

            box = sample_rrc_boxes(np_rng, 1, scale=self.native_rrc_scale,
                                   ratio=self.native_rrc_ratio)[0]
            arr = decode_rrc(img_bytes, self.native_target, box)
        elif self.native_decode:
            from xtagclip_tpu_torch.data.native import decode_resize

            arr = decode_resize(img_bytes, self.native_target)
        if arr is not None:
            self.decoded["native"] += 1
            return arr
        # a non-JPEG member or a failed native decode: the PIL transform
        # (webdatasets mix formats; no sample is dropped silently)
        arr = self.transform(Image.open(io.BytesIO(img_bytes)).convert("RGB"))
        self.decoded["PIL"] += 1
        return arr

    def _decoded(self):
        rng = random.Random(self.seed + self._epoch)
        np_rng = np.random.default_rng(self.seed + self._epoch)
        buf = []
        for _key, img_bytes, txt in self.reader:
            try:
                arr = self._decode_one(img_bytes, np_rng)
            except OSError as e:
                if log_and_continue(e):
                    continue
                raise
            tokens = np.asarray(self.tokenizer([txt])[0], np.int32)
            if self.shuffle_buffer > 1:
                buf.append((arr, tokens))
                if len(buf) >= self.shuffle_buffer:
                    yield buf.pop(rng.randrange(len(buf)))
            else:
                yield arr, tokens
        rng.shuffle(buf)
        yield from buf

    def _batches(self):
        it = self._decoded()
        produced = 0
        exhausted = False
        while produced < self.num_batches and not exhausted:
            imgs, txts = [], []
            for _ in range(self.batch_size):
                try:
                    a, t = next(it)
                except StopIteration:
                    if not self.loop_stream:
                        exhausted = True  # val: stop at the stream's end
                        break
                    it = self._decoded()  # train: loop the shards
                    try:
                        a, t = next(it)
                    except StopIteration:
                        raise RuntimeError(
                            "webdataset stream is empty for this rank/worker "
                            "— fewer shards than ranks x workers, or every "
                            "sample failed to decode") from None
                imgs.append(a)
                txts.append(t)
            if imgs:
                produced += 1
                yield np.stack(imgs), np.stack(txts)
            elif produced == 0 and exhausted:
                raise RuntimeError(
                    "webdataset stream yielded no samples — empty shards or "
                    "every sample failed to decode")

    def __iter__(self):
        return background(self._batches, self.PREFETCH)


def get_wds_dataset(args, preprocess_fn, is_train, epoch=0, tokenizer=None):
    """The webdataset loader of ``--train-data`` / ``--val-data`` (JAX
    wds.py:339-409; reference get_wds_dataset, data.py:328-443)."""
    input_shards = args.train_data if is_train else args.val_data
    assert input_shards
    shards = expand_urls(input_shards)
    num_samples = (args.train_num_samples if is_train
                   else args.val_num_samples)
    if not num_samples:
        num_samples, _ = get_dataset_size(input_shards)
        if not num_samples:
            if is_train:
                raise RuntimeError(
                    "Currently, the number of dataset samples must be "
                    "specified for the training dataset. Please specify it "
                    "via `--train-num-samples`.")
            num_samples = 0

    world = getattr(args, "world_size", 1)
    rank = getattr(args, "rank", 0)
    if is_train:
        global_batch = args.batch_size * max(world, 1)
        num_batches = max(1, num_samples // global_batch) if num_samples else 1
    else:
        # the val reader is unsplit (every process sees the whole set):
        # batches are a per-rank ceiling, and the loader stops at the
        # stream's end, so an over-estimate duplicates no sample
        num_batches = (math.ceil(num_samples / args.batch_size)
                       if num_samples else 1)

    weights = None
    if is_train and getattr(args, "train_data_upsampling_factors", None):
        # one factor per '::' source, expanded to each of its shards
        src_weights = [float(w) for w in
                       args.train_data_upsampling_factors.split("::")]
        sources = (list(input_shards)
                   if isinstance(input_shards, (list, tuple))
                   else str(input_shards).split("::"))
        if len(src_weights) != len(sources):
            raise ValueError(
                f"--train-data-upsampling-factors has {len(src_weights)} "
                f"entries for {len(sources)} '::'-separated sources")
        weights = []
        for src, w in zip(sources, src_weights):
            weights.extend([w] * len(expand_urls(src)))

    reader = WebDatasetReader(WdsConfig(
        shards=shards,
        resampled=bool(getattr(args, "dataset_resampled", False)),
        weights=weights, seed=getattr(args, "seed", 0), epoch=epoch,
        rank=rank if is_train else 0, world_size=world if is_train else 1))
    native = bool(getattr(args, "native_decode", False))
    native_target = 224
    if native and getattr(preprocess_fn, "cfg", None) is not None:
        native_target = preprocess_fn.cfg.size_hw[0]
    loader = WdsLoader(
        reader, preprocess_fn, tokenizer, args.batch_size, num_batches,
        shuffle_buffer=1000 if is_train else 1,
        seed=getattr(args, "seed", 0), native_decode=native,
        native_target=native_target, native_train=is_train,
        loop_stream=is_train)
    return DataInfo(dataloader=loader)
