"""The port's webdataset input (data/wds.py) against the JAX package's, on
the CPU: tests/test_wds.py's ten cases, each run through both packages on
the same tar shards written to ``tmp_path``.

Bars: the reader's keys, the shard order per epoch and per rank, and the
loader's batches equal JAX's exactly (images as uint8: JAX's transforms
with ``normalize_host=False``, which is what the port's always yield; ids
as int32); the native decode is the same library in both (uint8 equal);
``cli.main`` on the shards trains from one JAX-exported ``.pt`` with the
same per-step losses as JAX's CLI within 1e-3 (fp32).
"""

import io
import json
import logging
import os
import re
import tarfile
import types

import numpy as np
import pytest
from PIL import Image

from xtagclip_tpu.data import wds as jwds
from xtagclip_tpu.data.transforms import PreprocessCfg as JCfg
from xtagclip_tpu.data.transforms import TrainTransform as JTrain
from xtagclip_tpu.data.transforms import image_transform_eval as j_eval
from xtagclip_tpu.data.transforms import image_transform_train as j_train
from xtagclip_tpu.tokenize.bpe import SimpleTokenizer as JTok
from xtagclip_tpu_torch.data import native as pnative
from xtagclip_tpu_torch.data import wds as pwds
from xtagclip_tpu_torch.data.transforms import PreprocessCfg as PCfg
from xtagclip_tpu_torch.data.transforms import TrainTransform as PTrain
from xtagclip_tpu_torch.data.transforms import image_transform_eval as p_eval
from xtagclip_tpu_torch.data.transforms import image_transform_train as p_train
from xtagclip_tpu_torch.tokenize.bpe import SimpleTokenizer as PTok
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401


def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _make_shard(path, n, prefix, corrupt_member=False):
    """tests/test_wds.py's shard: n seeded 16x16 PNGs with captions, and
    a member that is not an image."""
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            key = f"{prefix}{i:04d}"
            img = Image.fromarray((np.random.default_rng(i).random(
                (16, 16, 3)) * 255).astype("uint8"))
            buf = io.BytesIO()
            img.save(buf, "PNG")
            _add(tf, f"{key}.png", buf.getvalue())
            _add(tf, f"{key}.txt", f"caption {prefix}{i}".encode())
        if corrupt_member:
            _add(tf, "broken.png", b"not an image")
            _add(tf, "broken.txt", b"broken caption")


def _make_jpeg_shard(path, n, hw=(48, 64), seed=0):
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            img = Image.fromarray((np.random.default_rng(seed + i).random(
                (*hw, 3)) * 255).astype("uint8"))
            buf = io.BytesIO()
            img.save(buf, "JPEG", quality=92)
            _add(tf, f"j{i:04d}.jpg", buf.getvalue())
            _add(tf, f"j{i:04d}.txt", f"jpeg caption {i}".encode())


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("wds")
    for s in range(3):
        _make_shard(str(d / f"data-{s:04d}.tar"), 8, f"s{s}-",
                    corrupt_member=(s == 1))
    return str(d)


def _paths(shards):
    return jwds.expand_urls(os.path.join(shards, "data-{0000..0002}.tar"))


def _same_batches(port, jax):
    port, jax = list(port), list(jax)
    assert len(port) == len(jax)
    for (pi, pt), (ji, jt) in zip(port, jax):
        assert pi.dtype == ji.dtype == np.uint8
        np.testing.assert_array_equal(pi, ji)
        assert pt.dtype == jt.dtype == np.int32
        np.testing.assert_array_equal(pt, jt)
    return port


@pytest.mark.parametrize("urls", ["/x/data-{0000..0002}.tar", "a.tar::b.tar",
                                  ["/y/s-{08..11}.tar", "c.tar"], "plain.tar"])
def test_expand_urls(urls):
    assert pwds.expand_urls(urls) == jwds.expand_urls(urls)
    assert pwds.expand_urls("/x/data-{0000..0002}.tar") == [
        "/x/data-0000.tar", "/x/data-0001.tar", "/x/data-0002.tar"]


def test_reader_and_corruption_tolerance(shards, tmp_path):
    paths = _paths(shards)
    reader = pwds.WebDatasetReader(pwds.WdsConfig(shards=paths, seed=3))
    samples = list(reader)
    want = list(jwds.WebDatasetReader(jwds.WdsConfig(shards=paths, seed=3)))
    assert len(samples) == 25  # 24 good + the 'broken' key, yielded raw
    assert samples == want
    again = pwds.WebDatasetReader(pwds.WdsConfig(shards=paths, seed=3))
    assert [s[0] for s in again] == [s[0] for s in samples]
    reader.set_epoch(1)
    jreader = jwds.WebDatasetReader(jwds.WdsConfig(shards=paths, seed=3))
    jreader.set_epoch(1)
    assert [s[0] for s in reader] == [s[0] for s in jreader]
    assert [s[0] for s in reader] != [s[0] for s in samples]
    # a shard that cannot be opened is logged and skipped
    missing = [str(tmp_path / "missing.tar"), paths[2]]
    tol = pwds.WebDatasetReader(pwds.WdsConfig(shards=missing))
    jtol = jwds.WebDatasetReader(jwds.WdsConfig(shards=missing))
    assert [s[0] for s in tol] == [s[0] for s in jtol]
    assert len([s for s in tol]) == 8


def test_node_split(shards):
    paths = _paths(shards)
    seen = []
    for rank in range(3):
        cfg = dict(shards=paths, seed=0, rank=rank, world_size=3)
        keys = [s[0] for s in pwds.WebDatasetReader(pwds.WdsConfig(**cfg))]
        assert keys == [s[0] for s in
                        jwds.WebDatasetReader(jwds.WdsConfig(**cfg))]
        seen.append({k.split("-")[0] for k in keys if k.startswith("s")})
    # each rank reads exactly one shard, and together they read all three
    assert all(len(s) == 1 for s in seen)
    assert set.union(*seen) == {"s0", "s1", "s2"}


def test_wds_loader_batches(shards):
    paths = _paths(shards)
    kw = dict(batch_size=4, num_batches=7, shuffle_buffer=8)
    port = pwds.WdsLoader(pwds.WebDatasetReader(pwds.WdsConfig(shards=paths)),
                          p_eval(PCfg(size=16)), PTok(), **kw)
    jax = jwds.WdsLoader(jwds.WebDatasetReader(jwds.WdsConfig(shards=paths)),
                         j_eval(JCfg(size=16), normalize_host=False), JTok(),
                         **kw)
    batches = _same_batches(port, jax)
    assert len(batches) == 7  # the stream loops to fill (train contract)
    imgs, txts = batches[0]
    assert imgs.shape == (4, 16, 16, 3) and txts.shape == (4, 77)
    assert port.decode == "PIL" and port.decoded["PIL"] >= 28


def test_wds_loader_native_train_decode(tmp_path):
    """--native-decode's train path: the native random resized crop with
    boxes from the per-epoch seeded generator, uint8 equal to JAX's (the
    same library); the crops change with the epoch."""
    if not pnative.native_available():
        pytest.skip(f"native library: {pnative.decode_route()}")
    shard = str(tmp_path / "jpeg-0000.tar")
    _make_jpeg_shard(shard, 12)
    kw = dict(batch_size=4, num_batches=2, shuffle_buffer=1,
              native_decode=True, native_target=32, native_train=True)
    port = pwds.WdsLoader(pwds.WebDatasetReader(pwds.WdsConfig(
        shards=[shard], seed=0)), PTrain(PCfg(size=32)), PTok(), **kw)
    jax = jwds.WdsLoader(jwds.WebDatasetReader(jwds.WdsConfig(
        shards=[shard], seed=0)), JTrain(JCfg(size=32), normalize_host=False),
        JTok(), **kw)
    batches = _same_batches(port, jax)
    assert port.decode == "native" and port.decoded == {"native": 8, "PIL": 0}
    imgs, txts = batches[0]
    assert imgs.shape == (4, 32, 32, 3) and txts.shape[0] == 4
    port.set_epoch(1)
    jax.set_epoch(1)
    imgs2, _ = _same_batches(port, jax)[0]
    assert not np.array_equal(imgs, imgs2)
    # a pixel augmentation the native path lacks takes the PIL transform
    jitter = pwds.WdsLoader(
        pwds.WebDatasetReader(pwds.WdsConfig(shards=[shard])),
        PTrain(PCfg(size=32), aug_cfg={"color_jitter": 0.4}), PTok(),
        **kw)
    assert jitter.decode.startswith("PIL (color_jitter")
    # every batch taken: the producer thread decodes ahead of the consumer,
    # so after one batch the count was a race (4 or more)
    assert len(list(jitter)) == 2
    assert jitter.decoded == {"native": 0, "PIL": 8}


def test_val_loader_stops_at_stream_end_with_partial_batch(shards):
    paths = _paths(shards)
    kw = dict(batch_size=5, num_batches=100, shuffle_buffer=1,
              loop_stream=False)
    port = pwds.WdsLoader(pwds.WebDatasetReader(pwds.WdsConfig(shards=paths)),
                          p_eval(PCfg(size=16)), PTok(), **kw)
    jax = jwds.WdsLoader(jwds.WebDatasetReader(jwds.WdsConfig(shards=paths)),
                         j_eval(JCfg(size=16), normalize_host=False), JTok(),
                         **kw)
    batches = _same_batches(port, jax)
    assert sum(b[0].shape[0] for b in batches) == 24  # each sample once
    assert batches[-1][0].shape[0] == 4  # 24 = 4 x 5 + 4


def _args(**kw):
    base = dict(train_data=None, val_data=None, train_num_samples=None,
                val_num_samples=None, batch_size=4, world_size=1, rank=0,
                seed=0, dataset_resampled=False,
                train_data_upsampling_factors=None, native_decode=False)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_val_num_batches_is_per_rank_ceil(shards):
    args = _args(val_data=os.path.join(shards, "data-{0000..0002}.tar"),
                 val_num_samples=25, world_size=8)
    port = pwds.get_wds_dataset(args, p_eval(PCfg(size=16)), is_train=False,
                                tokenizer=PTok())
    jax = jwds.get_wds_dataset(args, j_eval(JCfg(size=16)), is_train=False,
                               tokenizer=JTok())
    assert port.dataloader.num_batches == jax.dataloader.num_batches == 7


def test_resampled_weights_expand_per_shard(shards):
    spec = (os.path.join(shards, "data-{0000..0001}.tar") + "::"
            + os.path.join(shards, "data-0002.tar"))
    args = _args(train_data=spec, train_num_samples=24,
                 dataset_resampled=True, train_data_upsampling_factors="1::2")
    port = pwds.get_wds_dataset(args, p_train(PCfg(size=16)), is_train=True,
                                tokenizer=PTok())
    assert port.dataloader.reader.cfg.weights == [1.0, 1.0, 2.0]
    jreader = jwds.get_wds_dataset(args, j_train(JCfg(size=16)),
                                   is_train=True,
                                   tokenizer=JTok()).dataloader.reader
    assert list(port.dataloader.reader._shards_for_epoch()) == list(
        jreader._shards_for_epoch())
    assert len(list(port.dataloader)) == 6
    bad = _args(**dict(vars(args), train_data_upsampling_factors="1::2::3"))
    with pytest.raises(ValueError, match="3 entries for 2"):
        pwds.get_wds_dataset(bad, p_train(PCfg(size=16)), is_train=True,
                             tokenizer=PTok())


def test_empty_stream_raises_clear_error():
    loader = pwds.WdsLoader(pwds.WebDatasetReader(pwds.WdsConfig(shards=[])),
                            p_eval(PCfg(size=16)), PTok(), batch_size=2,
                            num_batches=2, shuffle_buffer=1)
    with pytest.raises(RuntimeError, match="stream is empty"):
        list(loader)
    val = pwds.WdsLoader(pwds.WebDatasetReader(pwds.WdsConfig(shards=[])),
                         p_eval(PCfg(size=16)), PTok(), batch_size=2,
                         num_batches=2, shuffle_buffer=1, loop_stream=False)
    with pytest.raises(RuntimeError, match="yielded no samples"):
        list(val)


# -- cli.main end to end on the shards, the port beside JAX's CLI ------------

TINY = dict(embed_dim=64,
            vision_cfg=dict(layers=1, width=64, head_width=32, patch_size=8,
                            image_size=16),
            text_cfg=dict(context_length=16, vocab_size=49408, width=64,
                          heads=2, layers=1))


def _losses(log_path):
    text = open(log_path).read()
    return [float(x) for x in re.findall(r"Train Epoch: \d+ \[\d+/\d+\] "
                                         r"loss: (\S+)", text)]


def _run_jax_cli(argv):
    """JAX's cli.main, with the root logger's handlers and levels put
    back after it (its setup_logging changes them)."""
    from xtagclip_tpu.cli import main as jax_main

    root = logging.getLogger()
    handlers = list(root.handlers)
    levels = {name: logging.getLogger(name).level
              for name in [None, *root.manager.loggerDict]}
    try:
        return jax_main.main(argv)
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                root.removeHandler(h)
                h.close()
        for name, level in levels.items():
            logging.getLogger(name).setLevel(level)


@pytest.mark.parametrize("native", [True, False])
def test_main_cli_webdataset_end_to_end(tmp_path, native):
    """cli.main over JPEG tar shards from one JAX-exported .pt: with
    --native-decode the crops are the native library's seeded ones in both
    packages, and the per-step losses match JAX's within 1e-3 (fp32);
    without it the PIL train transform runs (its crops are unseeded in
    both, so only finite, falling-free losses and the checkpoint are
    checked)."""
    import jax

    from xtagclip_tpu.convert.export import save_open_clip_checkpoint
    from xtagclip_tpu.factory import add_model_config as jax_add_config
    from xtagclip_tpu.factory import create_model as jax_create_model
    from xtagclip_tpu_torch import factory
    from xtagclip_tpu_torch.cli import main as port_main
    from xtagclip_tpu_torch.train.logger import close_logging

    if native and not pnative.native_available():
        pytest.skip(f"native library: {pnative.decode_route()}")
    cfg = tmp_path / "torch-tiny-wds.json"
    cfg.write_text(json.dumps(TINY))
    jax_add_config(str(cfg))
    factory.add_model_config(cfg)
    for s in range(3):
        _make_jpeg_shard(str(tmp_path / f"data-{s:04d}.tar"), 8, hw=(24, 20),
                         seed=10 * s)
    pt = str(tmp_path / "init.pt")
    save_open_clip_checkpoint(jax_create_model("torch-tiny-wds"), pt)
    jax.clear_caches()
    argv = ["--model", "torch-tiny-wds", "--pretrained", pt,
            "--train-data", str(tmp_path / "data-{0000..0002}.tar"),
            "--dataset-type", "webdataset", "--train-num-samples", "16",
            "--batch-size", "4", "--epochs", "1", "--warmup", "1",
            "--precision", "fp32", "--lr", "1e-3", "--force-image-size",
            "16", "--logs", str(tmp_path / "logs"),
            "--log-every-n-steps", "1", "--val-frequency", "0",
            "--workers", "2"] + (["--native-decode"] if native else [])
    try:
        out = port_main.main([*argv, "--name", "port", "--device", "cpu"])
    finally:
        close_logging()
    rec = out["epochs"][0]["train"]
    assert (tmp_path / "logs" / "port" / "checkpoints" / "epoch_1").is_dir()
    assert len(rec["data_step_s"]) == 4
    port_losses = _losses(tmp_path / "logs" / "port" / "out.log")
    assert len(port_losses) == 4 and np.isfinite(port_losses).all()
    if not native:
        assert rec["decode"] == "PIL" and rec["decoded"]["PIL"] >= 16
        return
    assert rec["decode"] == "native" and rec["decoded"]["PIL"] == 0
    _run_jax_cli([*argv, "--name", "jax"])
    jax_losses = _losses(tmp_path / "logs" / "jax" / "out.log")
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-3, atol=1e-3)
