"""``--remote-sync`` and ``pt_load`` in the port (train/file_utils.py)
against the JAX package's, on the CPU, with the fsspec protocol on local
paths only (nothing leaves the machine).

Every test that starts the sync process terminates and joins it in a
``finally``, and the CLI test checks that no child process outlives
``main``. Bars: the fsspec mirror holds every file of the run directory
but those under ``epoch_latest``, as JAX's does; ``pt_load`` of a
``file://`` URL equals ``torch.load`` of the path.
"""

import multiprocessing
import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from scar_fixtures import make_scar_dataset  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

from xtagclip_tpu.train import file_utils as jfile_utils  # noqa: E402
from xtagclip_tpu_torch import factory  # noqa: E402
from xtagclip_tpu_torch.cli import main_other  # noqa: E402
from xtagclip_tpu_torch.train import file_utils  # noqa: E402
from xtagclip_tpu_torch.train.logger import close_logging  # noqa: E402

torch.set_num_threads(1)

FILES = {"out.log": b"log line\n", "params.txt": b"lr: 5e-05\n",
         "checkpoints/epoch_1/state.pt": b"x" * 64,
         "checkpoints/epoch_latest/state.pt": b"y" * 64,
         "checkpoints/best_val_top1/state.pt": b"z" * 32}


def _run_dir(root):
    for rel, data in FILES.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
    return str(root)


def _tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_fsspec_sync_mirrors_all_but_epoch_latest(tmp_path):
    local = _run_dir(tmp_path / "run")
    want = {k: v for k, v in FILES.items() if "epoch_latest" not in k}
    assert file_utils.remote_sync(local, str(tmp_path / "port"), "fsspec")
    assert jfile_utils.remote_sync(local, str(tmp_path / "jax"), "fsspec")
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax") == want
    # a second pass copies only what changed in length
    with open(os.path.join(local, "out.log"), "ab") as f:
        f.write(b"more\n")
    assert file_utils.remote_sync(local, f"file://{tmp_path / 'port'}",
                                  "fsspec")
    assert _tree(tmp_path / "port")["out.log"] == b"log line\nmore\n"
    assert not file_utils.remote_sync(local, str(tmp_path / "x"), "ftp")


def test_sync_process_mirrors_and_is_joined(tmp_path):
    local = _run_dir(tmp_path / "run")
    remote = tmp_path / "remote"
    proc = file_utils.start_sync_process(1, local, str(remote), "fsspec")
    assert proc.daemon
    try:
        proc.start()
        want = {k for k in FILES if "epoch_latest" not in k}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and set(_tree(remote)) != want:
            time.sleep(0.2)
        assert set(_tree(remote)) == want
    finally:
        proc.terminate()
        proc.join(30)
    assert not proc.is_alive()


def test_pt_load_reads_fsspec_urls(tmp_path):
    obj = {"state_dict": {"w": torch.arange(6.0).reshape(2, 3)}, "epoch": 3}
    path = tmp_path / "ckpt.pt"
    torch.save(obj, path)
    for src in (str(path), f"file://{path}"):
        got = file_utils.pt_load(src, map_location="cpu")
        assert got["epoch"] == 3
        assert torch.equal(got["state_dict"]["w"], obj["state_dict"]["w"])


TOY = dict(
    embed_dim=512,
    vision_cfg=dict(layers=1, width=64, head_width=32, patch_size=16,
                    image_size=32),
    text_cfg=dict(context_length=77, vocab_size=49408, width=512, heads=4,
                  layers=1),
)


def test_main_other_remote_sync_stops_with_main(tmp_path):
    """``main_other --remote-sync <dir> --remote-sync-protocol fsspec``
    starts the sync process for the run and stops it when main returns
    and when main raises: no child process outlives it."""
    factory.register_model_config("torch-sync-toy", TOY)
    root = str(tmp_path / "scar_train")
    csv = make_scar_dataset(root, n=4, image_size=40)
    argv = ["--model", "torch-sync-toy", "--train-data", root,
            "--scar-train-csv", csv, "--batch-size", "4", "--epochs", "1",
            "--precision", "fp32", "--use-tagging", "--use-fusion",
            "--device", "cpu", "--workers", "1", "--logs",
            str(tmp_path / "logs"), "--remote-sync", str(tmp_path / "remote"),
            "--remote-sync-protocol", "fsspec", "--remote-sync-frequency",
            "1"]
    try:
        out = main_other.main(argv + ["--name", "synced"])
        assert out["epochs"][0]["epoch"] == 1
        assert multiprocessing.active_children() == []
        with pytest.raises(FileNotFoundError):
            main_other.main(argv + ["--name", "failed", "--pretrained",
                                    str(tmp_path / "missing.pt")])
        assert multiprocessing.active_children() == []
        params = (tmp_path / "logs" / "synced" / "params.txt").read_text()
        assert "remote_sync_protocol: fsspec" in params
    finally:
        for child in multiprocessing.active_children():
            child.terminate()
            child.join(30)
        close_logging()
