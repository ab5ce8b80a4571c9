"""Run-directory helpers (port of xtagclip_tpu/train/file_utils.py):
``--remote-sync``, a daemon process that mirrors the run directory to
``--remote-sync`` every ``--remote-sync-frequency`` seconds (``aws s3
sync``, ``gsutil rsync`` or an fsspec copy), skipping ``epoch_latest``;
``pt_load``, a ``torch.load`` that also reads an fsspec URL (``s3://``,
``gs://``, ``file://``, ...); and ``copy_codebase``.
"""

from __future__ import annotations

import contextlib
import io
import logging
import multiprocessing
import os
import shutil
import subprocess
import time


def _run_sync(cmd) -> bool:
    result = subprocess.run(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    if result.returncode != 0:
        logging.error("remote sync failed: %s",
                      result.stderr.decode()[-500:])
        return False
    return True


def remote_sync_s3(local_dir: str, remote_dir: str) -> bool:
    return _run_sync(["aws", "s3", "sync", local_dir, remote_dir,
                      "--exclude", "*epoch_latest*"])


def remote_sync_gcs(local_dir: str, remote_dir: str) -> bool:
    return _run_sync(["gsutil", "-m", "rsync", "-r", "-x",
                      ".*epoch_latest.*", local_dir, remote_dir])


def remote_sync_fsspec(local_dir: str, remote_dir: str) -> bool:
    """Copy every file of ``local_dir`` that ``remote_dir`` lacks or holds
    at another length, but those under ``epoch_latest``."""
    try:
        import fsspec
    except ImportError:
        logging.error("fsspec unavailable")
        return False
    a = fsspec.get_mapper(local_dir)
    b = fsspec.get_mapper(remote_dir)
    for k in a:
        if "epoch_latest" in k:
            continue
        try:
            if k in b and len(a[k]) == len(b[k]):
                continue
            b[k] = a[k]
        except Exception as e:  # noqa: BLE001 (a store's error ends the pass)
            logging.info("skip %s: %s", k, e)
            return False
    return True


def remote_sync(local_dir: str, remote_dir: str, protocol: str) -> bool:
    logging.info("remote sync %s -> %s (%s)", local_dir, remote_dir, protocol)
    if protocol == "s3":
        return remote_sync_s3(local_dir, remote_dir)
    if protocol == "gcs":
        return remote_sync_gcs(local_dir, remote_dir)
    if protocol == "fsspec":
        return remote_sync_fsspec(local_dir, remote_dir)
    logging.error("unknown remote protocol %s", protocol)
    return False


def _loop(sync_every, local_dir, remote_dir, protocol):
    while True:
        time.sleep(sync_every)
        remote_sync(local_dir, remote_dir, protocol)


def start_sync_process(sync_every: int, local_dir: str, remote_dir: str,
                       protocol: str):
    """The (unstarted) daemon process that syncs every ``sync_every``
    seconds; spawned, not forked, as the trainer holds threads."""
    return multiprocessing.get_context("spawn").Process(
        target=_loop, args=(sync_every, local_dir, remote_dir, protocol),
        daemon=True)


@contextlib.contextmanager
def remote_sync_running(args, local_dir: str):
    """With ``--remote-sync``, the sync process of the run directory
    ``local_dir`` (to ``<--remote-sync>/<--name>``, as JAX's main_other
    starts it) while the block runs; it is terminated and joined when the
    block ends, an exception included."""
    proc = None
    if args.remote_sync:
        proc = start_sync_process(
            args.remote_sync_frequency, local_dir,
            os.path.join(args.remote_sync, args.name),
            args.remote_sync_protocol)
        proc.start()
    try:
        yield proc
    finally:
        if proc is not None:
            proc.terminate()
            proc.join()


def pt_load(file_path: str, map_location=None):
    """``torch.load`` (tensors and containers only: ``weights_only``) of a
    local file or an fsspec URL (read whole into memory first)."""
    import torch

    if "://" in str(file_path):
        import fsspec

        logging.info("Loading remote checkpoint %s", file_path)
        with fsspec.open(file_path, "rb") as f:
            data = f.read()
        return torch.load(io.BytesIO(data), map_location=map_location,
                          weights_only=True)
    return torch.load(file_path, map_location=map_location, weights_only=True)


def copy_codebase(args) -> str:
    """Copy the package source into the run dir (reference main.py
    copy_codebase: a reproducibility snapshot under logs/<name>/code)."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(args.logs, args.name, "code", "xtagclip_tpu_torch")
    shutil.copytree(src, dst, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc",
                                                  "_build"))
    return dst
