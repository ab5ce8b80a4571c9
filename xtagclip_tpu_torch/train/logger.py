"""Logging setup: 'time | level | message' to the console and a file,
optional hostname (port of xtagclip_tpu/train/logger.py; reference
open_clip_train/logger.py:4-26).

Two departures, both for a process that runs the CLI more than once (the
tests, chip_smoke.py): a second call replaces the handlers the first one
installed instead of adding to them, and only the root logger's level is
set, so library loggers (PyTorch's own) keep theirs.
"""

from __future__ import annotations

import logging

_INSTALLED: list = []


def setup_logging(log_file=None, level=logging.INFO, include_host: bool = False):
    host = ""
    if include_host:
        import socket

        host = f"{socket.gethostname()} | "
    formatter = logging.Formatter(
        f"%(asctime)s | {host}%(levelname)s | %(message)s",
        datefmt="%Y-%m-%d,%H:%M:%S")
    close_logging()
    root = logging.getLogger()
    root.setLevel(level)
    handlers = [logging.StreamHandler()]
    if log_file:
        handlers.append(logging.FileHandler(filename=log_file))
    for h in handlers:
        h.setFormatter(formatter)
        root.addHandler(h)
        _INSTALLED.append(h)


def close_logging():
    """Remove and close the handlers ``setup_logging`` installed."""
    root = logging.getLogger()
    for h in _INSTALLED:
        root.removeHandler(h)
        h.close()
    _INSTALLED.clear()


class AverageMeter:
    """Running average (reference open_clip_train/train.py:23-40)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
