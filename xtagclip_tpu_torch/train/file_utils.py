"""Run-directory helpers (port of ``copy_codebase`` from
xtagclip_tpu/train/file_utils.py; the remote sync is not ported)."""

from __future__ import annotations

import os
import shutil


def copy_codebase(args) -> str:
    """Copy the package source into the run dir (reference main.py
    copy_codebase: a reproducibility snapshot under logs/<name>/code)."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(args.logs, args.name, "code", "xtagclip_tpu_torch")
    shutil.copytree(src, dst, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc",
                                                  "_build"))
    return dst
