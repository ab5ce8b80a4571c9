"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface (no PyTorch headers, no ninja, no pybind), for ``sm_90a``. The
output goes to ``xtagclip_tpu_torch/_build/`` under a name keyed by a hash
of every source and the flags, so a changed source rebuilds and a fresh
checkout builds on first use. All sources compile at once, one nvcc each.
``--use_fast_math`` is deliberately absent: it changes ``expf``/``erff``.

Nothing here runs at import time; a missing nvcc or a failed compile
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNEL_SOURCES = ("fused_attn_half", "fused_mlp_half", "fused_attn_half_bwd",
                  "normalize_images", "flash_attn_fwd", "flash_attn_bwd",
                  "fused_mlp")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda, PATH): "
            "the port's CUDA kernels are built from source on first use")
    return found


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_digest()}.so"


def build_all() -> dict:
    """Compile every kernel source not yet built, all at once.

    Returns ``{name: {"path", "seconds", "log"}}``; ``log`` holds nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills) of a fresh
    build, also written beside the library as ``.log``, and is empty for a
    library that was already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    result = {}
    for name in KERNEL_SOURCES:
        out = library_path(name)
        if out.exists():
            result[name] = {"path": str(out), "seconds": 0.0, "log": ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        result[name] = {"path": str(out),
                        "seconds": time.perf_counter() - t0, "log": log}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return result


_VP = ctypes.c_void_p
_I64P = ctypes.POINTER(ctypes.c_longlong)
_ARGTYPES = {
    "xtag_fused_attn_half": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,  # x, ln_g, ln_b, wqkv, bqkv, wout, bout, mask
        _VP, _VP, _VP, _VP, _VP,                 # xn, qkv, att, mask scratch; out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, L, D, H
        ctypes.c_float, _VP,                     # eps, stream
    ],
    "xtag_fused_attn_half_bwd": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,  # x, g, ln_g, ln_b, wqkv, bqkv, wout, mask
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,  # xn, qkv, datt, att, dxn, stats, partial, mask scratch
        _VP, _VP, _VP, _VP, _VP, _VP,            # dx, dqkv, dwout, dbout, dls, dlb
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, L, D, H
        ctypes.c_float, _VP,                     # eps, stream
    ],
    "xtag_fused_mlp_half": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP,       # x, ln_g, ln_b, w1, b1, w2, b2
        _VP, _VP, _VP,                           # xn, hidden scratch; out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # N, D, Hd, act
        ctypes.c_float, _VP,                     # eps, stream
    ],
    "xtag_fused_mlp": [
        _VP, _VP, _VP, _VP, _VP,                 # x, w1, b1, w2, b2
        _VP, _VP,                                # hidden scratch; out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # N, D, Hd, act
        _VP,                                     # stream
    ],
    "xtag_flash_attn_fwd": [
        _VP, _VP, _VP, _VP, _VP,                 # q, k, v, o, lse (or null)
        _I64P,                                   # (b, h, l) strides of q, k, v, o
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, L, dh
        ctypes.c_float, _VP,                     # scale, stream
    ],
    "xtag_flash_attn_bwd": [
        _VP, _VP, _VP, _VP, _VP, _VP,            # q, k, v, o, dout, lse
        _VP, _VP, _VP, _VP,                      # stat scratch; dq, dk, dv
        _I64P,                                   # strides of the eight views
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, L, dh
        ctypes.c_float, _VP,                     # scale, stream
    ],
    "xtag_normalize_images": [
        _VP, _VP, ctypes.c_longlong, ctypes.c_int,  # x, out, n, out_bf16
        *[ctypes.c_float] * 6,                       # scale[3], bias[3]
        _VP,                                         # stream
    ],
}


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` (built first if needed), with argtypes
    declared for its entry point ``xtag_<name>`` and ``xtag_error_string``."""
    if name not in KERNEL_SOURCES:
        raise KeyError(name)
    path = build_all()[name]["path"]
    lib = ctypes.CDLL(path)
    fn = getattr(lib, f"xtag_{name}")
    fn.argtypes = _ARGTYPES[f"xtag_{name}"]
    fn.restype = ctypes.c_int
    lib.xtag_error_string.argtypes = [ctypes.c_int]
    lib.xtag_error_string.restype = ctypes.c_char_p
    return lib


def int64_array(values) -> ctypes.Array:
    """A C array of int64 (strides handed to a launcher)."""
    return (ctypes.c_longlong * len(values))(*values)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = lib.xtag_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
