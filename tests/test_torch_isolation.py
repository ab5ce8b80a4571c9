"""The PyTorch port stands alone: it never imports JAX, flax or the JAX
package, its entry points default to the card and refuse to run quietly on
the CPU, and chip_smoke.py fails without a CUDA device."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from xtagclip_tpu_torch import factory

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "xtagclip_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "xtagclip_tpu")


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


SCRIPTS = ("chip_smoke", "probe_attn_numerics")  # the port's scripts at the root


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / f"{s}.py" for s in SCRIPTS]


def test_port_modules_import_without_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules() + list(SCRIPTS)!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_create_model_defaults_to_card_and_raises_before_allocating(
        no_cuda, tmp_path, monkeypatch):
    path = tmp_path / "torchtinyiso.json"
    path.write_text(json.dumps({
        "embed_dim": 64,
        "vision_cfg": {"layers": 1, "width": 64, "patch_size": 8,
                       "image_size": 32},
        "text_cfg": {"context_length": 16, "vocab_size": 1024, "width": 64,
                     "heads": 1, "layers": 1}}))
    factory.add_model_config(path)

    def must_not_build(*a, **k):
        raise AssertionError("model allocated before the device check")

    monkeypatch.setattr(factory, "CLIP", must_not_build)
    monkeypatch.setattr(factory, "VisionTransformer", must_not_build)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory.create_model(path.stem)


def test_chip_smoke_fails_without_cuda(no_cuda, capsys):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert chip_smoke.main() == 1
    assert capsys.readouterr().out == ""
