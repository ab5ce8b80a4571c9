"""The public names of the JAX package that the port gained last, each
against JAX's on the CPU: ``AsymmetricLoss`` and ``DQNCOSLoss`` (values
and, for the port, gradients against its functions), ``HFTokenizer.
set_language`` (with and without a language hook), ``PromptTable.
template_index`` (``total`` from an explicit numpy generator),
``CheckpointManager.latest_tag``, ``INCEPTION_MEAN`` / ``INCEPTION_STD``
and ``LATEST_CHECKPOINT_NAME``.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import xtagclip_tpu as jpkg  # noqa: E402
import xtagclip_tpu_torch as port  # noqa: E402
from xtagclip_tpu.cli import main_other as jmain_other  # noqa: E402
from xtagclip_tpu.tokenize import prompts as jprompts  # noqa: E402
from xtagclip_tpu.train import checkpoint as jcheckpoint  # noqa: E402
from xtagclip_tpu.utils import constants as jconstants  # noqa: E402
from xtagclip_tpu_torch import losses  # noqa: E402
from xtagclip_tpu_torch.cli import main_other  # noqa: E402
from xtagclip_tpu_torch.tokenize import hf  # noqa: E402
from xtagclip_tpu_torch.tokenize import prompts  # noqa: E402
from xtagclip_tpu_torch.train import checkpoint  # noqa: E402
from xtagclip_tpu_torch.utils import constants  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401


def test_loss_classes_are_exported_as_jax_exports_them():
    for name in ("AsymmetricLoss", "DQNCOSLoss"):
        assert name in jpkg.__all__ and name in port.__all__
        assert getattr(port, name) is getattr(losses, name)
        assert name in losses.__all__


@pytest.mark.parametrize("kw", [{}, dict(gamma_neg=7, gamma_pos=0,
                                         clip=0.05)])
def test_asymmetric_loss_class_matches_jax(kw):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 44)).astype(np.float32) * 3
    targets = (rng.random((4, 44)) < 0.3).astype(np.float32)
    want = float(jpkg.AsymmetricLoss(**kw)(logits, targets))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = port.AsymmetricLoss(**kw)(x, torch.from_numpy(targets))
    assert abs(got.item() - want) <= 1e-5 * abs(want)
    got.backward()
    y = torch.from_numpy(logits).requires_grad_(True)
    losses.asymmetric_loss(y, torch.from_numpy(targets),
                           **{k: v for k, v in kw.items()}).backward()
    assert torch.equal(x.grad, y.grad)


def test_dqncos_loss_class_matches_jax():
    logits = np.random.default_rng(2).standard_normal((6, 6)).astype(
        np.float32) * 4
    want = float(jpkg.DQNCOSLoss()(logits))
    got = port.DQNCOSLoss()(torch.from_numpy(logits)).item()
    assert abs(got - want) <= 1e-6 * abs(want)


def test_constants_equal_jax():
    assert constants.INCEPTION_MEAN == jconstants.INCEPTION_MEAN
    assert constants.INCEPTION_STD == jconstants.INCEPTION_STD
    assert main_other.LATEST_CHECKPOINT_NAME == \
        jmain_other.LATEST_CHECKPOINT_NAME == "epoch_latest"


def test_template_index_matches_jax():
    """A template's row, and ``total`` drawn from a seeded numpy
    generator: the same rows as JAX's from the same seed."""
    table = prompts.PromptTable(["scar"])
    jtable = jprompts.PromptTable(["scar"])
    assert table.templates == jtable.templates
    for name in table.templates:
        assert table.template_index(name) == jtable.template_index(name)
    rng, jrng = np.random.default_rng(9), np.random.default_rng(9)
    got = [table.template_index("total", rng) for _ in range(20)]
    want = [jtable.template_index("total", jrng) for _ in range(20)]
    assert got == want and len(set(got)) > 1
    assert 0 <= table.template_index("total") < len(table.templates)
    with pytest.raises(ValueError):
        table.template_index("no such template")


def test_latest_tag_matches_jax(tmp_path):
    for d in ("epoch_2", "epoch_10", "best_val_acc"):
        os.makedirs(tmp_path / d)
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    assert mgr.latest_tag() == jcheckpoint.find_latest_checkpoint(
        str(tmp_path)) == "epoch_10"
    os.makedirs(tmp_path / "epoch_latest")
    assert mgr.latest_tag() == "epoch_latest"
    empty = checkpoint.CheckpointManager(str(tmp_path / "none"), write=False)
    assert empty.latest_tag() is None


class _Hooked:
    """A stand-in for a tokenizer with a language hook (NLLB's)."""

    def __init__(self):
        self.langs = []

    def set_src_lang_special_tokens(self, lang):
        self.langs.append(lang)


def _bare(tok, cls):
    """An instance of ``cls`` around ``tok`` without loading a tokenizer
    (JAX's and the port's ``__init__`` read a hub or a directory)."""
    obj = cls.__new__(cls)
    obj.tokenizer = tok
    set_lang = getattr(tok, "set_src_lang_special_tokens", None)
    if callable(set_lang):
        obj.set_lang_fn = set_lang
    return obj


def test_set_language_matches_jax():
    """With a language hook both call it; without one both warn and
    change nothing."""
    from xtagclip_tpu.tokenize import hf as jhf

    for cls in (hf.HFTokenizer, jhf.HFTokenizer):
        tok = _Hooked()
        _bare(tok, cls).set_language("kor_Hang")
        assert tok.langs == ["kor_Hang"]
        with pytest.warns(UserWarning, match="Cannot set language"):
            _bare(object(), cls).set_language("kor_Hang")


def test_hf_tokenizer_init_sets_the_language_through_set_language(
        monkeypatch, tmp_path):
    """The port's ``__init__`` applies ``language`` through
    ``set_language``, as JAX's does, on a tokenizer with the hook."""
    made = _Hooked()

    class Auto:
        @staticmethod
        def from_pretrained(path, **kw):
            return made

    monkeypatch.setattr(hf, "resolve_tokenizer_dir", lambda name: str(
        tmp_path))
    monkeypatch.setattr(hf, "_transformers", lambda what: type(
        "tf", (), {"AutoTokenizer": Auto}))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tok = hf.HFTokenizer("nllb", language="fra_Latn")
    assert made.langs == ["fra_Latn"]
    tok.set_language("deu_Latn")
    assert made.langs == ["fra_Latn", "deu_Latn"]
