"""A hub cache that never reaches the network, for the port's tests of
named ``--pretrained`` tags.

``hub`` gives an empty hub cache directory under ``tmp_path``, with
``HF_HUB_OFFLINE=1`` and ``HF_HUB_CACHE`` set for the test, and
``huggingface_hub.hf_hub_download`` held to local files whoever calls it
(the JAX package reads the hub's offline flag only when
``huggingface_hub`` is imported), all undone when the test ends. URL
fetches are the caller's to monkeypatch (``urlretrieve``).
"""

import huggingface_hub
import pytest


@pytest.fixture
def hub(tmp_path, monkeypatch):
    cache = tmp_path / "hub"
    cache.mkdir()
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    download = huggingface_hub.hf_hub_download

    def local_only(*args, **kwargs):
        kwargs["local_files_only"] = True
        return download(*args, **kwargs)

    monkeypatch.setattr(huggingface_hub, "hf_hub_download", local_only)
    return str(cache)
