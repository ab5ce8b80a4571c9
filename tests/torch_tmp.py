"""Temporary files of the port's tests, removed when they are done with.

The CLI tests write checkpoints, tar shards and exported programs of tens
to hundreds of MB under pytest's base temp directory, which pytest keeps
for three runs. A test module that imports these autouse fixtures deletes
each test's ``tmp_path`` when the test ends, and whatever its module-scoped
fixtures made there (``tmp_path_factory``) when the module ends.
"""

import shutil

import pytest


@pytest.fixture(autouse=True, scope="module")
def remove_module_tmp(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    before = set(base.iterdir())
    yield
    for path in set(base.iterdir()) - before:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(autouse=True)
def remove_test_tmp(request):
    path = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)
