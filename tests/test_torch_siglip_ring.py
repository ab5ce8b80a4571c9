"""The port's SigLIP loss across 3 ranks (gloo, on the CPU): the
``shift`` and ``bidir`` neighbour rings and the ``reduce`` and ``gather``
all-gathers against the one-process loss of the [3 b, 3 b] matrix of the
concatenated batch (JAX's tests/test_siglip_ring_path.py contract).

At 3 ranks ``bidir`` takes one step each way (at 2 its two directions
coincide). The mean over ranks of the ranks' losses is the global loss,
within 1e-5 relative; each rank's gradients of its own rows (the ring
carries the other ranks' terms back) over the world size, and the mean
over ranks of the shared scale's and bias's, are the global loss's
gradients within 1e-5 of their largest entry. One spawn runs every case.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_dist_worker as w  # noqa: E402
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

WORLD = 3
IMPLS = ("shift", "bidir", "reduce", "gather")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    arrays = w.loss_arrays(2 * WORLD)
    ranks = w.spawn("losses", WORLD, tmp_path_factory.mktemp("ring"),
                    {"arrays": arrays})
    return {"ranks": ranks, "ref": w.loss_terms(arrays)}


@pytest.mark.parametrize("impl", IMPLS)
def test_ring_loss_and_gradients_match_one_process(run, impl):
    w.check_term(run["ranks"], run["ref"], f"siglip_{impl}")


@pytest.mark.parametrize("impl", IMPLS)
def test_ranks_see_only_their_rows_with_negatives_of_the_others(run, impl):
    """A rank's loss is its own rows' block plus the negative-only blocks
    of every other rank: the ranks' losses differ, and none is the global
    loss on its own."""
    losses = [r["terms"][f"siglip_{impl}"][0] for r in run["ranks"]]
    assert len(set(losses)) == WORLD


def test_impls_agree_across_ranks(run):
    for r in run["ranks"]:
        values = [r["terms"][f"siglip_{i}"][0] for i in IMPLS]
        assert max(values) - min(values) <= 1e-5 * abs(values[0])
