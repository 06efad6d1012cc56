"""The float64 batch-4 steps of tests/test_torch_train_batch4.py for
GRID_REAS lstm3d: the same two tests on this file's `runs` fixture, in a
file of their own so that the conv3d and lstm3d fixtures (minutes each
on the CPU, the lstm3d one the longer) run on two test workers."""

import pytest

pytest.importorskip("torch")

from tests.test_torch_train_batch4 import (  # noqa: E402,F401
    computed, test_batch4_harness_three_steps_match_jax,
    test_batch4_train_bn_step_matches_jax)


@pytest.fixture(scope="module", params=["lstm3d"])
def runs(request, tmp_path_factory):
    yield from computed(request.param, tmp_path_factory)
