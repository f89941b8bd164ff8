"""Sharded training under context parallelism against the reference's
sharded step, on the CPU (tests/test_torch_spmd_train_ref.py's note says
how both sides run and at which bounds): minitron-4b's smoke config
(6/2 heads) on (1, 4), where the reference lays attention out by
sequence ("seq"). Each point takes 8 of a microbatch's 32 query rows
(the "auto" backend: its rows against the gathered k and v), so the
gathered weights, h and the gathered k and v enter the row split
through `spmd.copy`: their gradients are each point's rows' share,
summed over "model". One AdamW step of 2 microbatches with remat."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd_train_ref import (  # noqa: F401  (a fixture)
    check_step, one_torch_thread, reference_steps,
)

#: tag -> (arch, mesh shape, fsdp)
CASES = {"minitron-4b@1x4": ("minitron-4b", (1, 4), True)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_steps(tmp_path_factory, CASES)


@pytest.mark.parametrize("tag", list(CASES))
def test_sequence_split_step_matches_reference_sharded_step(tag,
                                                            reference):
    check_step(tag, *CASES[tag], reference)
