"""Sharded training against the reference's sharded step, on the CPU
(tests/test_torch_spmd_train_ref.py's note says how both sides run and
at which bounds): mamba2-370m's smoke config on (2, 2) with FSDP
(in_proj's and the conv's outputs gathered over "model", each point's
SSD on its 4 of 8 heads, the tied embedding's vocabulary split) and
whisper-base's on (2, 2) with FSDP (its frames in the batch, projected
by each point's columns of `frame_proj`; the encoder's and the
decoder's attention and cross-attention on each point's 2 of 4 heads).
One AdamW step of 2 microbatches with remat."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd_train_ref import (  # noqa: F401  (a fixture)
    check_step, one_torch_thread, reference_steps,
)

#: tag -> (arch, mesh shape, fsdp)
CASES = {"mamba2-370m@2x2": ("mamba2-370m", (2, 2), True),
         "whisper-base@2x2": ("whisper-base", (2, 2), True)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_steps(tmp_path_factory, CASES)


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_step_matches_reference_sharded_step(tag, reference):
    check_step(tag, *CASES[tag], reference)
