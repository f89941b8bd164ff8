"""Sharded training against the reference's sharded step, on the CPU
(tests/test_torch_spmd_train_ref.py's note says how both sides run and
at which bounds): deepseek-v2-lite-16b's smoke config on (2, 2) with
FSDP (MLA's gathered latent, `w_kr` gathered whole, the shared
expert's split layers gathered once a call, the experts'
backward split two a point) and llava-next-mistral-7b's on (2, 2) (the
patch prefix projected by each point's columns of `patch_proj`, its
gather's backward keeping the point's slice; the targets padded over
the patches). One AdamW step of 2 microbatches with remat."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd_train_ref import (  # noqa: F401  (a fixture)
    check_step, one_torch_thread, reference_steps,
)

#: tag -> (arch, mesh shape, fsdp)
CASES = {"deepseek-v2-lite-16b@2x2": ("deepseek-v2-lite-16b", (2, 2), True),
         "llava-next-mistral-7b@2x2": ("llava-next-mistral-7b", (2, 2),
                                       True)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_steps(tmp_path_factory, CASES)


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_step_matches_reference_sharded_step(tag, reference):
    check_step(tag, *CASES[tag], reference)
