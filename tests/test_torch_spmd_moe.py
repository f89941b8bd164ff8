"""Sharded serving against the reference's sharded run, on the CPU:
mixtral-8x7b's smoke config (4 experts top-2, 4/2 heads, a window of 64)
on tests/test_torch_spmd.py's meshes (its note says how both sides run).
On (2, 2) and (2, 1, 2) the experts split 2 a point (expert-parallel)
and the kv heads 1 a point; on (1, 4) each point holds one expert, and
the 2 kv heads do not split whole over 4, so attention runs by sequence
(context parallel: tests/test_torch_spmd_cp.py).
Prefill and teacher-forced decode logits within 2e-4 / 3e-4, in f32."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd import (  # noqa: F401  (one_torch_thread: a fixture)
    MESHES, check_case, mesh_cases, one_torch_thread, reference_runs,
)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(tmp_path_factory,
                          mesh_cases("mixtral-8x7b", "mixtral-8x7b"))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mixtral_matches_reference_sharded_run(mesh, reference):
    check_case(reference, "mixtral-8x7b", "mixtral-8x7b", None, mesh)
