"""Sharded serving against the reference's sharded run, on the CPU:
mixtral-8x7b's smoke config at capacity factor 0.5, where capacity binds
(its own 4.0 never does), on tests/test_torch_spmd.py's meshes (its note
says how both sides run). The dropped (token, slot) pairs must be the
reference's: the capacity comes from the global expert count and each
data shard's tokens are one of the reference's groups, also where a
point holds only some of the experts. Prefill and teacher-forced decode
logits within 2e-4 / 3e-4, in f32."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd import (  # noqa: F401  (one_torch_thread: a fixture)
    MESHES, check_case, mesh_cases, one_torch_thread, reference_runs,
)

CF = 0.5


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(tmp_path_factory,
                          mesh_cases(f"mixtral-cf{CF}", "mixtral-8x7b", CF))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_binding_capacity_matches_reference_sharded_run(mesh, reference):
    check_case(reference, f"mixtral-cf{CF}", "mixtral-8x7b", CF, mesh)
