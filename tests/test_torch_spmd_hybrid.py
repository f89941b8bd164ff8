"""Sharded serving against the reference's sharded run, on the CPU:
jamba-1.5-large-398b's smoke config (a period of one attention layer,
4/2 heads of 32, and seven Mamba-2 layers of 8 heads; 4 experts top-2 on
every second layer) on tests/test_torch_spmd.py's meshes (its note says
how both sides run). On (2, 2) every block kind splits over "model"
(the kv heads one a point, the Mamba heads four, the experts two); on
(1, 4) the 2 kv heads do not divide 4, so attention runs gathered while
the Mamba-2 mixers split four ways (2 heads and 72 conv channels a
point) and the experts one a point. Prefill and teacher-forced decode
logits within 2e-4 / 3e-4, in f32."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd import (  # noqa: F401  (one_torch_thread: a fixture)
    MESHES, check_case, mesh_cases, one_torch_thread, reference_runs,
)

ARCH = "jamba-1.5-large-398b"
CASES = ("2x2", "1x4")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(tmp_path_factory, [
        c for c in mesh_cases(ARCH, ARCH) if c[0].split("@")[1] in CASES])


@pytest.mark.parametrize("mesh", CASES)
def test_hybrid_matches_reference_sharded_run(mesh, reference):
    check_case(reference, ARCH, ARCH, None, mesh)
