"""Sharded serving against the reference's sharded run, on the CPU:
llava-next-mistral-7b's smoke config (4/2 heads of 32, 8 patch
positions of width 128) on tests/test_torch_spmd.py's meshes (its note
says how both sides run: the patch embeddings drawn from SEED + 1 and
split over the data axes with the tokens, the cap and the decode
positions counting the patches). `patch_proj` is split by its columns
over "model": each point projects its columns of the patches, which are
all-gathered before the token rows. On (2, 2), with `fsdp` on and off,
the kv heads split one a point; on (1, 4) the 2 kv heads do not divide
4, so attention runs gathered, behind a prefix still split four ways.
Prefill and teacher-forced decode logits within 2e-4 / 3e-4, in f32."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd import (  # noqa: F401  (one_torch_thread: a fixture)
    MESHES, check_case, mesh_cases, one_torch_thread, reference_runs,
)

ARCH = "llava-next-mistral-7b"
CASES = ("2x2", "2x2-nofsdp", "1x4")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(tmp_path_factory, [
        c for c in mesh_cases(ARCH, ARCH) if c[0].split("@")[1] in CASES])


@pytest.mark.parametrize("mesh", CASES)
def test_patch_prefix_matches_reference_sharded_run(mesh, reference):
    check_case(reference, ARCH, ARCH, None, mesh)
