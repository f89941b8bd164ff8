"""Sharded serving against the reference's sharded run, on the CPU:
deepseek-v2-lite-16b's smoke config (MLA with 4 heads of 32, latent rank
64, 16 rope dims; 4 experts top-2 and a shared expert; a dense first
layer) on tests/test_torch_spmd.py's meshes (its note says how both
sides run). On (2, 2), with `fsdp` on and off, each point holds 2 of
the 4 heads, 32 of the 64 latent columns and 8 of the 16 rope columns,
2 of the experts and one of the two stacked layers of the shared
expert (the sharding rules give it the experts' spec, so the backbone
gathers it along its layers once a call); on (1, 4) one head, 16 latent
and 4 rope columns a point: each point's rope columns hold halves of
RoPE's pairs, so k_rope is rotated whole from the gathered `w_kr`.
Prefill and teacher-forced decode logits within 2e-4 / 3e-4, in f32."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd import (  # noqa: F401  (one_torch_thread: a fixture)
    MESHES, check_case, mesh_cases, one_torch_thread, reference_runs,
)

ARCH = "deepseek-v2-lite-16b"
CASES = ("2x2", "2x2-nofsdp", "1x4")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(tmp_path_factory, [
        c for c in mesh_cases(ARCH, ARCH) if c[0].split("@")[1] in CASES])


@pytest.mark.parametrize("mesh", CASES)
def test_mla_matches_reference_sharded_run(mesh, reference):
    check_case(reference, ARCH, ARCH, None, mesh)
