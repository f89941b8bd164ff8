"""Sharded serving against the reference's sharded run, on the CPU:
mamba2-370m's smoke config (d_model 128, 8 Mamba-2 heads of 32, state
16, tied 512-row embedding) on tests/test_torch_spmd.py's meshes (its
note says how both sides run). in_proj's 552 columns, the conv's 288
channels and out_proj's rows split over "model": on (2, 2), with `fsdp`
on and off, point 0 holds all 256 columns of z and the first 20 of xBC,
so each point projects with its columns and gathers, runs the conv on
its 144 channels (its conv cache holds those), gathers the conv's
output and runs the SSD on its 4 heads (its SSM cache holds those); on
(1, 4) 72 channels and 2 heads a point. Prefill and teacher-forced
decode logits within 2e-4 / 3e-4, in f32. jamba's hybrid stack is in
tests/test_torch_spmd_hybrid.py."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd import (  # noqa: F401  (one_torch_thread: a fixture)
    MESHES, check_case, mesh_cases, one_torch_thread, reference_runs,
)

ARCH = "mamba2-370m"
CASES = ("2x2", "2x2-nofsdp", "1x4")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(tmp_path_factory, [
        c for c in mesh_cases(ARCH, ARCH) if c[0].split("@")[1] in CASES])


@pytest.mark.parametrize("mesh", CASES)
def test_mamba2_matches_reference_sharded_run(mesh, reference):
    check_case(reference, ARCH, ARCH, None, mesh)
