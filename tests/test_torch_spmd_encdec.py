"""Sharded serving against the reference's sharded run, on the CPU:
whisper-base's smoke config (2 encoder and 2 decoder layers, d_model 64,
4 heads of 16, 16 stub frames a clip, a 512-row vocabulary) on
tests/test_torch_spmd.py's meshes (its note says how both sides run:
the frames drawn from SEED + 1 and split over the data axes with the
tokens, the prefill encoding them and the decode steps taking them
encoded once more). `frame_proj` is split by its columns over "model":
each point projects its columns of the frames, which are all-gathered;
the encoder's attention and MLP, the decoder's self-attention and its
cross-attention (K and V projected from the point's rows of the whole
encoder output) run on each point's heads: 2 a point on (2, 2), with
`fsdp` on and off, and 1 on (1, 4). Prefill and teacher-forced decode
logits within 2e-4 / 3e-4, in f32."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd import (  # noqa: F401  (one_torch_thread: a fixture)
    MESHES, check_case, mesh_cases, one_torch_thread, reference_runs,
)

ARCH = "whisper-base"
CASES = ("2x2", "2x2-nofsdp", "1x4")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(tmp_path_factory, [
        c for c in mesh_cases(ARCH, ARCH) if c[0].split("@")[1] in CASES])


@pytest.mark.parametrize("mesh", CASES)
def test_encoder_decoder_matches_reference_sharded_run(mesh, reference):
    check_case(reference, ARCH, ARCH, None, mesh)
