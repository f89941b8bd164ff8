"""Sharded serving against the reference's sharded run, on the CPU
(tests/test_torch_spmd.py's note says how both sides run):

  * minitron-4b (relu2, 6/2 heads), starcoder2-7b (gelu, layernorm, 4/2
    heads of 36) and command-r-35b (8/2 heads) at (2, 2): prefill and
    teacher-forced decode logits within 2e-4 / 3e-4, in f32;
  * the resharding restore: a qwen1.5-4b smoke checkpoint written by the
    reference (`save_tree`), restored onto a (2, 2) mesh with
    `restore_tree(..., shardings=param_shardings(...))`, gives the
    reference's prefill logits within 2e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import restore_tree
from repro_torch.models.common import abstract_params
from repro_torch.parallel import sharding as S

from test_torch_spmd import (  # noqa: F401  (one_torch_thread: a fixture)
    MESHES, T0, check_case, cpu_mesh, one_torch_thread, port_config,
    port_sharded_run, reference_runs,
)

ARCHS = ("minitron-4b", "starcoder2-7b", "command-r-35b")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt") / "qwen"
    cases = [[f"{a}@2x2", a, None, *MESHES["2x2"]] for a in ARCHS]
    return reference_runs(tmp_path_factory, cases, ckpt), ckpt


@pytest.mark.parametrize("arch", ARCHS)
def test_more_archs_match_reference_on_2x2(arch, reference):
    check_case(reference[0], arch, arch, None, "2x2")


def test_restore_reference_checkpoint_onto_a_mesh(reference):
    ref, ckpt = reference
    cfg = port_config("qwen1.5-4b")
    shape, axes, fsdp = MESHES["2x2"]
    mesh = cpu_mesh(shape, axes)
    params = restore_tree(str(ckpt), abstract_params(cfg, device="cpu"),
                          S.param_shardings(cfg, mesh, fsdp=fsdp))
    got = port_sharded_run(cfg, params, shape, axes, None, calls_to=T0)
    np.testing.assert_allclose(got["prefill"], ref["ckpt/prefill"],
                               rtol=2e-4, atol=2e-4)
