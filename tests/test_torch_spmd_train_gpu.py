"""Sharded training (`build_train_step(..., mesh=)`) on an NVIDIA GPU.

Imports torch, numpy and `repro_torch` only (no jax, no reference
package), so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_spmd_train_gpu.py

Every test carries the `gpu` marker and skips, with a reason, where
`torch.cuda.is_available()` is false. Four mesh points on one card
(`["cuda:0"] * 4`), qwen1.5-4b's smoke config in f32 with TF32 off:
* the sharded step against the unsharded step on the same weights and
  batch, as tests/test_torch_spmd_train.py holds it on the CPU, at 1e-4
  where the CPU test holds 1e-5 (cuBLAS sums in other orders);
* a step with remat under a 30 s rendezvous timeout finishes: on CUDA
  autograd runs a backward on one worker thread per device unless
  `spmd.run` turns that off in each point's thread, and the four points
  of one card would then wait for each other on that one thread until
  the timeout (no CPU test can show it: a CPU backward runs on the
  caller's thread);
* the sharded step with a point on each of four cards (the collectives
  as peer copies) against the unsharded step, at the same bounds; it
  skips with fewer than four cards;
* deepseek-v2-lite-16b at its published widths cut to 3 layers (MLA's
  gathered latent and rope keys; 64 experts, 32 a point, and the shared
  experts' two stacked layers, one a point; the dense first layer), one
  f32 AdamW step sharded on (2, 2) of cuda:0 x 4 with FSDP against the
  unsharded step, through `chip_smoke.sharded_train_gate`: the step
  passes the gate of path `train-sharded` (every leaf's gradient within
  `SHARDED_TRAIN_GRAD_REL`, the loss, norm, parameters and updates
  within theirs), the card's check of the expert-parallel backward, and
  its control (a data shard's gradient only) fails it."""
import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.parallel import spmd as SP
from repro_torch.train.step import TrainConfig

from test_torch_spmd_train import CASES, batch_of, check_case

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sharded step runs on CUDA "
                    "streams a mesh point")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("case", ["2x2", "2x2-nofsdp"])
def test_sharded_step_matches_unsharded_on_one_card(case, cuda):
    check_case(case, device="cuda:0", tol=1e-4)


def test_sharded_step_across_four_cards(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: a mesh point on each")
    check_case("2x2", device=[f"cuda:{i}" for i in range(4)], tol=1e-4)


def test_sharded_step_backward_finishes_within_its_timeout(cuda,
                                                           monkeypatch):
    monkeypatch.setattr(SP, "DEFAULT_TIMEOUT", 30.0)
    t0 = time.perf_counter()
    check_case("2x2", device="cuda:0", tol=1e-4)
    assert time.perf_counter() - t0 < 30.0


def test_deepseek_sharded_step_passes_the_smoke_gate(cuda):
    import chip_smoke
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_layers=3)
    mesh = make_test_mesh((2, 2), ("data", "model"), devices=[cuda] * 4)
    out = chip_smoke.sharded_train_gate(
        torch, cfg, mesh, batch_of(cfg, cuda), TrainConfig(microbatches=2,
                                                     loss_chunk=64), True)
    sound, control = out["sharded"], out["control"]
    assert sound["passes_gate"], sound
    assert not control["passes_gate"], control
