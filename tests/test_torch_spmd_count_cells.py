"""The dry run's own cells (`launch.collectives.count_cell`, each at its
published widths and full shape on the production meshes (32, 8) and
(2, 32, 8)) against the formulas of `spmd.py`'s note where they model
the cell: `spmd.serve_comm` for serving with FSDP off and no stub
frontend, `spmd.train_comm` for a dense model's train step. A
prefill is a pass of no decode step into `seq_len` slots, a decode step
the difference of a pass of one step and one of none after a prompt of
`seq_len - 1` tokens. The cells take every split the formula knows:
heads split whole (command-r-35b, minitron-4b), by sequence
(qwen1.5-4b's 20 heads and starcoder2-7b's 36 on a model axis of 8),
the expert-parallel MoE (mixtral-8x7b), MLA with its shared experts
(deepseek-v2-lite-16b), the Mamba-2 mixer (mamba2-370m), and at (2, 32,
8) a prefill batch of 32 whole on every point of 64 data points (its
caches' slots split over "data": mixtral's 32,768-token prompt
overfills its 4,096-slot window ring, and the written slots are
gathered)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import collectives as C
from repro_torch.launch.dryrun import serve_fsdp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import TRAIN_SETTINGS, microbatches_for
from repro_torch.parallel import spmd as SP
from repro_torch.train.step import TrainConfig

ARCHS = ("qwen1.5-4b", "starcoder2-7b", "command-r-35b", "minitron-4b",
         "mamba2-370m", "deepseek-v2-lite-16b", "mixtral-8x7b")


@pytest.mark.parametrize("multi", (False, True), ids=("single", "multi"))
@pytest.mark.parametrize("shape", ("prefill_32k", "decode_32k"))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_count_is_serve_comm(arch, shape, multi):
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi)
    assert not serve_fsdp(cfg, mesh)
    spec = SHAPES[shape]
    b, s = spec.global_batch, spec.seq_len
    if spec.kind == "prefill":
        want = SP.serve_comm(cfg, mesh, b, s, 0, s)
    else:
        one, none = (SP.serve_comm(cfg, mesh, b, s - 1, g, s)
                     for g in (1, 0))
        want = {k: one[k] - none[k] for k in one}
    got = C.count_cell(arch, shape, mesh)
    assert {k: got[k] * mesh.size for k in SP.COMM} == want
    stats = C.collective_stats(got)
    assert stats["all-to-all"] == stats["collective-permute"] == {
        "count": 0, "bytes": 0}
    assert C.received_bytes(got) == sum(
        got[k + "_bytes"] for k in ("all_reduce", "all_gather",
                                    "reduce_scatter"))


@pytest.mark.parametrize("multi", (False, True), ids=("single", "multi"))
@pytest.mark.parametrize("arch", ("minitron-4b", "command-r-35b"))
def test_train_cell_count_is_train_comm(arch, multi):
    """The dry run's train_4k cell of a dense model whose heads split
    whole (minitron-4b without FSDP, command-r-35b with it), with its
    `TRAIN_SETTINGS` and microbatches, against `spmd.train_comm`: the
    batch over "pod" and "data", FSDP over "data"."""
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi)
    spec, ts = SHAPES["train_4k"], TRAIN_SETTINGS[arch]
    tc = TrainConfig(microbatches=microbatches_for(arch, cfg, mesh, spec),
                     remat=True, loss_chunk=ts.loss_chunk,
                     accum_dtype=ts.accum_dtype)
    got = C.count_cell(arch, "train_4k", mesh)
    assert {k: got[k] * mesh.size for k in SP.COMM} == SP.train_comm(
        cfg, mesh, spec.global_batch, spec.seq_len, tc, ts.fsdp)
