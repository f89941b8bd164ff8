"""The count of tests/test_torch_spmd_count.py (its note says what is
held) for MLA: deepseek-v2-lite-16b's smoke config (MLA split over "model", its
latent cache by columns, or by slots over "data" at batch 1; the
expert-parallel MoE with its shared experts gathered along their
layers). On (1, 8), where 8 divides none of its 4 heads, r 64 and dr 16,
MLA splits by sequence (its leaves gathered, each point's rows' latent,
rope keys and y gathered, its cache's slots split, a decode step's
partials merged) and the MoE's d_ff_expert inside each expert: there the
count is also `spmd.serve_comm`'s and `spmd.train_comm`'s."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeSpec
from repro_torch.launch import collectives as C
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.parallel import spmd as SP

from test_torch_spmd_count import (  # noqa: F401  (a fixture)
    GEN, SEQ, _setup, _train_config, cases, check_call, check_serve,
    one_torch_thread,
)

ARCH = "deepseek-v2-lite-16b"


@pytest.mark.parametrize("arch,layout,call", cases((ARCH,)))
def test_count_is_the_real_runs_comm(arch, layout, call, monkeypatch):
    check_call(arch, layout, call, monkeypatch)


@pytest.mark.parametrize("layout", ("2x2", "2x2-b1", "1x4"))
def test_count_serve_is_the_real_pass_comm(layout):
    check_serve(ARCH, layout)


@pytest.mark.parametrize("arch,layout,call", cases((ARCH,),
                                                   layouts=("1x8",)))
def test_sequence_split_count_is_the_real_runs_comm(arch, layout, call,
                                                     monkeypatch):
    check_call(arch, layout, call, monkeypatch)


def test_sequence_split_count_is_serve_comm_and_train_comm():
    """On (1, 8): a served pass into 32 slots (4 a point) counted equals
    the real pass's COMM and `spmd.serve_comm`; a train step's count
    equals `spmd.train_comm`."""
    cap = SEQ + GEN + 13
    assert cap % 8 == 0
    got = check_serve(ARCH, "1x8", cap)
    cfg, mesh, fsdp, batch = _setup(ARCH, "1x8")
    n = mesh.size
    assert SP.serve_comm(cfg, mesh, batch, SEQ, GEN, cap) == {
        k: got[k] * n for k in SP.COMM}
    tc = _train_config(batch)
    got = C.count(cfg, ShapeSpec("t", SEQ, batch, "train"), mesh,
                  fsdp=fsdp, tc=tc, optimizer=D.make_optimizer(ARCH))
    assert SP.train_comm(cfg, mesh, batch, SEQ, tc, fsdp) == {
        k: got[k] * n for k in SP.COMM}


def test_train_comm_is_the_count_with_the_batch_split():
    """On (2, 8), the batch split over "data" too (the MoE's auxiliary
    loss all-reduced over it in the forward and the recomputation): a
    train step's count equals `spmd.train_comm`."""
    cfg, _, fsdp, batch = _setup(ARCH, "1x8")
    mesh = make_test_mesh((2, 8), ("data", "model"), devices=["cpu"] * 16)
    tc = _train_config(batch)
    got = C.count(cfg, ShapeSpec("t", SEQ, batch, "train"), mesh,
                  fsdp=fsdp, tc=tc, optimizer=D.make_optimizer(ARCH))
    assert SP.train_comm(cfg, mesh, batch, SEQ, tc, fsdp) == {
        k: got[k] * mesh.size for k in SP.COMM}
