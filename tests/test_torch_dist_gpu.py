"""The distributed runtime's device paths on an NVIDIA GPU: the exchange
over a mesh of four shards on one card, the sharded Bloom transfer
through K2 and K3, and broadcast joins whose local engine returns device
index vectors.

Imports torch, numpy and `repro_torch` only (no jax, no reference
package), so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_dist_gpu.py

Every test carries the `gpu` marker and skips, with a reason, where
`torch.cuda.is_available()` is false; the tests of a mesh across cards
skip with fewer than two (run them on a host with four). Outputs are
integer and boolean
arrays: they must equal the simulated exchange, the plain versions on
the CPU and the host join bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import bloom, distributed
from repro_torch.core.engine_join import (
    CudaJoinEngine, NumpyJoinEngine, sorted_join_indices,
)
from repro_torch.core.engine_join_dist import (
    MeshExchange, SimulatedExchange, broadcast_join_indices,
    shuffle_join_indices,
)
from repro_torch.kernels.bloom import ops as kb
from repro_torch.launch.mesh import make_data_mesh

pytestmark = pytest.mark.gpu

HOWS = ("inner", "left", "semi", "anti")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _mesh(dev, p=4):
    return make_data_mesh(p, devices=[dev] * p)


def test_mesh_exchange_on_one_card_equals_simulated(cuda):
    """Ragged uint32 blocks through all_to_all and all_gather over
    cuda:0 x 4 == the simulated exchange; the strategies over it == the
    single-host join."""
    rng = np.random.default_rng(3)
    ex, sim = MeshExchange(_mesh(cuda)), SimulatedExchange(4)
    assert ex.device_backed and ex.nshards == 4
    blocks = [[rng.integers(0, 2**32, (int(rng.integers(0, 300)), 3),
                            dtype=np.uint32) for _ in range(4)]
              for _ in range(4)]
    for g, w in zip(ex.all_to_all(blocks), sim.all_to_all(blocks)):
        np.testing.assert_array_equal(g, w)
    shards = [rng.integers(0, 2**32, (int(rng.integers(0, 200)), 2),
                           dtype=np.uint32) for _ in range(4)]
    np.testing.assert_array_equal(ex.all_gather(shards),
                                  sim.all_gather(shards))
    host = NumpyJoinEngine()
    for nb, npr in ((4096, 20000), (17, 5000), (5000, 33)):
        bk = rng.integers(-3, nb // 2 + 1, nb).astype(np.int64)
        pk = rng.integers(-3, nb // 2 + 9, npr).astype(np.int64)
        for how in HOWS:
            want = sorted_join_indices(bk, pk, how)
            for got in (shuffle_join_indices(bk, pk, how, ex),
                        broadcast_join_indices(bk, pk, how, ex, host)):
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("tree_or", [False, True])
def test_distributed_transfer_on_cuda_equals_cpu_plain(cuda, tree_or):
    """Four shards on one card (K2 builds, OR all-reduce, K3 probes) ==
    the same transfer on four CPU shards (the plain versions): words and
    masks bit for bit; K2 and K3 launch once a shard, K1 and K7 never."""
    rng = np.random.default_rng(7)
    bkeys = rng.integers(0, 6_000_000, 300_000).astype(np.int64)
    pkeys = rng.integers(0, 6_000_000, 1_000_003).astype(np.int64)
    nblocks = bloom.blocks_for(len(bkeys))
    out = {}
    for dev in ("cpu", cuda):
        mesh = _mesh(dev)
        b = distributed.shard_table_arrays(bkeys, mesh, bucket=True)
        p = distributed.shard_table_arrays(pkeys, mesh, bucket=True)
        kb.reset_launches()
        words = distributed.distributed_bloom_build(*b, nblocks, mesh,
                                                    tree_or=tree_or)
        fn = distributed.make_distributed_transfer(mesh, nblocks,
                                                   tree_or=tree_or)
        mask = fn(*b, *p)
        out[str(dev)] = ([w.cpu() for w in words],
                         torch.cat([m.cpu() for m in mask]),
                         dict(kb.LAUNCHES))
    (cw, cm, _), (gw, gm, launches) = out["cpu"], out[str(cuda)]
    for a, b in zip(cw, gw):
        assert torch.equal(a, b)
    assert torch.equal(cm, gm)
    assert launches["bloom_build"] == 8 and launches["probe"] == 4
    assert launches["multi_probe"] == launches["bloom_transfer"] == 0
    hit = gm.numpy()[:len(pkeys)]
    assert hit[np.isin(pkeys, bkeys)].all()


def test_distributed_semi_join_on_cuda_equals_isin(cuda):
    rng = np.random.default_rng(11)
    b = rng.integers(0, 10**6, 40_000).astype(np.int64)
    p = rng.integers(0, 2 * 10**6, 100_000).astype(np.int64)
    bsh = [torch.from_numpy(c).to(cuda) for c in np.split(b, 4)]
    psh = [torch.from_numpy(c).to(cuda) for c in np.split(p, 4)]
    bm = [torch.ones(len(c), dtype=torch.bool, device=cuda) for c in bsh]
    pm = [torch.ones(len(c), dtype=torch.bool, device=cuda) for c in psh]
    got = torch.cat([m.cpu() for m in distributed.distributed_semi_join(
        _mesh(cuda))(bsh, bm, psh, pm)]).numpy()
    np.testing.assert_array_equal(got, np.isin(p, b))


def test_broadcast_join_with_device_index_vectors_equals_host(cuda):
    """A broadcast join whose local engine is the cuda engine with the
    plane on (its shard results are device tensors, downloaded) == the
    host engine's, NULL planes included."""
    rng = np.random.default_rng(5)
    local = CudaJoinEngine(device=cuda)
    assert local.device_resident
    host = NumpyJoinEngine()
    for ex in (SimulatedExchange(4), MeshExchange(_mesh(cuda))):
        for nb, npr in ((3000, 50_000), (1, 1000), (20_000, 7)):
            bk = rng.integers(-5, nb, nb).astype(np.int64)
            pk = rng.integers(-5, nb + 50, npr).astype(np.int64)
            bv, pv = rng.random(nb) > 0.1, rng.random(npr) > 0.1
            for how in HOWS:
                for valid in ((None, None), (bv, pv)):
                    want = broadcast_join_indices(bk, pk, how, ex, host,
                                                  *valid)
                    got = broadcast_join_indices(bk, pk, how, ex, local,
                                                 *valid)
                    assert got[2] == want[2]
                    for g, w in zip(got[:2], want[:2]):
                        assert isinstance(g, np.ndarray)
                        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# a mesh across cards (skips with fewer than two)
# --------------------------------------------------------------------------


@pytest.fixture()
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs: a mesh across cards")
    return make_data_mesh()


def test_mesh_exchange_across_cards_equals_simulated(cards):
    """The default mesh (the largest power of two of the visible cards):
    peer copies deliver the simulated exchange's blocks."""
    p = len(cards.devices)
    assert len({d.index for d in cards.devices}) == p
    rng = np.random.default_rng(13)
    ex, sim = MeshExchange(cards), SimulatedExchange(p)
    blocks = [[rng.integers(0, 2**32, (int(rng.integers(0, 500)), 4),
                            dtype=np.uint32) for _ in range(p)]
              for _ in range(p)]
    for g, w in zip(ex.all_to_all(blocks), sim.all_to_all(blocks)):
        np.testing.assert_array_equal(g, w)
    shards = [rng.integers(0, 2**32, (int(rng.integers(0, 300)), 3),
                           dtype=np.uint32) for _ in range(p)]
    np.testing.assert_array_equal(ex.all_gather(shards),
                                  sim.all_gather(shards))


@pytest.mark.parametrize("tree_or", [False, True])
def test_distributed_transfer_across_cards_equals_cpu_plain(cards, tree_or):
    """K2 and K3 launched on each shard's own card (the current device
    switched for the call), the filter OR-ed across cards: words on every
    card and the mask == the CPU plain versions'."""
    p = len(cards.devices)
    rng = np.random.default_rng(17)
    bkeys = rng.integers(0, 6_000_000, 500_000).astype(np.int64)
    pkeys = rng.integers(0, 6_000_000, 2_000_001).astype(np.int64)
    nblocks = bloom.blocks_for(len(bkeys))
    out = []
    for mesh in (make_data_mesh(p, devices=["cpu"] * p), cards):
        b = distributed.shard_table_arrays(bkeys, mesh, bucket=True)
        pr = distributed.shard_table_arrays(pkeys, mesh, bucket=True)
        kb.reset_launches()
        words = distributed.distributed_bloom_build(*b, nblocks, mesh,
                                                    tree_or=tree_or)
        mask = distributed.make_distributed_transfer(
            mesh, nblocks, tree_or=tree_or)(*b, *pr)
        assert [m.device for m in mask] == [t.device for t in pr[0]]
        out.append(([w.cpu() for w in words],
                    torch.cat([m.cpu() for m in mask]), dict(kb.LAUNCHES)))
    (cw, cm, _), (gw, gm, launches) = out
    for w in gw:
        assert torch.equal(w, cw[0])
    assert torch.equal(gm, cm)
    assert launches["bloom_build"] == 2 * p and launches["probe"] == p


def test_executor_distributed_across_cards(cards):
    """With more than one card visible the auto rule takes the
    device-backed exchange over every card; Q5 and Q9 through the cuda
    backends stay md5-equal to the eager numpy oracle."""
    from repro_torch.core.transfer import make_strategy
    from repro_torch.relational import ExecConfig, Executor
    from repro_torch.relational.table import table_digest
    from repro_torch.tpch import build_query, generate
    sf = 0.05
    cat = generate(sf=sf, seed=7)
    cfg = ExecConfig(strategy=make_strategy("pred-trans", backend="cuda"),
                     join_backend="cuda", engine="distributed")
    for qn in (5, 9):
        want, _ = Executor(cat, ExecConfig(late_materialize=False)).execute(
            build_query(qn, sf=sf))
        got, st = Executor(cat, cfg).execute(build_query(qn, sf=sf))
        assert table_digest(got) == table_digest(want), qn
        d = st.report()["dist"]
        assert d["device_backed"] and d["nshards"] == len(cards.devices)
        assert d["shuffle_bytes"] + d["broadcast_bytes"] > 0
