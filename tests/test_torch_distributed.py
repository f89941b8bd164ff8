"""Port parity of the distributed filter transfer
(`repro_torch.core.distributed`, `repro_torch.launch.mesh`,
`repro_torch.parallel.sharding`) against the reference, on the CPU.

The port's shards are tensors on the devices of
`make_data_mesh(p, devices=["cpu"] * p)`, where K2 and K3 run their plain
torch versions. Inputs are made from a seed with numpy. The all-reduced
filter words must equal the reference's `repro.core.bloom.build` over
all the build keys and the sharded mask its `repro.core.bloom.probe` of
the whole probe column, bit for bit (the reference's own
tests/test_distributed.py runs its sharded transfer under 8 forced XLA
devices in a subprocess; its single-device build and probe are the same
filter, DESIGN §3). `distributed_semi_join` must equal `np.isin`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import bloom as rbloom
from repro.core import hashing as rhashing
from repro.core.engine_bloom import get_engine as rget_engine
from repro.parallel.sharding import axis_size as raxis_size
from repro_torch.core import bloom, distributed
from repro_torch.core.engine_bloom import get_engine
from repro_torch.launch.mesh import DataMesh, make_data_mesh
from repro_torch.parallel.sharding import axis_size


def _cat(shards):
    return np.concatenate([s.cpu().numpy() for s in shards])


def _keys(seed, nb=4096, npr=5003):
    rng = np.random.default_rng(seed)
    bkeys = rng.integers(-10**6, 10**6, nb).astype(np.int64)
    pkeys = np.concatenate([bkeys[: npr // 2],
                            rng.integers(2 * 10**6, 3 * 10**6,
                                         npr - npr // 2).astype(np.int64)])
    return bkeys, rng.permutation(pkeys)


def _reference(bkeys, pkeys, nblocks):
    blo, bhi = rhashing.key_halves(bkeys)
    plo, phi = rhashing.key_halves(pkeys)
    words = np.asarray(rbloom.build(jnp.asarray(blo), jnp.asarray(bhi),
                                    jnp.ones(len(bkeys), bool), nblocks))
    hit = np.asarray(rbloom.probe(jnp.asarray(words), jnp.asarray(plo),
                                  jnp.asarray(phi)))
    return words, hit


@pytest.mark.parametrize("tree_or", [False, True])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_distributed_transfer_equals_reference_build_and_probe(p, tree_or):
    """Each shard's K2 build, OR all-reduced, is the reference's filter
    over every build key on every shard; the sharded K3 probe is its
    probe of the whole column, padding rows False."""
    mesh = make_data_mesh(p, devices=["cpu"] * p)
    for seed in range(2):
        bkeys, pkeys = _keys(seed)
        nblocks = rbloom.blocks_for(len(bkeys))
        want_words, want_hit = _reference(bkeys, pkeys, nblocks)
        blo, bhi, bm = distributed.shard_table_arrays(bkeys, mesh)
        plo, phi, pm = distributed.shard_table_arrays(pkeys, mesh)
        words = distributed.distributed_bloom_build(
            blo, bhi, bm, nblocks, mesh, tree_or=tree_or)
        assert len(words) == p
        for w in words:
            np.testing.assert_array_equal(bloom.words_to_host(w),
                                          want_words)
        fn = distributed.make_distributed_transfer(mesh, nblocks,
                                                   tree_or=tree_or)
        got = _cat(fn(blo, bhi, bm, plo, phi, pm))
        np.testing.assert_array_equal(got[:len(pkeys)], want_hit)
        assert not got[len(pkeys):].any()
        assert want_hit[np.isin(pkeys, bkeys)].all()


@pytest.mark.parametrize("p", [2, 8])
def test_engine_hooks_size_and_shard_as_reference(p):
    """`BloomEngine.make_distributed_transfer` sizes the filter for the
    live build keys as the reference's engine does, and `shard_keys`
    pads each shard to the reference's power-of-two bucket; the result
    is the reference's probe."""
    mesh = make_data_mesh(p, devices=["cpu"] * p)
    bkeys, pkeys = _keys(p, nb=3000, npr=7001)
    eng, reng = get_engine("cuda", device="cpu"), rget_engine("numpy")
    assert eng.k == reng.k
    nblocks = rbloom.blocks_for(len(bkeys))
    _, want = _reference(bkeys, pkeys, nblocks)
    plo, phi, pm = eng.shard_keys(pkeys, mesh)
    per = rbloom._bucket(-(-len(pkeys) // p))
    assert [len(s) for s in plo] == [per] * p
    blo, bhi, bm = eng.shard_keys(bkeys, mesh)
    for e in (eng, get_engine("numpy")):
        fn = e.make_distributed_transfer(mesh, live_keys=len(bkeys),
                                         tree_or=p == 8)
        got = _cat(fn(blo, bhi, bm, plo, phi, pm))
        np.testing.assert_array_equal(got[:len(pkeys)], want)


@pytest.mark.parametrize("p", [1, 2, 8])
def test_distributed_semi_join_equals_isin(p):
    mesh = make_data_mesh(p, devices=["cpu"] * p)
    rng = np.random.default_rng(p)
    for dtype in (np.int32, np.int64):
        b = rng.integers(0, 10**6, 4096).astype(dtype)
        pk = np.concatenate([b[:1000], rng.integers(
            2 * 10**6, 3 * 10**6, 3096).astype(dtype)])
        per_b, per_p = len(b) // p, len(pk) // p
        split = [torch.from_numpy(a[s * n:(s + 1) * n])
                 for a, n in ((b, per_b), (pk, per_p)) for s in range(p)]
        bsh, psh = split[:p], split[p:]
        bm = [torch.ones(per_b, dtype=torch.bool) for _ in range(p)]
        bm[-1][:7] = False                  # invalid rows never match
        pm = [torch.ones(per_p, dtype=torch.bool) for _ in range(p)]
        got = _cat(distributed.distributed_semi_join(mesh)(bsh, bm, psh,
                                                           pm))
        live_b = np.concatenate([a.numpy()[m.numpy()]
                                 for a, m in zip(bsh, bm)])
        np.testing.assert_array_equal(got, np.isin(pk, live_b))


def test_or_all_reduce_variants_agree():
    """Gather-OR and recursive doubling give every shard the OR of all
    shards' words."""
    rng = np.random.default_rng(5)
    devs = [torch.device("cpu")] * 8
    words = [torch.from_numpy(rng.integers(-2**31, 2**31, (16, 8),
                                           dtype=np.int64)
                              .astype(np.int32)) for _ in range(8)]
    want = np.bitwise_or.reduce([w.numpy() for w in words])
    for fn in (distributed._or_all_reduce, distributed._or_all_reduce_tree):
        for out in fn(words, devs):
            np.testing.assert_array_equal(out.numpy(), want)
    with pytest.raises(AssertionError):
        distributed._or_all_reduce_tree(words[:3], devs[:3])


def test_data_mesh_and_axis_size():
    """`axis_size` reads a DataMesh as the reference's reads a mesh;
    `make_data_mesh` takes explicit devices, repeated ones included."""
    mesh = make_data_mesh(devices=["cpu"] * 4)
    assert isinstance(mesh, DataMesh)
    assert mesh.shape == {"data": 4} and mesh.axis_names == ("data",)
    for name in ("data", "model"):
        assert axis_size(mesh, name) == raxis_size(mesh, name)
    assert axis_size(mesh, "model") == 1
    assert make_data_mesh(2, axis="rows", devices=["cpu"] * 4).shape == \
        {"rows": 2}
    with pytest.raises(ValueError):
        make_data_mesh(8, devices=["cpu"] * 4)


def test_data_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_data_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_data_mesh(devices=["cuda:0"] * 2)


@pytest.mark.parametrize("tree_or", [False, True])
def test_one_shard_equals_reference_transfer_in_process(tree_or):
    """On this process's one XLA device the reference's own sharded
    functions run in-process: at one shard, `shard_table_arrays`'s
    layout and `make_distributed_transfer`'s mask equal the reference's
    (bucketed as `shard_keys` pads)."""
    from repro.core import distributed as rdist
    from repro.launch.mesh import make_data_mesh as rmake_data_mesh
    rmesh = rmake_data_mesh(1)
    mesh = make_data_mesh(devices=["cpu"])
    bkeys, pkeys = _keys(9, nb=1000, npr=3001)
    nblocks = rbloom.blocks_for(len(bkeys))
    rb = rdist.shard_table_arrays(bkeys, rmesh, bucket=True)
    rp = rdist.shard_table_arrays(pkeys, rmesh, bucket=True)
    b = distributed.shard_table_arrays(bkeys, mesh, bucket=True)
    pr = distributed.shard_table_arrays(pkeys, mesh, bucket=True)
    for got, want in zip((*b, *pr), (*rb, *rp)):
        g = _cat(got)
        np.testing.assert_array_equal(
            g.view(np.uint32) if g.dtype == np.int32 else g,
            np.asarray(want))
    want = np.asarray(rdist.make_distributed_transfer(
        rmesh, nblocks, tree_or=tree_or)(*rb, *rp))
    got = _cat(distributed.make_distributed_transfer(
        mesh, nblocks, tree_or=tree_or)(*b, *pr))
    np.testing.assert_array_equal(got, want)
