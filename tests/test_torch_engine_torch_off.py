"""The port's `torch` backends with the device-resident data plane off
(`device="off"`), against the reference's `jax` backends: the 20 TPC-H
queries late and eager (md5, per-vertex counts and `DeviceStats` equal,
as in `test_torch_engine_torch.py`), `pred-trans-adaptive` by digests on
both planes, and the pieces: the plain-torch key -> row map against the
sequential insert, its `DeviceStats` against the reference's jnp map,
the join engines pair for pair, and the torch bloom engine's words
against the host mirror's."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.core import device_plane as rdp
from repro.core.engine_join import get_join_engine as rget_join_engine
from repro.kernels.semijoin import ops as rsj
from repro.relational.table import table_digest as rtable_digest
from repro.tpch import QUERIES
from repro_torch.core import bloom, device_plane, hashing
from repro_torch.core.engine_bloom import TorchEngine, get_engine
from repro_torch.core.engine_join import TorchJoinEngine, get_join_engine
from repro_torch.kernels.semijoin import ops as sj
from repro_torch.relational.table import table_digest

from test_torch_engine_torch import (  # noqa: F401  (fixture)
    check_pair, port_tiny, run_pair)

HOWS = ("inner", "left", "semi", "anti")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the suite runs in several
    worker processes at once, and a torch thread pool in each
    oversubscribes the cores (the training files took 25x their
    single-process time so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("late", [True, False], ids=["late", "eager"])
@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_tpch_torch_plane_off_matches_reference_jax(tpch_tiny, port_tiny,
                                                    qn, late):
    ref, port = run_pair(tpch_tiny, port_tiny, qn, "off", late)
    check_pair(ref, port, (qn, "off", late))


@pytest.mark.parametrize("plane", ["on", "off"])
@pytest.mark.parametrize("qn", [3, 5, 9])
def test_tpch_torch_adaptive_md5_equal_reference(tpch_tiny, port_tiny, qn,
                                                 plane):
    """pred-trans-adaptive on torch: the result's md5 equals the
    reference jax backend's (its cost rows differ, so its schedule may)."""
    (rres, _), (res, _) = run_pair(tpch_tiny, port_tiny, qn, plane, True,
                                   strategy="pred-trans-adaptive")
    assert table_digest(res) == rtable_digest(rres), (qn, plane)


def _halves(keys):
    lo, hi = hashing.key_halves(keys)
    return (torch.from_numpy(lo.view(np.int32)),
            torch.from_numpy(hi.view(np.int32)))


@pytest.mark.parametrize("n,dups", [(1, 0), (700, 0), (5000, 0),
                                    (5000, 300)])
def test_build_rows_torch_answers_as_the_sequential_insert(n, dups):
    """The parallel-claim map: the same occupied count as the sequential
    insert, every lookup the same row (the last row of a duplicated
    key), misses -1; every occupied slot holds a distinct key."""
    rng = np.random.default_rng(n + dups)
    keys = rng.integers(-2**40, 2**40, n).astype(np.int64)
    if dups:
        keys[rng.integers(0, n, dups)] = keys[rng.integers(0, n, dups)]
    lo, hi = _halves(keys)
    cap = sj.capacity_for(n)
    table, occ = sj.build_rows_torch(lo, hi, torch.ones(n, dtype=bool), cap)
    want, wocc = sj.build_rows_ref(lo, hi, cap)
    assert int(occ) == int(wocc[0]) == len(np.unique(keys))
    probe = np.concatenate([keys, rng.integers(2**41, 2**42, 500)])
    plo, phi = _halves(probe)
    np.testing.assert_array_equal(sj.lookup_ref(table, plo, phi).numpy(),
                                  sj.lookup_ref(want, plo, phi).numpy())
    full = table[:, 2] != 0
    held = hashing.keys64(table[full, 0], table[full, 1])
    assert held.unique().numel() == int(occ)


def test_build_rows_torch_skips_masked_rows():
    keys = np.arange(100, dtype=np.int64) * 7
    lo, hi = _halves(keys)
    mask = torch.arange(100) % 3 == 0
    table, occ = sj.build_rows_torch(lo, hi, mask, 512)
    assert int(occ) == 34
    rows = sj.lookup_ref(table, lo, hi).numpy()
    np.testing.assert_array_equal(rows, np.where(mask.numpy(),
                                                 np.arange(100), -1))


@pytest.mark.parametrize("dups", [False, True])
def test_joinmap_torch_device_stats_match_reference_jnp(dups):
    """Build and lookup cross the host<->device boundary as the
    reference's jnp map does: the same syncs and bytes, the same
    occupancy and rows."""
    rng = np.random.default_rng(3)
    keys = rng.permutation(3000).astype(np.int64)
    if dups:
        keys[:10] = keys[10:20]
    probe = rng.integers(0, 4000, 2500).astype(np.int64)
    rst = rdp.DeviceStats()
    with rdp.track(rst):
        rtable, rocc = rsj.joinmap_build(keys, use_pallas=False)
        rrows = rsj.joinmap_lookup(rtable, probe, use_pallas=False)
    st = device_plane.DeviceStats()
    with device_plane.track(st):
        table, occ = sj.joinmap_build_torch(keys, "cpu")
        rows = sj.joinmap_lookup_torch(table, probe)
    assert occ == rocc
    assert st.report() == rst.report()
    if not dups:
        np.testing.assert_array_equal(rows, rrows)


@pytest.mark.parametrize("plane", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("how", HOWS)
def test_torch_join_engine_matches_reference_jax(plane, how):
    """join_indices and join_indices_valid pair for pair with the
    reference's JaxJoinEngine (unique and duplicated build keys, NULLs
    on both sides), with equal DeviceStats."""
    rng = np.random.default_rng(7)
    reng = rget_join_engine("jax", device_resident=plane)
    eng = get_join_engine("torch", device_resident=plane, device="cpu")
    assert isinstance(eng, TorchJoinEngine)
    for build in (rng.permutation(1500).astype(np.int64),
                  rng.integers(0, 400, 1500).astype(np.int64)):
        probe = rng.integers(0, 2000, 1800).astype(np.int64)
        bv = rng.random(len(build)) > 0.1
        pv = rng.random(len(probe)) > 0.1
        for args in ((), (bv, pv)):
            rst, st = rdp.DeviceStats(), device_plane.DeviceStats()
            with rdp.track(rst):
                want = reng.join_indices_valid(build, probe, how, *args)
            with device_plane.track(st):
                got = eng.join_indices_valid(build, probe, how, *args)
            for g, w in zip(got, want):
                g = g.numpy() if isinstance(g, torch.Tensor) else g
                np.testing.assert_array_equal(np.asarray(g, np.int64),
                                              np.asarray(w, np.int64))
            assert st.report() == rst.report(), (how, plane, len(args))


@pytest.mark.parametrize("plane", [True, False], ids=["on", "off"])
def test_torch_engine_words_equal_host_mirror(plane):
    """Filters the torch bloom engine builds over a survivor set are the
    host mirror's word for word, and its probes the host's masks; the
    column's device hash state is computed once per bucket."""
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 10**9, 3000).astype(np.int64)
    valid = rng.random(3000) > 0.2
    mask = rng.random(3000) > 0.5
    eng = get_engine("torch", device_resident=plane, device="cpu")
    host = get_engine("numpy")
    assert isinstance(eng, TorchEngine) and eng.host_side == (not plane)
    ek, hk = eng.keys(keys), host.keys(keys)
    f = eng.build_filter(ek, mask=mask, valid=valid)
    want = host.build_filter(hk, mask=mask, valid=valid)
    np.testing.assert_array_equal(bloom.words_to_host(f.words), want.words)
    probe = rng.integers(0, 10**9, 4000).astype(np.int64)
    pk = eng.keys(np.concatenate([keys, probe]))
    got = eng.probe_filter(want, pk, live=np.arange(7000) % 4 != 0)
    np.testing.assert_array_equal(got, host.probe_filter(
        want, host.keys(np.concatenate([keys, probe])),
        live=np.arange(7000) % 4 != 0))
    if plane:
        assert ek.dev_hashed(4096) is ek.dev_hashed(4096)
