"""Port parity of the transfer-artifact cache
(`repro_torch.core.artifact_cache`, a copy of
`repro.core.artifact_cache`): content checksums equal the reference's on
what each package's executor caches for Q5 (filters and the slot state),
and the cache's own behaviour (LRU order, invalidation, export/absorb,
verify-on-hit corruption self-heal) matches the reference's tests. One
deliberate difference: a `torch.Tensor` reaching the checksum walk
raises `TypeError` (cached artifacts are host values)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.artifact_cache import ArtifactCache as RArtifactCache
from repro.core.artifact_cache import content_checksum as rcontent_checksum
from repro.core.artifact_cache import content_checksums as rchecksums
from repro.core.transfer import make_strategy as rmake_strategy
from repro.relational import ExecConfig as RExecConfig
from repro.relational import Executor as RExecutor
from repro.relational.table import table_digest as rtable_digest
from repro.tpch import build_query as rbuild_query
from repro_torch import interop
from repro_torch.core import faultinject
from repro_torch.core.artifact_cache import (
    _VERIFY_SEEDS, ArtifactCache, content_checksum, content_checksums,
)
from repro_torch.core.transfer import make_strategy
from repro_torch.relational import ExecConfig, Executor
from repro_torch.relational.plancache import PlanCache
from repro_torch.relational.table import Table, table_digest
from repro_torch.tpch import build_query


def _export(catalog):
    return {name: {c: (t[c].decode(), t[c].valid) for c in t.names}
            for name, t in catalog.items()}


@pytest.fixture(scope="module")
def port_tiny(tpch_tiny):
    return interop.catalog_from_arrays(_export(tpch_tiny))


@pytest.fixture(scope="module")
def port_small(tpch_small):
    return interop.catalog_from_arrays(_export(tpch_small))


def _port_cfg(backend, ac, pc=None):
    return ExecConfig(
        strategy=make_strategy("pred-trans", backend=backend, device="cpu",
                               artifact_cache=ac),
        join_backend=backend, torch_device="cpu", artifact_cache=ac,
        plan_cache=pc)


@pytest.fixture(scope="module")
def reference_q5_rows(tpch_tiny):
    ac = RArtifactCache()
    RExecutor(tpch_tiny, RExecConfig(
        strategy=rmake_strategy("pred-trans", backend="numpy",
                                artifact_cache=ac),
        artifact_cache=ac)).execute(rbuild_query(5, sf=0.002))
    return ac.export_entries()


@pytest.mark.parametrize("backend", ["numpy", "cuda"])
def test_q5_artifact_checksums_equal_reference(port_tiny, reference_q5_rows,
                                               backend):
    """Each package's executor caches Q5's filters and slot state in the
    same order; every filter's stored checksums (the uint32 view of the
    device words on `cuda`) and the slot state's equal the reference's
    (the transfer snapshot's wall seconds and backend name aside)."""
    ac = ArtifactCache()
    Executor(port_tiny, _port_cfg(backend, ac)).execute(
        build_query(5, sf=0.002))
    rows = ac.export_entries()
    assert [r[0][0] for r in rows] == [r[0][0] for r in reference_q5_rows]
    assert sum(r[0][0] == "bloom" for r in rows) > 5
    for (key, value, nbytes, _, sums, _), ref in zip(rows,
                                                     reference_q5_rows):
        assert nbytes == ref[2]
        if key[0] == "bloom":
            assert value[0].dtype == np.uint32
            assert sums == ref[4] == rchecksums(ref[1])
            continue
        slots, snap = value
        rslots, rsnap = ref[1]
        assert content_checksum(slots) == rcontent_checksum(rslots)
        assert snap.backend == backend
        assert content_checksum(dataclasses.replace(
            snap, seconds=0.0, backend=rsnap.backend)) == \
            rcontent_checksum(dataclasses.replace(rsnap, seconds=0.0))


@pytest.mark.parametrize("n", [16, 20_000, 1 << 17])
def test_content_checksums_equal_reference_on_arrays(n):
    rng = np.random.default_rng(n)
    words = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    value = (words, {"k": rng.integers(0, 9, n)}, None, 3, "s")
    assert content_checksums(value) == rchecksums(value)
    assert len(content_checksums(value)) == (
        1 if words.nbytes <= 64 << 10 else _VERIFY_SEEDS)


def test_tensor_raises_type_error():
    t = torch.arange(2000, dtype=torch.int32)
    with pytest.raises(TypeError, match="host values"):
        content_checksum((np.zeros(4), t))
    ac = ArtifactCache()
    with pytest.raises(TypeError, match="torch.Tensor"):
        ac.put(("bloom", b"t"), (t, None), nbytes=8000)
    assert len(ac) == 0
    # the words a cached filter holds: the tensor's host uint32 view
    ac.put(("bloom", b"t"), (t.numpy().view(np.uint32), None), nbytes=8000)
    assert ac.get(("bloom", b"t")) is not None


def test_lru_and_invalidation():
    ac = ArtifactCache(max_bytes=1000)
    t = Table.from_arrays({"x": np.arange(4, dtype=np.int64)}, "t")
    ac.put(("bloom", b"a"), ("A",), nbytes=400, versions=[t.version])
    ac.put(("bloom", b"b"), ("B",), nbytes=400, versions=[99999])
    assert ac.get(("bloom", b"a")) == ("A",)
    ac.put(("bloom", b"c"), ("C",), nbytes=400, versions=[])   # evicts b
    assert ac.get(("bloom", b"b")) is None
    assert ac.invalidate_table(t) == 1
    assert ac.get(("bloom", b"a")) is None
    assert ac.get(("bloom", b"c")) is not None
    ac.put(("bloom", b"huge"), ("D",), nbytes=10**6)           # > budget
    assert ac.get(("bloom", b"huge")) is None
    snap = ac.snapshot()
    assert snap["evictions"] == 1 and snap["invalidated"] == 1
    assert ac.invalidate_all() == 1 and len(ac) == 0


def test_eviction_prefers_cheap_rebuilds():
    """Cost-to-rebuild weighted LRU: among the oldest entries the one
    cheapest per byte goes first, as in the reference."""
    def run(cls):
        ac = cls(max_bytes=1000)
        ac.put(("bloom", b"dear"), ("x",), nbytes=300, cost_ns=10**9)
        ac.put(("bloom", b"cheap"), ("y",), nbytes=300, cost_ns=10)
        ac.put(("bloom", b"unknown"), ("z",), nbytes=300)
        ac.put(("bloom", b"new"), ("w",), nbytes=300, cost_ns=10**6)
        return [k[1] for k, *_ in ac.export_entries()]
    assert run(ArtifactCache) == run(RArtifactCache) == [b"dear", b"cheap",
                                                         b"new"]


def test_export_absorb_reverifies_content():
    ac = ArtifactCache()
    arr = np.arange(1000, dtype=np.int64)
    ac.put(("filter", "a"), arr, arr.nbytes, versions=[7])
    rows = ac.export_entries()
    assert rows and rows[0][4] == content_checksums(arr) == rchecksums(arr)
    fresh = ArtifactCache()
    assert fresh.absorb(rows) == (1, 0)
    corrupt = [(k, np.zeros_like(v), nb, vers, cks, cost)
               for k, v, nb, vers, cks, cost in rows]
    fresh2 = ArtifactCache()
    assert fresh2.absorb(corrupt) == (0, 1)
    assert fresh2.corruptions == 1


def test_corruption_detected_and_dropped():
    ac = ArtifactCache()
    words = np.arange(64, dtype=np.uint32)
    ac.put(("bloom", b"sig"), (words, None), nbytes=words.nbytes)
    assert ac.get(("bloom", b"sig")) is not None
    words[3] ^= 0xFFFF                     # flip bits in place
    assert ac.get(("bloom", b"sig")) is None       # dropped, miss
    assert ac.corruptions == 1 and len(ac) == 0
    assert ac.snapshot()["corruptions"] == 1


def test_rotating_verify_catches_mid_buffer_corruption():
    ac = ArtifactCache()
    big = np.arange(20_000, dtype=np.int64)      # 160 KiB
    ac.put(("filter", "x"), big, big.nbytes)
    assert len(ac._entries[("filter", "x")][3]) == _VERIFY_SEEDS
    assert ac.get(("filter", "x")) is not None
    big[10_000] = -1                             # mid-buffer, off-window
    for hits in range(1, _VERIFY_SEEDS + 1):
        if ac.get(("filter", "x")) is None:
            break
    else:
        pytest.fail("mid-buffer corruption never detected")
    assert ac.corruptions == 1 and hits <= _VERIFY_SEEDS


def test_deserialize_fault_counts_as_corruption():
    ac = ArtifactCache()
    ac.put(("bloom", b"x"), (np.ones(8, np.uint32), None), nbytes=32)
    with faultinject.inject({"cache.deserialize": 0}) as sched:
        assert ac.get(("bloom", b"x")) is None     # absorbed, not raised
    assert sched.fired["cache.deserialize"] == 1
    assert ac.corruptions == 1


def test_verify_on_hit_can_be_disabled():
    ac = ArtifactCache(verify_on_hit=False)
    words = np.arange(8, dtype=np.uint32)
    ac.put(("bloom", b"k"), (words, None), nbytes=32)
    words[0] ^= 1
    assert ac.get(("bloom", b"k")) is not None
    assert ac.corruptions == 0


@pytest.mark.parametrize("backend", ["numpy", "cuda"])
def test_cache_self_heal_end_to_end(tpch_small, port_small, backend):
    """Corrupt a stored slot table's bytes: the warm rerun detects it,
    recomputes, matches the reference oracle, and the healed entry
    replays warm next time."""
    want = rtable_digest(RExecutor(tpch_small, RExecConfig(
        late_materialize=False)).execute(rbuild_query(5, sf=0.01))[0])
    ac, pc = ArtifactCache(), PlanCache()
    ex = Executor(port_small, _port_cfg(backend, ac, pc))
    assert table_digest(ex.execute(build_query(5, sf=0.01))[0]) == want
    key = next(k for k in ac._entries if k[0] == "slots")
    tbl = ac._entries[key][0][0][0][0]
    col = tbl[tbl.names[0]]
    col.data.flags.writeable = True
    col.data[0] += 1
    r2, s2 = ex.execute(build_query(5, sf=0.01))
    assert table_digest(r2) == want
    assert not s2.transfer.from_cache
    assert ac.corruptions >= 1
    r3, s3 = ex.execute(build_query(5, sf=0.01))
    assert table_digest(r3) == want and s3.transfer.from_cache
