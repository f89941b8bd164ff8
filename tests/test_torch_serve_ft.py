"""The port's serving layer under overload, faults and restarts, as the
reference's serving tests drive it (`tests/test_serve.py`,
`tests/test_recovery.py`, `tests/test_fault_tolerance.py`): admission
reject and shedding, deadlines and cancellation, worker death, table
updates, shutdown, and warm-restart snapshots. Results are md5-equal to
the reference package's on the same data; the servers run the cuda
backends on `torch_device="cpu"` (the kernels' plain versions) unless a
test says otherwise."""
import pickle
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.transfer import make_strategy as rmake_strategy
from repro.relational import ExecConfig as RExecConfig
from repro.relational import Executor as RExecutor
from repro.relational.plan import GroupBy as RGroupBy
from repro.relational.plan import Join as RJoin
from repro.relational.plan import Scan as RScan
from repro.relational.table import Column as RColumn
from repro.relational.table import Table as RTable
from repro.relational.table import table_digest as rtable_digest
from repro.tpch import build_query as rbuild_query
from repro_torch import interop
from repro_torch.core import faultinject
from repro_torch.core.errors import (
    BackendError, DeadlineExceeded, ResourceExhausted,
)
from repro_torch.core.faultinject import FaultSchedule, InjectedFault
from repro_torch.kernels.bloom import ops as kb
from repro_torch.relational.plan import GroupBy, Join, Scan
from repro_torch.relational.table import Column, Table, table_digest
from repro_torch.serve import (
    QueryServer, ServeConfig, ServerSaturated, load_snapshot,
    restore_if_present, write_snapshot,
)
from repro_torch.serve.snapshot import _MAGIC
from repro_torch.tpch import build_query

SF = 0.01


def _cfg(**kw):
    kw.setdefault("torch_device", "cpu")
    return ServeConfig(**kw)


def _export(catalog):
    return {name: {c: (t[c].decode(), t[c].valid) for c in t.names}
            for name, t in catalog.items()}


@pytest.fixture(scope="module")
def port_small(tpch_small):
    return interop.catalog_from_arrays(_export(tpch_small))


def _arrays(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    return {"fact": {"f_k": rng.integers(0, 100, n),
                     "f_j": rng.integers(0, 60, n),
                     "f_v": rng.integers(0, 10, n)},
            "dim": {"d_k": np.arange(100), "d_w": rng.integers(0, 5, 100)},
            "dim2": {"e_k": np.arange(60), "e_w": rng.integers(0, 7, 60)}}


def _small_catalog(seed=0):
    return {name: Table({c: Column(a) for c, a in cols.items()}, name)
            for name, cols in _arrays(seed=seed).items()}


def _small_plan():
    return GroupBy(Join(Scan("fact"), Scan("dim"), ["f_k"], ["d_k"]),
                   ["d_w"], [("cnt", "count", None)])


def _small_oracle(seed=0):
    """The reference's digest of `_small_plan` over the same arrays."""
    cat = {name: RTable({c: RColumn(a) for c, a in cols.items()}, name)
           for name, cols in _arrays(seed=seed).items()}
    plan = RGroupBy(RJoin(RScan("fact"), RScan("dim"), ["f_k"], ["d_k"]),
                    ["d_w"], [("cnt", "count", None)])
    return rtable_digest(RExecutor(cat, rmake_strategy(
        "pred-trans")).execute(plan)[0])


def _q5_oracle(tpch_small):
    return rtable_digest(RExecutor(tpch_small, RExecConfig(
        late_materialize=False)).execute(rbuild_query(5, SF))[0])


def _gate(srv):
    """Stall `srv`'s workers inside `_execute` until the event is set."""
    gate = threading.Event()
    orig = srv._execute

    def stalled(req):
        gate.wait(20)
        return orig(req)
    srv._execute = stalled
    return gate


# --------------------------------------------------------------------------
# admission: reject and shedding
# --------------------------------------------------------------------------


def test_admission_reject(port_small):
    cfg = _cfg(strategy="no-pred-trans", workers=1, max_queue=1,
               admission="reject")
    with QueryServer(port_small, cfg) as srv:
        gate = _gate(srv)
        first = srv.submit(build_query(5, SF))      # occupies the worker
        got = None
        try:
            for _ in range(4):
                srv.submit(build_query(5, SF))
        except ServerSaturated as e:
            got = e
        gate.set()
        first.result(30)
        assert got is not None
        assert srv.metrics.rejected >= 1


def test_admission_shedding_typed_and_immediate():
    cat = _small_catalog()
    with QueryServer(cat, _cfg(strategy="pred-trans", workers=1,
                               max_queue=0)) as srv:
        srv.query(_small_plan())       # calibrate the service EWMA
        gate = _gate(srv)
        running = srv.submit(_small_plan())
        queued = srv.submit(_small_plan())
        srv.metrics._service_ewma = 5.0          # 1 queued * 5s >> 0.5s
        with pytest.raises(ResourceExhausted) as ei:
            srv.submit(_small_plan(), timeout=0.5)
        assert ei.value.phase == "admission"
        accepted = srv.submit(_small_plan())     # no deadline: never shed
        gate.set()
        results = [f.result(30) for f in (running, queued, accepted)]
        snap = srv.metrics.snapshot()
    assert snap["shed"] == 1 and snap["completed"] == 4
    want = _small_oracle()
    assert all(table_digest(r) == want for r, _ in results)


def test_shed_disabled_admits_doomed_queries():
    with QueryServer(_small_catalog(), _cfg(strategy="pred-trans",
                                            workers=1, shed=False)) as srv:
        srv.query(_small_plan())
        srv.metrics._service_ewma = 5.0
        srv.submit(_small_plan(), timeout=30.0).result(30)
        assert srv.metrics.snapshot()["shed"] == 0


# --------------------------------------------------------------------------
# deadlines, cancellation, worker death, failing queries
# --------------------------------------------------------------------------


def test_timeout_and_cancel_counters(port_small):
    with QueryServer(port_small, _cfg(strategy="pred-trans",
                                      workers=1)) as srv:
        with pytest.raises(DeadlineExceeded):
            srv.query(build_query(5, SF), timeout=0.0)
        gate = _gate(srv)
        fut = srv.submit(build_query(5, SF))
        assert srv.cancel(fut) is True       # queued or running
        gate.set()
        with pytest.raises(BaseException):   # cancelled either way
            fut.result(30)
        snap = srv.metrics_snapshot()["server"]
    assert snap["timeouts"] == 1
    assert snap["cancellations"] + snap["failed"] >= 1


def test_worker_crash_isolated_to_one_query():
    want = _small_oracle()
    with QueryServer(_small_catalog(), _cfg(strategy="pred-trans",
                                            workers=1)) as srv:
        with faultinject.inject(FaultSchedule({"worker.crash": 0})):
            fut = srv.submit(_small_plan(), tag="victim")
            with pytest.raises(BackendError) as ei:
                fut.result(30)
            assert ei.value.phase == "serve"
            res, _ = srv.query(_small_plan(), tag="survivor")
        snap = srv.metrics.snapshot()
    assert table_digest(res) == want
    assert snap["worker_deaths"] == 1
    assert snap["failed"] == 1 and snap["completed"] == 1


def test_worker_survives_failing_query(tpch_small, port_small):
    """degrade=False on the numpy backends: the faulting query errors its
    own Future, and the same worker serves the next query."""
    cfg = _cfg(strategy="pred-trans", join_backend="numpy", workers=1,
               degrade=False)
    with QueryServer(port_small, cfg) as srv:
        with faultinject.inject({"engine.probe": "all"}):
            with pytest.raises(InjectedFault):
                srv.submit(build_query(5, SF)).result(30)
        res, _ = srv.query(build_query(5, SF))
        snap = srv.metrics_snapshot()["server"]
    assert table_digest(res) == _q5_oracle(tpch_small)
    assert snap["errors"] == 1 and snap["completed"] == 1


def test_close_resolves_all_futures(port_small):
    srv = QueryServer(port_small, _cfg(strategy="no-pred-trans", workers=1,
                                       max_queue=0))
    gate = _gate(srv)
    futs = [srv.submit(build_query(5, SF)) for _ in range(6)]
    closer = threading.Thread(
        target=srv.close, kwargs={"wait": True, "cancel_pending": True})
    closer.start()
    gate.set()
    closer.join(60)
    assert not closer.is_alive()
    assert all(f.done() for f in futs)
    with pytest.raises(RuntimeError):
        srv.submit(build_query(5, SF))


def test_close_default_drains_queued_work(port_small):
    srv = QueryServer(port_small, _cfg(strategy="pred-trans", workers=2))
    futs = [srv.submit(build_query(qn, SF)) for qn in (3, 5, 10)]
    srv.close(wait=True)
    assert all(f.done() and f.exception() is None for f in futs)


# --------------------------------------------------------------------------
# table updates
# --------------------------------------------------------------------------


def test_update_table_invalidates_and_recomputes(tpch_small, port_small):
    """Swapping a table drops its derived artifacts, and the next run
    matches the reference's cold run on the new data."""
    with QueryServer(dict(port_small), _cfg(strategy="pred-trans",
                                            workers=2)) as srv:
        d1 = table_digest(srv.query(build_query(5, SF))[0])
        res, st = srv.query(build_query(5, SF))
        assert table_digest(res) == d1 and st.transfer.from_cache
        region = port_small["region"]
        half = Table(region.gather(np.arange(len(region) // 2)).columns,
                     "region")
        assert srv.update_table("region", half) > 0
        got, st = srv.query(build_query(5, SF))
    rregion = tpch_small["region"]
    rhalf = RTable(rregion.gather(np.arange(len(rregion) // 2)).columns,
                   "region")
    want = rtable_digest(RExecutor({**tpch_small, "region": rhalf},
                                   rmake_strategy("pred-trans")).execute(
        rbuild_query(5, SF))[0])
    assert not st.transfer.from_cache
    assert table_digest(got) == want != d1


# --------------------------------------------------------------------------
# warm-restart snapshots
# --------------------------------------------------------------------------


def _count_kernel_calls(monkeypatch):
    """Count K1/K2 wrapper calls (the engine looks them up per call)."""
    calls = {"multi_probe": 0, "build": 0}
    for name in calls:
        fn = getattr(kb, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(kb, name, counted)
    return calls


def _tensors(obj, seen=None):
    """Every torch.Tensor reachable from `obj` (containers, dataclasses,
    objects' __dict__)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.keys()) + list(obj.values())
    elif isinstance(obj, (list, tuple, set, frozenset)):
        items = list(obj)
    elif hasattr(obj, "__dict__"):
        items = list(vars(obj).values())
    else:
        return []
    return [t for it in items for t in _tensors(it, seen)]


def test_snapshot_roundtrip_warm_restart(tmp_path, tpch_small, port_small,
                                         monkeypatch):
    """Drain a cuda-backend server to a snapshot; the restored server's
    first Q5 replays warm, md5-equal, with no K1/K2 call. The snapshot
    holds host values only, and restores into a numpy-backend server
    (no device) warm too."""
    want = _q5_oracle(tpch_small)
    path = str(tmp_path / "serve.snap")
    cfg = dict(strategy="pred-trans", workers=2,
               strategy_kw={"device_resident": True})
    calls = _count_kernel_calls(monkeypatch)
    srv = QueryServer(port_small, _cfg(**cfg))
    srv.query(build_query(5, SF))
    written = srv.drain_to_snapshot(path)
    assert calls["multi_probe"] > 0 and calls["build"] > 0
    calls.update(multi_probe=0, build=0)
    assert written["artifacts"] > 0
    with open(path, "rb") as f:
        raw = f.read()
    doc = pickle.loads(raw[len(_MAGIC):].partition(b"\n")[2])
    assert _tensors(doc) == []
    for backend in ("cuda", "numpy"):
        with QueryServer(port_small, _cfg(join_backend=backend,
                                          snapshot_path=path,
                                          **cfg)) as srv2:
            info = srv2.restore_info
            res, stats = srv2.query(build_query(5, SF))
            assert "restore" in srv2.metrics_snapshot()
        assert info["loaded"] and info["artifacts"] == written["artifacts"]
        assert table_digest(res) == want
        assert stats.report()["transfer"]["from_cache"]
    assert calls == {"multi_probe": 0, "build": 0}


def test_snapshot_cross_process_version_remap(tmp_path):
    """A restarted process rebuilds the same catalog under different
    version numbers: restore digest-matches the tables, re-adopts the
    snapshot's versions, and the first query replays warm."""
    path = str(tmp_path / "serve.snap")
    cat1 = _small_catalog(seed=3)
    srv = QueryServer(cat1, _cfg(strategy="pred-trans", workers=1))
    srv.query(_small_plan())
    srv.drain_to_snapshot(path)
    cat2 = _small_catalog(seed=3)
    assert all(cat2[n].version != cat1[n].version for n in cat2)
    with QueryServer(cat2, _cfg(strategy="pred-trans", workers=1,
                                snapshot_path=path)) as srv2:
        info = srv2.restore_info
        res, stats = srv2.query(_small_plan())
    assert info["loaded"] and info["tables_matched"] > 0
    assert info["artifacts"] > 0 and info["artifacts_dropped"] == 0
    assert stats.report()["transfer"]["from_cache"]
    assert table_digest(res) == _small_oracle(seed=3)


def test_snapshot_stale_table_invalidates_entries(tmp_path):
    path = str(tmp_path / "serve.snap")
    srv = QueryServer(_small_catalog(seed=4), _cfg(strategy="pred-trans",
                                                   workers=1))
    srv.query(_small_plan())
    srv.drain_to_snapshot(path)
    cat2 = _small_catalog(seed=4)
    cat2["fact"] = _small_catalog(seed=99)["fact"]   # new content
    with QueryServer(cat2, _cfg(strategy="pred-trans", workers=1,
                                snapshot_path=path)) as srv2:
        info = srv2.restore_info
        res, stats = srv2.query(_small_plan())
    assert info["loaded"] and info["tables_stale"] >= 1
    assert not stats.report()["transfer"]["from_cache"]
    rcat = {name: RTable({c: RColumn(a) for c, a in cols.items()}, name)
            for name, cols in _arrays(seed=4).items()}
    rcat["fact"] = RTable({c: RColumn(a) for c, a in
                           _arrays(seed=99)["fact"].items()}, "fact")
    plan = RGroupBy(RJoin(RScan("fact"), RScan("dim"), ["f_k"], ["d_k"]),
                    ["d_w"], [("cnt", "count", None)])
    assert table_digest(res) == rtable_digest(RExecutor(
        rcat, rmake_strategy("pred-trans")).execute(plan)[0])


def test_snapshot_bad_files_mean_cold_start(tmp_path):
    from repro_torch.core.artifact_cache import ArtifactCache
    path = str(tmp_path / "serve.snap")
    cat = _small_catalog()
    write_snapshot(path, cat, artifact_cache=ArtifactCache())
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF                    # flip one payload byte
    open(path, "wb").write(bytes(raw))
    info = load_snapshot(path, cat, artifact_cache=ArtifactCache())
    assert not info["loaded"] and info["reason"] == "signature-mismatch"
    write_snapshot(path, cat)
    with faultinject.inject(FaultSchedule({"snapshot.load": 0})):
        info = load_snapshot(path, cat)
    assert not info["loaded"] and info["reason"].startswith("corrupt:")
    assert restore_if_present(None, {}) is None
    assert restore_if_present(str(tmp_path / "missing.snap"), {}) is None
