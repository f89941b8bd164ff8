"""Port parity of the serving layer (`repro_torch.serve`): the port's
`QueryServer` against the reference's on the same TPC-H catalog.

Every result is md5-equal (`table_digest`) to the reference server's on
`join_backend="numpy"`, cold and warm, for workers 1 and 4 and three
strategies, on the port's numpy backend and on its cuda backend with
`torch_device="cpu"` (the kernels' plain versions). With one worker the
schedule is fixed, and the plan-cache and artifact-cache counters and
each query's `ExecStats.degraded` equal the reference server's, fault
injection included. The rest covers what the port adds or changes: the
cuda default, per-query device round trips under concurrency, launch
counts under threads, the engine singletons' race, and a failing kernel
wrapper, which errors its Future and is never answered on the host."""
import asyncio
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from repro.core import faultinject as rfaultinject
from repro.relational import ExecConfig as RExecConfig
from repro.relational import Executor as RExecutor
from repro.relational.table import table_digest as rtable_digest
from repro.serve import QueryServer as RQueryServer
from repro.serve import ServeConfig as RServeConfig
from repro.tpch import QUERIES, build_query as rbuild_query
from repro_torch import interop
from repro_torch.core import faultinject
from repro_torch.core.errors import BackendError
from repro_torch.kernels.bloom import ops as kb
from repro_torch.kernels.flashattn import ops as fa
from repro_torch.kernels.semijoin import ops as sj
from repro_torch.relational.table import table_digest
from repro_torch.serve import QueryServer, ServeConfig
from repro_torch.tpch import build_query

SF = 0.01
QNS = sorted(QUERIES)
STRATEGIES = ["pred-trans", "pred-trans-adaptive", "no-pred-trans"]


def _export(catalog):
    return {name: {c: (t[c].decode(), t[c].valid) for c in t.names}
            for name, t in catalog.items()}


@pytest.fixture(scope="module")
def port_small(tpch_small):
    return interop.catalog_from_arrays(_export(tpch_small))


@pytest.fixture(scope="module")
def oracle(tpch_small):
    """The reference eager oracle's digest of every query."""
    return {qn: rtable_digest(RExecutor(tpch_small, RExecConfig(
        late_materialize=False)).execute(rbuild_query(qn, SF))[0])
        for qn in QNS}


def _cfg(**kw):
    kw.setdefault("torch_device", "cpu")
    return ServeConfig(**kw)


def _serve_passes(srv, build, passes=2):
    """Submit the 20 queries in order, wait for all; `passes` times.
    Returns per pass and query (digest, from_cache, filters_reused,
    degraded)."""
    out = []
    for _ in range(passes):
        futs = [(qn, srv.submit(build(qn, SF))) for qn in QNS]
        rows = {}
        for qn, f in futs:
            res, st = f.result(60)
            rows[qn] = (table_digest(res) if build is build_query
                        else rtable_digest(res),
                        st.transfer.from_cache, st.transfer.filters_reused,
                        st.degraded)
        out.append(rows)
    return out


def _counters(srv):
    snap = srv.metrics_snapshot()
    ac = snap["artifact_cache"]
    return ({k: snap["plan_cache"][k] for k in ("entries", "hits",
                                                "misses")},
            {k: ac[k] for k in ("entries", "bytes", "evictions",
                                "invalidated", "corruptions", "kinds")},
            snap["server"]["warm_replays"])


_REFERENCE = {}


def _reference(tpch_small, strategy, fault=None):
    """The reference server at workers=1 on the numpy backend: each
    pass's rows and the final cache counters (memoised)."""
    key = (strategy, fault)
    if key not in _REFERENCE:
        cfg = RServeConfig(strategy=strategy, join_backend="numpy",
                           workers=1)
        with RQueryServer(tpch_small, cfg) as srv:
            if fault is None:
                rows = _serve_passes(srv, rbuild_query)
            else:
                with rfaultinject.inject({fault: "all"}):
                    rows = _serve_passes(srv, rbuild_query)
            _REFERENCE[key] = (rows, _counters(srv))
    return _REFERENCE[key]


@pytest.mark.parametrize("backend", ["numpy", "cuda"])
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_serve_passes_match_reference(tpch_small, port_small, oracle,
                                      strategy, workers, backend):
    """Cold then warm, every digest equals the reference server's (and
    its eager oracle's); the warm pass replays slot states. With one
    worker the per-query cache flags, `degraded` records and the cache
    counters equal the reference server's."""
    ref_rows, ref_counters = _reference(tpch_small, strategy)
    with QueryServer(port_small, _cfg(strategy=strategy, workers=workers,
                                      join_backend=backend)) as srv:
        rows = _serve_passes(srv, build_query)
        counters = _counters(srv)
    for got, want in zip(rows, ref_rows):
        assert {qn: r[0] for qn, r in got.items()} == \
            {qn: r[0] for qn, r in want.items()} == oracle
    assert all(r[1] for r in rows[1].values())       # warm: slot replays
    if workers == 1:
        assert rows == ref_rows
        assert counters == ref_counters


@pytest.mark.parametrize("strategy", ["pred-trans", "pred-trans-adaptive"])
def test_degraded_records_match_reference(tpch_small, port_small, oracle,
                                          strategy):
    """A probe fault at every call: on the numpy backends the port's
    ladder takes the reference's moves query by query (one worker, fixed
    schedule), with equal cache counters and oracle results."""
    ref_rows, ref_counters = _reference(tpch_small, strategy,
                                        "engine.probe")
    with QueryServer(port_small, _cfg(strategy=strategy, workers=1,
                                      join_backend="numpy")) as srv:
        with faultinject.inject({"engine.probe": "all"}):
            rows = _serve_passes(srv, build_query)
        counters = _counters(srv)
        degradations = srv.metrics_snapshot()["server"]["degradations"]
    assert rows == ref_rows
    assert counters == ref_counters
    assert {qn: r[0] for qn, r in rows[0].items()} == oracle
    assert degradations == sum(bool(r[3]) for p in rows for r in p.values())
    assert degradations > 0


def test_mixed_sessions_on_threads(port_small, oracle):
    """Four clients on four threads, two per strategy, each submitting
    the 20 queries through its own `Session`, then the same warm."""
    with QueryServer(port_small, _cfg(strategy="pred-trans",
                                      join_backend="cuda",
                                      workers=4)) as srv:
        sessions = [srv.session(s, tag=f"c{i}") for i, s in enumerate(
            ["pred-trans", "pred-trans", "pred-trans-adaptive",
             "pred-trans-adaptive"])]
        results, errors = [], []

        def client(sess):
            try:
                futs = [(qn, sess.submit(build_query(qn, SF)))
                        for qn in QNS]
                results.extend((qn, table_digest(f.result(60)[0]))
                               for qn, f in futs)
            except BaseException as e:        # noqa: BLE001 — reported
                errors.append(e)

        for _ in range(2):
            threads = [threading.Thread(target=client, args=(s,))
                       for s in sessions]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
        snap = srv.metrics_snapshot()
    assert errors == []
    assert len(results) == 2 * 4 * len(QNS)
    assert all(d == oracle[qn] for qn, d in results)
    assert snap["server"]["completed"] == 2 * 4 * len(QNS)
    assert snap["server"]["warm_replays"] >= 4 * len(QNS)
    assert set(snap["server"]["per_tag"]) == {"c0", "c1", "c2", "c3"}


def test_aquery_and_query(port_small, oracle):
    with QueryServer(port_small, _cfg(strategy="pred-trans",
                                      join_backend="cuda")) as srv:
        async def many():
            return await asyncio.gather(*(
                srv.aquery(build_query(qn, SF)) for qn in (3, 5, 10)))
        got = asyncio.run(many())
        res, st = srv.query(build_query(5, SF))
    assert [table_digest(r) for r, _ in got] == [oracle[q]
                                                 for q in (3, 5, 10)]
    assert table_digest(res) == oracle[5] and st.transfer.from_cache


def test_round_trips_under_concurrency_equal_serial(port_small):
    """`DeviceStats` is per thread: each query's `report()["device"]`
    counts its own crossings while three others run, and equals its
    count from one worker. No filter is cached (a zero-byte artifact
    cache) and each query runs once, so every run does the same work."""
    def run(workers):
        with QueryServer(port_small, _cfg(
                strategy="pred-trans", join_backend="cuda", workers=workers,
                artifact_cache_bytes=0,
                strategy_kw={"device_resident": True})) as srv:
            futs = [(qn, srv.submit(build_query(qn, SF))) for qn in QNS]
            return {qn: f.result(60)[1].report()["device"]
                    for qn, f in futs}
    serial = run(1)
    assert sum(d["round_trips"] for d in serial.values()) > 0
    assert sum(d["fused_calls"] for d in serial.values()) > 0
    for _ in range(2):
        assert run(4) == serial


# --------------------------------------------------------------------------
# what the port changes: defaults, validation, failing kernels
# --------------------------------------------------------------------------


def test_defaults_run_on_the_card():
    cfg = ServeConfig()
    assert (cfg.join_backend, cfg.torch_device) == ("cuda", "cuda")
    with pytest.raises(NotImplementedError, match="item 8"):
        ServeConfig(engine="distributed")
    with pytest.raises(ValueError, match="join_backend"):
        ServeConfig(join_backend="pallas")


def test_default_server_without_cuda_raises(port_small, monkeypatch):
    """With no CUDA, the default server's query errors its Future with
    the device error; it is not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with QueryServer(port_small, ServeConfig(strategy="pred-trans",
                                             workers=1)) as srv:
        with pytest.raises(RuntimeError, match="CUDA"):
            srv.query(build_query(5, SF))
        snap = srv.metrics_snapshot()["server"]
    assert snap["errors"] == 1 and snap["completed"] == 0


@pytest.mark.parametrize("wrapper", ["multi_probe", "build"])
def test_failing_kernel_errors_future_and_opens_breaker(
        port_small, monkeypatch, wrapper):
    """A K1 or K2 wrapper that fails (as a failed build or launch does)
    under the server on the cuda backend: the query's Future raises, the
    rung's breaker records it and opens, and the next query gets the
    circuit-open error. No host rung answers either query."""
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise RuntimeError("bloom kernel failed to launch")

    monkeypatch.setattr(kb, wrapper, broken)
    cfg = _cfg(strategy="pred-trans", join_backend="cuda", workers=2,
               breaker_window=2, breaker_threshold=1,
               breaker_cooldown=600.0,
               strategy_kw={"device_resident": True})
    with QueryServer(port_small, cfg) as srv:
        with pytest.raises(RuntimeError, match="failed to launch"):
            srv.query(build_query(5, SF))
        rung = "single/late/cuda+pred-trans"
        assert srv.breakers.snapshot()[rung]["state"] == "open"
        with pytest.raises(BackendError, match="circuit open"):
            srv.query(build_query(5, SF))
        snap = srv.metrics_snapshot()
    assert calls
    assert snap["server"]["errors"] == 2
    assert snap["server"]["completed"] == snap["server"]["degradations"] == 0
    assert set(snap["breakers"]) == {rung}
    assert snap["artifact_cache"]["kinds"].get("slots", {}).get("puts",
                                                                0) == 0


def test_engine_singletons_race_free():
    """Concurrent first-touch engine creation yields one instance per
    key, on both backends (the locked get_* paths)."""
    import repro_torch.core.engine_bloom as eb
    import repro_torch.core.engine_join as ej
    eb._ENGINES.clear()
    ej._ENGINES.clear()
    out = []
    barrier = threading.Barrier(8)

    def touch():
        barrier.wait()
        out.append((eb.get_engine("numpy"), ej.get_join_engine("numpy"),
                    eb.get_engine("cuda", device="cpu"),
                    ej.get_join_engine("cuda", device="cpu")))

    threads = [threading.Thread(target=touch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(out) == 8
    for i in range(4):
        assert len({id(row[i]) for row in out}) == 1


# --------------------------------------------------------------------------
# launch counts under threads
# --------------------------------------------------------------------------


class _OnCuda:
    """A CPU tensor that reports a CUDA device, so a wrapper takes its
    kernel branch as far as the (faked) library call."""
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


def _hammer(fn, threads=8, calls=500):
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    barrier = threading.Barrier(threads)

    def run():
        barrier.wait()
        for _ in range(calls):
            fn()
    try:
        pool = [threading.Thread(target=run) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)


@pytest.mark.parametrize("mod,name", [(kb, "multi_probe"),
                                      (sj, "joinmap_lookup"),
                                      (fa, "flash_decode")])
def test_launch_counts_exact_under_threads(mod, name):
    mod.reset_launches()
    _hammer(lambda: mod.LAUNCHES.bump(name))
    assert mod.LAUNCHES[name] == 8 * 500
    assert sum(mod.LAUNCHES.values()) == 8 * 500
    mod.reset_launches()
    assert sum(mod.LAUNCHES.values()) == 0


def test_k1_wrapper_counts_exact_under_threads(monkeypatch):
    """8 threads × 500 calls of the K1 wrapper, each taking its kernel
    branch through a library that reports success, count 4,000."""
    lib = type("Lib", (), {"bloom_max_filters": staticmethod(lambda: 8),
                           "bloom_multi_probe": staticmethod(
                               lambda *a: 0)})()
    monkeypatch.setattr(kb, "_lib", lambda: lib)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw:
                        _OnCuda(empty(*a, **kw)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    words = _OnCuda(torch.zeros((8, 8), dtype=torch.int32))
    keys = _OnCuda(torch.zeros(64, dtype=torch.int32))
    kb.reset_launches()
    _hammer(lambda: kb.multi_probe([words], [keys], [keys]))
    assert kb.LAUNCHES["multi_probe"] == 8 * 500
    kb.reset_launches()
