"""Port parity of the distributed join runtime
(`repro_torch.core.engine_join_dist`) against the reference's
(`repro.core.engine_join_dist`), on the CPU.

Inputs are made from a seed with numpy and fed to both packages. The
reference runs its `SimulatedExchange` (one XLA device in this process;
its own tests tie its `MeshExchange` to that under 8 forced devices).
The port runs its `SimulatedExchange` and its `MeshExchange` on
`make_data_mesh(p, devices=["cpu"] * p)`. Index vectors, wire bytes,
strategy choices, `report()["dist"]`, recovery events and ladder moves
are integers and strings and must be equal; query results equal by md5
(`table_digest`)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine_join_dist as rdist
from repro.core import faultinject as rfi
from repro.core.engine_join import NumpyJoinEngine as RNumpyJoinEngine
from repro.core.recovery import HedgePolicy as RHedgePolicy
from repro.core.recovery import RetryBudget as RRetryBudget
from repro.core.transfer import make_strategy as rmake_strategy
from repro.relational import ExecConfig as RExecConfig
from repro.relational import Executor as RExecutor
from repro.relational.table import table_digest as rtable_digest
from repro.tpch import QUERIES, build_query as rbuild_query
from repro_torch import interop
from repro_torch.core import engine_join_dist as dist
from repro_torch.core import faultinject as fi
from repro_torch.core.engine_join import CudaJoinEngine, NumpyJoinEngine
from repro_torch.core.errors import BackendError
from repro_torch.core.recovery import HedgePolicy, RetryBudget
from repro_torch.core.transfer import make_strategy
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.relational import ExecConfig, Executor
from repro_torch.relational.table import Column, Table, table_digest
from repro_torch.tpch import build_query

HOWS = ("inner", "left", "semi", "anti")
SF = 0.01


def _sides(seed):
    """Duplicate-heavy small-domain keys (negatives included) and NULL
    planes for both sides."""
    rng = np.random.default_rng(seed)
    nb, npr = int(rng.integers(1, 400)), int(rng.integers(1, 900))
    bk = rng.integers(-5, 60, nb).astype(np.int64)
    pk = rng.integers(-5, 70, npr).astype(np.int64)
    return bk, pk, rng.random(nb) > 0.2, rng.random(npr) > 0.3


def _exchange(kind, p):
    if kind == "simulated":
        return dist.SimulatedExchange(p)
    return dist.MeshExchange(make_data_mesh(p, devices=["cpu"] * p))


@pytest.mark.parametrize("kind", ["simulated", "mesh"])
@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("how", HOWS)
def test_strategies_equal_reference(how, p, kind):
    """broadcast_join_indices and shuffle_join_indices: index vectors and
    wire bytes equal the reference's, with and without NULL planes on
    either side; the broadcast's local engine is the host engine and the
    cuda engine with the plane on (device index vectors, downloaded)."""
    ex, rex = _exchange(kind, p), rdist.SimulatedExchange(p)
    locals_ = (NumpyJoinEngine(),
               CudaJoinEngine(device_resident=True, device="cpu"))
    for seed in range(4):
        bk, pk, bv, pv = _sides(seed)
        for bvalid, pvalid in ((None, None), (bv, None), (None, pv),
                               (bv, pv)):
            ctx = (how, p, kind, seed, bvalid is None, pvalid is None)
            want = rdist.shuffle_join_indices(
                bk, pk, how, rex, build_valid=bvalid, probe_valid=pvalid)
            got = dist.shuffle_join_indices(
                bk, pk, how, ex, build_valid=bvalid, probe_valid=pvalid)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=str(ctx))
            want = rdist.broadcast_join_indices(
                bk, pk, how, rex, RNumpyJoinEngine(), build_valid=bvalid,
                probe_valid=pvalid)
            for local in locals_:
                got = dist.broadcast_join_indices(
                    bk, pk, how, ex, local, build_valid=bvalid,
                    probe_valid=pvalid)
                assert got[0].dtype == got[1].dtype == np.int64
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(
                        g, w, err_msg=str((*ctx, local.backend)))


@pytest.mark.parametrize("p", [2, 4, 8])
def test_mesh_exchange_equals_simulated_and_counts_like_reference(p):
    """The port's MeshExchange on CPU devices delivers the simulated
    exchange's blocks, and counts one upload and one download a
    collective with the reference's byte counts (its `_put` of the
    padded send buffer, its download of every shard's receive buffer)."""
    from repro_torch.core import device_plane
    rng = np.random.default_rng(p)
    mesh_ex, sim = _exchange("mesh", p), dist.SimulatedExchange(p)
    assert mesh_ex.device_backed and mesh_ex.nshards == p
    blocks = [[rng.integers(0, 2**32, (int(rng.integers(0, 9)), 3),
                            dtype=np.uint32) for _ in range(p)]
              for _ in range(p)]
    shards = [rng.integers(0, 2**32, (int(rng.integers(0, 7)), 2),
                           dtype=np.uint32) for _ in range(p)]
    st = device_plane.DeviceStats()
    with device_plane.track(st):
        got = mesh_ex.all_to_all(blocks)
        gathered = mesh_ex.all_gather(shards)
    for t, (g, w) in enumerate(zip(got, sim.all_to_all(blocks))):
        np.testing.assert_array_equal(g, w, err_msg=str(t))
    np.testing.assert_array_equal(gathered, sim.all_gather(shards))
    b_a2a = max(8, 1 << (max(len(b) for r in blocks for b in r) - 1)
                .bit_length())
    b_ag = max(8, 1 << (max(len(s) for s in shards) - 1).bit_length())
    assert (st.h2d_syncs, st.d2h_syncs) == (2, 2)
    assert st.h2d_bytes == 4 * p * (p * b_a2a * 3 + b_ag * 2)
    assert st.d2h_bytes == 4 * p * p * (b_a2a * 3 + b_ag * 2)


def test_shard_bounds_and_cursor_equal_reference(tpch_small):
    """shard_bounds equal; shard_cursor's shards materialise to the
    reference's shards of the same join cursor."""
    from repro.core.engine_join import JoinCursor as RJoinCursor
    from repro.core.engine_join import Slot as RSlot
    from repro.relational import ops as rops
    from repro_torch.core.engine_join import JoinCursor, Slot
    from repro_torch.relational import ops
    for n in (0, 1, 7, 64, 1000):
        for p in (1, 2, 4, 8):
            np.testing.assert_array_equal(dist.shard_bounds(n, p),
                                          rdist.shard_bounds(n, p))
    port = interop.catalog_from_arrays(
        {name: {c: (tpch_small[name][c].decode(), tpch_small[name][c].valid)
                for c in tpch_small[name].names}
         for name in ("lineitem", "orders")})
    cols = ["l_orderkey", "o_totalprice"]
    curs = []
    for cat, jc, slot, o in ((tpch_small, RJoinCursor, RSlot, rops),
                             (port, JoinCursor, Slot, ops)):
        bidx, pidx = o.join_indices_nullsafe(
            o.composite_key(cat["orders"], ["o_orderkey"]),
            o.composite_key(cat["lineitem"], ["l_orderkey"]), how="inner")
        curs.append(jc.join(jc.from_slot(slot(cat["lineitem"])),
                            jc.from_slot(slot(cat["orders"])),
                            bidx, pidx, "inner"))
    for p in (2, 8):
        want = rdist.shard_cursor(curs[0], p)
        got = dist.shard_cursor(curs[1], p)
        assert [len(s) for s in got] == [len(s) for s in want]
        for g, w in zip(got, want):
            gt, wt = g.materialize(cols)[0], w.materialize(cols)[0]
            for c in cols:
                np.testing.assert_array_equal(gt[c].data, wt[c].data)


def test_engine_strategy_choice_and_bytes_equal_reference():
    """Small build => broadcast, big symmetric build => shuffle, an empty
    side => local, NULL planes priced in: each join's DistJoinStat and
    the totals equal the reference's (cf. the reference's
    tests/test_engine_join_dist.py)."""
    eng = dist.DistributedJoinEngine(nshards=4, device=False,
                                     torch_device="cpu")
    ref = rdist.DistributedJoinEngine(nshards=4, device=False)
    big_p = np.arange(10_000, dtype=np.int64) % 10
    rng = np.random.default_rng(1)
    calls = [(np.arange(10, dtype=np.int64), big_p, None, None),
             (np.arange(8_000, dtype=np.int64), big_p, None, None),
             (np.array([], np.int64), big_p, None, None),
             (np.arange(3_000, dtype=np.int64), big_p,
              rng.random(3_000) > 0.5, None),
             (np.arange(3_000, dtype=np.int64), big_p, None,
              rng.random(10_000) > 0.5)]
    for bk, pk, bv, pv in calls:
        for how in HOWS:
            got = eng.join_indices_valid(bk, pk, how, bv, pv)
            want = ref.join_indices_valid(bk, pk, how, bv, pv)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    assert ([j.__dict__ for j in eng.stats.joins]
            == [j.__dict__ for j in ref.stats.joins])
    assert eng.stats.strategy_counts() == ref.stats.strategy_counts() \
        == {"broadcast": 12, "shuffle": 4, "local": 4}
    assert (eng.stats.shuffle_bytes, eng.stats.broadcast_bytes) \
        == (ref.stats.shuffle_bytes, ref.stats.broadcast_bytes)


def test_forked_engines_share_exchange_but_not_stats():
    a = dist.get_distributed_engine(4, device=False, torch_device="cpu")
    b = dist.get_distributed_engine(4, device=False, torch_device="cpu")
    assert a.exchange is b.exchange and a.local is b.local
    a.join_indices(np.arange(5, dtype=np.int64),
                   np.arange(9, dtype=np.int64), "inner")
    assert len(a.stats.joins) == 1 and len(b.stats.joins) == 0
    c = dist.get_distributed_engine(4, "cuda", device=False,
                                    torch_device="cpu")
    assert c.exchange is not a.exchange and c.local.backend == "cuda"


def test_auto_exchange_follows_the_visible_cuda_devices():
    """Auto: simulated without a second CUDA device (here: none, or a
    CPU local engine), device-backed on an explicit mesh."""
    assert not dist.DistributedJoinEngine(
        nshards=4, torch_device="cpu").exchange.device_backed
    assert not dist.DistributedJoinEngine(nshards=8).exchange.device_backed
    eng = dist.DistributedJoinEngine(
        mesh=make_data_mesh(2, devices=["cpu", "cpu"]), torch_device="cpu")
    assert eng.exchange.device_backed and eng.nshards == 2
    with pytest.raises(ValueError, match="power of two"):
        dist.MeshExchange(make_data_mesh(3, devices=["cpu"] * 3))
    assert dist._device_count("cpu") == 1


# --------------------------------------------------------------------------
# Executor(engine="distributed") on TPC-H
# --------------------------------------------------------------------------


def _export(catalog):
    return {name: {c: (t[c].decode(), t[c].valid) for c in t.names}
            for name, t in catalog.items()}


@pytest.fixture(scope="module")
def port_small(tpch_small):
    return interop.catalog_from_arrays(_export(tpch_small))


@pytest.fixture(scope="module")
def ref_dist(tpch_small):
    """The reference's distributed executor (numpy backends, 4 simulated
    shards): (digest, report) per query, computed once."""
    cache = {}

    def get(qn):
        if qn not in cache:
            res, st = RExecutor(tpch_small, RExecConfig(
                strategy=rmake_strategy("pred-trans"), engine="distributed",
                dist_shards=4, dist_device=False)).execute(
                rbuild_query(qn, sf=SF))
            cache[qn] = (rtable_digest(res), st.report())
        return cache[qn]
    return get


def _port_cfg(backend, **kw):
    if backend == "numpy":
        strategy = make_strategy("pred-trans")
    else:
        strategy = make_strategy("pred-trans", backend="cuda",
                                 device_resident=True, device="cpu")
    return ExecConfig(strategy=strategy, join_backend=backend,
                      torch_device="cpu", engine="distributed",
                      dist_shards=4, dist_device=False, **kw)


@pytest.mark.parametrize("backend", ["numpy", "cuda"])
@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_tpch_distributed_equals_reference(port_small, ref_dist, qn,
                                           backend):
    """Port, engine="distributed" with 4 simulated shards, on the numpy
    backends and on the cuda backends (device="cpu": the kernels' plain
    versions, the Bloom plane on, the local joins plane off) == the
    reference's distributed executor: md5, `report()["dist"]` key for
    key (the strategies follow the join sizes, not the local backend)
    and `report()["recoveries"]`."""
    want_md5, want = ref_dist(qn)
    res, stats = Executor(port_small, _port_cfg(backend)).execute(
        build_query(qn, sf=SF))
    rep = stats.report()
    assert table_digest(res) == want_md5, (qn, backend)
    assert rep["dist"] == want["dist"], (qn, backend)
    assert rep["recoveries"] == want["recoveries"]
    assert stats.dist.joins, "no joins routed through the runtime"


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


def test_q5_distributed_device_syncs_match_reference_pallas(tpch_tiny,
                                                            monkeypatch):
    """Q5 at sf 0.002, engine="distributed": the cuda backends (Bloom
    plane on, local joins plane off on the CPU) against the reference's
    pallas backends in interpret mode in the same posture: d2h syncs and
    fused calls equal; h2d syncs one lower per hash-map build (the
    reference's all-ones row mask upload, as on the single-host
    plane-off route); the dist report equal."""
    from repro.kernels.semijoin import ops as rsj
    from repro_torch.kernels.semijoin import ops as sj
    sf = 0.002
    ref_builds = _count_calls(monkeypatch, rsj, "joinmap_build")
    builds = _count_calls(monkeypatch, sj, "joinmap_build")
    rres, rstats = RExecutor(tpch_tiny, RExecConfig(
        strategy=rmake_strategy("pred-trans", backend="pallas",
                                device_resident=True),
        join_backend="pallas", engine="distributed", dist_shards=4,
        dist_device=False)).execute(rbuild_query(5, sf=sf))
    cat = interop.catalog_from_arrays(_export(tpch_tiny))
    res, stats = Executor(cat, _port_cfg("cuda")).execute(
        build_query(5, sf=sf))
    assert table_digest(res) == rtable_digest(rres)
    want, got = rstats.report(), stats.report()
    assert got["dist"] == want["dist"]
    assert len(builds) == len(ref_builds) > 0
    for key in ("d2h_syncs", "fused_calls"):
        assert got["device"][key] == want["device"][key], key
    assert got["device"]["h2d_syncs"] == \
        want["device"]["h2d_syncs"] - len(ref_builds)
    assert got["device"]["fused_calls"] > 0


# --------------------------------------------------------------------------
# shard-level recovery and the ladder
# --------------------------------------------------------------------------


def _arrays(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    return {"fact": {"f_k": rng.integers(0, 100, n),
                     "f_j": rng.integers(0, 60, n),
                     "f_v": rng.integers(0, 10, n)},
            "dim": {"d_k": np.arange(100), "d_w": rng.integers(0, 5, 100)},
            "dim2": {"e_k": np.arange(60), "e_w": rng.integers(0, 7, 60)}}


def _catalogs():
    from repro.relational.table import Column as RColumn
    from repro.relational.table import Table as RTable
    arrays = _arrays()
    port = {t: Table({c: Column(v) for c, v in cols.items()}, t)
            for t, cols in arrays.items()}
    ref = {t: RTable({c: RColumn(v) for c, v in cols.items()}, t)
           for t, cols in arrays.items()}
    return ref, port


def _plan(mod_plan):
    return mod_plan.GroupBy(mod_plan.Join(mod_plan.Scan("fact"),
                                          mod_plan.Scan("dim"),
                                          ["f_k"], ["d_k"]),
                            ["d_w"], [("cnt", "count", None)])


def _both(spec, ref_kw=None, port_kw=None):
    """Run the small plan through both distributed executors (2
    simulated shards, the ladder armed) under the same fault schedule;
    returns [(digest, report, fired)] for (reference, port)."""
    import repro.relational.plan as rplan
    import repro_torch.relational.plan as pplan
    ref_cat, port_cat = _catalogs()
    out = []
    for (mkx, mkcfg, strat, fimod, digest, cat, plan, kw) in (
            (RExecutor, RExecConfig, rmake_strategy("pred-trans"), rfi,
             rtable_digest, ref_cat, _plan(rplan), ref_kw or {}),
            (Executor, ExecConfig, make_strategy("pred-trans"), fi,
             table_digest, port_cat, _plan(pplan), port_kw or {})):
        if mkx is Executor:
            kw = dict(kw, torch_device="cpu")
        cfg = mkcfg(strategy=strat, engine="distributed", dist_shards=2,
                    dist_device=False, degrade=True, **kw)
        with fimod.inject(fimod.FaultSchedule(spec)) as sched:
            res, st = mkx(cat, cfg).execute(plan)
        out.append((digest(res), st.report(), sched.total_fired()))
    return out


@pytest.mark.parametrize("spec", [
    {"exchange.send": 0}, {"exchange.recv": 0},
    {"exchange.send": [0, 1, 2]}, {"exchange.send": "all"},
    {"exchange.recv": "all"}, {"shard.delay": 0}],
    ids=["send-retry", "recv-retry", "replay", "send-ladder", "recv-ladder",
         "delay-unhedged"])
def test_recovery_events_and_ladder_equal_reference(spec):
    """Retry in place, lineage replay after exhaustion, and the ladder
    once both are spent (distributed -> single/numpy): the port's
    recovery events and ladder moves equal the reference's, and both
    results equal the undisturbed oracle."""
    (rmd5, rrep, rfired), (md5, rep, fired) = _both(spec)
    assert md5 == rmd5 and fired == rfired > 0
    assert rep["recoveries"] == rrep["recoveries"]
    assert [(d["from"], d["to"], d["phase"], d["error"])
            for d in rep["degraded"]] == \
        [(d["from"], d["to"], d["phase"], d["error"])
         for d in rrep["degraded"]]


def test_hedged_straggler_and_empty_budget_equal_reference():
    """A hedged straggler (first result wins) and an empty retry budget
    (no retry: straight to the ladder) give the reference's events."""
    kw = dict(hedge=(RHedgePolicy(min_delay=0.005, straggle_seconds=0.25),
                     HedgePolicy(min_delay=0.005, straggle_seconds=0.25)))
    (rmd5, rrep, _), (md5, rep, _) = _both(
        {"shard.delay": 0}, {"hedge": kw["hedge"][0]},
        {"hedge": kw["hedge"][1]})
    assert md5 == rmd5 and not rep["degraded"]
    assert rep["recoveries"]["hedges"] == rrep["recoveries"]["hedges"] >= 1
    assert [(e["kind"], e["label"], e["shard"], e["winner"])
            for e in rep["recoveries"]["events"]] == \
        [(e["kind"], e["label"], e["shard"], e["winner"])
         for e in rrep["recoveries"]["events"]]
    rb, b = RRetryBudget(capacity=0.0, refill_per_s=0.0), \
        RetryBudget(capacity=0.0, refill_per_s=0.0)
    (rmd5, rrep, _), (md5, rep, _) = _both(
        {"exchange.send": 0}, {"retry_budget": rb}, {"retry_budget": b})
    assert md5 == rmd5
    assert rep["recoveries"] == rrep["recoveries"]
    assert [d["to"] for d in rep["degraded"]] == \
        [d["to"] for d in rrep["degraded"]] != []
    assert b.refused == rb.refused >= 1


def test_tpch_q5_exchange_ladder_equals_reference(tpch_small, port_small):
    """The reference's tests/test_fault_tolerance.py ladder case: an
    "all" exchange.send schedule knocks Q5's distributed engine down to
    the single-host rung, md5-equal, with the reference's moves."""
    runs = []
    for mkx, mkcfg, strat, fimod, cat, plan, digest, kw in (
            (RExecutor, RExecConfig, rmake_strategy("pred-trans"), rfi,
             tpch_small, rbuild_query(5, SF), rtable_digest, {}),
            (Executor, ExecConfig, make_strategy("pred-trans"), fi,
             port_small, build_query(5, SF), table_digest,
             {"torch_device": "cpu"})):
        cfg = mkcfg(strategy=strat, engine="distributed", dist_shards=4,
                    dist_device=False, degrade=True, **kw)
        with fimod.inject({"exchange.send": "all"}) as sched:
            res, st = mkx(cat, cfg).execute(plan)
        assert sched.total_fired() > 0
        rep = st.report()
        runs.append((digest(res), [(d["from"], d["to"], d["phase"])
                                   for d in rep["degraded"]],
                     rep["recoveries"]))
    assert runs[0] == runs[1]
    assert runs[1][1][0][0].startswith("distributed/")
    assert runs[1][1][0][1].startswith("single/")


def test_cuda_rung_surfaces_an_exhausted_fault():
    """join_backend="cuda" (torch_device="cpu"): a fault that outlasts
    retry and replay surfaces; the rung is not answered on the host."""
    import repro_torch.relational.plan as pplan
    _, cat = _catalogs()
    cfg = ExecConfig(strategy=make_strategy("pred-trans"),
                     join_backend="cuda", torch_device="cpu",
                     engine="distributed", dist_shards=2, dist_device=False,
                     degrade=True)
    with fi.inject({"exchange.send": "all"}):
        with pytest.raises(BackendError):
            Executor(cat, cfg).execute(_plan(pplan))
    # a transient fault still recovers in place on the cuda rung
    with fi.inject(fi.FaultSchedule({"exchange.send": 0})):
        res, st = Executor(cat, cfg).execute(_plan(pplan))
    assert st.report()["recoveries"]["retries"] == 1
    assert not st.degraded
    want, _ = Executor(cat, ExecConfig(late_materialize=False)).execute(
        _plan(pplan))
    assert table_digest(res) == table_digest(want)


def test_serve_config_passes_retry_budget_and_hedge():
    """ServeConfig(engine="distributed"): the server's RetryBudget pays
    the in-place retry and its HedgePolicy hedges the straggler."""
    import repro_torch.relational.plan as pplan
    from repro_torch.serve import QueryServer, ServeConfig
    _, cat = _catalogs()
    cfg = ServeConfig(strategy="pred-trans", engine="distributed",
                      join_backend="numpy", torch_device="cpu", workers=1,
                      hedge=True)
    with QueryServer(cat, cfg) as srv:
        srv.hedge.min_delay = 0.005
        srv.hedge.straggle_seconds = 0.25
        with fi.inject(fi.FaultSchedule({"exchange.send": 0})):
            _, st = srv.query(_plan(pplan))
        assert st.report()["recoveries"]["retries"] == 1
        assert srv.retry_budget.spent == 1
        with fi.inject(fi.FaultSchedule({"shard.delay": 0})):
            _, st = srv.query(_plan(pplan))
        assert st.report()["recoveries"]["hedges"] >= 1
        assert srv.metrics.snapshot()["hedges"] >= 1
    assert st.dist is not None and not st.dist.device_backed
