"""Port parity on the plane-off route: the `cuda` backends with the
device-resident data plane off (`make_strategy(..., device_resident=False)`,
`ExecConfig(device="off")`), on device="cpu" where the kernel wrappers
(K2, K3, K4, K5) run their plain torch versions.

Inputs are made from a seed and fed to both packages. Tables match the
reference eager oracle by md5 (`table_digest`); survivor masks,
per-filter live counts, key ranges, filter words and host<->device sync
counts are integers and match exactly. The plane-off vertex scan itself
is held against the reference in tests/test_torch_engine_bloom.py."""
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine_bloom as reb
from repro.core.transfer import make_strategy as rmake_strategy
from repro.kernels.semijoin import ops as rsj
from repro.relational import ExecConfig as RExecConfig
from repro.relational import Executor as RExecutor
from repro.relational.table import table_digest as rtable_digest
from repro.tpch import QUERIES, build_query as rbuild_query
from repro_torch import interop
from repro_torch.core.transfer import make_strategy
from repro_torch.kernels.semijoin import ops as sj
from repro_torch.relational import ExecConfig, Executor
from repro_torch.relational.table import table_digest
from repro_torch.tpch import build_query, generate

SF = 0.01


def _export(catalog):
    return {name: {c: (t[c].decode(), t[c].valid) for c in t.names}
            for name, t in catalog.items()}


@pytest.fixture(scope="module")
def port_small(tpch_small):
    return interop.catalog_from_arrays(_export(tpch_small))


def _plane_off_cfg(strategy="pred-trans", **kw):
    return ExecConfig(
        strategy=make_strategy(strategy, backend="cuda",
                               device_resident=False, device="cpu"),
        join_backend="cuda", device="off", torch_device="cpu", **kw)


@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_tpch_plane_off_md5_equal_reference(tpch_small, port_small, qn):
    """Port, cuda backends on CPU with the plane off == the reference
    eager oracle, by md5; per-vertex transfer counts == the reference
    numpy engine's."""
    ref, _ = RExecutor(tpch_small, RExecConfig(
        late_materialize=False)).execute(rbuild_query(qn, sf=SF))
    _, rstats = RExecutor(tpch_small, RExecConfig(
        strategy=rmake_strategy("pred-trans", backend="numpy"))).execute(
        rbuild_query(qn, sf=SF))
    res, stats = Executor(port_small, _plane_off_cfg()).execute(
        build_query(qn, sf=SF))
    assert table_digest(res) == rtable_digest(ref), qn
    assert stats.transfer.per_vertex == rstats.transfer.per_vertex
    assert stats.report()["device"]["fused_calls"] == 0


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


def test_q5_plane_off_syncs_match_reference_pallas(tpch_tiny, monkeypatch):
    """Q5 at sf 0.002: d2h syncs equal the reference pallas engines' with
    device="off" in their on-TPU posture (device compaction:
    `host_compact=False` on a test-local engine). h2d syncs differ by
    exactly one per hash-map build: the reference uploads an all-ones
    row mask there, and K4 takes the row count instead."""
    sf = 0.002
    reng = reb.PallasEngine(device_resident=False)
    reng.host_compact = False
    monkeypatch.setitem(reb._ENGINES, ("pallas", reng.k, None, False), reng)
    ref_builds = _count_calls(monkeypatch, rsj, "joinmap_build")
    builds = _count_calls(monkeypatch, sj, "joinmap_build")
    rstrat = rmake_strategy("pred-trans", backend="pallas",
                            device_resident=False)
    assert rstrat.engine is reng
    _, rstats = RExecutor(tpch_tiny, RExecConfig(
        strategy=rstrat, join_backend="pallas", device="off")).execute(
        rbuild_query(5, sf=sf))
    cat = interop.catalog_from_arrays(_export(tpch_tiny))
    _, stats = Executor(cat, _plane_off_cfg()).execute(build_query(5, sf=sf))
    want = rstats.report()["device"]
    got = stats.report()["device"]
    assert len(builds) == len(ref_builds) > 0
    assert got["d2h_syncs"] == want["d2h_syncs"]
    assert got["h2d_syncs"] == want["h2d_syncs"] - len(ref_builds)
    assert got["device_compactions"] == want["device_compactions"] > 0
    assert got["fused_calls"] == want["fused_calls"] == 0


@pytest.mark.parametrize("module,wrapper", [
    ("bloom", "probe"), ("semijoin", "build_rows"), ("semijoin", "lookup")])
def test_degrade_never_moves_a_plane_off_rung_to_the_host(monkeypatch,
                                                         module, wrapper):
    """With the ladder armed, a plane-off kernel wrapper that fails (as a
    failed nvcc build or launch does) makes the query raise; no
    numpy-rung result comes back in its place."""
    from repro_torch.kernels.bloom import ops as kb

    def broken(*a, **kw):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(kb if module == "bloom" else sj, wrapper, broken)
    cat = generate(sf=0.002, seed=3)
    with pytest.raises(RuntimeError, match="failed to launch"):
        Executor(cat, _plane_off_cfg(degrade=True)).execute(
            build_query(5, sf=0.002))


def test_exec_config_device_off_runs_the_cuda_backends():
    """`device="off"` with the cuda join backend builds a plane-off join
    engine, `"auto"` on a CPU device resolves to the plane-off route
    too, and a query through both cuda backends on that route matches
    the eager oracle."""
    cat = generate(sf=0.002, seed=3)
    for device in ("off", "auto"):
        ex = Executor(cat, ExecConfig(join_backend="cuda", device=device,
                                      torch_device="cpu"))
        assert ex.join_engine.backend == "cuda"
        assert not ex.join_engine.device_resident
    assert Executor(cat, ExecConfig(join_backend="cuda", device="on",
                                    torch_device="cpu")
                    ).join_engine.device_resident
    want, _ = Executor(cat, ExecConfig(late_materialize=False)).execute(
        build_query(5, sf=0.002))
    got, _ = Executor(cat, ExecConfig(
        strategy=make_strategy("pred-trans", backend="cuda", device="cpu"),
        join_backend="cuda", torch_device="cpu")).execute(
        build_query(5, sf=0.002))
    assert table_digest(got) == table_digest(want)


@pytest.mark.parametrize("strategy", ["pred-trans", "bloom-join",
                                      "pred-trans-adaptive"])
def test_strategies_reach_the_plane_off_engine(strategy):
    """`device_resident=False` reaches the cuda bloom engine through
    every backend-aware strategy, and Q5 through it matches the eager
    oracle."""
    cat = generate(sf=0.002, seed=3)
    cfg = _plane_off_cfg(strategy)
    assert cfg.strategy.engine.backend == "cuda"
    assert not cfg.strategy.engine.device_resident
    want, _ = Executor(cat, ExecConfig(late_materialize=False)).execute(
        build_query(5, sf=0.002))
    got, _ = Executor(cat, cfg).execute(build_query(5, sf=0.002))
    assert table_digest(got) == table_digest(want)
