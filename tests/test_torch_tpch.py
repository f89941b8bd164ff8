"""Port parity on TPC-H: the generator, the catalog carried across from
the reference package, and all 20 queries through the port's `cuda`
backends (on device="cpu": the kernels' plain torch versions) with the
device-resident data plane on.

Inputs are made from a seed and fed to both packages. Tables match by
md5 (`table_digest`), per-vertex transfer counts and host<->device sync
counts are integers and match exactly."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.core import bloom as rbloom
from repro.core import hashing as rhashing
from repro.core.transfer import make_strategy as rmake_strategy
from repro.relational import ExecConfig as RExecConfig
from repro.relational import Executor as RExecutor
from repro.relational.table import table_digest as rtable_digest
from repro.tpch import QUERIES, build_query as rbuild_query
from repro_torch import interop
from repro_torch.core import bloom
from repro_torch.core.transfer import make_strategy
from repro_torch.relational import ExecConfig, Executor
from repro_torch.relational.table import table_digest
from repro_torch.tpch import build_query, generate

SF = 0.01


def _export(catalog):
    """A reference catalog as plain numpy arrays (the interop format)."""
    return {name: {c: (t[c].decode(), t[c].valid) for c in t.names}
            for name, t in catalog.items()}


@pytest.fixture(scope="module")
def port_small(tpch_small):
    return interop.catalog_from_arrays(_export(tpch_small))


@pytest.fixture(scope="module")
def oracle_digests(tpch_small):
    """Reference eager-oracle digest per query, computed once."""
    cache = {}

    def get(qn):
        if qn not in cache:
            res, _ = RExecutor(tpch_small,
                               RExecConfig(late_materialize=False)).execute(
                rbuild_query(qn, sf=SF))
            cache[qn] = rtable_digest(res)
        return cache[qn]
    return get


def _device_cfg(strategy):
    return ExecConfig(
        strategy=make_strategy(strategy, backend="cuda",
                               device_resident=True, device="cpu"),
        join_backend="cuda", device="on", torch_device="cpu")


def test_generator_tables_match_reference(tpch_small):
    """Every table of the port's generate(sf=0.01, seed=7) has the
    reference's md5."""
    port = generate(sf=SF, seed=7)
    assert sorted(port) == sorted(tpch_small)
    for name in port:
        assert table_digest(port[name]) == rtable_digest(tpch_small[name]), \
            name


def test_catalog_from_arrays_round_trips(tpch_small, port_small):
    """A reference catalog exported as numpy arrays comes back with the
    same md5 per table, NULL masks included."""
    for name, t in tpch_small.items():
        assert port_small[name].names == list(t.names)
        assert table_digest(port_small[name]) == rtable_digest(t), name


def test_filter_from_words_round_trips(rng):
    """A reference filter's words carried across probe identically
    (every inserted key hits; word-for-word the same filter)."""
    keys = rng.integers(0, 10**6, 500).astype(np.int64)
    lo, hi = rhashing.key_halves(keys)
    words = rbloom.build_np(lo, hi, np.ones(500, bool), 64)
    filt = interop.filter_from_words(words, 4)
    np.testing.assert_array_equal(filt.words, words)
    assert bloom.probe_np(filt.words, lo, hi).all()
    with pytest.raises(ValueError):
        interop.filter_from_words(words[:3], 4)


@pytest.mark.parametrize("strategy", ["pred-trans", "pred-trans-adaptive"])
@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_tpch_cuda_backend_md5_equal_reference(port_small, oracle_digests,
                                               qn, strategy):
    """Port, cuda backends on CPU with the plane on == the reference eager
    oracle, by md5."""
    res, stats = Executor(port_small, _device_cfg(strategy)).execute(
        build_query(qn, sf=SF))
    assert table_digest(res) == oracle_digests(qn), (qn, strategy)


@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_tpch_per_vertex_matches_reference_numpy(tpch_small, port_small,
                                                 qn):
    """pred-trans per-vertex transfer counts == the reference numpy
    engine's, exactly."""
    _, rstats = RExecutor(tpch_small, RExecConfig(
        strategy=rmake_strategy("pred-trans", backend="numpy"))).execute(
        rbuild_query(qn, sf=SF))
    _, stats = Executor(port_small, _device_cfg("pred-trans")).execute(
        build_query(qn, sf=SF))
    assert stats.transfer.per_vertex == rstats.transfer.per_vertex


def test_q5_device_syncs_match_reference_pallas(tpch_tiny):
    """Q5 at sf 0.002: h2d/d2h sync counts and fused-probe calls equal
    the reference pallas engine's (interpret mode) with the plane on."""
    sf = 0.002
    _, rstats = RExecutor(tpch_tiny, RExecConfig(
        strategy=rmake_strategy("pred-trans", backend="pallas",
                                device_resident=True),
        join_backend="pallas", device="on")).execute(rbuild_query(5, sf=sf))
    cat = interop.catalog_from_arrays(_export(tpch_tiny))
    _, stats = Executor(cat, _device_cfg("pred-trans")).execute(
        build_query(5, sf=sf))
    want = rstats.report()["device"]
    got = stats.report()["device"]
    for key in ("h2d_syncs", "d2h_syncs", "fused_calls"):
        assert got[key] == want[key], key
    assert got["fused_calls"] > 0
