"""The port's plain-torch `torch` backends (the reference's `jax` role)
against the reference's `jax` backends, with the device-resident data
plane on (`device="on"`; plane off: `test_torch_engine_torch_off.py`).

The 20 TPC-H queries at sf 0.002 run through both packages on the same
catalog (the reference's, carried across as numpy arrays), late and
eager. Tables must be md5-equal (`table_digest`); the per-vertex
transfer counts and the host<->device `DeviceStats` are integers and
must be equal exactly. `pred-trans-adaptive` is held by digests only:
its cost rows differ between the packages by design."""
import pytest

torch = pytest.importorskip("torch")

from repro.core.transfer import make_strategy as rmake_strategy
from repro.relational import ExecConfig as RExecConfig
from repro.relational import Executor as RExecutor
from repro.relational.table import table_digest as rtable_digest
from repro.tpch import QUERIES, build_query as rbuild_query
from repro_torch import interop
from repro_torch.core.transfer import make_strategy
from repro_torch.relational import ExecConfig, Executor
from repro_torch.relational.table import table_digest
from repro_torch.tpch import build_query

SF = 0.002
PLANE = "on"


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


def _export(catalog):
    return {name: {c: (t[c].decode(), t[c].valid) for c in t.names}
            for name, t in catalog.items()}


@pytest.fixture(scope="module")
def port_tiny(tpch_tiny):
    return interop.catalog_from_arrays(_export(tpch_tiny))


def run_pair(ref_cat, port_cat, qn, plane, late, strategy="pred-trans"):
    """(reference result, stats), (port result, stats) of one query on
    the reference's jax backends and the port's torch backends."""
    dr = plane == "on"
    ref = RExecutor(ref_cat, RExecConfig(
        strategy=rmake_strategy(strategy, backend="jax",
                                device_resident=dr),
        join_backend="jax", device=plane, late_materialize=late)).execute(
        rbuild_query(qn, sf=SF))
    port = Executor(port_cat, ExecConfig(
        strategy=make_strategy(strategy, backend="torch",
                               device_resident=dr, device="cpu"),
        join_backend="torch", device=plane, torch_device="cpu",
        late_materialize=late)).execute(build_query(qn, sf=SF))
    return ref, port


def check_pair(ref, port, ctx):
    (rres, rst), (res, st) = ref, port
    assert table_digest(res) == rtable_digest(rres), ctx
    assert st.transfer.per_vertex == rst.transfer.per_vertex, ctx
    assert st.report()["device"] == rst.report()["device"], ctx


@pytest.mark.parametrize("late", [True, False], ids=["late", "eager"])
@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_tpch_torch_backend_matches_reference_jax(tpch_tiny, port_tiny, qn,
                                                  late):
    """md5, per-vertex counts and DeviceStats equal to the reference's
    jax backends."""
    ref, port = run_pair(tpch_tiny, port_tiny, qn, PLANE, late)
    check_pair(ref, port, (qn, PLANE, late))
    if late:
        assert port[1].report()["device"]["fused_calls"] > 0 or \
            port[1].transfer.per_vertex == {}
