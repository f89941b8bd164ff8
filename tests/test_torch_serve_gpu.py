"""The port's serving layer and curation pipeline on an NVIDIA GPU.

Imports torch, numpy and `repro_torch` only (no jax, no reference
package), so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serve_gpu.py

Every test carries the `gpu` marker and skips, with a reason, where
`torch.cuda.is_available()` is false. Query results must match the
port's eager numpy oracle by md5 (`table_digest`), which the CPU tests
hold against the reference package."""
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.core import bloom
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.bloom import ops as kb
from repro_torch.kernels.flashattn import ops as fa
from repro_torch.kernels.semijoin import ops as sj

pytestmark = pytest.mark.gpu

SF = 0.01
NEVER = ("probe", "bloom_transfer", "joinmap_build", "joinmap_lookup",
         "semijoin_build", "semijoin_probe", "flash_prefill", "flash_decode")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tpch():
    from repro_torch.relational import ExecConfig, Executor
    from repro_torch.relational.table import table_digest
    from repro_torch.tpch import QUERIES, build_query, generate
    cat = generate(sf=SF, seed=7)
    oracle = {qn: table_digest(Executor(cat, ExecConfig(
        late_materialize=False)).execute(build_query(qn, sf=SF))[0])
        for qn in sorted(QUERIES)}
    return cat, oracle


def _launches():
    return {**kb.LAUNCHES, **sj.LAUNCHES, **fa.LAUNCHES}


def _reset():
    for mod in (kb, sj, fa):
        mod.reset_launches()


def test_server_on_the_card_matches_oracle(cuda, tpch):
    """`QueryServer` with its defaults (the cuda backends on the card),
    4 workers, the 20 queries twice at once, cold then warm: every result
    md5-equal to the oracle; K1 and K2 launch cold, fewer times warm, and
    no other kernel launches."""
    from repro_torch.relational.table import table_digest
    from repro_torch.serve import QueryServer, ServeConfig
    from repro_torch.tpch import build_query
    cat, oracle = tpch
    counts = []
    with QueryServer(cat, ServeConfig(strategy="pred-trans",
                                      workers=4)) as srv:
        for _ in range(2):
            _reset()
            futs = [(qn, srv.submit(build_query(qn, sf=SF)))
                    for qn in sorted(oracle) * 2]
            for qn, f in futs:
                res, st = f.result(300)
                assert table_digest(res) == oracle[qn], qn
                assert st.report()["transfer"]["backend"] == "cuda"
            torch.cuda.synchronize()
            counts.append(_launches())
        assert srv.metrics_snapshot()["server"]["failed"] == 0
    cold, warm = counts
    for name in ("multi_probe", "bloom_build"):
        assert cold[name] > warm[name], name
    assert all(c[name] == 0 for c in counts for name in NEVER)


def test_curation_on_the_card_matches_host(cuda):
    from repro_torch.data import CurationPipeline, synthetic_corpus
    from repro_torch.relational.table import table_digest
    corpus = synthetic_corpus(n_docs=5000, seed=1)
    _reset()
    got = CurationPipeline(corpus, "pred-trans").select()
    torch.cuda.synchronize()
    counts = _launches()
    want = CurationPipeline(corpus, "no-pred-trans", device=None).select()
    assert table_digest(got) == table_digest(want)
    assert counts["multi_probe"] > 0 and counts["bloom_build"] > 0
    assert all(counts[name] == 0 for name in NEVER)


def test_first_kernel_calls_from_two_threads_build_once(cuda, tmp_path,
                                                        monkeypatch):
    """Two threads entering K2 then K1 together, with no library built
    yet: nvcc runs once, and both threads' results equal the plain
    versions."""
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kbuild, "_LIBS", {})
    monkeypatch.setattr(kbuild, "BUILD_INFO", {})
    monkeypatch.setattr(kb, "_LIB", None)
    started = []
    start = kbuild._start

    def counted(name):
        st = start(name)
        if st is not None:
            started.append(name)
        return st
    monkeypatch.setattr(kbuild, "_start", counted)

    rng = np.random.default_rng(0)
    n = 1 << 16
    lo, hi = bloom.keys_to_device(rng.integers(0, 1 << 40, n), cuda)
    barrier = threading.Barrier(2)
    out, errors = [], []

    def call():
        try:
            barrier.wait()
            w = kb.build(lo, hi, 512)
            out.append((w, kb.multi_probe([w], [lo], [hi])))
        except BaseException as e:      # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert started == ["bloom"]
    w_ref = kb.build_ref(lo, hi, 512)
    m_ref = kb.multi_probe_ref([w_ref], [lo], [hi])
    for w, m in out:
        assert torch.equal(w, w_ref) and torch.equal(m, m_ref)
    assert bool(m_ref.all())
