"""Port parity of the data-curation pipeline (`repro_torch.data`): the
same synthetic corpus (seeded), the same selection (md5 by
`table_digest`), stats and token batches as the reference's
`repro.data.CurationPipeline`, for three strategies, on the numpy
backends (`device=None`) and on the cuda backends with `device="cpu"`
(the kernels' plain versions)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import CurationPipeline as RCurationPipeline
from repro.data import synthetic_corpus as rsynthetic_corpus
from repro.relational.table import table_digest as rtable_digest
from repro_torch.data import CurationPipeline, synthetic_corpus
from repro_torch.relational.table import table_digest

STRATEGIES = ["no-pred-trans", "pred-trans", "yannakakis"]


@pytest.fixture(scope="module")
def corpora():
    return rsynthetic_corpus(n_docs=2000, seed=3), \
        synthetic_corpus(n_docs=2000, seed=3)


@pytest.fixture(scope="module")
def reference(corpora):
    out = {}
    for s in STRATEGIES:
        pipe = RCurationPipeline(corpora[0], strategy=s, vocab=512)
        sel = pipe.select()
        out[s] = (rtable_digest(sel), pipe.stats,
                  list(pipe.batches(batch_size=8, seq_len=32, seed=5)))
    return out


def test_corpus_equals_reference(corpora):
    ref, port = corpora
    assert set(ref) == set(port)
    for name in ref:
        assert table_digest(port[name]) == rtable_digest(ref[name]), name


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_selection_and_batches_equal_reference(corpora, reference, strategy,
                                               device):
    want, rstats, rbatches = reference[strategy]
    pipe = CurationPipeline(corpora[1], strategy=strategy, vocab=512,
                            device=device)
    sel = pipe.select()
    assert table_digest(sel) == want == reference["no-pred-trans"][0]
    st = pipe.stats
    assert (st.strategy, st.chunks_in, st.chunks_out, st.join_input_rows) \
        == (rstats.strategy, rstats.chunks_in, rstats.chunks_out,
            rstats.join_input_rows)
    batches = list(pipe.batches(batch_size=8, seq_len=32, seed=5))
    assert len(batches) == len(rbatches) > 0
    for (toks, tgts), (rtoks, rtgts) in zip(batches, rbatches):
        np.testing.assert_array_equal(toks, rtoks)
        np.testing.assert_array_equal(tgts, rtgts)


def test_cuda_backend_runs_the_kernels_plain_versions(corpora, monkeypatch):
    """`device="cpu"` takes the cuda bloom engine (its K2 builds run as
    plain versions); `device=None` never does."""
    from repro_torch.kernels.bloom import ops as kb
    calls = []
    build = kb.build
    monkeypatch.setattr(kb, "build", lambda *a, **kw: (calls.append(1),
                                                       build(*a, **kw))[1])
    CurationPipeline(corpora[1], device=None).select()
    assert calls == []
    pipe = CurationPipeline(corpora[1], device="cpu")
    pipe.select()
    assert calls and pipe.strategy.engine.backend == "cuda"


def test_plan_kw_and_strategy_instance(corpora):
    from repro_torch.core.transfer import make_strategy
    strict = CurationPipeline(corpora[1], device="cpu", min_quality=0.9)
    loose = CurationPipeline(corpora[1], make_strategy("pred-trans"),
                             device="cpu")
    assert len(strict.select()) < len(loose.select())
    assert loose.strategy.engine.backend == "numpy"


def test_default_device_without_cuda_raises(corpora, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CurationPipeline(corpora[1], "pred-trans")
    with pytest.raises(RuntimeError, match="CUDA"):
        CurationPipeline(corpora[1], "no-pred-trans").select()
