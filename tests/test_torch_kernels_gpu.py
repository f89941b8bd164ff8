"""The port's hand-written CUDA kernels on an NVIDIA GPU.

Imports torch, numpy and `repro_torch` only (no jax, no reference
package), so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Every test carries the `gpu` marker and skips, with a reason, where
`torch.cuda.is_available()` is false (a CUDA kernel has no CPU mode).
K1/K2 outputs are integer and boolean arrays: they must equal their
plain torch versions bit-exactly; query results must match the port's
eager numpy oracle by md5 (`table_digest`)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.core import bloom, hashing
from repro_torch.kernels.bloom import ops as kb

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _keys(rng, n):
    k = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                     dtype=np.int64)
    k[:2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    return k


@pytest.mark.parametrize("m", [1, 2, 3])
def test_kernels_match_plain_versions(cuda, m):
    """K1 and K2 == their plain versions on the card, bit-exact, with
    ragged counts, survivor ids, a validity plane and nblocks = 1."""
    rng = np.random.default_rng(m)
    n = 1 << 16
    lo, hi = bloom.halves_to_device(*hashing.key_halves(_keys(rng, n)), cuda)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    idx = torch.from_numpy(np.sort(rng.choice(n, n // 2, replace=False))
                           .astype(np.int32)).to(cuda)
    words = []
    for nb in (1, 512, 64)[:m]:
        w = kb.build(lo, hi, nb, idx=idx, count=n // 3, valid=valid)
        ref = kb.build_ref(lo, hi, nb, idx=idx, count=n // 3, valid=valid)
        assert torch.equal(w, ref), nb
        words.append(w)
    for ix, count in ((None, n - 7), (idx, n // 2 - 5)):
        got = kb.multi_probe(words, [lo] * m, [hi] * m, idx=ix, count=count)
        ref = kb.multi_probe_ref(words, [lo] * m, [hi] * m, idx=ix,
                                 count=count)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (m, ix is not None)


def test_wrappers_count_launches_and_check_inputs(cuda):
    kb.reset_launches()
    lo = torch.zeros(1024, dtype=torch.int32, device=cuda)
    w = kb.build(lo, lo, 8)
    kb.multi_probe([w], [lo], [lo])
    assert kb.LAUNCHES == {"multi_probe": 1, "bloom_build": 1}
    with pytest.raises(ValueError):
        kb.build(lo.to(torch.int64), lo.to(torch.int64), 8)
    with pytest.raises(ValueError):
        kb.multi_probe([w], [lo[::2]], [lo[::2]])


def test_tpch_q5_on_gpu_matches_oracle(cuda):
    """Q5 at sf 0.01 through the cuda backends with the plane on: the
    kernels launch and the result has the eager oracle's md5."""
    from repro_torch.core.transfer import make_strategy
    from repro_torch.relational import ExecConfig, Executor
    from repro_torch.relational.table import table_digest
    from repro_torch.tpch import build_query, generate
    cat = generate(sf=0.01, seed=7)
    ref, _ = Executor(cat, ExecConfig(late_materialize=False)).execute(
        build_query(5, sf=0.01))
    kb.reset_launches()
    res, stats = Executor(cat, ExecConfig(
        strategy=make_strategy("pred-trans", backend="cuda"),
        join_backend="cuda")).execute(build_query(5, sf=0.01))
    assert table_digest(res) == table_digest(ref)
    assert kb.LAUNCHES["multi_probe"] > 0 and kb.LAUNCHES["bloom_build"] > 0
    assert stats.report()["device"]["fused_calls"] > 0
