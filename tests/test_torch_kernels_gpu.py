"""The port's hand-written CUDA kernels on an NVIDIA GPU.

Imports torch, numpy and `repro_torch` only (no jax, no reference
package), so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Every test carries the `gpu` marker and skips, with a reason, where
`torch.cuda.is_available()` is false (a CUDA kernel has no CPU mode).
K1-K7 outputs are integer and boolean arrays: they must equal their
plain torch versions bit-exactly (K4, whose parallel build lays the
table out in another order, by its occupied count and by K5's answers);
query results must match the port's eager numpy oracle by md5
(`table_digest`). K8 (flash attention) is bf16 and sums in another
order than its plain version: it must agree with `flash_plain` and with
`sdpa_ref` within atol = rtol = 2e-2, the reference's own bf16
tolerance (tests/test_kernels_flash.py), with f32 matmuls (TF32 off);
a decode output (Sq 1) also within two bf16 ulps of the largest output
(`_decode_limit`), since at a long cache 2e-2 is as large as the outputs."""
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.core import bloom
from repro_torch.kernels.bloom import ops as kb
from repro_torch.kernels.semijoin import ops as sj

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


#: K2's routes (`bloom.cu`, K2's note): a filter of at most TINY blocks
#: is built whole in shared memory; below FEW rows (or above 2^23
#: blocks) each key goes straight into L2; otherwise the rows are
#: partitioned into 2^clamp(log2 nblocks - 8, 4, 11)-block slices, 256
#: of them for 2^12 to 2^19 blocks, and a slice is built in shared memory
TINY, FEW = 64, 1 << 18


@pytest.mark.parametrize("m", [1, 2, 3, 16])
def test_kernels_match_plain_versions(cuda, m):
    """K1 and K2 == their plain versions on the card, bit-exact, with
    ragged counts,
    survivor ids, a validity plane, nblocks = 1 and a two-slice filter;
    m = 16 is `bloom_max_filters`."""
    rng = np.random.default_rng(m)
    n = 1 << 16
    lo, hi = bloom.keys_to_device(_keys(rng, n), cuda)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    idx = torch.from_numpy(np.sort(rng.choice(n, n // 2, replace=False))
                           .astype(np.int32)).to(cuda)
    words = []
    for f in range(m):
        nb = (1, 512, 64, 8192)[f % 4]
        w = kb.build(lo, hi, nb, idx=idx, count=n // 3 - f, valid=valid)
        ref = kb.build_ref(lo, hi, nb, idx=idx, count=n // 3 - f,
                           valid=valid)
        assert torch.equal(w, ref), nb
        words.append(w)
    for ix, count in ((None, n - 7), (idx, n // 2 - 5), (None, 3),
                      (idx, 0)):
        got = kb.multi_probe(words, [lo] * m, [hi] * m, idx=ix, count=count)
        ref = kb.multi_probe_ref(words, [lo] * m, [hi] * m, idx=ix,
                                 count=count)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (m, ix is not None, count)


@pytest.mark.parametrize("rate", [0, 25, 100])
@pytest.mark.parametrize("m", [1, 2, 4, 16])
def test_multi_probe_cooperative_matches_plain_version(cuda, m, rate):
    """K1 (one sector request a live row a filter, 16 rows a warp at a
    time) == its plain version bit-exact, each filter over its own key
    column, where no row passes a filter (all-zero filters), about a
    quarter does (each filter built from a quarter of its column's keys)
    and every row does (built from all of them); counts 0, 3 and ragged,
    over every row and over survivor ids; filters of 1 to 8,192 blocks."""
    rng = np.random.default_rng(100 * m + rate)
    n = (1 << 16) + 77
    cols, words = [], []
    for f in range(m):
        lo, hi = bloom.keys_to_device(_keys(rng, n), cuda)
        nb = (8192, 64, 1, 512)[f % 4]
        members = n * rate // 100
        words.append(kb.build_ref(lo[:members], hi[:members], nb) if members
                     else torch.zeros((nb, bloom.LANES), dtype=torch.int32,
                                      device=cuda))
        cols.append((lo, hi))
    los, his = [c[0] for c in cols], [c[1] for c in cols]
    idx = torch.from_numpy(rng.permutation(n)[: n // 2].astype(np.int32)
                           ).to(cuda)
    kb.reset_launches()
    for ix in (None, idx):
        rows = n if ix is None else n // 2
        for count in (0, 3, rows - 29):
            got = kb.multi_probe(words, los, his, idx=ix, count=count)
            ref = kb.multi_probe_ref(words, los, his, idx=ix, count=count)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (ix is not None, count)
            if rate == 100 and count:
                assert bool(got[:, :count].all())
            if rate == 0:
                assert not bool(got.any())
    assert kb.LAUNCHES["multi_probe"] == 6


def _sparse_build(lo, hi, nblocks, k=bloom.DEFAULT_K):
    """K2's function for a filter too wide for `build_ref` (which packs
    256 bools a block): the OR of each key's bits, set word by word."""
    from repro_torch.core import hashing
    h = hashing.hash64(lo, hi)
    flat = torch.unique((bloom._block_index(h, nblocks)[:, None] * 256
                         + bloom._positions(h, k)).reshape(-1))
    words = torch.zeros(nblocks * 8, dtype=torch.int64, device=lo.device)
    words.index_add_(0, flat >> 5, torch.ones_like(flat) << (flat & 31))
    return bloom.to_i32(words).view(nblocks, 8)


@pytest.mark.parametrize("nblocks,n", [
    (1, 1 << 16), (TINY, 1 << 16),                   # tiny
    (2 * TINY, FEW + 4096), (4096, FEW + 4096),      # partitioned / direct
    (8192, 1 << 19), (1 << 19, 6_001_215),           # partitioned
])
def test_build_kernel_routes_match_plain_version(cuda, nblocks, n):
    """K2 == `build_ref` bit-exact on each side of each route boundary,
    the last at the SF 1 lineitem shape, over every row (n - 7 rows:
    FEW or more rows partition past TINY blocks) and over survivor ids
    with a validity plane and a ragged count (n / 2 - 5 rows: below FEW
    the direct route but at 6 M keys)."""
    rng = np.random.default_rng(nblocks)
    lo, hi = bloom.keys_to_device(_keys(rng, n), cuda)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    idx = torch.from_numpy(rng.permutation(n)[: n // 2].astype(np.int32)
                           ).to(cuda)
    kb.reset_launches()
    for ix, count, v in ((None, n - 7, None), (idx, n // 2 - 5, valid)):
        got = kb.build(lo, hi, nblocks, idx=ix, count=count, valid=v)
        ref = kb.build_ref(lo, hi, nblocks, idx=ix, count=count, valid=v)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (ix is not None, count)
    assert kb.LAUNCHES["bloom_build"] == 2       # one a call, any route


@pytest.mark.parametrize("route", [1, 2])
@pytest.mark.parametrize("nblocks,n", [(1024, 1 << 14), (1 << 17, 1 << 21)])
def test_build_kernel_forced_routes_match_plain_version(cuda, route,
                                                        nblocks, n):
    """K2 with its direct (1) or partitioned (2) route forced
    (`bloom_build_force_route`, as `chip_smoke.route_sweep` times them)
    == `build_ref` bit-exact at the smallest and the largest build the
    `pred-trans` path gives it, over survivor ids with a validity plane;
    the scratch query follows the forced route, and -1 restores the
    rule."""
    rng = np.random.default_rng(n)
    lo, hi = bloom.keys_to_device(_keys(rng, n), cuda)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    idx = torch.from_numpy(rng.permutation(n)[: n // 2].astype(np.int32)
                           ).to(cuda)
    lib = kb._lib()
    log2nb = int(nblocks).bit_length() - 1
    rule = lib.bloom_build_scratch_bytes(n // 2 - 5, log2nb)
    assert lib.bloom_build_force_route(route) == -1
    try:
        assert (lib.bloom_build_scratch_bytes(n // 2 - 5, log2nb) > 0) == \
            (route == 2)
        got = kb.build(lo, hi, nblocks, idx=idx, count=n // 2 - 5,
                       valid=valid)
        ref = kb.build_ref(lo, hi, nblocks, idx=idx, count=n // 2 - 5,
                           valid=valid)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    finally:
        assert lib.bloom_build_force_route(-1) == route
    assert lib.bloom_build_scratch_bytes(n // 2 - 5, log2nb) == rule


@pytest.mark.parametrize("log2nb", [23, 24])
def test_build_kernel_wide_filters_match_sparse_version(cuda, log2nb):
    """At 2^23 blocks (4,096 slices, the partitioned route's widest) and
    2^24 (above it: each key ORed straight into the filter), K2's words
    equal the OR of each key's bits (`_sparse_build`, itself equal to
    `build_ref` on a narrow filter), over survivor ids with a validity
    plane."""
    rng = np.random.default_rng(log2nb)
    n = 1 << 20
    lo, hi = bloom.keys_to_device(_keys(rng, n), cuda)
    assert torch.equal(_sparse_build(lo, hi, 1024),
                       kb.build_ref(lo, hi, 1024))
    keep = rng.random(n) < 0.9
    idx = rng.permutation(n)[: n // 2].astype(np.int32)
    count = n // 2 - 3
    rows = idx[:count][keep[idx[:count]]]
    got = kb.build(lo, hi, 1 << log2nb, idx=torch.from_numpy(idx).to(cuda),
                   count=count, valid=torch.from_numpy(keep).to(cuda))
    sel = torch.from_numpy(rows.astype(np.int64)).to(cuda)
    want = _sparse_build(lo[sel], hi[sel], 1 << log2nb)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _build_keys(rng, case, n):
    """Build keys of the skew cases: `equal` one key n times, `one-slice`
    keys whose hashes all lie below 2^24, so in the first of the 256
    slices K2 cuts a 2^12- to 2^19-block filter into (built back from
    hashes with `chip_smoke.skewed_keys`), `repeated` each key 4 times
    in a row, as `l_orderkey` repeats."""
    import chip_smoke
    if case == "equal":
        return np.full(n, 42, np.int64)
    if case == "repeated":
        return np.repeat(_keys(rng, n // 4), 4)
    return chip_smoke.skewed_keys(np, rng, n)


@pytest.mark.parametrize("nblocks", [1, 4096, 1 << 19])
@pytest.mark.parametrize("case", ["equal", "one-slice", "repeated",
                                  "count-0", "all-invalid"])
def test_build_kernel_skew_and_empty_inputs(cuda, case, nblocks):
    """K2 == `build_ref` bit-exact where the rows pile into few blocks or
    one slice (all but the slice's capacity on the overflow list, ORed
    in through L2), and where no row is inserted (count 0; every row
    invalid), on the tiny and partitioned routes: 2^20 rows."""
    rng = np.random.default_rng(len(case) + nblocks)
    n = 1 << 20
    keys = _build_keys(rng, case, n) if case in (
        "equal", "one-slice", "repeated") else _keys(rng, n)
    lo, hi = bloom.keys_to_device(keys, cuda)
    count = 0 if case == "count-0" else n - 1
    valid = (torch.zeros(n, dtype=torch.bool, device=cuda)
             if case == "all-invalid" else None)
    got = kb.build(lo, hi, nblocks, count=count, valid=valid)
    ref = kb.build_ref(lo, hi, nblocks, count=count, valid=valid)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if case in ("count-0", "all-invalid"):
        assert int(got.abs().sum()) == 0


def test_build_scratch_follows_the_source_note(cuda):
    """K2's scratch on the partitioned route: p + 1 cursors, p slice
    regions of 5/4 of the mean rows a slice + 256 hashes, and an
    overflow list of a hash a row; none on the other routes."""
    def partitioned(count, p):
        cap = count // p + count // (4 * p) + 256
        return 4 * (p + 1) + 4 * p * cap + 4 * count
    lib = kb._lib()
    assert lib.bloom_build_scratch_bytes(6_001_215, 6) == 0      # tiny
    assert lib.bloom_build_scratch_bytes(FEW - 1, 19) == 0      # direct
    assert lib.bloom_build_scratch_bytes(6_001_215, 19) == \
        partitioned(6_001_215, 256)                             # S 2,048
    assert lib.bloom_build_scratch_bytes(FEW, 7) == partitioned(FEW, 8)
    assert lib.bloom_build_scratch_bytes(FEW, 23) == partitioned(FEW, 4096)
    assert lib.bloom_build_scratch_bytes(FEW, 24) == 0          # direct


def test_wrappers_count_launches_and_check_inputs(cuda):
    kb.reset_launches()
    lo = torch.zeros(1024, dtype=torch.int32, device=cuda)
    w = kb.build(lo, lo, 8)
    kb.multi_probe([w], [lo], [lo])
    assert kb.LAUNCHES == {"multi_probe": 1, "bloom_build": 1, "probe": 0,
                           "bloom_transfer": 0}
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


@pytest.mark.parametrize("nb", [1, 64, 4096])
def test_probe_kernel_matches_plain_version(cuda, nb):
    """K3 == its plain version on the card, bit-exact, over every row and
    over survivor ids with a ragged count."""
    rng = np.random.default_rng(nb)
    n = 1 << 16
    keys = _keys(rng, n)
    lo, hi = bloom.keys_to_device(keys, cuda)
    words = kb.build_ref(lo[: n // 4], hi[: n // 4], nb)
    idx = torch.from_numpy(np.sort(rng.choice(n, n // 2, replace=False))
                           .astype(np.int32)).to(cuda)
    kb.reset_launches()
    for ix, count in ((None, n - 9), (idx, n // 2 - 5), (None, 0)):
        got = kb.probe(words, lo, hi, idx=ix, count=count)
        ref = kb.probe_ref(words, lo, hi, idx=ix, count=count)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (nb, ix is not None, count)
    assert got.sum() == 0
    assert kb.LAUNCHES["probe"] == 3 and kb.LAUNCHES["multi_probe"] == 0


#: K3's rows a thread (`bloom.cu`, K3's note): PROBE_ROWS from MANY_ROWS
#: rows on, one below
PROBE_ROWS, MANY_ROWS = 4, 1 << 22


@pytest.mark.parametrize("rows", [0, 1, PROBE_ROWS],
                         ids=["rule", "one", "four"])
@pytest.mark.parametrize("nb", [1, 64, 1 << 12, 1 << 13, 1 << 16])
def test_probe_kernel_filter_sizes_match_plain_version(cuda, nb, rows):
    """K3, at the rows a thread its rule takes or forced to one or four
    (`bloom_probe_force_rows`), == its plain version bit for bit into
    filters of 1 to 2^16 blocks: over every row, over survivor ids, each
    with a count below n and n not a multiple of a CTA's rows, over
    columns and ids that do not start on a 16-byte boundary, and at
    n = 1; one launch a call."""
    rng = np.random.default_rng(nb + rows)
    n = (1 << 16) + 4099
    keys = _keys(rng, n)
    lo, hi = bloom.keys_to_device(keys, cuda)
    words = kb.build_ref(lo[: n // 3], hi[: n // 3], nb)
    idx = torch.from_numpy(np.sort(rng.choice(n, n // 2 + 7, replace=False))
                           .astype(np.int32)).to(cuda)
    lib = kb._lib()
    lib.bloom_probe_force_rows(rows)
    kb.reset_launches()
    calls = ((lo, hi, None, n - 13), (lo, hi, idx, n // 2 - 5),
             (lo[1:], hi[1:], None, n - 2), (lo, hi, idx[1:], n // 2 - 3),
             (lo[:1], hi[:1], None, 1), (lo, hi, idx[:1], 1))
    try:
        for clo, chi, ix, count in calls:
            got = kb.probe(words, clo, chi, idx=ix, count=count)
            ref = kb.probe_ref(words, clo, chi, idx=ix, count=count)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (ix is not None, count)
    finally:
        lib.bloom_probe_force_rows(0)
    assert kb.LAUNCHES["probe"] == len(calls)


def test_probe_kernel_many_rows_match_plain_version(cuda):
    """K3 at the rule's four rows a thread: MANY_ROWS + 5 rows (a ragged
    last CTA) with and without survivor ids == its plain version bit for
    bit."""
    rng = np.random.default_rng(3)
    n = MANY_ROWS + 5
    lo, hi = bloom.keys_to_device(
        rng.integers(0, 1 << 20, 2 * n, dtype=np.int64), cuda)
    words = kb.build_ref(lo[: 1 << 16], hi[: 1 << 16], 4096)
    idx = torch.from_numpy(np.sort(rng.choice(2 * n, n, replace=False))
                           .astype(np.int32)).to(cuda)
    for ix, count in ((None, n - 3), (idx, n - 1)):
        got = kb.probe(words, lo, hi, idx=ix, count=count)
        ref = kb.probe_ref(words, lo, hi, idx=ix, count=count)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), ix is not None


def test_probe_rows_follow_the_source_note(cuda):
    """K3's rule: PROBE_ROWS rows a thread from MANY_ROWS rows on, one
    row a thread below."""
    lib = kb._lib()
    for n in (1, 4096, MANY_ROWS - 1, MANY_ROWS, 1 << 23, (1 << 31) - 1):
        assert lib.bloom_probe_rows(n) == (
            PROBE_ROWS if n >= MANY_ROWS else 1), n


@pytest.mark.parametrize("kind", ["map", "set"])
def test_lookup_kernels_at_the_edges_match_plain_versions(cuda, kind):
    """K5 (`map`) and K6b (`set`) over keys crowded at the end of a
    quarter of the slots and at the table's end (walks that run on past
    it into slot 0, `chip_smoke.crowded_keys`), with repeated build keys
    and misses: == the plain walk over the same table == each key's last
    row (membership), at 24,007 probes (not a multiple of a CTA's 256),
    over columns that do not start on a 16-byte boundary, and at n = 0
    and 1; one launch a call."""
    import chip_smoke
    rng = np.random.default_rng(len(kind))
    n = 20_000
    cap = sj.capacity_for(n)
    keys = chip_smoke.crowded_keys(np, rng, n, cap, cap.bit_length() - 3)
    keep = (rng.random(len(keys)) < 0.7 if kind == "set"
            else np.ones(len(keys), bool))
    lo, hi = bloom.keys_to_device(keys, cuda)
    if kind == "map":
        table, _ = sj.build_rows(lo, hi, cap)
        walk, ref_walk = sj.lookup, sj.lookup_ref
        last = {int(k): i for i, k in enumerate(keys)}
    else:
        table, _ = sj.set_build(lo, hi, cap, torch.from_numpy(keep).to(cuda))
        walk, ref_walk = sj.set_probe, sj.set_probe_ref
    probe = np.concatenate([keys, _keys(rng, 4007)])
    plo, phi = bloom.keys_to_device(probe, cuda)
    sj.reset_launches()
    calls = ((plo, phi, probe), (plo[1:], phi[1:], probe[1:]),
             (plo[:1], phi[:1], probe[:1]), (plo[:0], phi[:0], probe[:0]))
    for clo, chi, keys_in in calls:
        got = walk(table, clo, chi)
        ref = ref_walk(table, clo, chi)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), len(keys_in)
        if kind == "map":
            want = np.array([last.get(int(k), -1) for k in keys_in],
                            np.int32)
        else:
            want = np.isin(keys_in, keys[keep])
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert sj.LAUNCHES["joinmap_lookup" if kind == "map"
                       else "semijoin_probe"] == len(calls) - 1


@pytest.mark.parametrize("domain", [None, 1 << 15], ids=["unique", "dups"])
def test_joinmap_kernels_match_plain_versions(cuda, domain):
    """At 2^16 keys: K4's occupied count == the plain sequential build's
    (run on CPU copies) == the distinct count; K5's rows == the plain
    lookup over the same K4 table, and each key finds its last row."""
    rng = np.random.default_rng(5)
    n = 1 << 16
    keys = (_keys(rng, n) if domain is None
            else rng.integers(0, domain, n).astype(np.int64))
    lo, hi = bloom.keys_to_device(keys, cuda)
    cap = sj.capacity_for(n)
    sj.reset_launches()
    table, occ = sj.build_rows(lo, hi, cap)
    _, ref_occ = sj.build_rows_ref(lo.cpu(), hi.cpu(), cap)
    distinct = len(np.unique(keys))
    assert int(occ) == int(ref_occ) == distinct
    probe = np.concatenate([keys, _keys(rng, n)])
    plo, phi = bloom.keys_to_device(probe, cuda)
    got = sj.lookup(table, plo, phi)
    ref = sj.lookup_ref(table, plo, phi)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    last = {int(k): i for i, k in enumerate(keys)}
    want = np.array([last.get(int(k), -1) for k in probe], np.int32)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert sj.LAUNCHES == {"joinmap_build": 1, "joinmap_lookup": 1,
                           "semijoin_build": 0, "semijoin_probe": 0}
    with pytest.raises(ValueError):
        sj.build_rows(lo, hi, n)                # no empty slot left


#: K4's and K6a's routes (`semijoin.cu`, K4's note): below FEW_KEYS keys
#: each key goes straight into the table; otherwise the table is cut into
#: regions of 2^REGION_LOG2 slots (at most the table), each built in
#: shared memory, with an overflow list inserted last
FEW_KEYS, REGION_LOG2 = 1 << 19, 13


def _joinmap_case(rng, case):
    """Build keys of the K4/K6a route cases: n = 0, n = 1, and keys
    crowded at a region's tail, at the last region's wrap into slot 0 and
    past a region's part of the scratch, with repeated keys
    (`chip_smoke.crowded_keys`), at 5,003 keys and on each side of
    FEW_KEYS."""
    import chip_smoke
    n = {"n=0": 0, "n=1": 1, "crowded-5003": 5003,
         "crowded-threshold-1": FEW_KEYS - 1,
         "crowded-threshold": FEW_KEYS}[case]
    if n < 2:
        return _keys(rng, 2)[:n]
    return chip_smoke.crowded_keys(np, rng, n, sj.capacity_for(n),
                                   REGION_LOG2)


@pytest.mark.parametrize("route", [-1, 1, 2],
                         ids=["rule", "direct", "partitioned"])
@pytest.mark.parametrize("case", ["n=0", "n=1", "crowded-5003",
                                  "crowded-threshold-1", "crowded-threshold"])
@pytest.mark.parametrize("kind", ["map", "set"])
def test_joinmap_build_routes_match_plain_versions(cuda, kind, case, route):
    """K4 (`map`: every row) and K6a (`set`: the rows a mask keeps) on
    each route, by the rule or forced (`joinmap_build_force_route`):
    occupied == the plain sequential build's (CPU copies) == the distinct
    count, and K5 (K6b) over the kernel's table == the plain walk over
    the same table == each key's last row (membership) for every build
    key and 997 misses; the wrapper counts one launch a build."""
    rng = np.random.default_rng(len(case) + route)
    keys = _joinmap_case(rng, case)
    n = len(keys)
    keep = (rng.random(n) < 0.7) if kind == "set" else np.ones(n, bool)
    lo, hi = bloom.keys_to_device(keys, cuda)
    mask = torch.from_numpy(keep).to(cuda) if kind == "set" else None
    cap = sj.capacity_for(n)
    lib = sj._lib()
    lib.joinmap_build_force_route(route, 0)
    sj.reset_launches()
    try:
        if kind == "map":
            table, occ = sj.build_rows(lo, hi, cap)
            _, ref_occ = sj.build_rows_ref(lo.cpu(), hi.cpu(), cap)
        else:
            table, occ = sj.set_build(lo, hi, cap, mask)
            _, ref_occ = sj.set_build_ref(lo.cpu(), hi.cpu(), cap,
                                          mask.cpu())
        scratch = lib.joinmap_build_scratch_bytes(n, cap)
    finally:
        lib.joinmap_build_force_route(-1, 0)
    assert int(occ) == int(ref_occ) == len(np.unique(keys[keep]))
    launched = sj.LAUNCHES["joinmap_build" if kind == "map"
                           else "semijoin_build"]
    assert launched == (1 if n else 0)
    if route == 2 or (route == -1 and n >= FEW_KEYS):
        assert (scratch > 0) == (n > 0)
    else:
        assert scratch == 0
    probe = np.concatenate([keys, _keys(rng, 997)])
    plo, phi = bloom.keys_to_device(probe, cuda)
    if kind == "map":
        got, ref = sj.lookup(table, plo, phi), sj.lookup_ref(table, plo, phi)
        last = {int(k): i for i, k in enumerate(keys)}
        want = np.array([last.get(int(k), -1) for k in probe], np.int32)
    else:
        got = sj.set_probe(table, plo, phi)
        ref = sj.set_probe_ref(table, plo, phi)
        want = np.isin(probe, keys[keep])
        assert int(table[:, 3].abs().sum()) == 0
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_joinmap_scratch_follows_the_source_note(cuda):
    """K4's (K6a's) scratch on the partitioned route: p = cap / 2^13
    regions' parts of 5/4 of the mean keys a region + 256 (at most a
    region's slots) and an overflow list of a row, 16-byte records, and
    p + 1 int cursors; none on the direct route (fewer than FEW_KEYS
    keys, or more than 4,096 regions)."""
    import chip_smoke

    def partitioned(n, cap):
        log2r = min(REGION_LOG2, cap.bit_length() - 1)
        log2p = cap.bit_length() - 1 - log2r
        p = 1 << log2p
        return 16 * (p * chip_smoke.region_cap(n, log2p, log2r) + n) + 4 * (
            p + 1)
    lib = sj._lib()
    assert lib.joinmap_build_scratch_bytes(FEW_KEYS - 1, 1 << 21) == 0
    for n, cap in ((FEW_KEYS, 1 << 21), (1_500_000, 1 << 22),
                   (6_001_215, 1 << 24), (FEW_KEYS, 1 << 25)):
        assert lib.joinmap_build_scratch_bytes(n, cap) == \
            partitioned(n, cap), (n, cap)
    assert lib.joinmap_build_scratch_bytes(FEW_KEYS, 1 << 26) == 0


def test_tpch_q5_plane_off_on_gpu_matches_oracle(cuda):
    """Q5 at sf 0.01 through the cuda backends with the plane off: K2,
    K3, K4 and K5 launch, K1 does not, and the result has the eager
    oracle's md5."""
    from repro_torch.core.transfer import make_strategy
    from repro_torch.relational import ExecConfig, Executor
    from repro_torch.relational.table import table_digest
    from repro_torch.tpch import build_query, generate
    cat = generate(sf=0.01, seed=7)
    ref, _ = Executor(cat, ExecConfig(late_materialize=False)).execute(
        build_query(5, sf=0.01))
    kb.reset_launches()
    sj.reset_launches()
    res, stats = Executor(cat, ExecConfig(
        strategy=make_strategy("pred-trans", backend="cuda",
                               device_resident=False),
        join_backend="cuda", device="off")).execute(build_query(5, sf=0.01))
    assert table_digest(res) == table_digest(ref)
    assert kb.LAUNCHES["probe"] > 0 and kb.LAUNCHES["bloom_build"] > 0
    assert kb.LAUNCHES["multi_probe"] == 0
    assert sj.LAUNCHES["joinmap_build"] > 0
    assert sj.LAUNCHES["joinmap_lookup"] > 0
    assert stats.report()["device"]["fused_calls"] == 0


@pytest.mark.parametrize("domain", [None, 1 << 14], ids=["unique", "dups"])
def test_set_kernels_match_plain_versions(cuda, domain):
    """At 2^16 keys with a mask: K6a's occupied count == the plain
    sequential build's (run on CPU copies) == the distinct masked count,
    and its table holds no row; K6b's mask == the plain probe over the
    same K6a table == np.isin; `semi_mask` on the card == on the CPU."""
    from repro_torch.kernels.semijoin import semi_mask
    from repro_torch.kernels.semijoin.ref import semi_mask_ref
    rng = np.random.default_rng(9)
    n = 1 << 16
    keys = (_keys(rng, n) if domain is None
            else rng.integers(0, domain, n).astype(np.int64))
    keep = rng.random(n) < 0.7
    lo, hi = bloom.keys_to_device(keys, cuda)
    mask = torch.from_numpy(keep).to(cuda)
    cap = sj.capacity_for(n)
    sj.reset_launches()
    table, occ = sj.set_build(lo, hi, cap, mask)
    _, ref_occ = sj.set_build_ref(lo.cpu(), hi.cpu(), cap, mask.cpu())
    assert int(occ) == int(ref_occ) == len(np.unique(keys[keep]))
    assert int(table[:, 3].abs().sum()) == 0
    probe = np.concatenate([keys, _keys(rng, n)])
    plo, phi = bloom.keys_to_device(probe, cuda)
    got = sj.set_probe(table, plo, phi)
    ref = sj.set_probe_ref(table, plo, phi)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.isin(probe, keys[keep]))
    assert sj.LAUNCHES["semijoin_build"] == sj.LAUNCHES["semijoin_probe"] == 1
    np.testing.assert_array_equal(semi_mask(probe, keys, keep),
                                  semi_mask_ref(probe, keys, keep))
    assert sj.LAUNCHES["semijoin_build"] == sj.LAUNCHES["semijoin_probe"] == 2


@pytest.mark.parametrize("nb", [1, 64, 4096])
def test_transfer_kernel_matches_plain_version(cuda, nb):
    """K7 == its plain version on the card: survivors and outgoing words
    bit-exact; `bloom_transfer` on the card == on the CPU."""
    from repro_torch.kernels.bloom import bloom_build, bloom_transfer
    rng = np.random.default_rng(nb)
    n = (1 << 16) - 3
    keys, out_keys = _keys(rng, n), _keys(rng, n)
    lo, hi = bloom.keys_to_device(keys, cuda)
    olo, ohi = bloom.keys_to_device(out_keys, cuda)
    mask = torch.from_numpy(rng.random(n) < 0.8).to(cuda)
    words = kb.build_ref(lo[: n // 4], hi[: n // 4], 64)
    kb.reset_launches()
    ok, w = kb.transfer(words, lo, hi, olo, ohi, mask, nb)
    ok_ref, w_ref = bloom.transfer(words, lo, hi, olo, ohi, mask, nb)
    torch.cuda.synchronize()
    assert torch.equal(ok, ok_ref) and torch.equal(w, w_ref)
    assert kb.LAUNCHES["bloom_transfer"] == 1
    keep = rng.random(n) < 0.5
    w_in = bloom_build(keys, keep)
    got = bloom_transfer(w_in, keys, out_keys)
    want = bloom_transfer(w_in.cpu(), keys, out_keys)
    np.testing.assert_array_equal(got[0], want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert got[0][keep].all()


#: K7's routes (`bloom.cu`, K7's note; `bloom_transfer_force`'s codes):
#: L2 (one row a thread, one atomic a bit into the zeroed filter), tiny
#: (one row a thread, an outgoing filter of at most TINY blocks in shared
#: memory) and partitioned (larger filters in at most 2^MAX_SLICES_LOG2
#: slices: TRANSFER_ROWS adjacent rows a thread, strided where the
#: columns are not 16-byte aligned, the survivors' hashes listed,
#: scattered by slice, each slice built in shared memory). The rule: into
#: at most TINY blocks the tiny route from TINY_ROWS rows a block on, L2
#: below; into more the partitioned route from MANY_TRANSFER rows on
#: where its slices allow, L2 otherwise.
TRANSFER_ROWS, TRANSFER_ROUTES = 4, (1, 2, 3)
MANY_TRANSFER, TINY_ROWS, MAX_SLICES_LOG2 = 1 << 22, 128, 12
TRANSFER_NS = (1, 3, (1 << 16) - 3, MANY_TRANSFER - 5, MANY_TRANSFER + 5)
TRANSFER_NBS = (1, 8, TINY, 4096, 1 << 19)


def _slices_log2(log2nb):
    """log2 of K2's slices in a 2^log2nb-block filter (`slice_log2`)."""
    return log2nb - min(max(log2nb - 8, 4), 11)


@pytest.mark.parametrize("kind", ["repeats", "distinct"])
@pytest.mark.parametrize("route", TRANSFER_ROUTES,
                         ids=["l2", "tiny", "partitioned"])
def test_transfer_kernel_forced_plans_match_plain_version(cuda, route, kind):
    """K7 with each route forced in turn (`bloom_transfer_force`) == its
    plain version bit for bit, survivors and outgoing words: at n in
    TRANSFER_NS (MANY_TRANSFER ± 5 sits at the rule's edge) into 1 to
    2^19 outgoing blocks, with outgoing keys of about 90 copies each or
    all distinct, masks all True, all False and 80% True, and over column
    views (`lo[1:]`, not 16-byte aligned: the partitioned route's strided
    rows); one launch a call."""
    rng = np.random.default_rng(10 * route + (kind == "distinct"))
    big = MANY_TRANSFER + 6
    keys = _keys(rng, big)
    lo, hi = bloom.keys_to_device(keys, cuda)
    olo, ohi = bloom.keys_to_device(
        rng.integers(0, big // 90, big, dtype=np.int64)
        if kind == "repeats" else _keys(rng, big), cuda)
    masks = (torch.ones(big, dtype=torch.bool, device=cuda),
             torch.zeros(big, dtype=torch.bool, device=cuda),
             torch.from_numpy(rng.random(big) < 0.8).to(cuda))
    words = kb.build_ref(lo[: 1 << 16], hi[: 1 << 16], 4096)
    lib = kb._lib()
    assert lib.bloom_transfer_force(route) == 0
    kb.reset_launches()
    calls = 0
    try:
        for i, (n, nb) in enumerate((n, nb) for n in TRANSFER_NS
                                    for nb in TRANSFER_NBS):
            mask = masks[i % 3]
            for at in ((0, 1) if n == (1 << 16) - 3 else (0,)):
                args = (words, lo[at:at + n], hi[at:at + n],
                        olo[at:at + n], ohi[at:at + n], mask[at:at + n], nb)
                ok, w = kb.transfer(*args)
                ok_ref, w_ref = bloom.transfer(*args)
                torch.cuda.synchronize()
                assert torch.equal(ok, ok_ref), (n, nb, at)
                assert torch.equal(w, w_ref), (n, nb, at)
                calls += 1
    finally:
        lib.bloom_transfer_force(0)
    assert kb.LAUNCHES["bloom_transfer"] == calls


@pytest.mark.parametrize("log2nb", [23, 24])
@pytest.mark.parametrize("forced", [0, 3], ids=["rule", "partitioned"])
def test_transfer_into_the_most_slices_matches_plain_version(cuda, log2nb,
                                                             forced):
    """K7 at MANY_TRANSFER + 5 rows into 2^23 blocks (2^MAX_SLICES_LOG2
    slices: the partitioned route's largest filter) and 2^24 (more: the
    L2 route, by the rule and when the partitioned route is forced): its
    survivors == the plain version's (which do not depend on the outgoing
    filter, so it runs into TINY blocks), its outgoing words == K2's build
    of the survivors' outgoing keys (held to its plain version by its own
    tests; the plain version's words take 16 and 32 GiB of int64 at these
    sizes)."""
    lib = kb._lib()
    n = MANY_TRANSFER + 5
    route = 3 if _slices_log2(log2nb) <= MAX_SLICES_LOG2 else 1
    assert (route == 3) == (log2nb == 23)
    rng = np.random.default_rng(log2nb)
    lo, hi = bloom.keys_to_device(_keys(rng, n), cuda)
    olo, ohi = bloom.keys_to_device(_keys(rng, n), cuda)
    mask = torch.from_numpy(rng.random(n) < 0.8).to(cuda)
    words = kb.build_ref(lo[: 1 << 16], hi[: 1 << 16], 4096)
    assert lib.bloom_transfer_force(forced) == 0
    try:
        assert lib.bloom_transfer_plan(n, log2nb) == route
        ok, w = kb.transfer(words, lo, hi, olo, ohi, mask, 1 << log2nb)
    finally:
        lib.bloom_transfer_force(0)
    ok_ref, _ = bloom.transfer(words, lo, hi, olo, ohi, mask, TINY)
    assert torch.equal(ok, ok_ref)
    assert torch.equal(w, kb.build(olo, ohi, 1 << log2nb, valid=ok_ref))


def test_transfer_plan_follows_the_source_note(cuda):
    """K7's rule (`bloom_transfer_plan`: the route's code): into at most
    TINY blocks the tiny route from TINY_ROWS rows a block on, L2 below;
    into more the partitioned route from MANY_TRANSFER rows on (scratch
    for n rows) where the filter has at most 2^MAX_SLICES_LOG2 slices, L2
    otherwise (no scratch); a forced route overrides the rule's (the tiny
    route only where the filter allows it, the partitioned one only where
    it has more blocks in few enough slices), and an out-of-range value
    is refused."""
    lib = kb._lib()
    for n in (1, 1024, 5003, MANY_TRANSFER - 1, MANY_TRANSFER, 1 << 23):
        for log2nb in (0, 3, 6, 7, 19, 23, 24, 26):
            route = ((2 if n >= TINY_ROWS << log2nb else 1)
                     if (1 << log2nb) <= TINY else
                     3 if n >= MANY_TRANSFER
                     and _slices_log2(log2nb) <= MAX_SLICES_LOG2 else 1)
            assert lib.bloom_transfer_plan(n, log2nb) == route, (n, log2nb)
            scratch = lib.bloom_transfer_scratch_bytes(n, log2nb)
            assert (scratch > 4 * n) == (route == 3), (n, log2nb)
    try:
        assert lib.bloom_transfer_force(2) == 0
        assert lib.bloom_transfer_plan(1, 19) == 1
        assert lib.bloom_transfer_plan(1, 6) == 2
        assert lib.bloom_transfer_force(3) == 0
        assert lib.bloom_transfer_plan(1, 19) == 3
        assert lib.bloom_transfer_plan(1, 23) == 3
        assert lib.bloom_transfer_plan(1, 24) == 1
        assert lib.bloom_transfer_plan(1, 6) == 2
        assert lib.bloom_transfer_force(1) == 0
        assert lib.bloom_transfer_plan(1 << 16, 0) == 1
        for bad in (4, -1):
            assert lib.bloom_transfer_force(bad) != 0
        assert lib.bloom_transfer_plan(1 << 16, 0) == 1  # left as it was
    finally:
        lib.bloom_transfer_force(0)


def _attn_inputs(rng, b, sq, skv, h, kvh, d, dev, ragged=True,
                 dead_rows=0):
    """bf16 q/k/v from numpy; decode-style positions; kv_valid ragged
    (the last 3 keys invalid) and, with `dead_rows`, the first rows'
    queries placed before every valid key (rows that see no key)."""
    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, torch.bfloat16)
    q, k, v = t((b, sq, h, d)), t((b, skv, kvh, d)), t((b, skv, kvh, d))
    q_pos = np.broadcast_to(np.arange(skv - sq, skv)[None], (b, sq)).copy()
    kv_pos = np.broadcast_to(np.arange(skv)[None], (b, skv)).copy()
    kv_valid = kv_pos < (skv - 3) if ragged else np.ones((b, skv), bool)
    if dead_rows:
        q_pos[:, :dead_rows] = -1
    return (q, k, v, torch.from_numpy(q_pos.astype(np.int32)).to(dev),
            torch.from_numpy(kv_pos.astype(np.int32)).to(dev),
            torch.from_numpy(kv_valid).to(dev))


def _attn_expected(q, k, v, qp, kp, kval, causal, window):
    from repro_torch.kernels.flashattn.ops import flash_plain
    from repro_torch.kernels.flashattn.ref import sdpa_ref
    rep = q.shape[2] // k.shape[2]
    plain = flash_plain(q, k, v, qp, kp, kval, causal=causal, window=window)
    dense = sdpa_ref(q, k.repeat_interleave(rep, 2),
                     v.repeat_interleave(rep, 2), qp, kp, kval,
                     causal=causal, window=window)
    return plain, dense


@pytest.fixture()
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal,window,pos", [
    (2, 128, 256, 4, 2, 64, True, None, "tail"),   # GQA
    (1, 200, 300, 2, 1, 128, True, None, "tail"),  # no length a tile multiple
    (2, 64, 200, 6, 2, 128, False, None, "tail"),  # not causal
    (1, 130, 130, 4, 4, 64, True, 64, "tail"),     # window, ragged tiles
    (1, 96, 96, 2, 2, 64, True, 17, "tail"),
    (2, 1, 384, 4, 4, 64, True, None, "tail"),     # decode
    (3, 1, 2088, 24, 8, 128, True, None, "tail"),  # decode, GQA 3
    (1, 1, 700, 36, 4, 128, True, 64, "tail"),     # decode, 9 heads a group
    (2, 1, 100, 8, 8, 128, False, None, "tail"),
    (1, 1, 32768, 20, 20, 128, True, None, "tail"),  # decode, 40 splits of
                                                     # 13 tiles
    (4, 1, 2088, 20, 20, 128, True, None, "ring"),   # qwen, wrapped ring
    (2, 1, 2088, 16, 16, 64, True, 64, "tail"),    # 31 of 33 tiles skipped
    (2, 1, 1000, 32, 2, 64, True, None, "dead"),   # group of 16; batch row 0
                                                   # sees no key
])
def test_flash_kernel_matches_plain_version(cuda, no_tf32, b, sq, skv, h,
                                            kvh, d, causal, window, pos):
    """K8 == `flash_plain` and `sdpa_ref` on the card within 2e-2 (bf16),
    and at Sq 1 also within `_decode_limit`, on the variant Sq selects;
    the wrapper counts that launch only. Positions: `tail` the
    decode-style ones of `_attn_inputs`, `ring` the model's ring cache
    after it has wrapped, `dead` row 0 placed before every key."""
    from repro_torch.kernels.flashattn import ops as fa
    rng = np.random.default_rng(sq * 7 + skv)
    args = _attn_inputs(rng, b, sq, skv, h, kvh, d, cuda,
                        dead_rows=int(pos == "dead"))
    if pos == "ring":
        args = args[:3] + _positions("ring", b, sq, skv, cuda)
    fa.reset_launches()
    got = fa.flash_attention(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    variant = "flash_decode" if sq == 1 else "flash_prefill"
    assert fa.LAUNCHES == {**{k: 0 for k in fa.LAUNCHES}, variant: 1}
    assert got.shape == (b, sq, h, d) and got.dtype == torch.bfloat16
    for want in _attn_expected(*args, causal, window):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        if sq == 1:
            err = float((got.float() - want.float()).abs().max())
            assert err <= _decode_limit(want), (err, _decode_limit(want))


def _decode_limit(ref):
    """Two bf16 ulps of the largest |ref|. The decode kernel and the
    plain versions round f32 values that differ by far less than an ulp,
    so each output lands at most one ulp of the largest output away;
    decode outputs are averages over the cache, small beside 2e-2 at a
    long one, and a split left out or misweighted moves them by a share
    of their own scale, well past two ulps."""
    top = float(ref.float().abs().max())
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def test_flash_decode_splits_follow_the_source_note(cuda):
    """The decode kernel's split rule gives the grids its source note
    states: ceil(B * KVH * tiles / 792) tiles a split, at least 2 and at
    most 64, and at least one split."""
    from repro_torch.kernels.flashattn import ops as fa
    assert fa.flash_decode_splits(4, 20, 2088) == 9      # qwen1.5-4b decode
    assert fa.flash_decode_splits(1, 20, 32768) == 40    # 13 tiles a split
    assert fa.flash_decode_splits(2, 8, 2088) == 17      # 2 tiles a split
    assert fa.flash_decode_splits(1, 1, 0) == 1
    assert fa.flash_decode_splits(512, 32, 32768) == 8   # 64 tiles a split


def test_flash_decode_tickets_return_to_zero(cuda, no_tf32):
    """Back-to-back decode calls with different B*KVH (the counter buffer
    grows between them) give the results of a lone call and leave every
    ticket counter at 0; a call on another stream takes its own
    counters."""
    from repro_torch.kernels.flashattn import ops as fa
    rng = np.random.default_rng(21)
    small = _attn_inputs(rng, 2, 1, 700, 8, 4, 128, cuda)
    big = _attn_inputs(rng, 4, 1, 2088, 20, 20, 128, cuda)
    first = fa.flash_attention(*small)
    torch.cuda.synchronize()
    outs = [fa.flash_attention(*x) for x in (big, small, big, small)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = fa.flash_attention(*big)
    torch.cuda.synchronize()
    assert torch.equal(outs[1], first) and torch.equal(outs[3], first)
    assert torch.equal(outs[0], outs[2]) and torch.equal(other, outs[0])
    dev = torch.cuda.current_device()
    mine = fa._TICKETS[(dev, torch.cuda.current_stream().cuda_stream)]
    theirs = fa._TICKETS[(dev, side.cuda_stream)]
    assert mine.numel() >= 4 * 20 and theirs is not mine
    assert int(mine.abs().sum()) == 0 and int(theirs.abs().sum()) == 0


@pytest.mark.parametrize("sq", [1, 70])
def test_flash_kernel_rows_without_a_valid_key(cuda, no_tf32, sq):
    """Rows whose query sees no key average v over the Skv real keys, as
    `sdpa_ref` gives (no padding takes part)."""
    from repro_torch.kernels.flashattn import ops as fa
    rng = np.random.default_rng(11)
    args = _attn_inputs(rng, 2, sq, 200, 4, 2, 64, cuda, dead_rows=1)
    got = fa.flash_attention(*args, causal=True)
    for want in _attn_expected(*args, True, None):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    mean_v = args[2].float().mean(dim=1).repeat_interleave(2, 1)
    torch.testing.assert_close(got[:, 0].float(), mean_v, atol=2e-2,
                               rtol=2e-2)


def _positions(case, b, sq, skv, dev):
    """(q_pos, kv_pos, kv_valid) of the tile-skipping cases: `ring` is
    the model's ring cache after `skv + 188` tokens (kv_pos wraps, so it
    is not monotone) queried by the last `sq` positions; `arange` and
    `dead` put query i and key i at position i (`dead`: row 0 at -1, so
    it sees no key)."""
    if case == "ring":
        from repro_torch.models.layers import _ring_positions
        index = skv + 188
        kp, kval = _ring_positions(index, skv, b, dev)
        qp = torch.arange(index - sq, index, dtype=torch.int32, device=dev)
        return qp[None].repeat(b, 1), kp, kval
    qp = torch.arange(sq, dtype=torch.int32, device=dev)[None].repeat(b, 1)
    kp = torch.arange(skv, dtype=torch.int32, device=dev)[None].repeat(b, 1)
    if case == "dead":
        qp[:, 0] = -1
    return qp, kp, torch.ones(b, skv, dtype=torch.bool, device=dev)


@pytest.mark.parametrize("case,b,sq,skv,h,kvh,d,window", [
    ("ring", 2, 256, 512, 4, 2, 128, None),     # wrapped ring cache
    ("ring", 1, 384, 700, 4, 4, 64, 200),
    ("arange", 2, 1024, 1024, 4, 4, 128, 100),  # window skips leading tiles
    ("arange", 1, 1024, 1024, 4, 2, 64, 300),
    ("dead", 1, 512, 512, 4, 4, 128, None),     # row 0 sees no key: redo
    ("dead", 2, 512, 512, 2, 1, 64, 64),
    ("arange", 2, 333, 461, 4, 2, 64, None),    # no tile-multiple lengths
    ("arange", 1, 650, 777, 4, 4, 128, None),
    ("arange", 1, 2048, 2048, 24, 8, 128, None),  # GQA 24/8
])
def test_flash_prefill_skips_only_masked_tiles(cuda, no_tf32, case, b, sq,
                                               skv, h, kvh, d, window):
    """The prefill kernel skips kv tiles that no row of its q-tile may
    see; on wrapped ring positions, windows, ragged lengths, GQA and a
    row that sees no key (which needs every tile), it still equals
    `flash_plain` and `sdpa_ref` within 2e-2."""
    from repro_torch.kernels.flashattn import ops as fa
    rng = np.random.default_rng(sq + skv + d)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda, torch.bfloat16)
    q, k, v = t((b, sq, h, d)), t((b, skv, kvh, d)), t((b, skv, kvh, d))
    args = (q, k, v, *_positions(case, b, sq, skv, cuda))
    fa.reset_launches()
    got = fa.flash_attention(*args, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_prefill"] == 1
    for want in _attn_expected(*args, True, window):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    if case == "dead":
        mean_v = v.float().mean(dim=1).repeat_interleave(h // kvh, 1)
        torch.testing.assert_close(got[:, 0].float(), mean_v, atol=2e-2,
                                   rtol=2e-2)


def _mla_positions(case, b, sq, skv, dev):
    """(q_pos, kv_pos, kv_valid) of deepseek-v2-lite's serve path: `fresh`
    the ring cache of `skv` slots right after a prompt of `sq` tokens
    (prefill) or at the step that writes slot skv - 8 (decode), `ring`
    and `dead` as in `_positions`."""
    if case != "fresh":
        return _positions(case, b, sq, skv, dev)
    from repro_torch.models.layers import _ring_positions
    index = sq if sq > 1 else skv - 7
    kp, kval = _ring_positions(index, skv, b, dev)
    qp = torch.arange(index - sq, index, dtype=torch.int32, device=dev)
    return qp[None].repeat(b, 1), kp, kval


@pytest.mark.parametrize("b,sq,skv,case", [
    (4, 2048, 2088, "fresh"),    # deepseek-v2-lite's serve prefill
    (2, 256, 512, "ring"),       # wrapped ring cache
    (1, 512, 512, "dead"),       # row 0 sees no key: the second pass
    (1, 333, 461, "fresh"),      # no tile-multiple lengths
    (4, 1, 2088, "fresh"),       # its serve decode step
    (4, 1, 2088, "ring"),
    (2, 1, 1000, "dead"),        # no row sees a key: the mean of v
    (1, 1, 32768, "fresh"),      # B 1 over a long cache: 40 splits
])
def test_flash_kernel_matches_plain_version_at_mla_head_sizes(
        cuda, no_tf32, b, sq, skv, case):
    """K8 at MLA's head sizes, q/k 192 and v 128 (16 heads, one query head
    a kv head, as deepseek-v2-lite calls it): == `flash_plain` and
    `sdpa_ref` within 2e-2, a decode line also within `_decode_limit`;
    a row that sees no key averages v over every key."""
    from repro_torch.kernels.flashattn import ops as fa
    rng = np.random.default_rng(sq + skv + 192)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda, torch.bfloat16)
    h = 16
    q, k, v = t((b, sq, h, 192)), t((b, skv, h, 192)), t((b, skv, h, 128))
    args = (q, k, v, *_mla_positions(case, b, sq, skv, cuda))
    fa.reset_launches()
    got = fa.flash_attention(*args, causal=True)
    torch.cuda.synchronize()
    variant = "flash_decode" if sq == 1 else "flash_prefill"
    assert fa.LAUNCHES == {**{k: 0 for k in fa.LAUNCHES}, variant: 1}
    assert got.shape == (b, sq, h, 128) and got.dtype == torch.bfloat16
    for want in _attn_expected(*args, True, None):
        assert want.shape == got.shape
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        if sq == 1:
            err = float((got.float() - want.float()).abs().max())
            assert err <= _decode_limit(want), (err, _decode_limit(want))
    if case == "dead":
        torch.testing.assert_close(got[:, 0].float(),
                                   v.float().mean(dim=1), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("sq", [1, 64])
@pytest.mark.parametrize("d,dv", [(192, 192), (128, 64), (96, 96),
                                  (192, 64)])
def test_flash_kernel_rejects_uncompiled_head_sizes(cuda, d, dv, sq):
    """A (D, Dv) pair the library is not compiled for raises ValueError on
    a CUDA tensor, for either variant, and launches nothing; the plain
    version never stands in."""
    from repro_torch.kernels.flashattn import ops as fa
    rng = np.random.default_rng(d + dv)
    q, k, v, qp, kp, kval = _attn_inputs(rng, 1, sq, 64, 2, 2, d, cuda)
    v = v[..., :dv] if dv < d else torch.cat([v, v], -1)[..., :dv]
    fa.reset_launches()
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, v.contiguous(), qp, kp, kval)
    assert sum(fa.LAUNCHES.values()) == 0


def test_flash_kernel_reads_strided_cache_views(cuda, no_tf32):
    """k/v as views into a larger [B, cap, KVH, D] cache and q as a slice
    of a wider projection: the kernel reads them through their strides."""
    from repro_torch.kernels.flashattn import ops as fa
    rng = np.random.default_rng(3)
    q, k, v, qp, kp, kval = _attn_inputs(rng, 2, 80, 160, 4, 2, 128, cuda)
    big = torch.zeros((2, 160, 6, 128), dtype=torch.bfloat16, device=cuda)
    big[:, :, 1:3] = k
    qwide = torch.zeros((2, 80, 8, 128), dtype=torch.bfloat16, device=cuda)
    qwide[:, :, 4:] = q
    got = fa.flash_attention(qwide[:, :, 4:], big[:, :, 1:3], v, qp, kp,
                             kval, causal=True)
    want = fa.flash_attention(q, k, v, qp, kp, kval, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    """f32, head_dim 96 and a decode group wider than the kernel serves
    on a CUDA device raise ValueError and launch nothing. None runs the
    plain version."""
    from repro_torch.kernels.flashattn import ops as fa
    rng = np.random.default_rng(5)
    args = _attn_inputs(rng, 1, 64, 64, 2, 2, 64, cuda)
    fa.reset_launches()
    f32 = [t.float() for t in args[:3]] + list(args[3:])
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention(*f32)
    args96 = _attn_inputs(rng, 1, 64, 64, 2, 2, 96, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(*args96)
    wide = _attn_inputs(rng, 1, 1, 64, 2 * fa.MAX_GROUP, 1, 64, cuda)
    with pytest.raises(ValueError, match="query heads per kv head"):
        fa.flash_attention(*wide)
    assert sum(fa.LAUNCHES.values()) == 0


def test_flash_kernel_failed_build_raises(cuda, tmp_path, monkeypatch):
    """A source nvcc refuses makes the wrapper raise; nothing launches."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flashattn import ops as fa
    bad = tmp_path / "flashattn.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setitem(kbuild.SOURCES, "flashattn", bad)
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(kbuild._LIBS, "flashattn", raising=False)
    monkeypatch.setattr(fa, "_LIB", None)
    args = _attn_inputs(np.random.default_rng(1), 1, 64, 64, 2, 2, 64, cuda)
    fa.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fa.flash_attention(*args)
    assert sum(fa.LAUNCHES.values()) == 0
