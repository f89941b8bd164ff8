"""Port parity: the plain versions of kernels K3 (single-filter Bloom
probe), K4 (key -> row map build) and K5 (its lookup), and the plane-off
join API `joinmap_build` / `joinmap_lookup`, against the reference
package (its Pallas kernels in interpret mode, its jnp table builder and
its join engines).

Inputs are made from a seed with numpy and fed to both packages. Every
output here is an integer or boolean array and must match bit-exactly;
the K4 table must equal the reference's (klo, khi, occ, row) lanes byte
for byte. The kernels themselves run only on an NVIDIA GPU: their tests
are in tests/test_torch_kernels_gpu.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import bloom as rbloom
from repro.core import hashing as rhashing
from repro.core.engine_join import PallasJoinEngine as RPallasJoinEngine
from repro.kernels.bloom import bloom as rkern
from repro.kernels.semijoin import ops as rsj
from repro.kernels.semijoin import semijoin as rsjk
from repro_torch.core.engine_join import get_join_engine
from repro_torch.kernels.bloom import ops as kb
from repro_torch.kernels.semijoin import ops as sj

HOWS = ("inner", "left", "semi", "anti")
TILE = 1024
EXTREMES = np.array([np.iinfo(np.int64).min, -(1 << 62), -(1 << 32), -1, 0,
                     1, 1 << 31, (1 << 32) - 1, np.iinfo(np.int64).max],
                    np.int64)


def _keys(rng, n, domain=None):
    """int64 keys; without a domain, over all of int64 with the extremes."""
    if domain is not None:
        return rng.integers(0, domain, n).astype(np.int64)
    k = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                     dtype=np.int64)
    k[: len(EXTREMES)] = EXTREMES[: n]
    return k


def _pad(a, fill=0):
    """Pad to the reference kernels' tile (their n % 1024 == 0 contract)."""
    m = -(-len(a) // TILE) * TILE
    out = np.full(m, fill, a.dtype)
    out[: len(a)] = a
    return out


def _t(a):
    """uint32 host array -> int32 CPU tensor (the port's device layout)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# --------------------------------------------------------------------------
# K3
# --------------------------------------------------------------------------


@pytest.mark.parametrize("nblocks", [1, 2, 64, 1024])
def test_probe_ref_matches_pallas(rng, nblocks):
    """K3's plain version == reference probe_pallas (interpret mode) over
    n = 5003 rows (not a tile multiple); then over survivor ids with a
    ragged count == the reference's _gather2 + probe_pallas +
    _mask_count; the CPU wrapper takes the plain version."""
    n = 5003
    member = _keys(rng, 3 * nblocks + 7)
    mlo, mhi = rhashing.key_halves(member)
    words = rbloom.build_np(mlo, mhi, np.ones(len(member), bool), nblocks)
    keys = _keys(rng, n)
    keys[::4] = rng.choice(member, len(keys[::4]))
    lo, hi = rhashing.key_halves(keys)
    ref = np.asarray(rkern.probe_pallas(
        jnp.asarray(words), jnp.asarray(_pad(lo)), jnp.asarray(_pad(hi)),
        interpret=True))[:n]
    tw = _t(words)
    got = kb.probe_ref(tw, _t(lo), _t(hi))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[::4].all()                       # members always hit

    idx = np.sort(rng.choice(n, 2048, replace=False)).astype(np.int32)
    count = 1501
    ref_g = np.asarray(rkern.probe_pallas(
        jnp.asarray(words), jnp.asarray(lo[idx]), jnp.asarray(hi[idx]),
        interpret=True)) & (np.arange(len(idx)) < count)
    got_g = kb.probe(tw, _t(lo), _t(hi), idx=torch.from_numpy(idx),
                     count=count)
    np.testing.assert_array_equal(got_g.numpy(), ref_g)
    np.testing.assert_array_equal(
        kb.probe(tw, _t(lo), _t(hi), count=n - 3).numpy(),
        ref & (np.arange(n) < n - 3))


def test_probe_wrapper_counts_nothing_on_cpu_and_rejects_bad_inputs(rng):
    kb.reset_launches()
    lo, hi = rhashing.key_halves(_keys(rng, 100))
    words = torch.zeros((16, 8), dtype=torch.int32)
    assert not kb.probe(words, _t(lo), _t(hi)).any()
    assert kb.LAUNCHES["probe"] == 0
    with pytest.raises(ValueError):
        kb.probe(words, _t(lo), _t(hi), count=101)


# --------------------------------------------------------------------------
# K4 / K5
# --------------------------------------------------------------------------


def _ref_table(keys, cap):
    """The reference's jnp joinmap builder (the Pallas build's insert
    order) over tile-padded keys, as host uint32 lanes."""
    lo, hi = rhashing.key_halves(_pad(keys))
    mask = _pad(np.ones(len(keys), bool), False)
    lanes = rsj._joinmap_build_jnp(jnp.asarray(lo), jnp.asarray(hi),
                                   jnp.asarray(mask), cap)
    return [np.asarray(a) for a in lanes]


@pytest.mark.parametrize("n,domain", [(1, None), (700, None), (3000, None),
                                      (3000, 900), (2500, 40)],
                         ids=["one", "unique", "unique-3k", "dups", "heavy"])
def test_build_rows_ref_table_matches_reference(rng, n, domain):
    """K4's plain version builds the reference's table byte for byte:
    klo, khi, occ and row lanes equal `_joinmap_build_jnp`'s; with
    duplicate keys `occupied` is the distinct count and the last row
    wins."""
    keys = _keys(rng, n, domain)
    cap = sj.capacity_for(n)
    assert cap == rsj.capacity_for(n)
    klo, khi, occ, row = _ref_table(keys, cap)
    lo, hi = rhashing.key_halves(keys)
    table, occupied = sj.build_rows(_t(lo), _t(hi), cap)
    got = table.numpy().view(np.uint32)
    for c, lane in enumerate((klo, khi, occ, row)):
        np.testing.assert_array_equal(got[:, c], lane, err_msg=str(c))
    assert int(occupied) == int(occ.sum()) == len(np.unique(keys))


@pytest.mark.parametrize("domain", [None, 5000], ids=["wide", "narrow"])
def test_lookup_ref_matches_pallas(rng, domain):
    """K5's plain version == reference lookup_pallas (interpret mode)
    over the same table, hits and misses, 3001 probe keys (not a tile
    multiple); `lookup_work` counts the slots and the distinct 32-byte
    sectors a step-by-step walk of the reference's lanes reads."""
    build = np.unique(_keys(rng, 1200, domain))
    rng.shuffle(build)
    cap = sj.capacity_for(len(build))
    klo, khi, occ, row = _ref_table(build, cap)
    probe = np.concatenate([rng.choice(build, 2000), _keys(rng, 1001,
                                                           domain)])
    plo, phi = rhashing.key_halves(probe)
    ref = np.asarray(rsjk.lookup_pallas(
        *(jnp.asarray(a) for a in (klo, khi, occ, row)),
        jnp.asarray(_pad(plo)), jnp.asarray(_pad(phi)),
        interpret=True))[: len(probe)]
    lo, hi = rhashing.key_halves(build)
    table, _ = sj.build_rows(_t(lo), _t(hi), cap)
    got = sj.lookup(table, _t(plo), _t(phi))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[:2000] >= 0).all()
    np.testing.assert_array_equal(build[ref[:2000]], probe[:2000])
    visited, sectors = 0, set()
    for a, b, s in zip(plo, phi, rhashing.hash64_np(plo, phi) & (cap - 1)):
        while True:
            visited += 1
            sectors.add(int(s) >> 1)
            if not occ[s] or (klo[s] == a and khi[s] == b):
                break
            s = (s + 1) & (cap - 1)
    assert sj.lookup_work(table, _t(plo), _t(phi)) == (visited, len(sectors))


def test_joinmap_api_matches_reference(rng):
    """joinmap_build / joinmap_lookup on the CPU == the reference's
    (jnp build, Pallas lookup in interpret mode): occupied and rows."""
    build = np.unique(_keys(rng, 900, 10**6))
    rng.shuffle(build)
    probe = np.concatenate([rng.choice(build, 1500),
                            _keys(rng, 500, 10**6)])
    rtable, rocc = rsj.joinmap_build(build, use_pallas=False)
    want = rsj.joinmap_lookup(rtable, probe, use_pallas=True,
                              interpret=True)
    table, occ = sj.joinmap_build(build, device="cpu")
    assert occ == rocc == len(build)
    got = sj.joinmap_lookup(table, probe)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    dup = np.concatenate([build, build[:7]])
    assert sj.joinmap_build(dup, device="cpu")[1] == len(build)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("dups", [False, True], ids=["unique", "dups"])
def test_plane_off_join_indices_match_reference(rng, how, dups):
    """The cuda join engine with the plane off (device="cpu") == the
    reference pallas join engine with the plane off, for inner, left,
    semi and anti; duplicate builds go to the host engine in both, and
    NULLs take the compact-and-remap."""
    build = np.unique(_keys(rng, 800, 3000))
    rng.shuffle(build)
    if dups:
        build = np.concatenate([build, build[::5]])
    probe = _keys(rng, 2100, 4000)
    ref = RPallasJoinEngine(device_resident=False)
    eng = get_join_engine("cuda", device_resident=False, device="cpu")
    for got, want in zip(eng.join_indices(build, probe, how),
                         ref.join_indices(build, probe, how)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    bv = rng.random(len(build)) < 0.9
    pv = rng.random(len(probe)) < 0.8
    for got, want in zip(eng.join_indices_valid(build, probe, how, bv, pv),
                         ref.join_indices_valid(build, probe, how, bv, pv)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_joinmap_wrappers_count_nothing_on_cpu_and_reject_bad_inputs(rng):
    sj.reset_launches()
    lo, hi = rhashing.key_halves(_keys(rng, 64))
    table, occ = sj.build_rows(_t(lo), _t(hi), 128)
    assert int(occ) == 64
    assert (sj.lookup(table, _t(lo), _t(hi)).numpy()
            == np.arange(64)).all()
    assert sj.LAUNCHES == {"joinmap_build": 0, "joinmap_lookup": 0,
                           "semijoin_build": 0, "semijoin_probe": 0}
    with pytest.raises(ValueError):
        sj.build_rows(_t(lo), _t(hi), 96)       # not a power of two
    with pytest.raises(ValueError):
        sj.build_rows(_t(lo), _t(hi), 64)       # no empty slot left


def _partitioned_twin(keys, cap, log2r):
    """Plain twin of K4's partitioned route (semijoin.cu, K4's note), one
    key at a time: the keys go to their regions' parts of the scratch in
    row order (a part keeps its first `region_cap` keys, the rest go to the
    overflow list), each region is built alone, in order (a walk that runs
    past the region's end sends its key to the overflow list), then the
    overflow list is inserted into the whole table; equal keys keep the
    largest row. Returns (int32 table [cap, 4], occupied, keys spilled
    from a part, keys whose walk left their region)."""
    import chip_smoke
    lo, hi = rhashing.key_halves(keys)
    log2cap = cap.bit_length() - 1
    log2r = min(log2r, log2cap)
    home = (rhashing.hash64_np(lo, hi) & (cap - 1)).astype(np.int64)
    rcap = chip_smoke.region_cap(len(keys), log2cap - log2r, log2r)
    parts = [[] for _ in range(cap >> log2r)]
    overflow = []
    for r, s in enumerate(home):
        part = parts[s >> log2r]
        (part if len(part) < rcap else overflow).append(r)
    spilled = len(overflow)
    table = np.zeros((cap, 4), np.uint32)

    def insert(r, end):
        s = home[r]
        while table[s, 2] and (table[s, 0] != lo[r] or table[s, 1] != hi[r]):
            s += 1
            if s == end:
                return False
            s &= cap - 1
        if not table[s, 2]:
            table[s] = (lo[r], hi[r], 1, r)
        table[s, 3] = max(table[s, 3], r)
        return True
    for reg, part in enumerate(parts):
        for r in part:
            if not insert(r, (reg + 1) << log2r):
                overflow.append(r)
    for r in overflow:
        insert(r, None)
    return (torch.from_numpy(table.view(np.int32)), int(table[:, 2].sum()),
            spilled, len(overflow) - spilled)


@pytest.mark.parametrize("n,log2r", [(3000, 8), (5000, 13), (3000, 13)],
                         ids=["32-regions", "2-regions", "one-region"])
def test_partitioned_build_twin_lookups_match_reference(rng, n, log2r):
    """A plain twin of K4's partitioned route (regions in order, overflow
    last) over keys crowded at a region's tail, at the last region's wrap
    into slot 0 and past a region's part of the scratch
    (`chip_smoke.crowded_keys`, with repeated keys) gives a valid table:
    `occupied` is the distinct count, and the plain lookup over it (K5's
    walk) finds every key's last row and misses the rest, as the
    reference's lookup (Pallas kernel in interpret mode) does over the
    reference's sequential table."""
    import chip_smoke
    cap = sj.capacity_for(n)
    keys = chip_smoke.crowded_keys(np, rng, n, cap, log2r)
    table, occupied, spilled, walked = _partitioned_twin(keys, cap, log2r)
    assert walked > 0 and (spilled > 0) == (cap > 1 << log2r)
    assert occupied == len(np.unique(keys))
    probe = np.concatenate([keys, _keys(rng, 997)])
    rtable, _ = rsj.joinmap_build(keys, use_pallas=False)
    want = rsj.joinmap_lookup(rtable, probe, use_pallas=True, interpret=True)
    plo, phi = rhashing.key_halves(probe)
    got = sj.lookup_ref(table, _t(plo), _t(phi))
    np.testing.assert_array_equal(got.numpy(), want)
