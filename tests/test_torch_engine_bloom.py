"""Port parity: the `cuda` Bloom engine (on device="cpu", where its kernel
wrappers run their plain torch versions) against the reference host
engine `repro.core.engine_bloom.get_engine("numpy")`, on the inputs of
tests/test_engine_bloom.py and tests/test_device_plane.py.

Inputs are made from a seed with numpy and fed to both packages.
Survivor masks, per-filter live counts (`live_after`), live counts, key
ranges and filter words are integers or booleans and must match
bit-exactly."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.core import bloom as rbloom
from repro.core import hashing as rhashing
from repro.core.engine_bloom import get_engine as rget_engine
from repro_torch.core import bloom, device_plane
from repro_torch.core.engine_bloom import get_engine

SIZES = [0, 1, 5, 100, 4096, 5003]


def _cuda_cpu():
    return get_engine("cuda", device="cpu", device_resident=True)


def _oracle_build(keys, mask, nblocks):
    lo, hi = rhashing.key_halves(np.asarray(keys))
    return rbloom.build_np(lo, hi, np.asarray(mask, bool), nblocks)


@pytest.mark.parametrize("n", SIZES)
def test_build_matches_reference(rng, n):
    """Filter words == reference numpy engine's, bit-exact."""
    keys = rng.integers(-2**62, 2**62, n).astype(np.int64)
    mask = rng.random(n) < 0.7
    nblocks = rbloom.blocks_for(max(int(mask.sum()), 1))
    ref = rget_engine("numpy")
    want = ref.build_filter(ref.keys(keys), mask, nblocks=nblocks).words
    eng = _cuda_cpu()
    got = eng.build_filter(eng.keys(keys), mask, nblocks=nblocks).words
    np.testing.assert_array_equal(bloom.words_to_host(got), want)
    np.testing.assert_array_equal(want, _oracle_build(keys, mask, nblocks))


@pytest.mark.parametrize("n", [1, 100, 5003])
def test_probe_matches_reference(rng, n):
    """Probe survivor mask == reference numpy engine's, bit-exact."""
    member = rng.integers(0, 10**6, max(n, 1)).astype(np.int64)
    keys = np.concatenate([member[: n // 2],
                           rng.integers(2 * 10**6, 3 * 10**6, n - n // 2)
                           .astype(np.int64)])
    ref = rget_engine("numpy")
    rf = ref.build_filter(ref.keys(member))
    want = ref.probe_filter(rf, ref.keys(keys))
    eng = _cuda_cpu()
    got = eng.probe_filter(eng.build_filter(eng.keys(member)),
                           eng.keys(keys))
    np.testing.assert_array_equal(got, want)
    assert got[np.isin(keys, member)].all()


def test_all_dead_mask_and_empty_edge(rng):
    """All-dead build masks insert nothing; an all-dead live set stays
    dead — same as the reference host engine."""
    eng = _cuda_cpu()
    keys = rng.integers(0, 10**6, 257).astype(np.int64)
    dead = np.zeros(len(keys), bool)
    filt = eng.build_filter(eng.keys(keys), dead, nblocks=8)
    assert not bloom.words_to_host(filt.words).any()
    assert not eng.probe_filter(filt, eng.keys(keys)).any()
    live = eng.probe_filter(eng.build_filter(eng.keys(keys)),
                            eng.keys(keys), live=dead)
    assert not live.any()


def test_vertex_scan_probe_build_parity(rng):
    """Full vertex step (2 incoming filters -> mask update -> 2 outgoing
    builds): mask, rows probed, live, live_after and both filters'
    words == the reference host engine's."""
    n = 2500
    in_keys = rng.integers(0, 10**4, n).astype(np.int64)
    out_keys = in_keys * 31 + 7
    mask = rng.random(n) < 0.9
    f_small = _oracle_build(rng.integers(0, 10**4, 300), np.ones(300), 32)
    f_big = _oracle_build(rng.integers(0, 10**4, 4000), np.ones(4000), 256)

    outs = []
    for eng in (rget_engine("numpy"), _cuda_cpu()):
        ek_in, ek_out = eng.keys(in_keys), eng.keys(out_keys)
        scan = eng.begin(mask)
        rows = scan.probe([(f_small, ek_in), (f_big, ek_in)])
        live = scan.live
        nblocks = rbloom.blocks_for(max(live, 1))
        w1 = bloom.words_to_host(scan.build(ek_out, nblocks))
        w2 = bloom.words_to_host(scan.build(ek_in, nblocks))
        outs.append((scan.mask.copy(), rows, live, list(scan.live_after),
                     w1, w2))
    ref, got = outs
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:4] == ref[1:4]
    np.testing.assert_array_equal(got[4], ref[4])
    np.testing.assert_array_equal(got[5], ref[5])


def _scan_outputs(eng, mask, keys, keys2, raw, out_keys, valid, words1,
                  words2, nblocks):
    scan = eng.begin(mask)
    scan.probe([(words1, eng.keys(keys)), (words2, eng.keys(keys2))])
    after_probe = scan.mask.copy()
    live_after = list(scan.live_after)
    scan.probe_range(raw, -120, 340, ek=eng.keys(raw))
    kr = scan.key_range(raw, ek=eng.keys(raw))
    krv = scan.key_range(raw, ek=eng.keys(raw), valid=valid)
    words = scan.build(eng.keys(out_keys), nblocks, valid=valid)
    return {"after_probe": after_probe, "live_after": live_after,
            "mask": scan.mask.copy(), "live": int(scan.live),
            "key_range": kr, "key_range_valid": krv,
            "words": bloom.words_to_host(words)}


def _scan_args(rng):
    n = 3000
    keys = rng.integers(0, 900, n).astype(np.int64)
    keys2 = rng.integers(0, 900, n).astype(np.int64)
    raw = rng.integers(-500, 500, n).astype(np.int64)
    out_keys = rng.integers(0, 900, n).astype(np.int64)
    mask = rng.random(n) < 0.8
    valid = rng.random(n) < 0.9
    nblocks = rbloom.blocks_for(n)
    words1 = _oracle_build(rng.integers(0, 900, 500), np.ones(500), 16)
    words2 = _oracle_build(rng.integers(0, 900, 700), np.ones(700), 64)
    return (mask, keys, keys2, raw, out_keys, valid, words1, words2,
            nblocks)


def _assert_scan_matches(ref, got):
    for field in ref:
        if field.startswith("key_range") or field == "live_after":
            assert got[field] == ref[field], field
        else:
            np.testing.assert_array_equal(got[field], ref[field],
                                          err_msg=field)


def test_fused_scan_matches_reference(rng):
    """One fused probe -> range-cut -> build scan: mask after each
    stage, per-filter live counts, device key ranges (plain and
    NULL-masked) and emitted words == the reference host engine's."""
    args = _scan_args(rng)
    _assert_scan_matches(_scan_outputs(rget_engine("numpy"), *args),
                         _scan_outputs(_cuda_cpu(), *args))


def test_plane_off_scan_matches_reference(rng):
    """The same scan with the plane off (two filters probed one by one
    through K3's plain version, range cut and key ranges through the
    host) == the reference host engine's."""
    args = _scan_args(rng)
    eng = get_engine("cuda", device="cpu", device_resident=False)
    assert not eng.device_resident
    _assert_scan_matches(_scan_outputs(rget_engine("numpy"), *args),
                         _scan_outputs(eng, *args))


def test_fused_scan_empty_survivors(rng):
    """A disjoint range cut kills every row: empty live set, key_range
    None, all-zero outgoing filter — same as the reference."""
    n = 256
    keys = rng.integers(0, 50, n).astype(np.int64)
    raw = rng.integers(0, 50, n).astype(np.int64)
    nblocks = rbloom.blocks_for(n)
    outs = []
    for eng in (rget_engine("numpy"), _cuda_cpu()):
        scan = eng.begin(np.ones(n, bool))
        scan.probe_range(raw, 1000, 2000, ek=eng.keys(raw))
        words = scan.build(eng.keys(keys), nblocks)
        outs.append((int(scan.live), scan.key_range(raw, ek=eng.keys(raw)),
                     bloom.words_to_host(words)))
    assert outs[0][0] == outs[1][0] == 0
    assert outs[0][1] is None and outs[1][1] is None
    np.testing.assert_array_equal(outs[1][2], outs[0][2])


def test_fused_scan_counts_one_sync_per_vertex(rng):
    """The fused probe syncs one counts vector per vertex (plus the
    survivor ids when the host reads the mask), as the reference's
    device scan does."""
    n = 3000
    keys = rng.integers(0, 900, n).astype(np.int64)
    words = _oracle_build(rng.integers(0, 900, 500), np.ones(500), 16)
    eng = _cuda_cpu()
    ek = eng.keys(keys)
    stats = device_plane.DeviceStats()
    with device_plane.track(stats):
        scan = eng.begin(np.ones(n, bool))
        scan.probe([(words, ek), (words, ek)])
    assert stats.fused_calls == 1 and stats.d2h_syncs == 1
    assert stats.h2d_syncs == 4          # 2 filters + lo/hi of one column


def test_plane_off_scan_syncs_one_scalar_per_filter(rng):
    """With the plane off: per filter one upload of its words and one
    scalar sync, then a device compaction; no fused call."""
    n = 3000
    keys = rng.integers(0, 900, n).astype(np.int64)
    words = _oracle_build(rng.integers(0, 900, 500), np.ones(500), 16)
    eng = get_engine("cuda", device="cpu", device_resident=False)
    ek = eng.keys(keys)
    stats = device_plane.DeviceStats()
    with device_plane.track(stats):
        scan = eng.begin(np.ones(n, bool))
        scan.probe([(words, ek), (words, ek)])
    assert stats.fused_calls == 0 and stats.d2h_syncs == 2
    assert stats.h2d_syncs == 4          # 2 filters + lo/hi of one column
    assert stats.device_compactions == 1  # the second filter removes none
