"""Port parity: the torch sorted-segment device join against the
reference's `segment_join_device` and the host engine's
`join_indices_valid` (the NULL-contract reference).

Inputs are made from a seed with numpy and fed to both packages; the
(build_idx, probe_idx) pairs are integers and must match bit-exactly —
order included (probe rows in original order, each probe row's matches
in stable build-key order). Covers duplicate keys, NULLs on either
side, signed-extreme keys, and inner/left/semi/anti."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.core import device_plane as rdp
from repro.core.engine_join import NumpyJoinEngine as RNumpyJoinEngine
from repro.kernels.semijoin import ops as rsj
from repro_torch.core import device_plane
from repro_torch.core.engine_join import NumpyJoinEngine, get_join_engine
from repro_torch.kernels.semijoin import ops as sj

HOWS = ("inner", "left", "semi", "anti")
EXTREMES = np.array([np.iinfo(np.int64).min, -(1 << 62), -3, -1, 0, 1,
                     7, 1 << 31, (1 << 62) - 1, np.iinfo(np.int64).max],
                    np.int64)


def _host(a):
    return np.asarray(device_plane.to_host(a)).astype(np.int64)


def _check(bk, pk, how, bv=None, pv=None):
    eb, ep = RNumpyJoinEngine().join_indices_valid(bk, pk, how, bv, pv)
    rb, rp = rsj.segment_join_device(bk, pk, how, bv, pv)
    rb = np.asarray(rdp.to_host(rb)).astype(np.int64)
    rp = np.asarray(rdp.to_host(rp)).astype(np.int64)
    gb, gp = sj.segment_join_device(bk, pk, how, bv, pv, device="cpu")
    gb, gp = _host(gb), _host(gp)
    ctx = (how, len(bk), len(pk), bv is not None, pv is not None)
    for got, want in ((gb, eb), (gp, ep), (gb, rb), (gp, rp)):
        np.testing.assert_array_equal(got, want, err_msg=str(ctx))


@pytest.mark.parametrize("how", HOWS)
def test_segment_join_seeded_sweep(how):
    """Heavy duplicate keys, NULL keys on either side, signed-extreme
    key values."""
    rng = np.random.default_rng(42)
    for trial in range(25):
        nb = int(rng.integers(1, 70))
        npr = int(rng.integers(1, 90))
        if trial % 5 == 4:
            bk = rng.choice(EXTREMES, nb)
            pk = rng.choice(EXTREMES, npr)
        else:
            dom = int(rng.integers(1, 14))
            bk = rng.integers(0, dom, nb).astype(np.int64)
            pk = rng.integers(0, dom, npr).astype(np.int64)
        bv = (rng.random(nb) < 0.75) if rng.random() < 0.5 else None
        pv = (rng.random(npr) < 0.75) if rng.random() < 0.5 else None
        _check(bk, pk, how, bv, pv)


@pytest.mark.parametrize("how", HOWS)
def test_segment_join_all_null_sides(how):
    """All-NULL sides: no probe row may match."""
    bk = np.array([5, 5, 9], np.int64)
    pk = np.array([5, 9, 9, 11], np.int64)
    _check(bk, pk, how, np.zeros(3, bool), None)
    _check(bk, pk, how, None, np.zeros(4, bool))
    _check(bk, pk, how, np.zeros(3, bool), np.zeros(4, bool))


@pytest.mark.parametrize("how", HOWS)
def test_segment_join_larger_than_pad_floor(how):
    """Sides past the 256-row pad floor, with an INT64_MAX build key
    next to the sorted-last NULL rows."""
    rng = np.random.default_rng(7)
    bk = rng.integers(-50, 50, 900).astype(np.int64)
    bk[::97] = np.iinfo(np.int64).max
    pk = rng.integers(-60, 60, 1300).astype(np.int64)
    pk[::101] = np.iinfo(np.int64).max
    _check(bk, pk, how, rng.random(900) < 0.9, rng.random(1300) < 0.9)


def test_cuda_join_engine_routes_and_delegates_empty():
    """The cuda join engine (CPU device) returns the segment join's
    pairs, and hands zero-length sides to the host engine."""
    eng = get_join_engine("cuda", device="cpu", device_resident=True)
    bk = np.array([3, 1, 3, 2], np.int64)
    pk = np.array([3, 4, 1, 3], np.int64)
    for how in HOWS:
        eb, ep = NumpyJoinEngine().join_indices(bk, pk, how)
        gb, gp = eng.join_indices(bk, pk, how)
        np.testing.assert_array_equal(_host(gb), eb)
        np.testing.assert_array_equal(_host(gp), ep)
        for b, p in ((np.empty(0, np.int64), pk), (bk, np.empty(0,
                                                               np.int64))):
            eb, ep = NumpyJoinEngine().join_indices(b, p, how)
            gb, gp = eng.join_indices(b, p, how)
            np.testing.assert_array_equal(np.asarray(gb), eb)
            np.testing.assert_array_equal(np.asarray(gp), ep)


def test_segment_join_counts_two_uploads_one_sync():
    """One join = two counted uploads (one stacked plane set per side)
    and one scalar sync, as in the reference."""
    bk = np.array([1, 2, 2, 5], np.int64)
    pk = np.array([2, 5, 7], np.int64)
    stats = device_plane.DeviceStats()
    with device_plane.track(stats):
        sj.segment_join_device(bk, pk, "inner", device="cpu")
    rstats = rdp.DeviceStats()
    with rdp.track(rstats):
        rsj.segment_join_device(bk, pk, "inner")
    assert stats.report() == rstats.report()
    assert (stats.h2d_syncs, stats.d2h_syncs) == (2, 1)
