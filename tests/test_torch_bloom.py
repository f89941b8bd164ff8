"""Port parity: hashing, the torch Bloom ops and the plain versions of
kernels K1 (fused multi-filter probe) and K2 (build) against the
reference package (numpy mirror and Pallas kernels in interpret mode).

Inputs are made from a seed with numpy and fed to both packages. Every
output here is an integer or boolean array and must match bit-exactly.
The kernels themselves run only on an NVIDIA GPU: their tests are in
tests/test_torch_kernels_gpu.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import bloom as rbloom
from repro.core import hashing as rhashing
from repro.kernels.bloom import bloom as rkern
from repro_torch.core import bloom, hashing
from repro_torch.kernels.bloom import ops as kb

EXTREMES = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).min + 1,
                     -(1 << 62), -(1 << 32), -3, -1, 0, 1, 7, 1 << 31,
                     (1 << 32) - 1, (1 << 62) - 1, np.iinfo(np.int64).max],
                    np.int64)
NBLOCKS = (1, 2, 64, 1024)


def _keys(rng, n):
    """int64 keys with negatives and both ±2^63 extremes."""
    k = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                     dtype=np.int64)
    k[: len(EXTREMES)] = EXTREMES[: n]
    return k


def _halves(keys):
    lo, hi = rhashing.key_halves(keys)
    return lo, hi, *bloom.halves_to_device(lo, hi, "cpu")


def test_hash_matches_reference(rng):
    """torch fmix32/hash64 (int64 masked) == reference hash64_np, bit-exact."""
    lo, hi, tlo, thi = _halves(_keys(rng, 20000))
    got = hashing.hash64(tlo, thi).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  rhashing.hash64_np(lo, hi))
    assert got.min() >= 0 and got.max() < 2 ** 32
    np.testing.assert_array_equal(
        hashing.fmix32(torch.from_numpy(lo.astype(np.int64))).numpy()
        .astype(np.uint32), rhashing.fmix32_np(lo))
    np.testing.assert_array_equal(hashing.key_halves(EXTREMES)[1],
                                  rhashing.key_halves(EXTREMES)[1])


@pytest.mark.parametrize("nblocks", NBLOCKS)
def test_build_probe_match_reference_mirror(rng, nblocks):
    """torch build/probe/probe_hashed_dev == reference build_np/probe_np,
    bit-exact words and masks, including the one-block special case."""
    keys = _keys(rng, 6000)
    mask = rng.random(len(keys)) < 0.6
    lo, hi, tlo, thi = _halves(keys)
    words = bloom.build(tlo, thi, torch.from_numpy(mask), nblocks)
    ref = rbloom.build_np(lo, hi, mask, nblocks)
    np.testing.assert_array_equal(bloom.words_to_host(words), ref)
    probe_keys = np.concatenate([keys[:3000], _keys(rng, 3000)])
    plo, phi, tplo, tphi = _halves(probe_keys)
    exp = rbloom.probe_np(ref, plo, phi)
    np.testing.assert_array_equal(bloom.probe(words, tplo, tphi).numpy(),
                                  exp)
    h, g1, g2 = bloom.hash_state(tplo, tphi)
    np.testing.assert_array_equal(
        bloom.probe_hashed_dev(words, h, g1, g2).numpy(), exp)
    assert exp[:3000][mask[:3000]].all()      # no false negatives


def _filters(rng, nbs):
    out = []
    for nb in nbs:
        ins = _keys(rng, 3 * nb + 5)
        lo, hi = rhashing.key_halves(ins)
        out.append(rbloom.build_np(lo, hi, np.ones(len(ins), bool), nb))
    return out


@pytest.mark.parametrize("nbs", [(1,), (64, 2), (1024, 1, 64)],
                         ids=["m1", "m2", "m3"])
def test_multi_probe_ref_matches_pallas(rng, nbs):
    """K1's plain version == reference multi_probe_pallas (interpret
    mode), bit-exact [m, n] cumulative masks; then with a survivor-id
    gather and a ragged count == the reference's gather + iota mask."""
    n = 8192
    m = len(nbs)
    words = _filters(rng, nbs)
    cols = []
    for f in range(m):
        keys = _keys(rng, n)
        # a share of keys the filters hold, so masks are not all-False
        keys[::3] = _keys(np.random.default_rng(f), n)[::3]
        cols.append(rhashing.key_halves(keys))
    los = [c[0] for c in cols]
    his = [c[1] for c in cols]
    ref = np.asarray(rkern.multi_probe_pallas(
        tuple(jnp.asarray(w) for w in words),
        tuple(jnp.asarray(a) for a in los),
        tuple(jnp.asarray(a) for a in his), interpret=True))
    tw = [torch.from_numpy(w.view(np.int32)) for w in words]
    tl = [torch.from_numpy(a.view(np.int32)) for a in los]
    th = [torch.from_numpy(a.view(np.int32)) for a in his]
    got = kb.multi_probe_ref(tw, tl, th)
    np.testing.assert_array_equal(got.numpy(), ref)

    idx = np.sort(rng.choice(n, 4096, replace=False)).astype(np.int32)
    count = 3001
    ref_g = np.asarray(rkern.multi_probe_pallas(
        tuple(jnp.asarray(w) for w in words),
        tuple(jnp.asarray(a[idx]) for a in los),
        tuple(jnp.asarray(a[idx]) for a in his), interpret=True))
    ref_g = ref_g & (np.arange(len(idx)) < count)[None, :]
    got_g = kb.multi_probe(tw, tl, th, idx=torch.from_numpy(idx),
                           count=count)
    np.testing.assert_array_equal(got_g.numpy(), ref_g)


@pytest.mark.parametrize("nblocks", NBLOCKS)
def test_build_ref_matches_pallas(rng, nblocks):
    """K2's plain version == reference build_pallas (interpret mode),
    bit-exact words, over gathered survivors with a ragged count and a
    validity plane."""
    n = 4096
    lo, hi = rhashing.key_halves(_keys(rng, n))
    idx = np.sort(rng.choice(n, 2048, replace=False)).astype(np.int32)
    count = 1500
    valid = rng.random(n) < 0.8
    mask = (np.arange(len(idx)) < count) & valid[idx]
    ref = np.asarray(rkern.build_pallas(
        jnp.asarray(lo[idx]), jnp.asarray(hi[idx]), jnp.asarray(mask),
        nblocks, interpret=True))
    tlo, thi = bloom.halves_to_device(lo, hi, "cpu")
    got = kb.build(tlo, thi, nblocks, idx=torch.from_numpy(idx),
                   count=count, valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(bloom.words_to_host(got), ref)
    # identity rows, no validity: the whole column
    ref_all = np.asarray(rkern.build_pallas(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(np.ones(n, bool)),
        nblocks, interpret=True))
    np.testing.assert_array_equal(
        bloom.words_to_host(kb.build_ref(tlo, thi, nblocks)), ref_all)


def test_cpu_wrappers_take_plain_version_and_do_not_count(rng):
    """On CPU tensors the wrappers run the plain versions (bit-equal) and
    never count a kernel launch."""
    kb.reset_launches()
    lo, hi, tlo, thi = _halves(_keys(rng, 2048))
    w = kb.build(tlo, thi, 16)
    np.testing.assert_array_equal(w.numpy(),
                                  kb.build_ref(tlo, thi, 16).numpy())
    out = kb.multi_probe([w], [tlo], [thi], count=1000)
    assert out[0, :1000].all() and not out[0, 1000:].any()
    assert kb.LAUNCHES == {"multi_probe": 0, "bloom_build": 0}


def test_wrappers_reject_bad_inputs(rng):
    lo, hi, tlo, thi = _halves(_keys(rng, 64))
    with pytest.raises(ValueError):
        kb.build(tlo, thi, 16, count=65)
    with pytest.raises(ValueError):
        kb.multi_probe([], [], [])
