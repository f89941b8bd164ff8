"""Port parity: the kernel library's public entry points (`semi_mask`,
`semijoin_build`/`semijoin_probe`, `bloom_build`/`bloom_probe`/
`bloom_transfer`) and the plain versions of kernels K6a (key set build),
K6b (membership probe) and K7 (fused filter transfer), against the
reference package (its Pallas kernels in interpret mode, its jnp Bloom
ops and its numpy oracle `semi_mask_ref`).

Inputs are made from a seed with numpy and fed to both packages. Every
output here is an integer or boolean array and must match bit-exactly
(tolerance 0); K6a's plain table must equal the reference's (klo, khi,
occ) lanes byte for byte. The kernels themselves run only on an NVIDIA
GPU: their tests are in tests/test_torch_kernels_gpu.py."""
import types

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import bloom as rbloom
from repro.core import hashing as rhashing
from repro.kernels.bloom import bloom as rkern
from repro.kernels.bloom import (bloom_build as r_bloom_build,
                                 bloom_probe as r_bloom_probe,
                                 bloom_transfer as r_bloom_transfer)
from repro.kernels.semijoin import semi_mask as r_semi_mask
from repro.kernels.semijoin import semijoin as rsjk
from repro.kernels.semijoin.ref import semi_mask_ref as r_semi_mask_ref
from repro.tpch.gen import date
from repro_torch.core import bloom
from repro_torch.kernels.bloom import (bloom_build, bloom_probe,
                                       bloom_transfer)
from repro_torch.kernels.bloom import ops as kb
from repro_torch.kernels.bloom import ref as kb_ref
from repro_torch.kernels.semijoin import (semi_mask, semijoin_build,
                                          semijoin_probe)
from repro_torch.kernels.semijoin import ops as sj
from repro_torch.kernels.semijoin.ref import semi_mask_ref

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
    m = max(-(-len(a) // TILE), 1) * TILE
    out = np.full(m, fill, a.dtype)
    out[: len(a)] = a
    return out


def _t(a):
    """uint32 host array -> int32 CPU tensor (the port's device layout)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _halves(keys):
    lo, hi = rhashing.key_halves(keys)
    return lo, hi, _t(lo), _t(hi)


# --------------------------------------------------------------------------
# K6a / K6b
# --------------------------------------------------------------------------

SET_CASES = {
    # name: (n, key domain, share of rows masked in)
    "one": (1, None, 1.0),
    "unique-masked": (1500, None, 0.7),
    "dups-masked": (2000, 700, 0.6),
    "heavy-dups": (1800, 30, 0.9),
    "all-masked-off": (900, None, 0.0),
}


def _ref_set(keys, mask, cap):
    """The reference's `build_pallas` (interpret mode) over tile-padded
    keys, as host uint32 (klo, khi, occ) lanes."""
    lo, hi = rhashing.key_halves(_pad(keys))
    lanes = rsjk.build_pallas(jnp.asarray(lo), jnp.asarray(hi),
                              jnp.asarray(_pad(mask, False)), cap,
                              interpret=True)
    return [np.asarray(a) for a in lanes]


@pytest.mark.parametrize("case", list(SET_CASES))
def test_set_build_ref_table_matches_build_pallas(rng, case):
    """K6a's plain version builds the reference's key set byte for byte:
    its lo, hi and state columns equal `build_pallas`'s klo, khi and occ
    (interpret mode), the row column stays 0, masked-off rows are never
    inserted, and `occupied` is the distinct count of the masked keys.
    The CPU wrapper takes the plain version."""
    n, domain, share = SET_CASES[case]
    keys = _keys(rng, n, domain)
    mask = rng.random(n) < share
    cap = sj.capacity_for(n)
    klo, khi, occ = _ref_set(keys, mask, cap)
    _, _, lo, hi = _halves(keys)
    table, occupied = sj.set_build(lo, hi, cap, torch.from_numpy(mask))
    got = table.numpy().view(np.uint32)
    for c, lane in enumerate((klo, khi, occ)):
        np.testing.assert_array_equal(got[:, c], lane, err_msg=str(c))
    assert not got[:, 3].any()
    assert int(occupied) == int(occ.sum()) == len(np.unique(keys[mask]))
    if share == 1.0:
        full, _ = sj.set_build_ref(lo, hi, cap)
        assert torch.equal(full, table)


@pytest.mark.parametrize("domain", [None, 3000], ids=["wide", "narrow"])
def test_set_probe_ref_matches_probe_pallas(rng, domain):
    """K6b's plain version == the reference's `probe_pallas` (interpret
    mode) over the same table, hits and misses, 3001 probe keys (not a
    tile multiple); `lookup_work` counts the slots and distinct 32-byte
    sectors a step-by-step walk of the reference's lanes reads."""
    keys = _keys(rng, 1700, domain)
    mask = rng.random(len(keys)) < 0.75
    cap = sj.capacity_for(len(keys))
    klo, khi, occ = _ref_set(keys, mask, cap)
    probe = np.concatenate([rng.choice(keys, 2000), _keys(rng, 1001,
                                                          domain)])
    plo, phi, tplo, tphi = _halves(probe)
    ref = np.asarray(rsjk.probe_pallas(
        *(jnp.asarray(a) for a in (klo, khi, occ)),
        jnp.asarray(_pad(plo)), jnp.asarray(_pad(phi)),
        interpret=True))[: len(probe)]
    _, _, lo, hi = _halves(keys)
    table, _ = sj.set_build(lo, hi, cap, torch.from_numpy(mask))
    got = sj.set_probe(table, tplo, tphi)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, np.isin(probe, keys[mask]))
    visited, sectors = 0, set()
    for a, b, s in zip(plo, phi, rhashing.hash64_np(plo, phi) & (cap - 1)):
        while True:
            visited += 1
            sectors.add(int(s) >> 1)
            if not occ[s] or (klo[s] == a and khi[s] == b):
                break
            s = (s + 1) & (cap - 1)
    assert sj.lookup_work(table, tplo, tphi) == (visited, len(sectors))


@pytest.mark.parametrize("nb,npr", [(1, 64), (100, 3000), (2000, 5000),
                                    (5000, 100)])
def test_semi_mask_matches_reference(rng, nb, npr):
    """The port's `semi_mask` on the CPU == the reference's `semi_mask`
    (Pallas build and probe in interpret mode) == `semi_mask_ref`, with
    a build mask, over lengths that are not tile multiples."""
    build = rng.integers(-10**12, 10**12, nb).astype(np.int64)
    probe = np.concatenate([
        build[rng.integers(0, nb, npr // 2)],
        rng.integers(2 * 10**12, 3 * 10**12, npr - npr // 2)
        .astype(np.int64)])
    bm = rng.random(nb) < 0.8
    got = semi_mask(probe, build, bm, device="cpu")
    assert got.dtype == bool and got.shape == (npr,)
    np.testing.assert_array_equal(got, r_semi_mask(probe, build, bm))
    np.testing.assert_array_equal(got, r_semi_mask_ref(probe, build, bm))
    np.testing.assert_array_equal(semi_mask_ref(probe, build, bm),
                                  r_semi_mask_ref(probe, build, bm))


def test_semi_mask_duplicates_all_masked_and_empty(rng):
    """Duplicate build keys, an all-masked build, an empty build and an
    empty probe, on the port's CPU path, against the reference."""
    build = np.repeat(rng.integers(0, 50, 100).astype(np.int64), 3)
    probe = np.arange(-10, 120, dtype=np.int64)
    np.testing.assert_array_equal(semi_mask(probe, build, device="cpu"),
                                  r_semi_mask(probe, build))
    off = np.zeros(len(build), bool)
    assert not semi_mask(probe, build, off, device="cpu").any()
    assert not r_semi_mask(probe, build, off).any()
    empty = np.empty(0, np.int64)
    assert not semi_mask(probe, empty, device="cpu").any()
    assert not semi_mask_ref(probe, empty).any()
    assert semi_mask(empty, build, device="cpu").shape == (0,)
    table = semijoin_build(build, device="cpu")
    assert table.shape == (sj.capacity_for(len(build)), 4)
    assert int(table[:, 2].sum()) == len(np.unique(build))
    np.testing.assert_array_equal(semijoin_probe(table, probe),
                                  np.isin(probe, build))


# --------------------------------------------------------------------------
# K7 and the public Bloom entry points
# --------------------------------------------------------------------------


@pytest.mark.parametrize("nblocks", [1, 8, 128])
def test_transfer_ref_matches_transfer_pallas(rng, nblocks):
    """K7's plain version (`ref.bloom_transfer_ref`, the port's
    `core.bloom.transfer`) and its CPU wrapper == the reference's
    `transfer_pallas` (interpret mode) == `repro.core.bloom.transfer`:
    the survivor mask and the outgoing words, bit for bit."""
    n = 2048
    keys = _keys(rng, n)
    out_keys = _keys(rng, n)
    mask = rng.random(n) < 0.8
    ilo, ihi, tilo, tihi = _halves(keys)
    olo, ohi, tolo, tohi = _halves(out_keys)
    in_w = rbloom.build(jnp.asarray(ilo[: n // 3]), jnp.asarray(ihi[: n // 3]),
                        jnp.ones(n // 3, bool), nblocks)
    args = [jnp.asarray(a) for a in (ilo, ihi, olo, ohi)]
    ok_r, w_r = rbloom.transfer(in_w, *args, jnp.asarray(mask), nblocks)
    ok_p, w_p = rkern.transfer_pallas(in_w, *args, jnp.asarray(mask),
                                      nblocks, interpret=True)
    np.testing.assert_array_equal(np.asarray(ok_p), np.asarray(ok_r))
    np.testing.assert_array_equal(np.asarray(w_p), np.asarray(w_r))
    tw = _t(np.asarray(in_w))
    tm = torch.from_numpy(mask)
    for fn in (kb_ref.bloom_transfer_ref, kb.transfer):
        ok, w = fn(tw, tilo, tihi, tolo, tohi, tm, nblocks)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
        np.testing.assert_array_equal(bloom.words_to_host(w),
                                      np.asarray(w_r))
    assert np.asarray(ok_r)[: n // 3][mask[: n // 3]].all()


@pytest.mark.parametrize("bits_per_key", [8, 16])
def test_public_bloom_api_matches_reference(rng, bits_per_key):
    """`bloom_build`, `bloom_probe` and `bloom_transfer` on the CPU ==
    the reference's public functions (Pallas in interpret mode) over
    5003 rows (not a tile multiple) with a mask: the words, the probe
    mask, and the transfer's survivors and outgoing words (sized, as in
    the reference, for the mask's live count)."""
    n = 5003
    keys = _keys(rng, n, 10**7)
    out_keys = _keys(rng, n, 10**6)
    mask = rng.random(n) < 0.6
    w = bloom_build(keys, mask, bits_per_key=bits_per_key, device="cpu")
    rw = r_bloom_build(keys, mask, bits_per_key=bits_per_key)
    np.testing.assert_array_equal(bloom.words_to_host(w), np.asarray(rw))
    probe = np.concatenate([keys, _keys(rng, 999, 10**8)])
    got = bloom_probe(w, probe)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, r_bloom_probe(rw, probe))
    assert got[:n][mask].all()
    tmask = rng.random(n) < 0.9
    ok, w2 = bloom_transfer(w, keys, out_keys, tmask,
                            bits_per_key=bits_per_key)
    rok, rw2 = r_bloom_transfer(rw, keys, out_keys, tmask,
                                bits_per_key=bits_per_key)
    np.testing.assert_array_equal(ok, rok)
    np.testing.assert_array_equal(bloom.words_to_host(w2), np.asarray(rw2))
    assert w2.shape[0] == rbloom.blocks_for(int(tmask.sum()), bits_per_key)
    ok_all, _ = bloom_transfer(w, keys, out_keys)
    np.testing.assert_array_equal(ok_all, r_bloom_transfer(
        rw, keys, out_keys)[0])
    with pytest.raises(ValueError):
        bloom_transfer(w, keys, out_keys[:-1])


# --------------------------------------------------------------------------
# cases A-C of chip_smoke.py's kernel-api phase, at sf 0.01
# --------------------------------------------------------------------------


def test_kernel_api_cases_at_sf001(tpch_small):
    """The TPC-H cases the chip smoke runs at SF 1, at sf 0.01 through the
    port's public functions on the CPU, against the reference's oracles:
    (A) Q5's lineitem ⋉ σ(orders) == `semi_mask_ref`; (B) Q4's EXISTS,
    orders ⋉ σ(lineitem), with duplicate build keys == `semi_mask_ref`,
    the set's occupied slots == the distinct masked keys; (C) Q5's
    transfer chain σ(orders) → lineitem → supplier == the reference's
    jnp build/transfer/probe bit for bit, its survivors a superset of
    (A)'s mask."""
    o, li, s = (tpch_small[t] for t in ("orders", "lineitem", "supplier"))
    o_key, o_date = o.array("o_orderkey"), o.array("o_orderdate")
    l_key, l_supp = li.array("l_orderkey"), li.array("l_suppkey")
    s_key = s.array("s_suppkey")
    q5 = (o_date >= date("1994-01-01")) & (o_date < date("1995-01-01"))
    sj.reset_launches()
    kb.reset_launches()

    a = semi_mask(l_key, o_key, q5, device="cpu")
    np.testing.assert_array_equal(a, r_semi_mask_ref(l_key, o_key, q5))
    assert 0 < a.sum() < len(a)

    q4 = li.array("l_commitdate") < li.array("l_receiptdate")
    table = semijoin_build(l_key, q4, device="cpu")
    assert int(table[:, 2].sum()) == len(np.unique(l_key[q4])) < q4.sum()
    np.testing.assert_array_equal(semijoin_probe(table, o_key),
                                  r_semi_mask_ref(o_key, l_key, q4))

    w = bloom_build(o_key, mask=q5, device="cpu")
    ok, w2 = bloom_transfer(w, l_key, l_supp)
    hit = bloom_probe(w2, s_key)
    olo, ohi = (jnp.asarray(x) for x in rhashing.key_halves(o_key))
    rw = rbloom.build(olo, ohi, jnp.asarray(q5),
                      rbloom.blocks_for(int(q5.sum())))
    lk = [jnp.asarray(x) for x in (*rhashing.key_halves(l_key),
                                   *rhashing.key_halves(l_supp))]
    rok, rw2 = rbloom.transfer(rw, *lk, jnp.ones(len(l_key), bool),
                               rbloom.blocks_for(len(l_key)))
    np.testing.assert_array_equal(bloom.words_to_host(w), np.asarray(rw))
    np.testing.assert_array_equal(ok, np.asarray(rok))
    np.testing.assert_array_equal(bloom.words_to_host(w2), np.asarray(rw2))
    np.testing.assert_array_equal(hit, np.asarray(rbloom.probe(
        rw2, *(jnp.asarray(x) for x in rhashing.key_halves(s_key)))))
    assert ok[a].all() and ok.sum() >= a.sum()
    assert hit[np.isin(s_key, l_supp[a])].all()
    assert sj.LAUNCHES["semijoin_build"] == sj.LAUNCHES["semijoin_probe"] == 0
    assert kb.LAUNCHES["bloom_transfer"] == 0


# --------------------------------------------------------------------------
# wrappers: devices and library errors
# --------------------------------------------------------------------------


class _OnCuda:
    """A CPU tensor that reports a CUDA device, so a wrapper takes its
    kernel branch as far as the (faked) library call."""
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


def _kernel_call(name):
    """(module, LAUNCHES key, fake library entry, the wrapper's call over
    _OnCuda inputs) for each K6/K7 wrapper."""
    lo = _OnCuda(torch.zeros(64, dtype=torch.int32))
    mask = _OnCuda(torch.ones(64, dtype=torch.bool))
    table = _OnCuda(torch.zeros((128, 4), dtype=torch.int32))
    words = _OnCuda(torch.zeros((8, 8), dtype=torch.int32))
    return {
        "set_build": (sj, "semijoin_build", "semijoin_set_build",
                      lambda: sj.set_build(lo, lo, 128, mask)),
        "set_probe": (sj, "semijoin_probe", "semijoin_set_probe",
                      lambda: sj.set_probe(table, lo, lo)),
        "transfer": (kb, "bloom_transfer", "bloom_transfer",
                     lambda: kb.transfer(words, lo, lo, lo, lo, mask, 16)),
    }[name]


@pytest.mark.parametrize("name", ["set_build", "set_probe", "transfer"])
def test_wrapper_raises_when_its_library_call_fails(monkeypatch, name):
    """A K6/K7 wrapper on a CUDA tensor whose C entry point returns a CUDA
    error raises RuntimeError naming it, and counts no launch; on a
    device that is neither CUDA nor the CPU it raises before any call."""
    mod, key, entry, call = _kernel_call(name)
    # K6a's and K7's wrappers ask the library for their scratch size first
    fake = types.SimpleNamespace(**{entry: lambda *a: 700,
                                    "joinmap_build_scratch_bytes":
                                        lambda *a: 0,
                                    "bloom_transfer_scratch_bytes":
                                        lambda *a: 0})
    monkeypatch.setattr(mod, "_lib", lambda: fake)

    def on_cuda(make):
        return lambda *a, device=None, **kw: _OnCuda(make(*a, **kw))

    monkeypatch.setattr(torch, "zeros", on_cuda(torch.zeros))
    monkeypatch.setattr(torch, "empty", on_cuda(torch.empty))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    mod.reset_launches()
    with pytest.raises(RuntimeError, match=f"{entry}: CUDA error 700"):
        call()
    assert mod.LAUNCHES[key] == 0
    monkeypatch.undo()
    meta = torch.zeros(64, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        {"set_build": lambda: sj.set_build(meta, meta, 128),
         "set_probe": lambda: sj.set_probe(meta.reshape(16, 4), meta, meta),
         "transfer": lambda: kb.transfer(meta.reshape(8, 8), meta, meta,
                                         meta, meta, meta.bool(), 16)}[name]()


def test_wrappers_check_inputs_and_count_nothing_on_cpu(rng):
    """The CPU path counts no launch; bad capacities and ragged masks are
    refused."""
    sj.reset_launches()
    kb.reset_launches()
    _, _, lo, hi = _halves(_keys(rng, 64))
    table, occ = sj.set_build(lo, hi, 128)
    assert int(occ) == 64 and sj.set_probe(table, lo, hi).all()
    assert sj.LAUNCHES["semijoin_build"] == sj.LAUNCHES["semijoin_probe"] == 0
    with pytest.raises(ValueError):
        sj.set_build(lo, hi, 96)                # not a power of two
    with pytest.raises(ValueError):
        sj.set_build(lo, hi, 64)                # no empty slot left
    w = kb.build(lo, hi, 8)
    ok, _ = kb.transfer(w, lo, hi, lo, hi, torch.ones(64, dtype=torch.bool),
                        8)
    assert ok.all() and kb.LAUNCHES["bloom_transfer"] == 0
