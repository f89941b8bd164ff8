"""Batched Bloom transfer engine: the hot path between the transfer
strategies and the filter kernels.

`repro_torch.core.transfer.PredTrans` describes *what* flows along the
transfer graph; this module decides *how* each vertex's filter work is
executed:

* **hash once, lazily** — `BloomEngine.keys` wraps a key column in
  `EngineKeys`; the full column's hash state materializes at most once
  per (vertex, column) — and only when a mostly-alive row set needs it,
  a survivor subset that earlier filters already shrank hashes just its
  own rows;
* **fused multi-filter probe** — all filters incoming at a vertex are
  applied in the given (LIP, most-selective-first) order over a single
  shrinking survivor set;
* **one scan probe→build** — a `VertexScan` carries the survivor set
  from the probe half to the build half, so emitting each outgoing
  filter is a gather over survivors, never a rescan of the table;
* **device-resident scans** — the `cuda` backend keeps the key halves
  and a re-bucketed survivor-id array on the device: one fused probe
  kernel (K1) per vertex, range cut, min-max and compaction as torch
  ops that never sync, builds through the build kernel (K2), and one
  small counts-vector sync per vertex;
* **bucketed batches** — key batches are padded to power-of-two buckets
  (`TILE` floor), the same rule as the reference package, so the bytes
  `DeviceStats` counts match it.

Two backends with bit-identical filter semantics:

* ``numpy`` — host mirror;
* ``cuda``  — `repro_torch.kernels.bloom` CUDA kernels on a CUDA device;
  on a CPU device (tests only) the kernels' plain torch versions.

The plain-torch device engine (the reference's ``jax`` role) and the
plane-off route are not part of this package yet.
"""
from __future__ import annotations

import dataclasses
import threading
import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import device_plane, faultinject, hashing
from repro_torch.core.bloom import (
    BLOCK_BITS, DEFAULT_BITS_PER_KEY, DEFAULT_K, LANES, BloomFilter,
    _bucket, _pad, blocks_for,
)

_LITTLE_ENDIAN = sys.byteorder == "little"

BACKENDS = ("numpy", "cuda")

#: bucket floor of the device backend — the reference's Pallas tile, kept
#: so padded sizes (and the h2d bytes counted for them) match it
TILE = 1024


# --------------------------------------------------------------------------
# key hash state
# --------------------------------------------------------------------------


@dataclasses.dataclass
class EngineKeys:
    """Per-column hash state, computed once and reused across all edges
    and passes.

    Host backend keeps the raw int64 keys and hashes *lazily*: the full
    column is hashed (and cached) only when a mostly-alive row set needs
    it; a shrunken survivor set is hashed directly from the raw keys.
    Hash state is uint32 block hash + double-hash generators. The device
    backend keeps the uint32 key halves on host and caches padded int32
    device copies of them per bucket size (`dev`)."""

    n: int
    lo: Optional[np.ndarray] = None   # uint32 [n] (device backend)
    hi: Optional[np.ndarray] = None   # uint32 [n] (device backend)
    h: Optional[np.ndarray] = None    # uint32 [n] block hash (host)
    g1: Optional[np.ndarray] = None   # uint32 [n] (host)
    g2: Optional[np.ndarray] = None   # uint32 [n] (odd; host)
    raw: Optional[np.ndarray] = None  # int64 [n] (host, lazy source)
    device: Optional[torch.device] = None
    _dev: Dict[int, Tuple] = dataclasses.field(default_factory=dict)

    def __len__(self):
        return self.n

    def _hash_subset(self, alive: np.ndarray) -> Tuple:
        if self.raw is not None:
            return _hash_host(self.raw[alive])
        return _hash_host_halves(self.lo[alive], self.hi[alive])

    def hga(self, alive: Optional[np.ndarray] = None) -> Tuple:
        """(h, g1, g2) over `alive` rows (None = every row). The full
        hash is computed once and cached; survivor subsets under half
        the column hash just their own rows (from `raw` int64 keys or
        from the device backend's uint32 halves — bit-identical either
        way)."""
        if self.h is None:
            if alive is not None and alive.size * 2 < self.n:
                return self._hash_subset(alive)
            if self.raw is not None:
                self.h, self.g1, self.g2 = _hash_host(self.raw)
            else:
                self.h, self.g1, self.g2 = _hash_host_halves(self.lo,
                                                             self.hi)
        if alive is None:
            return self.h, self.g1, self.g2
        return (self.h.take(alive), self.g1.take(alive),
                self.g2.take(alive))

    def dev(self, bucket: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Padded (lo, hi) int32 device tensors, cached per power-of-two
        bucket (one counted upload each)."""
        hit = self._dev.get(bucket)
        if hit is None:
            hit = (device_plane.to_device(_pad(self.lo, bucket),
                                          self.device),
                   device_plane.to_device(_pad(self.hi, bucket),
                                          self.device))
            self._dev[bucket] = hit
        return hit


def _hash_host(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """(h, g1, g2) uint32 hash state from int64 keys — the host mirror's
    hash pipeline (strided key halves, fused murmur finalizers)."""
    if not keys.flags.c_contiguous:
        keys = np.ascontiguousarray(keys)
    # strided views of the int64 words: same bits as hashing.key_halves,
    # one pass instead of mask+shift+cast
    v32 = keys.view(np.uint32)
    lo_s, hi_s = v32[0::2], v32[1::2]
    if not _LITTLE_ENDIAN:
        lo_s, hi_s = hi_s, lo_s
    return _hash_host_halves(lo_s, hi_s)


def _hash_host_halves(lo_s: np.ndarray, hi_s: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hash pipeline from uint32 halves. `lo_s`/`hi_s` may be strided
    views — never mutated in place."""
    tmp = np.empty(len(lo_s), np.uint32)
    # .copy() (never ascontiguousarray: a 1-row strided view IS
    # contiguous and would alias the table column) — _fmix_into
    # mutates its argument
    with np.errstate(over="ignore"):
        if hi_s.any():
            # h = fmix32(lo ^ fmix32(hi))
            h = _fmix_into(hi_s.copy(), tmp)
            np.bitwise_xor(h, lo_s, out=h)
            _fmix_into(h, tmp)
        else:
            # fmix32(0) == 0, so 32-bit keys (every TPC-H key)
            # skip the hi mix: h = fmix32(lo)
            h = _fmix_into(lo_s.copy(), tmp)
        g1 = _fmix_into(h ^ hashing.GOLDEN, tmp)
        g2 = _fmix_into(h ^ np.uint32(0x7FEB352D), tmp)
        np.bitwise_or(g2, np.uint32(1), out=g2)
    return h, g1, g2


def _fmix_into(h: np.ndarray, tmp: np.ndarray) -> np.ndarray:
    """murmur3 finalizer, in place on `h` (owned uint32 scratch `tmp` of
    the same shape). Identical op sequence to `hashing.fmix32_np` —
    bit-exact, two live arrays instead of per-op temporaries."""
    np.right_shift(h, 16, out=tmp)
    np.bitwise_xor(h, tmp, out=h)
    np.multiply(h, np.uint32(0x85EBCA6B), out=h)
    np.right_shift(h, 13, out=tmp)
    np.bitwise_xor(h, tmp, out=h)
    np.multiply(h, np.uint32(0xC2B2AE35), out=h)
    np.right_shift(h, 16, out=tmp)
    np.bitwise_xor(h, tmp, out=h)
    return h


# --------------------------------------------------------------------------
# packed incoming filters (numpy fused probe)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PackedFilters:
    """Incoming filters of one vertex, concatenated for a single fused
    probe: `words` stacks every filter's blocks, `offsets[f]` is filter
    f's first block in the stack, `log2nb[f]` its own block-count (each
    filter keeps its native size — no folding, so probing the pack is
    bit-identical to probing the filters one by one)."""

    words: np.ndarray                 # uint32 [sum(nblocks_f), LANES]
    offsets: np.ndarray               # int64 [m]
    log2nb: Tuple[int, ...]
    k: int


def pack_filters(filters: Sequence[np.ndarray], k: int) -> PackedFilters:
    log2nb = tuple(int(np.log2(w.shape[0])) for w in filters)
    if len(filters) == 1:
        words = np.ascontiguousarray(filters[0])
        offsets = np.zeros(1, np.int64)
    else:
        words = np.concatenate([np.asarray(w) for w in filters], axis=0)
        offsets = np.cumsum([0] + [w.shape[0] for w in filters[:-1]],
                            dtype=np.int64)
    return PackedFilters(words, offsets, log2nb, k)


def probe_packed_np(packed: PackedFilters, keys: Sequence[EngineKeys],
                    alive: Optional[np.ndarray], n_rows: int,
                    live_after: Optional[list] = None
                    ) -> Tuple[Optional[np.ndarray], int]:
    """Apply every packed filter, in order, to the `alive` row-index set
    (`alive=None` means every row — the common first-pass case, probed
    without materializing an index array or gathering hash state).

    Returns (surviving indices or None if all survived, rows actually
    probed). Survivors-only early exit at two levels: rows are dropped
    after the first missing hash round, and later filters see only
    earlier survivors. When `live_after` is given, the live count after
    each filter is appended to it (the adaptive scheduler's
    estimated-vs-actual selectivity feedback)."""
    flat = packed.words.reshape(-1)
    rows_probed = 0
    _u5, _u31, _upos = np.uint32(5), np.uint32(31), np.uint32(
        BLOCK_BITS - 1)
    for f in range(len(packed.offsets)):
        if alive is not None and alive.size == 0:
            if live_after is not None:
                live_after.append(0)
            continue
        m = n_rows if alive is None else int(alive.size)
        rows_probed += m
        l2 = packed.log2nb[f]
        h, g1, g2 = keys[f].hga(alive)
        off = int(packed.offsets[f])
        # uint32 word indices when the packed stack is small enough —
        # halves the index-arithmetic memory traffic on the hot round
        small = (off + (1 << l2)) * LANES < 2**31
        idt = np.uint32 if small else np.int64
        if l2:
            base = h >> np.uint32(32 - l2)          # fresh array, owned
            if not small:
                base = base.astype(np.int64)
            if off:
                base += idt(off)
            base *= idt(LANES)
        else:
            base = np.full(m, off * LANES, idt)
        cur = alive
        with np.errstate(over="ignore"):
            for j in range(packed.k):
                pos = (g1 & _upos) if j == 0 else \
                    ((g1 + np.uint32(j) * g2) & _upos)
                w = flat[base + (pos >> _u5)]
                hit = ((w >> (pos & _u31)) & np.uint32(1)) == 1
                if not hit.all():
                    # narrow by gathering survivors (reads ~survivors,
                    # not three full boolean passes)
                    sel = np.flatnonzero(hit)
                    cur = sel if cur is None else cur.take(sel)
                    base = base.take(sel)
                    g1 = g1.take(sel)
                    g2 = g2.take(sel)
                    if sel.size == 0:
                        break
        alive = cur
        if live_after is not None:
            live_after.append(n_rows if alive is None
                              else int(alive.size))
    return alive, rows_probed


def build_alive_np(ek: EngineKeys, alive: Optional[np.ndarray],
                   nblocks: int, k: int) -> np.ndarray:
    """Build filter words from the survivor index set (`alive=None` means
    every row). Bit-identical to `bloom.build_np` over the same rows."""
    h, g1, g2 = ek.hga(alive)
    l2 = int(np.log2(nblocks))
    if l2:
        blk = (h >> np.uint32(32 - l2)).astype(np.int64) * BLOCK_BITS
    else:
        blk = np.int64(0)
    bits = np.zeros(nblocks * BLOCK_BITS, bool)
    with np.errstate(over="ignore"):
        for j in range(k):
            pos = (g1 + np.uint32(j) * g2) & np.uint32(BLOCK_BITS - 1)
            bits[blk + pos] = True
    return np.packbits(bits, bitorder="little").view(np.uint32).reshape(
        nblocks, LANES)


# --------------------------------------------------------------------------
# device-scan helpers (torch ops; none of them syncs — the caller syncs one
# scalar or one small vector through `device_plane`)
# --------------------------------------------------------------------------


def _live(n: int, count: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device) < count


def _range_cut(lo_col, hi_col, idx, count: int, lo: int, hi: int):
    """Survivors of `lo <= key <= hi` over the live rows: (front-packed
    ids, device count)."""
    keys = hashing.keys64(lo_col, hi_col)
    vals = keys if idx is None else keys[idx]
    n = vals.shape[0]
    ok = (vals >= lo) & (vals <= hi) & _live(n, count, vals.device)
    return (device_plane.compact(ok, n, idx),
            torch.sum(ok, dtype=torch.int32))


def _minmax(lo_col, hi_col, idx, count: int, valid=None):
    """int64 [min, max] of the keys over live (and valid) rows — one
    16-byte vector; min > max when no such row exists."""
    keys = hashing.keys64(lo_col, hi_col)
    vals = keys if idx is None else keys[idx]
    live = _live(vals.shape[0], count, vals.device)
    if valid is not None:
        live = live & (valid if idx is None else valid[idx])
    big = torch.iinfo(torch.int64)
    return torch.stack([torch.where(live, vals, big.max).min(),
                        torch.where(live, vals, big.min).max()])


# --------------------------------------------------------------------------
# vertex scans: probe half + build half over one survivor set
# --------------------------------------------------------------------------


class VertexScan:
    """One vertex's transfer step. `probe` applies the (LIP-ordered)
    incoming filters; `build` emits an outgoing filter from the same
    survivor set — the probe→build pair is one logical scan.

    `probe_range` / `gather_live` are the adaptive scheduler's hooks
    (DESIGN.md §11): a min-max pre-filter over the raw keys, and the
    live-row key values an emitted filter's own range is computed from.
    Both are host-side control-plane ops — the raw composite key is
    host-resident for every backend (`Vertex.key`)."""

    #: live count after each filter of the last `probe` call (the
    #: adaptive scheduler's estimated-vs-actual selectivity feedback)
    live_after: Sequence[int] = ()

    def probe(self, incoming: Sequence[Tuple[np.ndarray, EngineKeys]]
              ) -> int:
        raise NotImplementedError

    @property
    def mask(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def live(self) -> int:
        raise NotImplementedError

    def build(self, ek: EngineKeys, nblocks: int,
              valid: Optional[np.ndarray] = None):
        """Emit filter words from the live set; rows where `valid` is
        False are additionally excluded from the *build only* (the
        NULL-tight contract: NULL keys never match, so they never need
        filter bits — the vertex's own mask is untouched)."""
        raise NotImplementedError

    def probe_range(self, raw: np.ndarray, lo: int, hi: int,
                    ek: Optional[EngineKeys] = None) -> int:
        """Shrink the live set to rows with lo <= raw <= hi. Returns
        the number of rows tested (the live count going in). When `ek`
        (the same column's hash state) is given, device-resident scans
        run the cut on device from the cached key halves — one scalar
        sync instead of a survivor-id sync."""
        raise NotImplementedError

    def gather_live(self, raw: np.ndarray) -> np.ndarray:
        """Values of `raw` (a full-column host array) at the live rows."""
        raise NotImplementedError

    def key_range(self, raw: np.ndarray,
                  ek: Optional[EngineKeys] = None,
                  valid: Optional[np.ndarray] = None):
        """(lo, hi) int64 min/max of `raw` over the live (and `valid`)
        rows, or None when no such row exists. Device-resident scans
        reduce on device and sync 16 bytes; everyone else gathers."""
        vals = self.gather_live(raw)
        if valid is not None:
            vals = vals[self.gather_live(np.asarray(valid, bool))]
        if vals.size == 0:
            return None
        return int(vals.min()), int(vals.max())

    def live_hashes(self, ek: EngineKeys) -> np.ndarray:
        """uint32 block hashes of the live rows (the KMV distinct
        estimator's input — shares `EngineKeys`' hash cache with the
        build that follows)."""
        raise NotImplementedError

    def clear(self) -> None:
        """Empty the live set without testing a row (a disjoint min-max
        range proved no row can survive)."""
        raise NotImplementedError


class _NumpyScan(VertexScan):
    def __init__(self, mask: np.ndarray, k: int):
        self._k = k
        self._mask0 = np.asarray(mask, bool)
        # _alive is the survivor index set; None means "every masked row"
        # — and when the mask is all-True, probes and builds run on the
        # raw hash arrays with no index materialization or gathers
        self._alive: Optional[np.ndarray] = None
        self._full: Optional[bool] = None          # lazy mask0.all()
        self._probed = False
        self._mask_out: Optional[np.ndarray] = None

    def _is_full(self) -> bool:
        if self._full is None:
            self._full = bool(self._mask0.all())
        return self._full

    def probe(self, incoming):
        if not incoming:
            self.live_after = []
            return 0
        faultinject.fire("engine.probe")
        if self._alive is None and not self._is_full():
            self._alive = np.flatnonzero(self._mask0)
        packed = pack_filters([w for w, _ in incoming], self._k)
        counts: list = []
        self._alive, rows = probe_packed_np(
            packed, [ek for _, ek in incoming], self._alive,
            len(self._mask0), live_after=counts)
        self.live_after = counts
        self._probed = True
        self._mask_out = None
        return rows

    def probe_range(self, raw, lo, hi, ek=None):
        if self._alive is None and not self._is_full():
            self._alive = np.flatnonzero(self._mask0)
        if self._alive is None:
            rows = len(self._mask0)
            keep = (raw >= lo) & (raw <= hi)
            if not keep.all():
                self._alive = np.flatnonzero(keep)
        else:
            rows = int(self._alive.size)
            vals = raw[self._alive]
            keep = (vals >= lo) & (vals <= hi)
            if not keep.all():
                self._alive = self._alive[keep]
        self._probed = True
        self._mask_out = None
        return rows

    def gather_live(self, raw):
        if self._alive is not None:
            return raw[self._alive]
        if self._is_full():
            return raw
        return raw[self._mask0]

    def live_hashes(self, ek):
        if self._alive is None and not self._is_full():
            self._alive = np.flatnonzero(self._mask0)
        return ek.hga(self._alive)[0]

    def clear(self):
        self._alive = np.empty(0, np.int64)
        self._probed = True
        self._mask_out = None

    @property
    def mask(self):
        if not self._probed or self._alive is None:
            return self._mask0          # alive None after probe => all hit
        if self._mask_out is None:
            out = np.zeros(len(self._mask0), bool)
            out[self._alive] = True
            self._mask_out = out
        return self._mask_out

    @property
    def live(self):
        if self._alive is not None:
            return int(self._alive.size)
        if self._is_full():
            return len(self._mask0)
        return int(np.count_nonzero(self._mask0))

    def build(self, ek, nblocks, valid=None):
        faultinject.fire("engine.build")
        if self._alive is None and not self._is_full():
            self._alive = np.flatnonzero(self._mask0)
        alive = self._alive
        if valid is not None:
            # NULL-tight: invalid-key rows leave the *build* set only
            if alive is None:
                if not valid.all():
                    alive = np.flatnonzero(valid)
            else:
                alive = alive[valid[alive]]
        return build_alive_np(ek, alive, nblocks, self._k)


class _DeviceScan(VertexScan):
    """Device-resident scan over a *compacted* survivor set.

    The working set is a device int32 array of original row ids,
    re-bucketed (power-of-two, `TILE` floor) after every probe — so later
    filters probe ~survivors, not the full padded column. Rows are
    `(idx, count)`: the first `count` entries are live, the tail is
    padding (zeros, masked by `count` — no separate validity array).
    `idx=None` is the identity (every row live).

    Per vertex the host syncs one per-filter counts vector (the fused
    probe), one scalar per range cut and 16 bytes per min-max; the
    survivor ids themselves sync only when the host needs the mask."""

    def __init__(self, mask: np.ndarray, engine: "CudaEngine"):
        self._e = engine
        self._n = len(mask)
        mask = np.asarray(mask, bool)
        if mask.all():
            self._idx = None                 # identity: all rows live
            self._count = self._n
            self._bucket = engine.bucket(self._n)
        else:
            host_idx = np.flatnonzero(mask).astype(np.int32)
            self._count = int(host_idx.size)
            self._bucket = engine.bucket(self._count)
            self._idx = device_plane.to_device(_pad(host_idx, self._bucket),
                                               engine.device)
        self._mask_out: Optional[np.ndarray] = None
        # host copy of the device survivor-id array, synced at most once
        # per state (invalidated whenever the live set changes)
        self._hidx: Optional[np.ndarray] = None

    def _set_live(self, idx, new_count: int) -> None:
        """Adopt a front-packed survivor-id array after a cut."""
        if new_count == self._count:
            return
        new_bucket = self._e.bucket(new_count)
        if new_bucket != self._bucket:
            idx = idx[:new_bucket]          # survivors are front-packed
            self._bucket = new_bucket
        self._idx = idx
        self._count = new_count
        self._mask_out = None
        self._hidx = None
        device_plane.count_compaction()

    def probe(self, incoming):
        """One fused probe kernel applies every incoming filter and the
        survivors are compacted on device; the host syncs a single
        per-filter counts vector for the whole vertex."""
        if not incoming:
            self.live_after = []
            return 0
        faultinject.fire("engine.probe")
        if self._count == 0:
            self.live_after = [0] * len(incoming)
            return 0
        words_dev = [device_plane.to_device(w, self._e.device)
                     for w, _ in incoming]
        idx, dcounts = self._e.fused_probe_idx(
            words_dev, [ek for _, ek in incoming], self._idx,
            self._count, self._n)
        device_plane.count_fused()
        host_counts = device_plane.to_host(dcounts)  # the ONE d2h sync
        self.live_after = [int(c) for c in host_counts]
        # rows-probed accounting matches the host engine: filter f
        # "sees" the rows still live when it runs
        rows = self._count + int(host_counts[:-1].sum())
        self._set_live(idx, int(host_counts[-1]))
        return rows

    def probe_range(self, raw, lo, hi, ek=None):
        """Range pre-filter. With the column's keys (`ek`) the cut runs
        on device from the cached key halves and syncs one scalar;
        otherwise the survivor ids are synced and tested on host."""
        if self._count == 0:
            return 0
        rows = self._count
        if ek is not None:
            dlo, dhi = ek.dev(self._e.bucket(self._n))
            idx, cnt = _range_cut(dlo, dhi, self._idx, self._count, lo, hi)
            self._set_live(idx, device_plane.scalar(cnt))
            return rows
        idx = self._host_idx()
        vals = raw if idx is None else raw[idx]
        keep = (vals >= lo) & (vals <= hi)
        if not keep.all():
            live = (np.flatnonzero(keep) if idx is None
                    else idx[keep]).astype(np.int32)
            self._count = int(live.size)
            self._bucket = self._e.bucket(self._count)
            self._idx = device_plane.to_device(_pad(live, self._bucket),
                                               self._e.device)
            self._mask_out = None
            self._hidx = None
        return rows

    def key_range(self, raw, ek=None, valid=None):
        if self._count == 0:
            return None
        if ek is None:
            return super().key_range(raw, ek=ek, valid=valid)
        b = self._e.bucket(self._n)
        dlo, dhi = ek.dev(b)
        v = None
        if valid is not None:
            v = device_plane.to_device(_pad(np.asarray(valid, bool), b,
                                            False), self._e.device)
        lo, hi = (int(x) for x in device_plane.to_host(
            _minmax(dlo, dhi, self._idx, self._count, v)))
        if lo > hi:             # every live row was invalid
            return None
        return lo, hi

    def gather_live(self, raw):
        idx = self._host_idx()
        return raw if idx is None else raw[idx]

    def live_hashes(self, ek):
        return ek.hga(self._host_idx())[0]

    def clear(self):
        self._count = 0
        self._bucket = self._e.bucket(0)
        self._idx = device_plane.to_device(
            _pad(np.empty(0, np.int32), self._bucket), self._e.device)
        self._mask_out = None
        self._hidx = None

    def _host_idx(self) -> Optional[np.ndarray]:
        """Live original row ids on host (None = every row). The device
        survivor-id array syncs once and is cached until the live set
        changes."""
        if self._idx is None:
            return None
        if self._hidx is None:
            out = device_plane.to_host(self._idx)
            self._hidx = out[: self._count].astype(np.int64)
        return self._hidx

    @property
    def mask(self):
        if self._mask_out is None:
            idx = self._host_idx()
            if idx is None:
                self._mask_out = np.ones(self._n, bool)
            else:
                out = np.zeros(self._n, bool)
                out[idx] = True
                self._mask_out = out
        return self._mask_out

    @property
    def live(self):
        return self._count

    def build(self, ek, nblocks, valid=None):
        faultinject.fire("engine.build")
        return self._e.build_idx(ek, self._idx, self._count, self._n,
                                 nblocks, valid=valid)


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------


class BloomEngine:
    """Backend-pluggable batched Bloom runtime. Subclasses provide the
    raw ops; this base provides the strategy-facing API:

    * ``keys(values)``            — hash a key column once;
    * ``begin(mask)``             — open a `VertexScan`;
    * ``build_filter`` / ``probe_filter`` — one-shot ops (Bloom-Join,
      benches, tests)."""

    backend = "base"
    #: the device-resident data plane: fused multi-filter probes, device
    #: compaction/range-cut/min-max, device builds — the host syncs
    #: scalars and tiny counts vectors only
    device_resident = False

    def __init__(self, k: int = DEFAULT_K):
        self.k = k

    # -- device-scan hooks ---------------------------------------------
    def fused_probe_idx(self, words, eks, idx, count: int, n: int):
        """One device pass over every incoming filter: returns (packed
        survivor ids, device int32 live-count-after-each-filter vector)
        — the caller syncs the counts once per vertex."""
        raise NotImplementedError

    def build_idx(self, ek: "EngineKeys", idx, count: int, n: int,
                  nblocks: int, valid: Optional[np.ndarray] = None):
        raise NotImplementedError

    # -- strategy-facing ----------------------------------------------
    def keys(self, values: np.ndarray) -> EngineKeys:
        raise NotImplementedError

    def begin(self, mask: np.ndarray) -> VertexScan:
        raise NotImplementedError

    def bucket(self, n: int) -> int:
        return _bucket(n)

    def build_filter(self, ek: EngineKeys,
                     mask: Optional[np.ndarray] = None,
                     bits_per_key: int = DEFAULT_BITS_PER_KEY,
                     nblocks: Optional[int] = None,
                     valid: Optional[np.ndarray] = None) -> BloomFilter:
        """`valid=False` rows are excluded from the build (and the
        sizing) — the NULL-tight hook: NULL join keys never match, so
        they never earn filter bits."""
        if valid is not None:
            valid = np.asarray(valid, bool)
            if valid.all():
                valid = None
        if mask is None:
            n_live = len(ek) if valid is None else int(valid.sum())
        else:
            mask = np.asarray(mask, bool)
            n_live = int(mask.sum()) if valid is None \
                else int((mask & valid).sum())
        ins = np.ones(len(ek), bool) if mask is None else mask
        if nblocks is None:
            nblocks = blocks_for(max(n_live, 1), bits_per_key)
        scan = self.begin(ins)
        return BloomFilter(scan.build(ek, nblocks, valid=valid), self.k)

    def probe_filter(self, filt: BloomFilter, ek: EngineKeys,
                     live: Optional[np.ndarray] = None) -> np.ndarray:
        scan = self.begin(np.ones(len(ek), bool) if live is None
                          else np.asarray(live, bool))
        scan.probe([(filt.words, ek)])
        return scan.mask


class NumpyEngine(BloomEngine):
    """Host mirror backend."""

    backend = "numpy"

    def keys(self, values):
        keys = np.asarray(values).astype(np.int64, copy=False)
        if not keys.flags.c_contiguous:
            keys = np.ascontiguousarray(keys)
        # lazy: EngineKeys.hga hashes the full column once on first
        # mostly-alive use, or just the survivor subset when earlier
        # filters already shrank the working set
        return EngineKeys(len(keys), raw=keys)

    def begin(self, mask):
        return _NumpyScan(mask, self.k)


class CudaEngine(BloomEngine):
    """`repro_torch.kernels.bloom` kernels over device-resident,
    survivor-compacted batches (the reference's `PallasEngine` role).
    On a CPU device — tests only — the kernel wrappers run their plain
    torch versions. Builds and compaction always stay on the device."""

    backend = "cuda"

    def __init__(self, k: int = DEFAULT_K,
                 device_resident: Optional[bool] = None,
                 device="cuda"):
        super().__init__(k)
        self.device = device_plane.resolve_device(device)
        if device_resident is None:
            device_resident = self.device.type == "cuda"
        if not device_resident:
            raise NotImplementedError(
                "the cuda bloom engine runs only with the device-resident "
                "data plane; the plane-off route (per-filter probes, "
                "kernel K3) is ROADMAP Queue 1, next slice")
        self.device_resident = True

    def keys(self, values):
        lo, hi = hashing.key_halves(np.asarray(values))
        return EngineKeys(len(lo), lo=lo, hi=hi, device=self.device)

    def begin(self, mask):
        return _DeviceScan(mask, self)

    def bucket(self, n):
        return _bucket(n, floor=TILE)

    def fused_probe_idx(self, words, eks, idx, count, n):
        from repro_torch.kernels.bloom import ops as kb
        b = self.bucket(n)
        los, his = zip(*(ek.dev(b) for ek in eks))
        cum = kb.multi_probe(words, los, his, idx=idx, count=count, k=self.k)
        counts = torch.sum(cum, dim=1, dtype=torch.int32)
        return device_plane.compact(cum[-1], cum.shape[1], idx), counts

    def build_idx(self, ek, idx, count, n, nblocks, valid=None):
        from repro_torch.kernels.bloom import ops as kb
        b = self.bucket(n)
        lo, hi = ek.dev(b)
        vdev = None if valid is None else device_plane.to_device(
            _pad(np.asarray(valid, bool), b, False), self.device)
        return kb.build(lo, hi, nblocks, idx=idx, count=count, valid=vdev,
                        k=self.k)


_ENGINES: Dict[Tuple, BloomEngine] = {}
_ENGINES_LOCK = threading.Lock()


def get_engine(backend: str = "numpy", k: int = DEFAULT_K,
               device_resident: Optional[bool] = None,
               device="cuda") -> BloomEngine:
    """Engine instances are cached so device key pads are shared across
    strategies and queries; creation is locked so concurrent sessions
    agree on one instance per key.

    `device` is where the ``cuda`` backend runs: a CUDA device (the
    default) launches the kernels, ``"cpu"`` runs their plain torch
    versions (tests). Without CUDA, a CUDA device raises RuntimeError.
    `device_resident=None` resolves to on for a CUDA device. The numpy
    backend ignores both."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown bloom backend {backend!r}; "
                         f"choose from {BACKENDS}")
    if backend == "numpy":
        key = (backend, k, None, None)
    else:
        dev = device_plane.resolve_device(device)
        key = (backend, k, device_resident, str(dev))
    with _ENGINES_LOCK:
        eng = _ENGINES.get(key)
        if eng is None:
            if backend == "numpy":
                eng = NumpyEngine(k)
            else:
                eng = CudaEngine(k, device_resident=device_resident,
                                 device=dev)
            _ENGINES[key] = eng
    return eng
