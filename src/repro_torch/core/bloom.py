"""Blocked (register-blocked) Bloom filter in torch, with a numpy mirror.

One hash picks a 256-bit block (8 uint32 lanes, one 32-byte memory
sector on the GPU); k bits are set/tested *within* the block via double
hashing. A probe costs one block load plus bit math — no k dependent
random accesses.

This module is the plain torch implementation and the oracle for the
CUDA kernels in `repro_torch.kernels.bloom`. Device filter words are
`int32` tensors holding the uint32 bit pattern; host words are
`np.uint32` (`words_to_host` and `device_plane.to_device` convert at
the boundary). Hash arithmetic runs in int64 masked to 32 bits
(`repro_torch.core.hashing`).

Key batches are padded to power-of-two buckets by the engine layer
(`repro_torch.core.engine_bloom`), the same shape contract as the
reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import hashing

BLOCK_BITS = 256          # bits per block
LANES = BLOCK_BITS // 32  # 8 uint32 lanes per block
DEFAULT_BITS_PER_KEY = 16
DEFAULT_K = 4


@dataclasses.dataclass
class BloomFilter:
    """words: uint32 [nblocks, LANES] (np.uint32 on host, int32 bit
    pattern on device). nblocks is a power of two."""
    words: object
    k: int = DEFAULT_K

    @property
    def nblocks(self) -> int:
        return self.words.shape[0]

    @property
    def nbits(self) -> int:
        return self.nblocks * BLOCK_BITS

    def nbytes(self) -> int:
        return self.nblocks * LANES * 4

    def fold_to(self, nblocks: int) -> "BloomFilter":
        """Shrink to a smaller power-of-two block count by OR-folding.

        Valid because the block index is the high bits of the hash:
        halving the block count drops the lowest block-index bit, i.e.
        blocks (2i, 2i+1) merge into block i."""
        assert nblocks <= self.nblocks and nblocks & (nblocks - 1) == 0
        w = self.words
        while w.shape[0] > nblocks:
            w = w.reshape(w.shape[0] // 2, 2, LANES)
            w = w[:, 0, :] | w[:, 1, :]
        return BloomFilter(w, self.k)

    def union(self, other: "BloomFilter") -> "BloomFilter":
        assert self.k == other.k
        n = min(self.nblocks, other.nblocks)
        a, b = self.fold_to(n), other.fold_to(n)
        return BloomFilter(a.words | b.words, self.k)


def blocks_for(n_keys: int, bits_per_key: int = DEFAULT_BITS_PER_KEY) -> int:
    """Power-of-two block count for ~n_keys insertions."""
    bits = max(int(n_keys) * bits_per_key, BLOCK_BITS)
    nblocks = max(1, int(2 ** np.ceil(np.log2(bits / BLOCK_BITS))))
    return nblocks


def words_to_host(words) -> np.ndarray:
    """Filter words (device int32 tensor, or a host int32/uint32 array)
    -> host np.uint32, reinterpreting the int32 bit pattern."""
    if not isinstance(words, np.ndarray):
        words = words.cpu().numpy()
    return words.view(np.uint32) if words.dtype == np.int32 else words


def halves_to_device(lo: np.ndarray, hi: np.ndarray, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host uint32 key halves -> device int32 bit patterns."""
    return (torch.from_numpy(np.ascontiguousarray(lo).view(np.int32))
            .to(device),
            torch.from_numpy(np.ascontiguousarray(hi).view(np.int32))
            .to(device))


def keys_to_device(keys: np.ndarray, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host int64 keys -> their device int32 (lo, hi) halves."""
    return halves_to_device(*hashing.key_halves(np.asarray(keys)), device)


def to_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


# -- device (torch) ----------------------------------------------------------


def _positions(h: torch.Tensor, k: int) -> torch.Tensor:
    """k in-block bit positions [n, k] via double hashing (odd stride)."""
    g1 = hashing.fmix32(h ^ int(hashing.GOLDEN))
    g2 = hashing.fmix32(h ^ int(hashing.P2)) | 1
    j = torch.arange(k, dtype=torch.int64, device=h.device)
    return (g1[:, None] + j[None, :] * g2[:, None]) & (BLOCK_BITS - 1)


def _block_index(h: torch.Tensor, nblocks: int) -> torch.Tensor:
    # use high bits for the block so they are independent of the low bits
    # used by double hashing inside the block; one block: no shift (a
    # shift by 32 is undefined)
    if nblocks == 1:
        return torch.zeros_like(h)
    return h >> (32 - int(np.log2(nblocks)))


def pack_bits(bits: torch.Tensor, nblocks: int) -> torch.Tensor:
    """bool [nblocks * BLOCK_BITS] -> int32 words [nblocks, LANES] (bit j
    of word w is flat bit 32*w + j, the numpy little-endian packing)."""
    b = bits.reshape(nblocks, LANES, 32).to(torch.int64)
    shifts = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, dtype=torch.int64, device=bits.device)
    return to_i32((b * shifts).sum(dim=-1))


def build(lo: torch.Tensor, hi: torch.Tensor, mask: torch.Tensor,
          nblocks: int, k: int = DEFAULT_K) -> torch.Tensor:
    """Build filter words (int32 [nblocks, LANES]) from uint32 key halves;
    rows with mask=False are dropped."""
    h = hashing.hash64(lo, hi)
    blk = _block_index(h, nblocks)
    pos = _positions(h, k)                                  # [n, k]
    fidx = (blk[:, None] * BLOCK_BITS + pos)[mask.to(torch.bool)]
    bits = torch.zeros(nblocks * BLOCK_BITS, dtype=torch.bool,
                       device=lo.device)
    bits[fidx.reshape(-1)] = True
    return pack_bits(bits, nblocks)


def probe(words: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
          k: int = DEFAULT_K) -> torch.Tensor:
    """Membership test -> bool [n]. False negatives impossible."""
    h, g1, g2 = hash_state(lo, hi)
    return probe_hashed_dev(words, h, g1, g2, k=k)


def hash_state(lo: torch.Tensor, hi: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(h, g1, g2) int64 hash state from uint32 key halves — computed
    once per key column and reusable by every `probe_hashed_dev` call."""
    h = hashing.hash64(lo, hi)
    g1 = hashing.fmix32(h ^ int(hashing.GOLDEN))
    g2 = hashing.fmix32(h ^ int(hashing.P2)) | 1
    return h, g1, g2


def probe_hashed_dev(words: torch.Tensor, h: torch.Tensor,
                     g1: torch.Tensor, g2: torch.Tensor,
                     k: int = DEFAULT_K) -> torch.Tensor:
    """`probe` from pre-hashed state: k flat word gathers, no rehash per
    filter. Bit-identical to `probe` over the same keys."""
    nblocks = words.shape[0]
    flat = hashing.u32(words.reshape(-1))
    base = _block_index(h, nblocks) * LANES
    out = torch.ones(h.shape, dtype=torch.bool, device=h.device)
    for j in range(k):
        pos = (g1 + j * g2) & (BLOCK_BITS - 1)
        w = flat[base + (pos >> 5)]
        out &= ((w >> (pos & 31)) & 1) == 1
    return out


def transfer(in_words: torch.Tensor,
             in_lo: torch.Tensor, in_hi: torch.Tensor,
             out_lo: torch.Tensor, out_hi: torch.Tensor,
             mask: torch.Tensor, nblocks: int, k: int = DEFAULT_K
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused filter transformation (paper §3.2): probe the incoming filter
    on the incoming join key; for passing rows insert the outgoing join key
    into a fresh outgoing filter. One scan, two filters.

    Returns (survivor_mask, out_words)."""
    ok = mask.to(torch.bool) & probe(in_words, in_lo, in_hi, k=k)
    return ok, build(out_lo, out_hi, ok, nblocks, k=k)


# -- host (numpy) mirror -----------------------------------------------------
#
# Bit-identical to the torch implementation above (tests assert exact word
# equality). The relational engine's host path uses this mirror.


def _positions_np(h: np.ndarray, k: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        g1 = hashing.fmix32_np(h ^ hashing.GOLDEN)
        g2 = hashing.fmix32_np(h ^ np.uint32(0x7FEB352D)) | np.uint32(1)
        j = np.arange(k, dtype=np.uint32)
        return (g1[:, None] + j[None, :] * g2[:, None]) & np.uint32(
            BLOCK_BITS - 1)


def _block_index_np(h: np.ndarray, nblocks: int) -> np.ndarray:
    if nblocks == 1:
        return np.zeros_like(h)
    return h >> np.uint32(32 - int(np.log2(nblocks)))


def build_np(lo: np.ndarray, hi: np.ndarray, mask: np.ndarray,
             nblocks: int, k: int = DEFAULT_K) -> np.ndarray:
    h = hashing.hash64_np(lo, hi)
    m = np.asarray(mask, bool)
    if not m.all():
        h = h[m]
    blk = _block_index_np(h, nblocks).astype(np.int64)
    pos = _positions_np(h, k).astype(np.int64)
    # flat bit index; constant-True fancy assignment needs no
    # read-modify-write, so duplicate indices are free
    fidx = blk[:, None] * BLOCK_BITS + pos
    bits = np.zeros(nblocks * BLOCK_BITS, bool)
    bits[fidx.ravel()] = True
    # little-endian packbits == the torch shift-sum packing (bit j of word
    # w is flat bit 32*w + j); tests assert bit-exact equality
    return np.packbits(bits, bitorder="little").view(np.uint32).reshape(
        nblocks, LANES)


def probe_np(words: np.ndarray, lo: np.ndarray, hi: np.ndarray,
             k: int = DEFAULT_K) -> np.ndarray:
    nblocks = words.shape[0]
    h = hashing.hash64_np(lo, hi)
    blk = _block_index_np(h, nblocks).astype(np.int64)
    pos = _positions_np(h, k)
    flat = words.reshape(-1)
    out = np.ones(len(h), bool)
    base = blk * LANES
    for j in range(k):                     # k flat gathers, no [n,k] temp
        pj = pos[:, j]
        w = flat[base + (pj >> 5)]
        out &= (w >> (pj & np.uint32(31)) & np.uint32(1)) == 1
    return out


# -- min-max (zone) filters --------------------------------------------------
#
# Near-free complement to the Bloom filters: a transfer edge's build side
# publishes the [lo, hi] range of its *live, valid* keys alongside the
# Bloom words. The probing side can then
#
#   * short-circuit the whole edge when the ranges are provably
#     disjoint (every probe key misses — no hash, no probe);
#   * skip the range test when its own conservative range is contained
#     in the build range (the min-max filter provably passes every row);
#   * otherwise apply the O(1)-per-row comparison *before* the Bloom
#     probe, so out-of-range rows never reach the hash rounds.
#
# Ranges are only meaningful for order-preserving key encodings
# (single non-dictionary columns and the packed two-column path —
# `ops.stable_key_encoding`); the hash-combine fallback scrambles
# order, so the scheduler disables min-max there.


@dataclasses.dataclass(frozen=True)
class MinMaxFilter:
    """Closed key range [lo, hi] of a filter's inserted keys. An empty
    build side is encoded as (0, -1) (matches `Column.value_range`) and
    is disjoint from everything."""

    lo: int
    hi: int

    @property
    def empty(self) -> bool:
        return self.hi < self.lo

    def disjoint(self, lo: int, hi: int) -> bool:
        """No key in [lo, hi] can be in this filter."""
        return self.empty or hi < self.lo or self.hi < lo

    def contains(self, lo: int, hi: int) -> bool:
        """Every key in [lo, hi] passes this filter (non-filtering)."""
        return (not self.empty) and self.lo <= lo and hi <= self.hi

    def probe_np(self, keys: np.ndarray) -> np.ndarray:
        if self.empty:
            return np.zeros(len(keys), bool)
        return (keys >= self.lo) & (keys <= self.hi)


def key_range(keys: np.ndarray) -> Tuple[int, int]:
    """(min, max) of a key vector; empty -> (0, -1)."""
    if len(keys) == 0:
        return (0, -1)
    return int(keys.min()), int(keys.max())


# -- KMV distinct-count estimator --------------------------------------------
#
# The adaptive transfer scheduler (repro_torch.core.transfer) estimates a
# build side's live distinct-key count from the hash state the Bloom
# build needs anyway (`EngineKeys.hga` — uniform uint32), so the
# estimate costs one partition pass over already-computed hashes and
# never an extra scan of the table. K-minimum-values: with the k-th
# smallest of n uniform hashes at position t in [0, 2^32), the distinct
# count is ≈ (k-1) · 2^32 / t (Bar-Yossef et al.; ±1/sqrt(k) relative
# error — k=256 gives ~6%, plenty for a skip/apply decision).

KMV_K = 256


def kmv_distinct(h: np.ndarray, k: int = KMV_K) -> int:
    """Distinct-count estimate from uint32 hash values (exact below
    ~4k rows). Duplicate keys put duplicate hashes among the minima, so
    the partition width grows (O(n) per round, bounded at 16k values
    examined) until it holds k *distinct* values; if heavy multiplicity
    exhausts the budget first, the estimate comes from however many
    distinct minima were found. Never a full O(n log n) sort of the
    column."""
    n = len(h)
    if n == 0:
        return 0
    if n <= 4 * k:
        return len(np.unique(h))
    kk = k
    while True:
        kk = min(kk, n)
        uniq = np.unique(np.partition(h, kk - 1)[: kk] if kk < n
                         else h)
        if len(uniq) >= k or kk >= min(n, 16 * k):
            break
        kk *= 4
    kd = min(len(uniq), k)
    t = int(uniq[kd - 1])
    if kd < 2 or t == 0:
        return kd
    return max(kd, int((kd - 1) * (2.0 ** 32) / t))


# -- hash-once key cache -----------------------------------------------------
#
# Predicate transfer touches the same (vertex, key column) many times: a
# column is probed by several incoming filters and inserted into several
# outgoing filters across the forward and backward passes. The hash values
# and in-block bit positions depend only on the key, so we compute them
# once per column and reuse.


@dataclasses.dataclass
class HashedKeys:
    """Hash state per key: block hash + double-hash generators. In-block
    bit positions are derived lazily per probe round for the *surviving*
    subset only."""
    h: np.ndarray        # uint32 [n]  (block hash)
    g1: np.ndarray       # uint32 [n]
    g2: np.ndarray       # uint32 [n]  (odd stride)
    k: int

    def __len__(self):
        return len(self.h)

    def pos_j(self, j: int, sel=None) -> np.ndarray:
        g1 = self.g1 if sel is None else self.g1[sel]
        g2 = self.g2 if sel is None else self.g2[sel]
        with np.errstate(over="ignore"):
            return (g1 + np.uint32(j) * g2) & np.uint32(BLOCK_BITS - 1)


def hash_keys(keys: np.ndarray, k: int = DEFAULT_K) -> HashedKeys:
    lo, hi = hashing.key_halves(np.asarray(keys))
    h = hashing.hash64_np(lo, hi)
    with np.errstate(over="ignore"):
        g1 = hashing.fmix32_np(h ^ hashing.GOLDEN)
        g2 = hashing.fmix32_np(h ^ np.uint32(0x7FEB352D)) | np.uint32(1)
    return HashedKeys(h, g1, g2, k)


def build_hashed(hk: HashedKeys, mask: np.ndarray | None, nblocks: int
                 ) -> np.ndarray:
    sel = None
    h = hk.h
    if mask is not None and not mask.all():
        sel = np.asarray(mask, bool)
        h = h[sel]
    blk = _block_index_np(h, nblocks).astype(np.int64) * BLOCK_BITS
    bits = np.zeros(nblocks * BLOCK_BITS, bool)
    for j in range(hk.k):
        bits[blk + hk.pos_j(j, sel).astype(np.int64)] = True
    return np.packbits(bits, bitorder="little").view(np.uint32).reshape(
        nblocks, LANES)


def probe_hashed(words: np.ndarray, hk: HashedKeys,
                 live: np.ndarray | None = None) -> np.ndarray:
    """Probe; if `live` (bool mask) is given, only live rows are tested
    (dead rows return False). Rows are dropped from the working set as
    soon as one hash misses; bit positions are derived lazily for
    survivors only."""
    n = len(hk)
    flat = words.reshape(-1)
    idx = np.flatnonzero(live) if live is not None else None
    h = hk.h if idx is None else hk.h[idx]
    nblocks = words.shape[0]
    base = _block_index_np(h, nblocks).astype(np.int64) * LANES
    alive = np.arange(n, dtype=np.int64) if idx is None else idx
    for j in range(hk.k):
        pj = hk.pos_j(j, alive)
        w = flat[base + (pj >> 5).astype(np.int64)]
        hit = (w >> (pj & np.uint32(31)) & np.uint32(1)) == 1
        if not hit.all():
            alive = alive[hit]
            base = base[hit]
        if len(alive) == 0:
            break
    out = np.zeros(n, bool)
    out[alive] = True
    return out


# -- host-facing convenience -------------------------------------------------

def _bucket(n: int, floor: int = 64) -> int:
    """Power-of-two batch size (>= floor). Canonical copy — the engine
    layer reuses it."""
    return max(floor, int(2 ** np.ceil(np.log2(max(n, 1)))))


def _pad(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if len(a) == n:
        return a
    out = np.full(n, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


def np_build(keys: np.ndarray, mask: np.ndarray | None = None,
             bits_per_key: int = DEFAULT_BITS_PER_KEY,
             k: int = DEFAULT_K) -> BloomFilter:
    keys = np.asarray(keys)
    n = int(mask.sum()) if mask is not None else len(keys)
    nblocks = blocks_for(max(n, 1), bits_per_key)
    if mask is None:
        mask = np.ones(len(keys), bool)
    lo, hi = hashing.key_halves(keys)
    return BloomFilter(build_np(lo, hi, mask, nblocks, k), k)


def np_probe(filt: BloomFilter, keys: np.ndarray) -> np.ndarray:
    lo, hi = hashing.key_halves(np.asarray(keys))
    return probe_np(words_to_host(filt.words), lo, hi, k=filt.k)
