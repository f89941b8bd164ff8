"""Device equi-joins: the sorted-segment join of the device-resident data
plane, the open-addressing key -> row map of the plane-off route
(kernels K4 and K5), and the open-addressing key set behind the kernel
library's semi-join `semi_mask` (kernels K6a and K6b).

**Sorted-segment join** (`segment_join_device`). Duplicate-key joins
entirely on the device — a stable argsort of the build keys, a binary
search per probe key, segment emission — with the host syncing one
output-size scalar per join. Bit-identical (build_idx, probe_idx) to
`engine_join.sorted_join_indices` under the NULL contract of
`JoinEngine.join_indices_valid`.

torch sorts and searches int64 natively, so the keys travel as their
(lo, hi) int32 halves (one stacked upload per side, the same bytes as
the reference) and are rebuilt as signed int64 on the device. NULL-key
and padding build rows are sorted past every real key with a second
stable pass on an invalid flag, and each probe row's match range is
clamped to the valid prefix, so they never match; NULL-key probe rows
get a zero match count (inner drops them, left emits them unmatched,
anti keeps them — no compact-and-remap on either side). These are torch
ops, not a hand kernel: sort and searchsorted were XLA primitives in the
reference too.

**Key -> row map** (`joinmap_build` / `joinmap_lookup`, the plane-off
hash-map join). `build_rows` (K4) and `lookup` (K5) are the wrappers:
on a CUDA tensor each launches its hand-written kernel from
`csrc/semijoin.cu` on the current stream (and raises if it cannot); on a
CPU tensor it runs the plain torch version beside it, `build_rows_ref`
(the reference's sequential insert) / `lookup_ref`. The table is int32
[cap, 4], one 16-byte record per slot: key halves, state (0 empty,
1 published), row — a finished table's columns are the reference's
klo/khi/occ/row lanes.

**Key set** (`semijoin_build` / `semijoin_probe` / `semi_mask`, the
Yannakakis semi-join of the paper's §2.2). `set_build` (K6a) and
`set_probe` (K6b) are K4 and K5 without the row: the same table format
with the row left at 0, the masked-off rows never inserted, and a bool
per probe key. Their plain versions are `set_build_ref` (the reference's
sequential insert) and `set_probe_ref`. A parallel build lays the table
out in another order than the sequential one, so a table is only ever
probed by the version that built it. `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bloom
from repro_torch.core import device_plane as dp
from repro_torch.core import hashing
from repro_torch.kernels.build import (LaunchCounts, check, check_bool,
                                      check_i32, library)

_I64MAX = torch.iinfo(torch.int64).max

LAUNCHES = LaunchCounts("joinmap_build", "joinmap_lookup", "semijoin_build",
                        "semijoin_probe")

#: the reference's Pallas tile: `capacity_for` keeps its floor of TILE // 2
TILE = 1024
#: slot record columns and the published state of a finished table
_LO, _HI, _STATE, _ROW = range(4)
_PUBLISHED = 1
_LIB: Optional[ctypes.CDLL] = None


def _pow2(n: int, floor: int = 256) -> int:
    return max(floor, int(2 ** np.ceil(np.log2(max(int(n), 1)))))


def _pad_pow2(a: np.ndarray, m: int, fill=0) -> np.ndarray:
    if m == len(a):
        return a
    out = np.full(m, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


def _segjoin_counts(bstack: torch.Tensor, pstack: torch.Tensor,
                    np_live: int):
    """(order, lo_pos, counts): build sort permutation (valid rows in
    stable key order first), each probe row's first-match position in
    it, and its match count (0 past `np_live` and for NULL probe keys)."""
    bkey = hashing.keys64(bstack[0], bstack[1])
    binv = bstack[2] != 0
    bkey = torch.where(binv, _I64MAX, bkey)
    order = torch.argsort(bkey, stable=True)
    order = order[torch.argsort(binv[order].to(torch.int8), stable=True)]
    skey = bkey[order]
    nvalid = torch.sum(~binv)
    pkey = hashing.keys64(pstack[0], pstack[1])
    lo_pos = torch.minimum(torch.searchsorted(skey, pkey), nvalid)
    hi_pos = torch.minimum(torch.searchsorted(skey, pkey, right=True),
                           nvalid)
    live = torch.arange(pkey.shape[0], device=pkey.device) < np_live
    if pstack.shape[0] == 3:
        live = live & (pstack[2] != 0)
    counts = torch.where(live, hi_pos - lo_pos, 0)
    return order.to(torch.int32), lo_pos, counts


def _segjoin_emit(order, lo_pos, counts, out_counts, total: int,
                  left: bool):
    """Match-pair emission: probe rows in original order, matches in
    stable build-key order (the engine output contract)."""
    npb = counts.shape[0]
    dev = counts.device
    starts = torch.cumsum(out_counts, 0) - out_counts
    probe_idx = torch.repeat_interleave(
        torch.arange(npb, dtype=torch.int64, device=dev), out_counts,
        output_size=total)
    within = torch.arange(total, dtype=torch.int64, device=dev) \
        - starts[probe_idx]
    build_pos = lo_pos[probe_idx] + within
    build_idx = order[torch.clamp(build_pos, 0, order.shape[0] - 1)]
    if left:
        build_idx = torch.where(counts[probe_idx] == 0, -1, build_idx)
    return build_idx.to(torch.int32), probe_idx.to(torch.int32)


def segment_join_device(build_key: np.ndarray, probe_key: np.ndarray,
                        how: str = "inner",
                        build_valid: Optional[np.ndarray] = None,
                        probe_valid: Optional[np.ndarray] = None,
                        device="cuda"):
    """Device sorted-segment equi-join. Returns (build_idx, probe_idx)
    with the exact semantics of `JoinEngine.join_indices_valid` — NULL
    contract included — as int32 device tensors (semi/anti build_idx is
    a host -1 vector, and an empty result two empty host vectors,
    matching the reference). Two counted uploads and one d2h scalar
    sync (the output size) per call."""
    build_key = np.asarray(build_key)
    probe_key = np.asarray(probe_key)
    nb, npr = len(build_key), len(probe_key)
    bb, pb = _pow2(nb), _pow2(npr)

    blo, bhi = hashing.key_halves(_pad_pow2(build_key, bb))
    bstack = np.empty((3, bb), np.uint32)
    bstack[0] = blo
    bstack[1] = bhi
    binv = np.zeros(bb, np.uint32)
    binv[nb:] = 1
    if build_valid is not None:
        binv[:nb][~np.asarray(build_valid, bool)] = 1
    bstack[2] = binv
    plo, phi = hashing.key_halves(_pad_pow2(probe_key, pb))
    pstack = np.empty((3 if probe_valid is not None else 2, pb),
                      np.uint32)
    pstack[0] = plo
    pstack[1] = phi
    if probe_valid is not None:
        pstack[2] = _pad_pow2(np.asarray(probe_valid, bool), pb, False)

    order, lo_pos, counts = _segjoin_counts(dp.to_device(bstack, device),
                                            dp.to_device(pstack, device),
                                            npr)
    live = torch.arange(pb, device=counts.device) < npr

    if how in ("semi", "anti"):
        ok = live & ((counts == 0) if how == "anti" else (counts > 0))
        sel = dp.compact(ok, pb)
        total = dp.scalar(torch.sum(ok, dtype=torch.int32))
        return np.full(total, -1, np.int64), sel[:total]
    if how == "left":
        out_counts = torch.where(live, torch.clamp(counts, min=1), 0)
    elif how == "inner":
        out_counts = counts
    else:
        raise ValueError(how)
    total = dp.scalar(torch.sum(out_counts, dtype=torch.int32))
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return _segjoin_emit(order, lo_pos, counts, out_counts, total,
                         how == "left")


# --------------------------------------------------------------------------
# key -> row map: K4 (build) and K5 (lookup)
# --------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = library("semijoin")
        lib.joinmap_build_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.joinmap_build_rows.restype = ctypes.c_int
        lib.joinmap_build_scratch_bytes.argtypes = [ctypes.c_int,
                                                    ctypes.c_int]
        lib.joinmap_build_scratch_bytes.restype = ctypes.c_longlong
        lib.joinmap_build_scatter.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.joinmap_build_scatter.restype = ctypes.c_int
        lib.joinmap_build_force_route.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.joinmap_build_force_route.restype = ctypes.c_int
        lib.joinmap_lookup.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.joinmap_lookup.restype = ctypes.c_int
        lib.semijoin_set_build.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.semijoin_set_build.restype = ctypes.c_int
        lib.semijoin_set_probe.argtypes = lib.joinmap_lookup.argtypes
        lib.semijoin_set_probe.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def capacity_for(n: int) -> int:
    """Power-of-two capacity at <= 50% load (at least TILE // 2)."""
    return _pow2(2 * max(int(n), 1), floor=TILE // 2)


def _check_cap(cap: int, n: int) -> None:
    if cap < 1 or cap & (cap - 1) or cap <= n:
        raise ValueError(f"table capacity {cap} must be a power of two "
                         f"above the {n} keys")


def _check_halves(lo: torch.Tensor, hi: torch.Tensor) -> None:
    check_i32(lo, lo.device, "lo")
    check_i32(hi, lo.device, "hi")
    if hi.shape != lo.shape:
        raise ValueError("lo and hi differ in length")


def _insert_ref(lo: torch.Tensor, hi: torch.Tensor, cap: int,
                mask: Optional[torch.Tensor], rows: bool):
    """The reference's sequential insert: the rows (those whose `mask` is
    True) one at a time in row order, linear probing from the key's home
    slot; equal keys share one slot, and with `rows` the last row wins
    (without, the row column stays 0). Returns (int32 table [cap, 4],
    int64 [1] count of occupied slots)."""
    _check_cap(cap, lo.shape[0])
    wrap = cap - 1
    home = (hashing.hash64(lo, hi) & wrap).tolist()
    los, his = lo.tolist(), hi.tolist()
    ids = (range(len(los)) if mask is None
           else torch.nonzero(mask.cpu()).flatten().tolist())
    klo, khi, state, row = ([0] * cap for _ in range(4))
    for i in ids:
        a, b, s = los[i], his[i], home[i]
        while state[s] and (klo[s] != a or khi[s] != b):
            s = (s + 1) & wrap
        klo[s], khi[s], state[s] = a, b, _PUBLISHED
        if rows:
            row[s] = i
    table = torch.stack([torch.tensor(c, dtype=torch.int32)
                         for c in (klo, khi, state, row)], dim=1)
    occupied = torch.tensor([sum(state)], dtype=torch.int64)
    return table.to(lo.device), occupied.to(lo.device)


def build_rows_ref(lo: torch.Tensor, hi: torch.Tensor, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch K4: the reference's sequential insert of every row, the
    last row winning (`_insert_ref`). The table is the reference's (klo,
    khi, occ, row) byte for byte. Returns (int32 table [cap, 4], int64 [1]
    count of occupied slots)."""
    return _insert_ref(lo, hi, cap, None, rows=True)


def _check_probe(table: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> Tuple[int, int]:
    """Check a walk's inputs; returns (cap, n)."""
    _check_halves(lo, hi)
    check_i32(table, lo.device, "table", ndim=2)
    if table.shape[1] != 4:
        raise ValueError("table must be [cap, 4]")
    cap = int(table.shape[0])
    _check_cap(cap, 0)
    return cap, int(lo.shape[0])


def _build(lib, rows: bool, lo: torch.Tensor, hi: torch.Tensor, cap: int,
           mask: Optional[torch.Tensor]):
    """Launch K4 (`rows`) or K6a over checked CUDA inputs; returns (table,
    occupied). On the partitioned route the scatter is launched first
    (`joinmap_build_scatter`), and the table and count are allocated
    while it runs; the kernels write every slot and zero the count (a
    memset first on the direct route, the regions' stores on the
    partitioned one: semijoin.cu, K4's note), so both are allocated
    uninitialised. The scratch is theirs for the call."""
    dev, n = lo.device, int(lo.shape[0])
    if n == 0:
        return (torch.zeros((cap, 4), dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    keep = None if mask is None else mask.data_ptr()
    nscratch = int(lib.joinmap_build_scratch_bytes(n, cap))
    scratch = (torch.empty(nscratch, dtype=torch.uint8, device=dev)
               if nscratch else None)
    if scratch is not None:
        check(lib.joinmap_build_scatter(lo.data_ptr(), hi.data_ptr(), keep,
                                        n, cap, scratch.data_ptr(), stream),
              "joinmap_build_scatter")
    table = torch.empty((cap, 4), dtype=torch.int32, device=dev)
    occupied = torch.empty(1, dtype=torch.int64, device=dev)
    args = (table.data_ptr(), occupied.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
    if rows:
        check(lib.joinmap_build_rows(lo.data_ptr(), hi.data_ptr(), n, cap,
                                     *args), "joinmap_build_rows")
        LAUNCHES.bump("joinmap_build")
    else:
        check(lib.semijoin_set_build(lo.data_ptr(), hi.data_ptr(), keep, n,
                                     cap, *args), "semijoin_set_build")
        LAUNCHES.bump("semijoin_build")
    return table, occupied


def build_rows(lo: torch.Tensor, hi: torch.Tensor, cap: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4. Key -> row map of int32 key halves [n] (row i = key i) in a
    table of `cap` slots; see `build_rows_ref`. Returns the table and the
    occupied count as device tensors (nothing is synced)."""
    dev = lo.device
    if dev.type == "cpu":
        return build_rows_ref(lo, hi, cap)
    if dev.type != "cuda":
        raise RuntimeError(f"joinmap build: no kernel for device {dev}")
    lib = _lib()
    _check_halves(lo, hi)
    _check_cap(cap, int(lo.shape[0]))
    return _build(lib, True, lo, hi, cap, None)


def _walk(table: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """The plain lookup loop: (int32 rows [n], slots visited, distinct
    32-byte sectors read). Each round reads the next slot of every key
    still unresolved; a key resolves at its own slot (its row) or an
    empty one (-1). Two 16-byte slots share a sector."""
    cap = table.shape[0]
    slot = hashing.hash64(lo, hi) & (cap - 1)
    rows = torch.full(lo.shape, -1, dtype=torch.int32, device=lo.device)
    ids = torch.arange(lo.shape[0], device=lo.device)
    read = torch.zeros(max(cap // 2, 1), dtype=torch.bool, device=lo.device)
    visited = 0
    while ids.numel():
        rec = table[slot]
        visited += int(ids.numel())
        read[slot >> 1] = True
        full = rec[:, _STATE] != 0
        hit = full & (rec[:, _LO] == lo) & (rec[:, _HI] == hi)
        rows[ids[hit]] = rec[hit, _ROW]
        go = full & ~hit
        ids, lo, hi = ids[go], lo[go], hi[go]
        slot = (slot[go] + 1) & (cap - 1)
    return rows, visited, int(read.sum())


def lookup_ref(table: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """Plain torch K5: the matched build row of each probe key (int32
    [n]), -1 on a miss."""
    return _walk(table, lo, hi)[0]


def lookup_work(table: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor) -> Tuple[int, int]:
    """K5's (and K6b's: the two walk alike) data-dependent work for these
    probe keys: (slots visited, distinct 32-byte sectors of the table they
    fall in). The sectors are the table bytes the walk must move; a
    revisit may hit in cache."""
    _, visited, sectors = _walk(table, lo, hi)
    return visited, sectors


def lookup(table: torch.Tensor, lo: torch.Tensor,
           hi: torch.Tensor) -> torch.Tensor:
    """K5. Linear-probe lookup of int32 key halves [n] in a `build_rows`
    table; see `lookup_ref`. Returns int32 [n] on the device."""
    dev = lo.device
    if dev.type == "cpu":
        return lookup_ref(table, lo, hi)
    if dev.type != "cuda":
        raise RuntimeError(f"joinmap lookup: no kernel for device {dev}")
    lib = _lib()
    cap, n = _check_probe(table, lo, hi)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    err = lib.joinmap_lookup(
        table.data_ptr(), cap, lo.data_ptr(), hi.data_ptr(), n,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "joinmap_lookup")
    LAUNCHES.bump("joinmap_lookup")
    return out


def joinmap_build(keys: np.ndarray, device="cuda"):
    """Key -> row map of host int64 build keys on `device`. Returns
    (table, occupied): `occupied < len(keys)` iff the keys hold
    duplicates (equal keys dedup into one slot), the join engine's
    signal to join on the host. Two counted uploads (the key halves) and
    one scalar sync (`occupied`). The reference uploads a third array, an
    all-ones mask over its tile padding; K4 takes the row count instead,
    so that upload is gone."""
    keys = np.asarray(keys)
    lo, hi = hashing.key_halves(keys)
    table, occupied = build_rows(dp.to_device(lo, device),
                                 dp.to_device(hi, device),
                                 capacity_for(len(keys)))
    return table, dp.scalar(occupied)


def joinmap_lookup(table: torch.Tensor, keys: np.ndarray) -> np.ndarray:
    """Matched build row per host int64 probe key, as a host int64
    array, -1 on a miss: two counted uploads and one d2h of the rows."""
    lo, hi = hashing.key_halves(np.asarray(keys))
    rows = lookup(table, dp.to_device(lo, table.device),
                  dp.to_device(hi, table.device))
    return dp.to_host(rows).astype(np.int64)


# --------------------------------------------------------------------------
# key set: K6a (build) and K6b (membership probe), and the public semi-join
# --------------------------------------------------------------------------


def set_build_ref(lo: torch.Tensor, hi: torch.Tensor, cap: int,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch K6a: the reference's sequential insert of the rows
    whose `mask` is True (None: every row), the row column left at 0
    (`_insert_ref`). The (lo, hi, state) columns are the reference's
    `build_pallas` (klo, khi, occ) byte for byte. Returns (int32 table
    [cap, 4], int64 [1] count of distinct inserted keys)."""
    return _insert_ref(lo, hi, cap, mask, rows=False)


def set_build(lo: torch.Tensor, hi: torch.Tensor, cap: int,
              mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6a. Key set of the int32 key halves [n] whose `mask` is True (None:
    every row) in a table of `cap` slots; see `set_build_ref`. Returns the
    table and the occupied count as device tensors (nothing is synced)."""
    dev = lo.device
    if dev.type == "cpu":
        return set_build_ref(lo, hi, cap, mask)
    if dev.type != "cuda":
        raise RuntimeError(f"semijoin build: no kernel for device {dev}")
    lib = _lib()
    _check_halves(lo, hi)
    n = int(lo.shape[0])
    if mask is not None:
        check_bool(mask, dev, n, "mask")
    _check_cap(cap, n)
    return _build(lib, False, lo, hi, cap, mask)


def set_probe_ref(table: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor) -> torch.Tensor:
    """Plain torch K6b: is each probe key in the set? bool [n], by K5's
    walk (a set's slots all hold row 0, so a hit is a row >= 0)."""
    return _walk(table, lo, hi)[0] >= 0


def set_probe(table: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """K6b. Membership of int32 key halves [n] in a `set_build` table;
    see `set_probe_ref`. Returns bool [n] on the device."""
    dev = lo.device
    if dev.type == "cpu":
        return set_probe_ref(table, lo, hi)
    if dev.type != "cuda":
        raise RuntimeError(f"semijoin probe: no kernel for device {dev}")
    lib = _lib()
    cap, n = _check_probe(table, lo, hi)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    err = lib.semijoin_set_probe(
        table.data_ptr(), cap, lo.data_ptr(), hi.data_ptr(), n,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "semijoin_set_probe")
    LAUNCHES.bump("semijoin_probe")
    return out


def semijoin_build(keys: np.ndarray, mask: Optional[np.ndarray] = None,
                   device="cuda") -> torch.Tensor:
    """Key set of host int64 keys (those whose `mask` is True) on
    `device`, through K6a: the int32 [cap, 4] table, cap sized for all
    `len(keys)` rows as the reference sizes it. The uploads are plain
    `.to(device)` copies (the reference's `jnp.asarray`), outside
    `DeviceStats`."""
    keys = np.asarray(keys)
    lo, hi = bloom.keys_to_device(keys, device)
    keep = (None if mask is None else
            torch.from_numpy(np.asarray(mask, bool)).to(device))
    return set_build(lo, hi, capacity_for(len(keys)), keep)[0]


def semijoin_probe(table: torch.Tensor, keys: np.ndarray) -> np.ndarray:
    """Membership of host int64 keys in a `semijoin_build` table, through
    K6b, as a host bool array."""
    lo, hi = bloom.keys_to_device(keys, table.device)
    return set_probe(table, lo, hi).cpu().numpy()


def semi_mask(probe_keys: np.ndarray, build_keys: np.ndarray,
              build_mask: Optional[np.ndarray] = None,
              device="cuda") -> np.ndarray:
    """R ⋉ S membership mask over `probe_keys`: is each key among the
    `build_keys` whose `build_mask` is True? K6a then K6b on `device`."""
    return semijoin_probe(semijoin_build(build_keys, build_mask, device),
                          probe_keys)


def reset_launches() -> None:
    LAUNCHES.reset()
