"""Cross-query transfer-artifact cache (DESIGN.md §12).

A thread-safe, byte-bounded cache shared by every executor a serving
session runs. Three artifact kinds live here, distinguished by the
first element of the key tuple:

* ``("bloom", filter_sig)`` — Bloom filter words (+ optional min-max
  range) built from a provenance-signed survivor state
  (`repro_torch.core.provenance.filter_sig`); reusable across queries,
  aliases, strategies with equal filter params, and engine backends
  (all backends build bit-identical words);
* ``("minmax", sig)`` — standalone min-max ranges;
* ``("slots", plan_fp, catalog_sig, strategy_sig)`` — a whole query's
  post-transfer slot state (compacted leaf tables + composite join
  keys), the scan+transfer phases' full output.

Every entry records the set of `Table.version` numbers it was derived
from; `invalidate_versions` (or `invalidate_all`) is the explicit
invalidation hook for table replacement. The keys are self-certifying
(a signature can only be recomputed from the same inputs) — that covers
*which* artifact an entry is, but not whether its bytes are still the
ones that were stored. Hits therefore **verify on read** (DESIGN.md
§13): `put` records content checksums (`content_checksum` — md5 over
the value's structure, with large arrays sampled so a hit stays O(1)
in entry size), and `get` recomputes and compares one. A mismatch —
bit rot, an in-place mutation bug, or an injected
``cache.deserialize`` fault — drops the entry, bumps the `corruptions`
counter, and reports a miss, so a poisoned entry self-heals by
recompute instead of serving wrong bytes. `verify_on_hit=False` turns
the guard off for benchmarking the bare lookup.

Sampling rotates (DESIGN.md §16): a fixed head+tail sample would never
see mid-buffer corruption of a large artifact, so arrays past the
full-hash threshold additionally contribute one **seeded mid-buffer
window**, its offset stratified across the interior by a seed in
``range(_VERIFY_SEEDS)``. `put` stores the checksum for every seed;
each `get` verifies the seed picked by the entry's own hit counter
(deterministic rotation), so corruption anywhere in the first
``_FULL_HASH_BYTES + _VERIFY_SEEDS * _SAMPLE_BYTES`` bytes of an array
is caught within at most `_VERIFY_SEEDS` hits while each individual
hit still hashes O(`_SAMPLE_BYTES`). Values with no large arrays store
a single checksum (every seed hashes identical bytes).

Eviction is cost-to-rebuild weighted LRU, not pure LRU: `put` records
`cost_ns` — the measured (or `TransferCosts`-estimated) time the
artifact took to build — and when the byte budget overflows, the cache
scans a small window at the LRU end and drops the entry with the
lowest rebuild cost per byte. A huge-but-instant artifact yields before
a small-but-expensive one of similar staleness; recency still bounds
the scan so a hot expensive entry is never at risk.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import faultinject

#: arrays at most this big are hashed in full ...
_FULL_HASH_BYTES = 64 << 10
#: ... larger ones contribute head + tail samples of this size (plus
#: dtype/shape), bounding verify cost per hit regardless of entry size
_SAMPLE_BYTES = 32 << 10
#: eviction scans this many entries at the LRU end and drops the one
#: cheapest to rebuild per byte (cost-to-rebuild weighted LRU)
_EVICT_WINDOW = 8
#: rotating verify-on-hit seeds: each adds one stratified mid-buffer
#: sample window to large-array checksums (seed = hits % _VERIFY_SEEDS)
_VERIFY_SEEDS = 4


def _hash_array(h, a: np.ndarray, seed: int, big) -> None:
    h.update(f"nd:{a.dtype.str}:{a.shape}".encode())
    a = np.ascontiguousarray(a)
    if a.nbytes <= _FULL_HASH_BYTES:
        h.update(a.tobytes())
        return
    big[0] = True
    flat = a.reshape(-1).view(np.uint8)
    h.update(flat[:_SAMPLE_BYTES].tobytes())
    h.update(flat[-_SAMPLE_BYTES:].tobytes())
    # seeded mid-buffer window: offsets stratified evenly across the
    # interior, so the _VERIFY_SEEDS windows tile it contiguously for
    # interiors up to _VERIFY_SEEDS * _SAMPLE_BYTES
    span = flat.size - 2 * _SAMPLE_BYTES
    if span > 0:
        win = min(span, _SAMPLE_BYTES)
        step = (span - win) // max(_VERIFY_SEEDS - 1, 1)
        off = _SAMPLE_BYTES + (seed % _VERIFY_SEEDS) * step
        h.update(flat[off:off + win].tobytes())


def _hash_value(h, v, seed: int, big) -> None:
    """Structural walk over the artifact kinds the cache stores: bloom
    word/range arrays, slot tuples of (Table, key dict), TransferStats
    snapshots. Dataclasses hash their declared fields only (lazy caches
    like `Column._vrange` appear after `put` and must not flip the
    checksum); dict items hash in sorted key order. `big[0]` flips to
    True when any array was sampled (its checksum is seed-dependent)."""
    if v is None:
        h.update(b"\x00N")
    elif isinstance(v, np.ndarray):
        _hash_array(h, v, seed, big)
    elif isinstance(v, torch.Tensor):
        raise TypeError(
            "artifact cache values are host values: got a torch.Tensor "
            f"on {v.device} (download it before caching)")
    elif isinstance(v, (bool, int, float, str, bytes)):
        h.update(f"{type(v).__name__}:{v!r}".encode())
    elif isinstance(v, (tuple, list)):
        h.update(f"seq:{len(v)}".encode())
        for item in v:
            _hash_value(h, item, seed, big)
    elif isinstance(v, (dict,)):
        h.update(f"map:{len(v)}".encode())
        for k in sorted(v, key=repr):
            h.update(repr(k).encode())
            _hash_value(h, v[k], seed, big)
    elif isinstance(v, (set, frozenset)):
        h.update(f"set:{len(v)}".encode())
        for item in sorted(v, key=repr):
            h.update(repr(item).encode())
    elif dataclasses.is_dataclass(v):
        h.update(f"dc:{type(v).__name__}".encode())
        for f in dataclasses.fields(v):
            h.update(f.name.encode())
            _hash_value(h, getattr(v, f.name), seed, big)
    elif hasattr(v, "columns") and isinstance(v.columns, dict):
        # Table (duck-typed: core must not import relational)
        h.update(f"tbl:{type(v).__name__}:{getattr(v, 'name', '')}"
                 .encode())
        _hash_value(h, v.columns, seed, big)
    else:
        h.update(f"obj:{type(v).__name__}:{v!r}".encode())


def content_checksum(value, seed: int = 0) -> str:
    """Sampled-md5 content digest of a cache value (hex). `seed`
    selects which stratified mid-buffer window large arrays contribute
    (values without large arrays hash identically for every seed)."""
    h = hashlib.md5()
    _hash_value(h, value, seed, [False])
    return h.hexdigest()


def content_checksums(value) -> Tuple[str, ...]:
    """The per-seed checksum tuple `put` stores: one entry when no
    array needed sampling, `_VERIFY_SEEDS` entries otherwise."""
    big = [False]
    h = hashlib.md5()
    _hash_value(h, value, 0, big)
    first = h.hexdigest()
    if not big[0]:
        return (first,)
    return (first,) + tuple(content_checksum(value, s)
                            for s in range(1, _VERIFY_SEEDS))


class ArtifactCache:
    """Byte-bounded LRU over provenance-keyed transfer artifacts."""

    def __init__(self, max_bytes: int = 256 << 20,
                 verify_on_hit: bool = True):
        self.max_bytes = int(max_bytes)
        self.verify_on_hit = verify_on_hit
        self._lock = threading.Lock()
        # key -> (value, nbytes, versions, checksums, cost_ns, hits)
        # checksums: per-seed tuple (or None when verify is off);
        # hits: one-int list, the entry's verify-seed rotation counter
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._bytes = 0
        self._by_version: Dict[int, Set[tuple]] = {}
        self._hits: Dict[str, int] = {}
        self._misses: Dict[str, int] = {}
        self._puts: Dict[str, int] = {}
        self._evictions = 0
        self._invalidated = 0
        self._corruptions = 0

    # -- core ----------------------------------------------------------
    def get(self, key: tuple):
        kind = key[0]
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self._misses[kind] = self._misses.get(kind, 0) + 1
                return None
            self._entries.move_to_end(key)
        value, _, _, stored, _, hits = ent
        if self.verify_on_hit:
            # outside the lock: verify cost must not serialize
            # concurrent warm hits across worker threads
            try:
                faultinject.fire("cache.deserialize")
                if stored is None:
                    ok = True
                else:
                    # rotate the sampled window per hit so mid-buffer
                    # corruption of a large artifact is caught within
                    # _VERIFY_SEEDS hits (int append under the GIL;
                    # a racing hit at worst repeats a seed)
                    seed = hits[0] % len(stored)
                    hits[0] += 1
                    ok = content_checksum(value, seed) == stored[seed]
            except faultinject.InjectedFault:
                ok = False
            if not ok:
                # self-heal: drop the poisoned entry (unless a racing
                # put already replaced it) and report a miss — the
                # caller recomputes and re-stores good bytes
                with self._lock:
                    if self._entries.get(key) is ent:
                        self._entries.pop(key)
                        self._bytes -= ent[1]
                        self._unindex(key, ent[2])
                    self._corruptions += 1
                    self._misses[kind] = self._misses.get(kind, 0) + 1
                return None
        with self._lock:
            self._hits[kind] = self._hits.get(kind, 0) + 1
        return value

    def put(self, key: tuple, value, nbytes: int,
            versions: Iterable[int] = (),
            cost_ns: Optional[int] = None) -> None:
        """Store `value` under `key`. `cost_ns` is the time the artifact
        took to build (measured, or estimated from calibrated
        `TransferCosts` coefficients) — it weights eviction so expensive
        artifacts outlive cheap ones of equal staleness. None means
        unknown, treated as free to rebuild (evicted first)."""
        kind = key[0]
        versions = frozenset(int(v) for v in versions)
        nbytes = int(nbytes)
        if nbytes > self.max_bytes:
            return                       # would evict everything else
        checksums = content_checksums(value) if self.verify_on_hit \
            else None
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
                self._unindex(key, old[2])
            self._entries[key] = (value, nbytes, versions, checksums,
                                  None if cost_ns is None else int(cost_ns),
                                  [0])
            self._bytes += nbytes
            for v in versions:
                self._by_version.setdefault(v, set()).add(key)
            self._puts[kind] = self._puts.get(kind, 0) + 1
            while self._bytes > self.max_bytes and self._entries:
                k = self._evict_candidate()
                _, nb, vers, _, _, _ = self._entries.pop(k)
                self._bytes -= nb
                self._unindex(k, vers)
                self._evictions += 1

    def _evict_candidate(self) -> tuple:
        """Among the `_EVICT_WINDOW` least-recently-used entries, the
        one with the lowest rebuild cost per byte; ties keep LRU order
        (oldest wins). Lock held by caller."""
        best_k = None
        best = None
        for i, (k, ent) in enumerate(self._entries.items()):
            if i >= _EVICT_WINDOW:
                break
            cost = ent[4]
            density = 0.0 if cost is None else cost / max(ent[1], 1)
            if best is None or density < best:
                best, best_k = density, k
        return best_k

    def _unindex(self, key: tuple, versions: frozenset) -> None:
        for v in versions:
            s = self._by_version.get(v)
            if s is not None:
                s.discard(key)
                if not s:
                    del self._by_version[v]

    # -- invalidation --------------------------------------------------
    def invalidate_versions(self, versions: Iterable[int]) -> int:
        """Drop every artifact derived from any of these table versions
        (call when a catalog table is replaced). Returns drop count."""
        dropped = 0
        with self._lock:
            keys: Set[tuple] = set()
            for v in versions:
                keys |= self._by_version.get(int(v), set())
            for k in keys:
                ent = self._entries.pop(k, None)
                if ent is not None:
                    self._bytes -= ent[1]
                    self._unindex(k, ent[2])
                    dropped += 1
            self._invalidated += dropped
        return dropped

    def invalidate_table(self, table) -> int:
        return self.invalidate_versions([table.version])

    def invalidate_all(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._by_version.clear()
            self._bytes = 0
            self._invalidated += n
        return n

    # -- snapshot/restore (DESIGN.md §16) ------------------------------
    def export_entries(self) -> list:
        """LRU-ordered (key, value, nbytes, versions, checksums,
        cost_ns) rows for `repro_torch.serve.snapshot` serialization."""
        with self._lock:
            return [(k, e[0], e[1], e[2], e[3], e[4])
                    for k, e in self._entries.items()]

    def absorb(self, rows) -> Tuple[int, int]:
        """Re-admit exported rows (a restored snapshot). Each value's
        stored checksum is **re-verified** before admission — a row
        whose bytes no longer match its provenance-era checksum is
        dropped and counted as a corruption, never served. Returns
        (kept, dropped)."""
        kept = dropped = 0
        for key, value, nbytes, versions, checksums, cost_ns in rows:
            if checksums is not None \
                    and content_checksum(value, 0) != checksums[0]:
                with self._lock:
                    self._corruptions += 1
                dropped += 1
                continue
            self.put(key, value, nbytes=nbytes, versions=versions,
                     cost_ns=cost_ns)
            kept += 1
        return kept, dropped

    # -- introspection -------------------------------------------------
    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def hit_count(self, kind: Optional[str] = None) -> int:
        with self._lock:
            if kind is None:
                return sum(self._hits.values())
            return self._hits.get(kind, 0)

    @property
    def corruptions(self) -> int:
        """Entries dropped by verify-on-hit (each healed by recompute)."""
        return self._corruptions

    def snapshot(self) -> dict:
        with self._lock:
            kinds = sorted(set(self._hits) | set(self._misses)
                           | set(self._puts))
            per = {}
            for k in kinds:
                h = self._hits.get(k, 0)
                m = self._misses.get(k, 0)
                per[k] = {"hits": h, "misses": m,
                          "puts": self._puts.get(k, 0),
                          "hit_rate": h / max(h + m, 1)}
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "max_bytes": self.max_bytes,
                    "evictions": self._evictions,
                    "invalidated": self._invalidated,
                    "corruptions": self._corruptions, "kinds": per}
