"""Late-materialized, backend-pluggable join runtime (DESIGN.md §8).

Predicate transfer shrinks join *inputs*; this module makes the join
phase itself stop re-materializing them. Two layers:

* **selection-vector cursors** (`JoinCursor`) — a join subtree's
  intermediate result is a set of per-source *selection vectors*
  (int64 row indices into each source leaf, -1 = outer-join NULL)
  composed through the join tree, never a materialized table. Payload
  columns are gathered exactly once, by `materialize()`, at the first
  operator that truly needs values (GroupBy / Project / Sort / a
  non-equi `extra` predicate — and those gather only the columns they
  reference). Keys are the only per-join gather, and per-leaf composite
  keys are computed once per query and shared with the transfer phase
  (`Vertex.raw_keys`, stashed by the strategies and compacted by the
  executor).

* **join-index engines** (`JoinEngine`) — `join_indices(build, probe)`
  with the same backend split as `repro_torch.core.engine_bloom`:

  - ``numpy``  — sort-based build + binary-search probe (the reference
    order every backend must reproduce bit-exactly), with a
    radix-partitioned variant for large build sides: both key vectors
    are partitioned by the top bits of a Fibonacci hash, each partition
    is joined independently, and the output is scattered back into
    global probe order — identical (build_idx, probe_idx) to the sorted
    path because equal keys always share a partition and the
    partition-local stable sort preserves their global relative order;
  - ``cuda``   — the device-resident data plane: every join runs as the
    sorted-segment device join (`repro_torch.kernels.semijoin.ops`),
    duplicate build keys and NULLs included, and returns device index
    vectors, so the cursors' selection vectors stay on the GPU until the
    single payload gather. The plane-off hash-map route (kernels K4/K5)
    is not part of this package yet.

The output contract — probe rows in original order; a probe row's
matches in the build side's stable key order — makes every downstream
float reduction order-deterministic, so query results are bitwise
identical across backends (tests/test_engine_join.py).
"""
from __future__ import annotations

import dataclasses
import threading
import itertools
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Set, \
    Tuple

import numpy as np

from repro_torch.core import faultinject

if TYPE_CHECKING:   # type-only: relational imports this module's engines
    from repro_torch.relational.table import Table

BACKENDS = ("numpy", "cuda")

_FIB64 = np.uint64(0x9E3779B97F4A7C15)


# --------------------------------------------------------------------------
# join-index engines
# --------------------------------------------------------------------------


def sorted_join_indices(build_key: np.ndarray, probe_key: np.ndarray,
                        how: str = "inner"
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Equi-join two int64 key vectors (the reference implementation).

    Returns (build_idx, probe_idx) row-index pairs. ``how``:
      inner  : matched pairs
      left   : every probe row; unmatched get build_idx == -1
               (probe side is the "left"/outer side here)
      semi   : probe rows with >=1 match (probe_idx only; build_idx == -1)
      anti   : probe rows with no match
    """
    order = np.argsort(build_key, kind="stable")
    sorted_key = build_key[order]
    lo = np.searchsorted(sorted_key, probe_key, side="left")
    hi = np.searchsorted(sorted_key, probe_key, side="right")
    counts = hi - lo

    if how == "semi":
        sel = np.flatnonzero(counts > 0)
        return np.full(len(sel), -1, np.int64), sel
    if how == "anti":
        sel = np.flatnonzero(counts == 0)
        return np.full(len(sel), -1, np.int64), sel

    if how == "left":
        out_counts = np.maximum(counts, 1)
    elif how == "inner":
        out_counts = counts
    else:
        raise ValueError(how)

    total = int(out_counts.sum())
    probe_idx = np.repeat(np.arange(len(probe_key), dtype=np.int64),
                          out_counts)
    # offsets within each probe row's match run
    starts = np.zeros(len(out_counts) + 1, np.int64)
    np.cumsum(out_counts, out=starts[1:])
    within = np.arange(total, dtype=np.int64) - starts[probe_idx]
    build_pos = lo[probe_idx] + within
    build_idx = order[np.minimum(build_pos, len(order) - 1)] \
        if len(order) else np.full(total, -1, np.int64)
    if how == "left":
        unmatched = counts[probe_idx] == 0
        build_idx = np.where(unmatched, np.int64(-1), build_idx)
    return build_idx.astype(np.int64), probe_idx


def _partition_ids(keys: np.ndarray, bits: int) -> np.ndarray:
    """Top `bits` of a Fibonacci key hash (one uint64 multiply). Both
    join sides must use the same hash family — equal keys must share a
    partition — and the choice only affects partition *assignment*,
    never the join output."""
    with np.errstate(over="ignore"):
        h = keys.astype(np.uint64) * _FIB64
    return (h >> np.uint64(64 - bits)).astype(np.int32)


def join_partition(build_key: np.ndarray, build_rows: np.ndarray,
                   probe_key: np.ndarray, probe_rows: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray, np.ndarray]:
    """Sorted join of one hash partition; returns the `parts` record
    consumed by `assemble_partitioned_join`: (build_rows, sort_order,
    lo, probe_rows, match_counts). `*_rows` map partition-local
    positions back to global row ids — equal keys always hash to one
    partition and the stable partitioning preserved their global
    relative order, so the assembled output is bit-identical to
    `sorted_join_indices` over the unpartitioned inputs."""
    so = np.argsort(build_key, kind="stable")
    skeys = build_key[so]
    lo = np.searchsorted(skeys, probe_key, side="left")
    c = np.searchsorted(skeys, probe_key, side="right") - lo
    return build_rows, so, lo, probe_rows, c


def assemble_partitioned_join(npr: int, counts: np.ndarray, parts,
                              how: str
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Scatter per-partition join results back into global probe order.

    `counts[probe_row]` is that row's match count; `parts` is a list of
    `join_partition` records. Shared by the single-host radix path and
    the distributed shuffle path (the reference's `engine_join_dist`) — both
    reduce to 'partition, join each partition sorted, scatter back'."""
    if how == "semi":
        sel = np.flatnonzero(counts > 0)
        return np.full(len(sel), -1, np.int64), sel
    if how == "anti":
        sel = np.flatnonzero(counts == 0)
        return np.full(len(sel), -1, np.int64), sel
    if how == "left":
        out_counts = np.maximum(counts, 1)
    elif how == "inner":
        out_counts = counts
    else:
        raise ValueError(how)

    starts = np.zeros(npr + 1, np.int64)
    np.cumsum(out_counts, out=starts[1:])
    total = int(starts[-1])
    probe_idx = np.repeat(np.arange(npr, dtype=np.int64), out_counts)
    build_idx = np.full(total, -1, np.int64)   # left-join unmatched stay -1
    for brows, so, lo, prows, c in parts:
        tot = int(c.sum())
        if tot == 0:
            continue
        rep = np.repeat(np.arange(len(prows), dtype=np.int64), c)
        lst = np.zeros(len(prows) + 1, np.int64)
        np.cumsum(c, out=lst[1:])
        within = np.arange(tot, dtype=np.int64) - lst[rep]
        grows = brows[so[lo[rep] + within]]
        build_idx[starts[prows[rep]] + within] = grows
    return build_idx, probe_idx


def radix_join_indices(build_key: np.ndarray, probe_key: np.ndarray,
                       how: str = "inner", target_rows: int = 8192
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Radix-partitioned build→probe: bit-identical output to
    `sorted_join_indices`, but the build-side sort runs per partition
    (cache-resident) and both sides are split by an O(n) counting sort
    on small-int partition ids."""
    nb, npr = len(build_key), len(probe_key)
    bits = max(1, min(8, int(np.log2(max(nb // target_rows, 2)))))
    nparts = 1 << bits
    pid_b = _partition_ids(build_key, bits)
    pid_p = _partition_ids(probe_key, bits)
    ob = np.argsort(pid_b, kind="stable")      # radix sort on int32
    op = np.argsort(pid_p, kind="stable")
    sb = np.zeros(nparts + 1, np.int64)
    np.cumsum(np.bincount(pid_b, minlength=nparts), out=sb[1:])
    sp = np.zeros(nparts + 1, np.int64)
    np.cumsum(np.bincount(pid_p, minlength=nparts), out=sp[1:])

    counts = np.zeros(npr, np.int64)
    parts = []
    for i in range(nparts):
        pseg = op[sp[i]:sp[i + 1]]
        bseg = ob[sb[i]:sb[i + 1]]
        if pseg.size == 0 or bseg.size == 0:
            continue
        part = join_partition(build_key[bseg], bseg,
                              probe_key[pseg], pseg)
        counts[pseg] = part[-1]
        parts.append(part)
    return assemble_partitioned_join(npr, counts, parts, how)


class JoinEngine:
    """Backend-pluggable `join_indices`."""

    backend = "base"

    def join_indices(self, build_key: np.ndarray, probe_key: np.ndarray,
                     how: str = "inner"
                     ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def join_indices_valid(self, build_key: np.ndarray,
                           probe_key: np.ndarray, how: str = "inner",
                           build_valid: Optional[np.ndarray] = None,
                           probe_valid: Optional[np.ndarray] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """`join_indices` under the engine NULL contract: rows flagged
        invalid never match. Inner/semi drop NULL-key probe rows, left
        emits them unmatched (build_idx == -1), anti keeps them;
        NULL-key build rows never appear in the output. Output order is
        the standard contract (probe rows in original order).

        Default implementation: compact invalid rows out, run the
        backend's all-valid fast path, remap indices back to the
        caller's row space. Engines for which host-global compaction is
        wrong (the distributed runtime) override this."""
        if build_valid is not None and bool(build_valid.all()):
            build_valid = None
        if probe_valid is not None and bool(probe_valid.all()):
            probe_valid = None
        bkeep = None
        if build_valid is not None:
            bkeep = np.flatnonzero(build_valid)
            build_key = build_key[bkeep]
        if probe_valid is None:
            bidx, pidx = self.join_indices(build_key, probe_key, how=how)
        else:
            pkeep = np.flatnonzero(probe_valid)
            bidx, pidx = self.join_indices(build_key, probe_key[pkeep],
                                           how=how)
            pidx = pkeep[pidx]
            dead = np.flatnonzero(~probe_valid)
            if how in ("left", "anti") and dead.size:
                # unmatched NULL-key probe rows re-enter in probe order
                bidx = np.concatenate([bidx,
                                       np.full(dead.size, -1, np.int64)])
                pidx = np.concatenate([pidx, dead])
                order = np.argsort(pidx, kind="stable")
                bidx, pidx = bidx[order], pidx[order]
        if bkeep is not None and len(bidx) and bkeep.size:
            # (an all-invalid build leaves bidx all -1 — nothing to remap)
            neg = bidx < 0
            if neg.any():
                bidx = np.where(neg, np.int64(-1),
                                bkeep[np.where(neg, 0, bidx)])
            else:
                bidx = bkeep[bidx]
        return bidx, pidx


#: sorted-vs-radix crossover of the host join, the reference package's
#: value (its own join-crossover sweep on its host). Both paths give
#: bit-identical output, so the value only moves time; re-tune it with
#: the port's bench harness (ROADMAP Queue 1 item 6).
RADIX_MIN = 1 << 18


class NumpyJoinEngine(JoinEngine):
    """Host path: sorted reference below `radix_min` build rows, the
    radix-partitioned variant above."""

    backend = "numpy"

    def __init__(self, radix_min: int = RADIX_MIN):
        self.radix_min = radix_min

    def join_indices(self, build_key, probe_key, how="inner"):
        faultinject.fire("join.indices")
        if len(build_key) >= self.radix_min and len(probe_key):
            return radix_join_indices(build_key, probe_key, how)
        return sorted_join_indices(build_key, probe_key, how)


class CudaJoinEngine(JoinEngine):
    """Device-resident joins: with the data plane on, every join goes
    through the sorted-segment device join
    (`kernels.semijoin.ops.segment_join_device`), which joins duplicate
    build keys natively, handles the NULL contract by zeroing match
    counts instead of the host compact-and-remap, and returns *device*
    index vectors. Empty sides go to the host engine. On a CPU device
    (tests only) the same torch ops run on the CPU."""

    backend = "cuda"

    def __init__(self, device_resident: Optional[bool] = None,
                 device="cuda"):
        from repro_torch.core import device_plane
        self.device = device_plane.resolve_device(device)
        if device_resident is None:
            device_resident = self.device.type == "cuda"
        if not device_resident:
            raise NotImplementedError(
                "the cuda join engine runs only with the device-resident "
                "data plane; the plane-off hash-map route (kernels K4/K5) "
                "is ROADMAP Queue 1, next slice")
        self.device_resident = True
        self._host = NumpyJoinEngine()

    def join_indices(self, build_key, probe_key, how="inner"):
        if len(build_key) == 0 or len(probe_key) == 0:
            return self._host.join_indices(build_key, probe_key, how)
        faultinject.fire("join.indices")
        from repro_torch.kernels.semijoin import ops as sj
        return sj.segment_join_device(build_key, probe_key, how,
                                      device=self.device)

    def join_indices_valid(self, build_key, probe_key, how="inner",
                           build_valid=None, probe_valid=None):
        if len(build_key) == 0 or len(probe_key) == 0:
            return self._host.join_indices_valid(
                build_key, probe_key, how, build_valid, probe_valid)
        if build_valid is not None and bool(np.asarray(build_valid).all()):
            build_valid = None
        if probe_valid is not None and bool(np.asarray(probe_valid).all()):
            probe_valid = None
        faultinject.fire("join.indices")
        from repro_torch.kernels.semijoin import ops as sj
        return sj.segment_join_device(build_key, probe_key, how,
                                      build_valid, probe_valid,
                                      device=self.device)


_ENGINES: Dict[Tuple, JoinEngine] = {}
_ENGINES_LOCK = threading.Lock()


def get_join_engine(backend: str = "numpy",
                    device_resident: Optional[bool] = None,
                    device="cuda") -> JoinEngine:
    """Engine instances are cached per (backend, plane, device) and
    created under a lock, so concurrent sessions share one instance
    (mirrors `engine_bloom.get_engine`).

    ``device`` is where the ``cuda`` engine runs (``"cpu"`` for tests;
    a CUDA device without CUDA raises RuntimeError);
    ``device_resident=None`` resolves to on for a CUDA device. The
    numpy engine has no device path and ignores both."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown join backend {backend!r}; "
                         f"choose from {BACKENDS}")
    if backend == "numpy":
        key = (backend, None, None)
    else:
        from repro_torch.core import device_plane
        dev = device_plane.resolve_device(device)
        key = (backend, device_resident, str(dev))
    with _ENGINES_LOCK:
        eng = _ENGINES.get(key)
        if eng is None:
            if backend == "numpy":
                eng = NumpyJoinEngine()
            else:
                eng = CudaJoinEngine(device_resident=device_resident,
                                     device=dev)
            _ENGINES[key] = eng
    return eng


# --------------------------------------------------------------------------
# selection-vector cursors
# --------------------------------------------------------------------------

_slot_ids = itertools.count()


@dataclasses.dataclass
class Slot:
    """One join source (a reduced leaf, or a materialized intermediate
    wrapped as a pseudo-leaf). `keys` caches composite join keys over
    the *full* slot table — computed once per query per column set,
    seeded from the transfer phase where possible."""

    table: Table
    keys: Dict[Tuple[str, ...], np.ndarray] = dataclasses.field(
        default_factory=dict)
    sid: int = dataclasses.field(default_factory=lambda: next(_slot_ids))

    def key(self, cols: Tuple[str, ...]) -> np.ndarray:
        k = self.keys.get(cols)
        if k is None:
            from repro_torch.relational import ops
            k = ops.composite_key(self.table, cols)
            self.keys[cols] = k
        return k


def _compose(sel: Optional[np.ndarray], idx: np.ndarray,
             idx_host: Optional[np.ndarray] = None) -> np.ndarray:
    """sel∘idx for non-negative idx (sel may carry -1 NULLs, preserved).

    Either operand may be a device array (the device-resident join
    path). A device sel composes with a device idx on device and stays
    resident; a *host* sel composes on host against `idx_host` — one
    downloaded copy of the device index vector, shared by every host
    slot of the join side — because host sels are headed for a host
    gather anyway, and a single d2h beats one h2d upload per slot plus
    the later sync back."""
    if sel is None:
        return idx
    host_sel = isinstance(sel, np.ndarray)
    host_idx = isinstance(idx, np.ndarray)
    if host_sel and not host_idx:
        if idx_host is None:
            from repro_torch.core import device_plane
            idx_host = device_plane.to_host(idx).astype(np.int64)
        return sel[idx_host]
    if not host_sel and host_idx:
        import torch
        from repro_torch.core import device_plane
        device_plane.count_h2d(idx.nbytes)
        idx = torch.from_numpy(idx).to(sel.device)
    return sel[idx]


def _compose_nullable(sel: Optional[np.ndarray], idx: np.ndarray,
                      idx_host: Optional[np.ndarray] = None
                      ) -> np.ndarray:
    """sel∘idx where idx == -1 rows stay NULL.

    NULL rows keep -1 through composition and materialize with
    `valid=False` and a clipped row-0 *representative* payload. The
    validity mask is the authoritative NULL signal (the engine's NULL
    contract, `relational.table`); the representative byte values are
    unspecified and may differ from the eager chain's (which clips into
    whatever intermediate table existed at its join). Device/host
    operand placement follows `_compose`."""
    if sel is None:
        return idx
    host_sel = isinstance(sel, np.ndarray)
    host_idx = isinstance(idx, np.ndarray)
    if host_sel and not host_idx:
        if idx_host is None:
            from repro_torch.core import device_plane
            idx_host = device_plane.to_host(idx).astype(np.int64)
        idx, host_idx = idx_host, True
    if host_sel and host_idx:
        if len(sel) == 0:
            # outer join against a side filtered to zero rows: every idx
            # is -1 (there was nothing to match), so every row is NULL
            return np.full(len(idx), -1, np.int64)
        neg = idx < 0
        out = sel[np.where(neg, 0, idx)]
        return np.where(neg, np.int64(-1), out)
    import torch
    from repro_torch.core import device_plane
    if len(sel) == 0:
        return torch.full((len(idx),), -1, dtype=torch.int32,
                          device=sel.device)
    if host_idx:
        device_plane.count_h2d(idx.nbytes)
        idx = torch.from_numpy(idx).to(sel.device)
    neg = idx < 0
    out = sel[torch.where(neg, 0, idx)]
    return torch.where(neg, -1, out).to(torch.int32)


def _host_idx_for(sel_map: Dict[int, Optional[np.ndarray]],
                  idx) -> Optional[np.ndarray]:
    """One host copy of a device join-index vector, made only when some
    slot's sel is host-resident and will need it (`_compose`)."""
    if isinstance(idx, np.ndarray):
        return idx
    if any(isinstance(s, np.ndarray) for s in sel_map.values()):
        from repro_torch.core import device_plane
        return device_plane.to_host(idx).astype(np.int64)
    return None


class JoinCursor:
    """A join subtree's result as selection vectors over its slots.

    `cols` fixes the output column order — probe-side columns first,
    then build-side columns not shadowed by the probe side — matching
    the materializing `ops.hash_join` exactly."""

    __slots__ = ("slots", "sel", "cols", "colmap", "nullable", "nrows",
                 "name", "srcnames")

    def __init__(self, slots: Dict[int, Slot],
                 sel: Dict[int, Optional[np.ndarray]],
                 cols: List[Tuple[str, int]], nullable: Set[int],
                 nrows: int, name: str,
                 srcnames: Optional[Dict[str, str]] = None):
        self.slots = slots
        self.sel = sel
        self.cols = cols
        self.colmap = {n: sid for n, sid in cols}
        self.nullable = nullable
        self.nrows = nrows
        self.name = name
        # output-name -> slot-column-name indirection (identity when
        # absent): a pure-rename Project stays a cursor, its payload
        # still ungathered (`project()`)
        self.srcnames = srcnames or None

    def _src(self, n: str) -> str:
        """Slot column name behind output column `n`."""
        if self.srcnames:
            return self.srcnames.get(n, n)
        return n

    # -- constructors --------------------------------------------------
    @staticmethod
    def from_slot(slot: Slot) -> "JoinCursor":
        cols = [(n, slot.sid) for n in slot.table.names]
        return JoinCursor({slot.sid: slot}, {slot.sid: None}, cols,
                          set(), len(slot.table), slot.table.name)

    @staticmethod
    def from_table(table: Table) -> "JoinCursor":
        return JoinCursor.from_slot(Slot(table))

    def __len__(self) -> int:
        return self.nrows

    # -- row selection -------------------------------------------------
    def take(self, idx: np.ndarray) -> "JoinCursor":
        """Rows by position (idx >= 0)."""
        idx_h = _host_idx_for(self.sel, idx)
        sel = {sid: _compose(s, idx, idx_h) for sid, s in self.sel.items()}
        return JoinCursor(self.slots, sel, self.cols,
                          set(self.nullable), len(idx), self.name,
                          srcnames=self.srcnames)

    def project(self, mapping: Dict[str, str]) -> "JoinCursor":
        """Column projection/rename without materialization:
        `mapping` = {output name: current column name}. Selection
        vectors and slots are shared; passthrough payloads stay
        ungathered, resolved through `srcnames` at first value use."""
        cols = []
        srcn = {}
        for out, src in mapping.items():
            sid = self.colmap[src]
            cols.append((out, sid))
            s = self._src(src)
            if s != out:
                srcn[out] = s
        return JoinCursor(self.slots, self.sel, cols,
                          set(self.nullable), self.nrows, self.name,
                          srcnames=srcn or None)

    # -- column access -------------------------------------------------
    def _sel_host(self, sid: int) -> Optional[np.ndarray]:
        """Host view of one selection vector. Device selections (the
        device-resident join path) sync exactly once here — at the
        payload-gather / key-read boundary — and the host copy is cached
        back so repeated readers pay no further syncs."""
        s = self.sel[sid]
        if s is not None and not isinstance(s, np.ndarray):
            from repro_torch.core import device_plane
            s = device_plane.to_host(s).astype(np.int64)
            self.sel[sid] = s
        return s

    def _sel_safe(self, sid: int) -> Optional[np.ndarray]:
        """Selection vector with NULL rows clipped to row 0 — the same
        representative-row semantics a chain of `Column.gather` calls
        produces for materialized NULLs."""
        s = self._sel_host(sid)
        if s is not None and sid in self.nullable:
            return np.where(s < 0, 0, s)
        return s

    def key(self, names: Sequence[str]) -> np.ndarray:
        """Composite int64 join key over the cursor's current rows."""
        from repro_torch.relational import ops
        names = tuple(names)
        sids = {self.colmap[n] for n in names}
        snames = tuple(self._src(n) for n in names)
        if (len(sids) == 1
                and ops.stable_key_encoding(
                    self.slots[next(iter(sids))].table, snames)):
            # cached full-slot composite, row-sliced — valid only when
            # the packed-vs-mixed decision cannot flip under filtering
            # (otherwise recompute below from the gathered view, as the
            # eager oracle effectively does)
            sid = sids.pop()
            raw = self.slots[sid].key(snames)
            s = self._sel_safe(sid)
            if s is None:
                return raw
            if len(raw) == 0:
                # every row is an outer-join NULL against an empty build
                # side; the eager chain gathers zero-filled columns there
                return np.zeros(len(s), np.int64)
            return raw[s]
        # key columns from different sources (e.g. Q5's
        # (l_suppkey, c_nationkey)) or an encoding-unstable column set:
        # gather each column, then combine
        return ops.composite_key(self.columns_view(names), names)

    def key_valid(self, names: Sequence[str]) -> Optional[np.ndarray]:
        """Rows whose key columns are all non-NULL (None = every row).
        NULL rows carry clipped representative bytes in `key`, so join
        matching must exclude them (`ops.join_indices_nullsafe`) — in
        both this runtime and the eager oracle, NULL keys never match."""
        out = None
        for n in names:
            sid = self.colmap[n]
            col = self.slots[sid].table[self._src(n)]
            cv = None
            if col.valid is not None and len(col):
                s = self._sel_safe(sid)
                cv = col.valid if s is None else col.valid[s]
            s = self._sel_host(sid)
            if sid in self.nullable and s is not None:
                nn = s >= 0
                cv = nn if cv is None else cv & nn
            if cv is not None:
                out = cv if out is None else out & cv
        return out

    def columns_view(self, names: Sequence[str]) -> "Table":
        """Thin materialization of just `names` (expression inputs)."""
        from repro_torch.relational.table import Table
        cols = {}
        for n in names:
            sid = self.colmap[n]
            c = self.slots[sid].table[self._src(n)]
            s = self._sel_host(sid)
            cols[n] = c if s is None else c.gather(s)
        return Table(cols, self.name)

    # -- composition ---------------------------------------------------
    @staticmethod
    def join(probe: "JoinCursor", build: "JoinCursor",
             build_idx: np.ndarray, probe_idx: np.ndarray,
             how: str) -> "JoinCursor":
        slots = dict(probe.slots)
        pidx_h = _host_idx_for(probe.sel, probe_idx)
        sel = {sid: _compose(s, probe_idx, pidx_h)
               for sid, s in probe.sel.items()}
        nullable = set(probe.nullable)
        cols = list(probe.cols)
        if how in ("inner", "left"):
            null_build = how == "left"
            bidx_h = _host_idx_for(build.sel, build_idx)
            for sid, slot in build.slots.items():
                slots[sid] = slot
                if null_build:
                    sel[sid] = _compose_nullable(build.sel[sid],
                                                 build_idx, bidx_h)
                    nullable.add(sid)
                else:
                    sel[sid] = _compose(build.sel[sid], build_idx,
                                        bidx_h)
                    if sid in build.nullable:
                        nullable.add(sid)
            cols += [(n, sid) for n, sid in build.cols
                     if n not in probe.colmap]
        # semi/anti keep probe columns only (as hash_join does)
        # probe's rename wins on output-name collision — colliding build
        # columns are dropped from `cols` above
        srcn = {**(build.srcnames or {}), **(probe.srcnames or {})}
        return JoinCursor(slots, sel, cols, nullable, len(probe_idx),
                          probe.name, srcnames=srcn or None)

    # -- materialization ----------------------------------------------
    def gather_bytes(self, names: Optional[Sequence[str]] = None) -> int:
        """Upper estimate of the bytes `materialize(names)` will gather
        (rows × row bytes over the columns that actually need a
        gather), computable *before* any allocation — the executor's
        pre-gather memory-budget guard reads this (DESIGN.md §13)."""
        keep = None if names is None else set(names)
        total = 0
        for n, sid in self.cols:
            if keep is not None and n not in keep:
                continue
            if self.sel[sid] is None:
                continue
            total += (self.nrows
                      * self.slots[sid].table[self._src(n)].data.itemsize)
        return total

    def materialize(self, names: Optional[Sequence[str]] = None
                    ) -> Tuple["Table", int]:
        """Gather payload columns once (all of them, or just `names` for
        an operator that only reads a subset). Returns
        (table, gathered_bytes) — the join phase's materialization
        traffic."""
        from repro_torch.relational.table import Table
        faultinject.fire("gather.payload")
        keep = None if names is None else set(names)
        cols = {}
        nbytes = 0
        for n, sid in self.cols:
            if keep is not None and n not in keep:
                continue
            c = self.slots[sid].table[self._src(n)]
            s = self._sel_host(sid)
            if s is not None:
                c = c.gather(s)
                nbytes += c.data.nbytes
            cols[n] = c
        return Table(cols, self.name), nbytes
