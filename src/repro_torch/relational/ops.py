"""Physical relational operators (host-vectorized numpy).

The engine's dynamic-cardinality control plane runs on host; the bulk
per-row math (Bloom build/probe/transfer, hash-table membership) is
delegated to `repro_torch.core` / `repro_torch.kernels`, which run on
the GPU. This split mirrors a production engine: fixed-shape inner
loops on the accelerator, dynamic-shape compaction at operator
boundaries.

Equi-joins are sort-based (sort the build side once, binary-search the
probe side, expand duplicates with prefix sums) — fully vectorized, and
the build/probe row counts reported to the executor match the paper's
HT/PR accounting.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.relational.table import Column, Table

# --------------------------------------------------------------------------
# key handling
# --------------------------------------------------------------------------


def composite_key(table: Table, names: Sequence[str]) -> np.ndarray:
    """Combine one or more integer key columns into a single int64 key.

    The encoding must be *canonical* (independent of the table instance):
    both sides of a join — and both endpoints of a transfer edge — encode
    the same logical key to the same int64 even after arbitrary filtering.
    Two-column keys with values in [0, 2^31) are packed loss-lessly as
    (a << 32) | b; anything else falls back to a 64-bit hash-combine
    (exactness then relies on the mix being collision-free over the key
    domain; TPC-H and the curation pipeline always take the packed path).
    """
    if len(names) == 1:
        return table.array(names[0]).astype(np.int64, copy=False)
    cols = [table[n] for n in names]
    arrays = [c.data.astype(np.int64, copy=False) for c in cols]
    if len(arrays) == 2:
        a, b = arrays
        if _packable(cols[0]) and _packable(cols[1]):
            return (a << np.int64(32)) | b
    # hash-combine fallback (canonical, vanishing collision probability)
    key = arrays[0].copy()
    for a in arrays[1:]:
        key = key * np.int64(-7046029254386353131) + a  # 64-bit mix
    return key


# --------------------------------------------------------------------------
# joins
# --------------------------------------------------------------------------


def _packable(c) -> bool:
    """Can this column take composite_key's packed path?

    Cached lineage bounds first (O(1) after the first touch of a base
    buffer); they are conservative, so when they fail the test, fall
    back to this buffer's exact range — the packed-vs-mixed decision
    must depend on the values actually present, or two sides holding
    identical key sets could encode differently and silently never
    match."""
    lo, hi = c.value_range()
    if lo >= 0 and hi < 2**31:
        return True
    lo, hi = c.exact_value_range()
    return lo >= 0 and hi < 2**31


def stable_key_encoding(table: Table, names: Sequence[str]) -> bool:
    """True iff `composite_key(table, names)` row-sliced equals
    `composite_key` recomputed on any row subset of `table` — i.e. the
    encoding decision cannot flip under filtering. Single columns and
    3+-column keys encode value-wise (always stable); a 2-column key is
    stable when it packs on the full table (subsets inherit the bounds
    and pack too). The executor uses this to decide whether the transfer
    phase's keys may seed the join runtime's per-slot cache."""
    if len(names) != 2:
        return True
    return _packable(table[names[0]]) and _packable(table[names[1]])


def join_indices(build_key: np.ndarray, probe_key: np.ndarray,
                 how: str = "inner") -> Tuple[np.ndarray, np.ndarray]:
    """Equi-join two key vectors.

    Returns (build_idx, probe_idx) row-index pairs. ``how``:
      inner  : matched pairs
      left   : every probe row; unmatched get build_idx == -1
               (probe side is the "left"/outer side here)
      semi   : probe rows with >=1 match (probe_idx only; build_idx == -1)
      anti   : probe rows with no match

    Delegates to the host join engine (`repro_torch.core.engine_join`): the
    sorted reference below the radix threshold, the radix-partitioned
    path above it — bit-identical outputs either way.
    """
    from repro_torch.core.engine_join import get_join_engine
    return get_join_engine("numpy").join_indices(build_key, probe_key,
                                                 how=how)


def key_validity(table: Table, names: Sequence[str]
                 ) -> Optional[np.ndarray]:
    """AND of the key columns' validity masks (None = every row valid).
    A row whose key contains a NULL can never equi-join (`hash_join` /
    the late-materialized runtime both enforce this): NULL data slots
    hold representative bytes, which must not leak into key matching."""
    v = None
    for n in names:
        cv = table[n].valid
        if cv is not None:
            v = cv if v is None else v & cv
    return v


def join_indices_nullsafe(build_key: np.ndarray, probe_key: np.ndarray,
                          how: str = "inner",
                          build_valid: Optional[np.ndarray] = None,
                          probe_valid: Optional[np.ndarray] = None,
                          engine=None) -> Tuple[np.ndarray, np.ndarray]:
    """`join_indices` where rows flagged invalid never match: NULL-key
    build rows are excluded from the build, NULL-key probe rows match
    nothing (inner/semi drop them, left emits them unmatched, anti
    keeps them). Output order contract unchanged. All-valid inputs take
    the engine fast path untouched.

    Dispatches to `engine.join_indices_valid` so each engine can own its
    NULL handling: the host/device engines compact invalid rows out and
    remap (`JoinEngine.join_indices_valid`), the distributed engine
    ships validity planes through its exchanges instead — compaction is
    a host-global operation it must not depend on."""
    if engine is None:
        from repro_torch.core.engine_join import get_join_engine
        engine = get_join_engine("numpy")
    if build_valid is not None and bool(build_valid.all()):
        build_valid = None
    if probe_valid is not None and bool(probe_valid.all()):
        probe_valid = None
    return engine.join_indices_valid(build_key, probe_key, how=how,
                                     build_valid=build_valid,
                                     probe_valid=probe_valid)


def hash_join(build: Table, probe: Table,
              build_keys: Sequence[str], probe_keys: Sequence[str],
              how: str = "inner",
              build_prefix: str = "", probe_prefix: str = "") -> Table:
    """Materializing equi-join. ``how='left'`` keeps all probe rows.
    Rows whose key columns contain NULLs never match."""
    bk = composite_key(build, build_keys)
    pk = composite_key(probe, probe_keys)
    bidx, pidx = join_indices_nullsafe(
        bk, pk, how=how,
        build_valid=key_validity(build, build_keys),
        probe_valid=key_validity(probe, probe_keys))
    cols = {}
    pt = probe if not probe_prefix else probe.with_prefix(probe_prefix)
    bt = build if not build_prefix else build.with_prefix(build_prefix)
    for name in pt.names:
        cols[name] = pt[name].gather(pidx)
    for name in bt.names:
        if name in cols:
            continue
        if how in ("semi", "anti"):
            continue
        cols[name] = bt[name].gather(bidx)
    return Table(cols, probe.name)


def semi_join_mask(probe_key: np.ndarray, build_key: np.ndarray
                   ) -> np.ndarray:
    """Boolean mask over probe rows that have a match in build (R ⋉ S).

    Precise membership (the Yannakakis primitive). Sorted-membership
    implementation; the reference package's open-addressing kernel
    (K6, not ported yet) is validated against it there.
    """
    uniq = np.unique(build_key)
    pos = np.searchsorted(uniq, probe_key)
    pos = np.minimum(pos, len(uniq) - 1) if len(uniq) else pos
    if not len(uniq):
        return np.zeros(len(probe_key), dtype=bool)
    return uniq[pos] == probe_key


# --------------------------------------------------------------------------
# aggregation
# --------------------------------------------------------------------------

_AGGS = ("sum", "min", "max", "count", "countv", "mean", "nunique")


def _group_codes(key: np.ndarray) -> Tuple[np.ndarray, int]:
    """Group id per row (0..ngroups-1, ids ordered by key value).

    Physically clustered keys (TPC-H fact tables are generated ordered
    by orderkey, the common GROUP BY column) take an O(n) boundary-scan
    path; otherwise np.unique's sort. Both return identical codes."""
    n = len(key)
    if n and bool(np.all(key[:-1] <= key[1:])):
        flag = np.empty(n, bool)
        flag[0] = True
        np.not_equal(key[1:], key[:-1], out=flag[1:])
        inverse = np.cumsum(flag) - 1
        return inverse, int(inverse[-1]) + 1
    _, inverse = np.unique(key, return_inverse=True)
    return inverse.astype(np.int64, copy=False), \
        (int(inverse.max()) + 1 if n else 0)


def group_codes(key: np.ndarray) -> Tuple[np.ndarray, int]:
    """Public `(inverse, ngroups)` over a combined key array. The
    executor's cursor GroupBy path feeds `JoinCursor.key` output here —
    bit-identical to `_grouping_codes` + `_group_codes` whenever the
    key columns are NULL-free (both reduce to `composite_key`)."""
    return _group_codes(key)


def group_rep_rows(inverse: np.ndarray, ngroups: int) -> np.ndarray:
    """Representative (last-occurrence) row index per group — the row
    whose key-column values stand for the group in the output."""
    rep = np.zeros(ngroups, np.int64)
    rep[inverse] = np.arange(len(inverse))
    return rep


def _value_codes(v: np.ndarray, n_fallback: int
                 ) -> Tuple[np.ndarray, np.int64]:
    """Small dense codes for nunique values: direct range offset when
    the value span is modest (one O(n) min/max scan, no sort), else
    np.unique compaction. The choice never changes any count — codes
    only need to be injective within the span."""
    if v.size:
        vmin, vmax = int(v.min()), int(v.max())
        span = vmax - vmin + 1
        if span <= max(4 * len(v), 1 << 20):
            return v - np.int64(vmin), np.int64(span)
    _, codes = np.unique(v, return_inverse=True)
    return codes.astype(np.int64, copy=False), np.int64(n_fallback + 1)


def _grouping_codes(table: Table, keys: Sequence[str]) -> np.ndarray:
    """int64 grouping key with SQL GROUP BY NULL semantics: per key
    column, NULL compares equal to NULL and distinct from every value,
    so NULL rows form their own group(s) instead of grouping by their
    representative bytes. NULL-free key columns take `composite_key`
    unchanged (the pre-validity fast path, bit-exact for TPC-H).

    When any key column carries NULLs, every column is *rank-coded*
    (order-preserving dense codes; NULL = rank |uniq|, i.e. NULLs sort
    last) and the per-column codes combine exactly as `composite_key`
    combines raw values — ranks are < nrows < 2^31, so two columns
    always pack losslessly."""
    cols = [table[k] for k in keys]
    nullable = [c.valid is not None and not bool(c.valid.all())
                for c in cols]
    if not any(nullable):
        return composite_key(table, keys)
    arrays = []
    for c, has_null in zip(cols, nullable):
        v = c.data.astype(np.int64, copy=False)
        if not has_null:
            uniq, inv = np.unique(v, return_inverse=True)
            arrays.append(inv.astype(np.int64, copy=False))
        else:
            uniq = np.unique(v[c.valid])
            code = np.searchsorted(uniq, v).astype(np.int64)
            arrays.append(np.where(c.valid, code, np.int64(len(uniq))))
    key = arrays[0]
    if len(arrays) == 1:
        return key
    if len(arrays) == 2:
        return (key << np.int64(32)) | arrays[1]
    for a in arrays[1:]:
        key = key * np.int64(-7046029254386353131) + a  # 64-bit mix
    return key


def _opt_valid(valid: np.ndarray) -> Optional[np.ndarray]:
    """None when every group produced a value (the mask-free contract)."""
    return None if bool(valid.all()) else valid


def group_aggregate(table: Table, keys: Sequence[str],
                    aggs: Sequence[Tuple[str, str, str]]) -> Table:
    """GROUP BY keys with aggs = [(out_name, agg, in_col)].

    agg in {sum, min, max, count, countv, mean, nunique}; in_col ignored
    for count; countv counts valid (non-NULL) values of in_col; nunique
    counts distinct values of in_col per group.

    SQL NULL semantics throughout (DESIGN.md §10): NULL keys form their
    own group(s) (`_grouping_codes`); sum/min/max/mean skip NULL inputs
    and yield NULL (a validity-masked output, never a sentinel) for
    all-NULL groups; nunique/countv ignore NULLs; count counts rows.
    NULL-free inputs take the original code paths bit-exactly.
    """
    if keys:
        key = _grouping_codes(table, keys)
        inverse, ngroups = _group_codes(key)
        rep = group_rep_rows(inverse, ngroups)
    else:
        ngroups = 1
        inverse = np.zeros(len(table), np.int64)
        rep = np.zeros(1, np.int64)

    # a NULL group's representative row is NULL in that key column,
    # so the gathered validity mask marks the output key NULL too
    key_cols = {k: table[k].gather(rep) for k in keys}
    return aggregate_by_codes(inverse, ngroups, key_cols, table, aggs,
                              table.name)


def aggregate_by_codes(inverse: np.ndarray, ngroups: int,
                       key_cols: Dict[str, Column], inputs: Table,
                       aggs: Sequence[Tuple[str, str, str]],
                       name: str) -> Table:
    """`group_aggregate`'s aggregation body over precomputed group
    codes: `key_cols` are the output key columns (one row per group,
    already gathered), `inputs` holds the agg input columns at full
    row length. The executor's cursor GroupBy path calls this directly
    so passthrough payload columns never materialize (DESIGN.md §15);
    `group_aggregate` is the materializing wrapper."""
    cols = dict(key_cols)
    counts = np.bincount(inverse, minlength=ngroups)
    for out_name, agg, in_col in aggs:
        if agg == "count":
            cols[out_name] = Column(counts.astype(np.int64))
            continue
        if agg == "countv":
            c = inputs[in_col]
            if c.valid is None:
                cols[out_name] = Column(counts.astype(np.int64))
            else:
                cols[out_name] = Column(np.bincount(
                    inverse, weights=c.valid.astype(np.float64),
                    minlength=ngroups).astype(np.int64))
            continue
        c = inputs[in_col]
        cv = c.valid if (c.valid is not None
                         and not bool(c.valid.all())) else None
        if agg == "nunique":
            # COUNT(DISTINCT x) ignores NULLs: restrict both the value
            # codes and the (group, value) pairs to valid rows —
            # otherwise NULL representative bytes count as (and collide
            # with) real values, and a NULL-widened min/max corrupts the
            # range-compaction span
            v = inputs.array(in_col).astype(np.int64)
            inv = inverse
            if cv is not None:
                sel = np.flatnonzero(cv)
                v, inv = v[sel], inverse[sel]
            vcodes, span = _value_codes(v, len(v))
            pair = inv.astype(np.int64) * span + vcodes
            upair = np.unique(pair)
            grp = (upair // span).astype(np.int64)
            cols[out_name] = Column(
                np.bincount(grp, minlength=ngroups).astype(np.int64))
            continue
        v = inputs.array(in_col)
        if agg in ("sum", "mean"):
            if cv is None:
                s = np.bincount(inverse, weights=v.astype(np.float64),
                                minlength=ngroups)
                if agg == "mean":
                    s = s / np.maximum(counts, 1)
                valid = None
            else:
                # NULL inputs contribute nothing; groups with no valid
                # input yield NULL (SQL SUM/AVG over all-NULL = NULL)
                w = np.where(cv, v, 0).astype(np.float64)
                s = np.bincount(inverse, weights=w, minlength=ngroups)
                vcnt = np.bincount(inverse,
                                   weights=cv.astype(np.float64),
                                   minlength=ngroups).astype(np.int64)
                if agg == "mean":
                    s = s / np.maximum(vcnt, 1)
                valid = _opt_valid(vcnt > 0)
            if agg == "sum" and v.dtype.kind in "iu":
                cols[out_name] = Column(s.astype(np.int64), valid=valid)
            else:
                cols[out_name] = Column(s, valid=valid)
        elif agg in ("min", "max"):
            if v.dtype.kind in "iu":
                info = np.iinfo(v.dtype)
                fill = info.max if agg == "min" else info.min
            else:
                fill = np.inf if agg == "min" else -np.inf
            out = np.full(ngroups, fill, dtype=v.dtype)
            ufunc = np.minimum if agg == "min" else np.maximum
            if cv is None:
                ufunc.at(out, inverse, v)
                valid = None
            else:
                sel = np.flatnonzero(cv)
                ufunc.at(out, inverse[sel], v[sel])
                # all-NULL groups keep the sentinel fill as their
                # representative bytes but are marked NULL — the
                # sentinel must never leak as a real result
                valid = _opt_valid(np.bincount(
                    inverse[sel], minlength=ngroups) > 0)
            cols[out_name] = Column(out, c.dictionary, valid)
        else:
            raise ValueError(agg)
    return Table(cols, name)


# --------------------------------------------------------------------------
# sort / limit
# --------------------------------------------------------------------------


def sort_indices(table: Table, by: Sequence[Tuple[str, bool]]
                 ) -> np.ndarray:
    """Stable row order for `by` = [(col, ascending)] (major-to-minor).
    Only reads the sort-key columns — the executor's lazy path feeds a
    thin key view and reorders its cursor with the result.

    NULL sort keys order after every value (NULLS LAST, ascending and
    descending alike): a nullable column contributes its validity as an
    extra, more-significant sub-key, with NULL slots' representative
    bytes flattened to a constant so ties among NULLs resolve by the
    stable original order, not by garbage."""
    keys = []
    for name, asc in reversed(by):  # lexsort: last key is primary
        c = table[name]
        v = c.data
        if c.valid is not None and not bool(c.valid.all()):
            fill = v[c.valid].min() if bool(c.valid.any()) else v.dtype.type(0)
            v = np.where(c.valid, v, fill)
            keys.append(v if asc else _descending_view(v))
            keys.append(~c.valid)    # more significant: NULLs last
        else:
            keys.append(v if asc else _descending_view(v))
    idx = np.lexsort(tuple(keys)) if keys else np.arange(len(table))
    return idx.astype(np.int64)


def sort_table(table: Table, by: Sequence[Tuple[str, bool]]) -> Table:
    """by = [(col, ascending)] in major-to-minor order."""
    return table.gather(sort_indices(table, by))


def _descending_view(v: np.ndarray) -> np.ndarray:
    if v.dtype.kind == "f":
        return -v
    if v.dtype.kind in "iu":
        return v.max(initial=0) - v.astype(np.int64)
    raise TypeError(v.dtype)


def limit(table: Table, n: int) -> Table:
    return table.head(n)
