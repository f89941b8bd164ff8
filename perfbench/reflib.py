"""NumPy helpers for the plain references of the query templates.

Imports NumPy alone: nothing of the program under test. The generators
(`perfbench/data/*.py`) emit a database as plain arrays: each table a
dict of columns, each column a NumPy array, and a string column a
`Strings` (int32 codes into a sorted vocabulary that holds only the
values present). The references read those arrays and work each answer
out again from them.

`acc` is the precision the reference computes its measures in:
float64, as the configurations state, or one of the two float32 controls
(`perfbench/control.py`). At float64 integer measures stay int64 and
float sums go through `np.bincount` (float64, exact for integer sums
below 2**53). `np.float32` casts every measure to float32 and sums one
row after the other; `PAIRWISE32` casts the same and sums each group
pairwise, as a tree reduction on a device or `np.sum` would.
"""
from __future__ import annotations

import datetime
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

_EPOCH = datetime.date(1970, 1, 1).toordinal()


class _Pairwise32:
    """float32 measures summed pairwise within each group."""

    def __repr__(self) -> str:
        return "PAIRWISE32"


PAIRWISE32 = _Pairwise32()


class Strings(NamedTuple):
    """A string column: `vocab[codes]` are its values; `vocab` is sorted
    and holds only values that occur."""
    codes: np.ndarray
    vocab: np.ndarray

    def __len__(self) -> int:
        return len(self.codes)

    def decode(self) -> np.ndarray:
        return self.vocab[self.codes]


def strings(values: np.ndarray) -> Strings:
    """A `Strings` column from an array of str values."""
    vocab, codes = np.unique(np.asarray(values), return_inverse=True)
    return Strings(codes.astype(np.int32), vocab)


def categorical(codes: np.ndarray, vocab: Sequence[str]) -> Strings:
    """A `Strings` column from codes into a vocabulary given in any
    order; values that never occur are dropped from the vocabulary."""
    vocab = np.asarray(vocab)
    order = np.argsort(vocab, kind="stable")
    rank = np.empty(len(vocab), np.int64)
    rank[order] = np.arange(len(vocab))
    sorted_codes = rank[np.asarray(codes)]
    present = np.bincount(sorted_codes, minlength=len(vocab)) > 0
    remap = np.cumsum(present) - 1
    return Strings(remap[sorted_codes].astype(np.int32), vocab[order][present])


def date(s: str) -> int:
    """'YYYY-MM-DD' -> days since 1970-01-01."""
    y, m, d = map(int, s.split("-"))
    return datetime.date(y, m, d).toordinal() - _EPOCH


def year(days: np.ndarray) -> np.ndarray:
    """Calendar year of days since 1970-01-01."""
    return np.asarray(days).astype("datetime64[D]").astype(
        "datetime64[Y]").astype(np.int64) + 1970


# -- predicates on string columns -----------------------------------------

def eq(col: Strings, value: str) -> np.ndarray:
    return isin(col, [value])


def isin(col: Strings, values: Sequence[str]) -> np.ndarray:
    hit = np.isin(col.vocab, np.asarray(values))
    return hit[col.codes]


def contains(col: Strings, part: str) -> np.ndarray:
    hit = np.char.find(col.vocab.astype(str), part) >= 0
    return hit[col.codes]


def between(col: Strings, lo: str, hi: str) -> np.ndarray:
    hit = (col.vocab >= lo) & (col.vocab <= hi)
    return hit[col.codes]


# -- keys -------------------------------------------------------------------

def lookup(pk: np.ndarray, fk: np.ndarray) -> np.ndarray:
    """Row of `pk` (unique keys) holding each value of `fk`; -1 where
    none does."""
    pk = np.asarray(pk)
    fk = np.asarray(fk)
    if len(pk) == 0:
        return np.full(len(fk), -1, np.int64)
    lo, hi = int(pk.min()), int(pk.max())
    if hi - lo < 4 * len(pk) + (1 << 20):
        # a key domain not much wider than the table: a direct map
        rows = np.full(hi - lo + 1, -1, np.int64)
        rows[pk - lo] = np.arange(len(pk))
        out = np.full(len(fk), -1, np.int64)
        inside = (fk >= lo) & (fk <= hi)
        out[inside] = rows[fk[inside] - lo]
        return out
    order = np.argsort(pk, kind="stable")
    spk = pk[order]
    pos = np.minimum(np.searchsorted(spk, fk), len(spk) - 1)
    return np.where(spk[pos] == fk, order[pos], -1)


def member(values: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """`values` found among `keys` (np.isin for integer keys)."""
    values, keys = np.asarray(values), np.asarray(keys)
    if len(keys) == 0 or len(values) == 0:
        return np.zeros(len(values), bool)
    lo = min(int(values.min()), int(keys.min()))
    hi = max(int(values.max()), int(keys.max()))
    if hi - lo < 4 * (len(values) + len(keys)) + (1 << 20):
        hit = np.zeros(hi - lo + 1, bool)
        hit[keys - lo] = True
        return hit[values - lo]
    return np.isin(values, keys)


def pair_key(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One int64 key for a pair of non-negative int32-range keys."""
    return (np.asarray(a, np.int64) << np.int64(32)) | np.asarray(b, np.int64)


def distinct_per_group(group: np.ndarray, value: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(groups, distinct values of `value` in each): COUNT(DISTINCT)."""
    pairs = np.sort(pair_key(group, value))
    if len(pairs):
        pairs = pairs[np.r_[True, pairs[1:] != pairs[:-1]]]
    g = pairs >> np.int64(32)
    starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]]) if len(g) \
        else np.zeros(0, np.int64)
    return g[starts], np.diff(np.r_[starts, len(g)])


# -- measures ---------------------------------------------------------------

def measure(x: np.ndarray, acc) -> np.ndarray:
    """A measure column in the reference's precision: unchanged at
    float64 (integers stay integers), cast at float32."""
    x = np.asarray(x)
    if acc is np.float64:
        return x
    return x.astype(np.float32)


def group_by(keys: Sequence[np.ndarray]
             ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(group id per row, the key values of each group), groups in
    ascending key order. Keys are integer arrays of equal length."""
    codes, uniq = [], []
    for k in keys:
        k = np.asarray(k)
        lo = int(k.min()) if len(k) else 0
        span = int(k.max()) - lo + 1 if len(k) else 0
        if span and span < 4 * len(k) + (1 << 20):
            # a key domain not much wider than the rows: dense codes
            present = np.bincount(k - lo, minlength=span) > 0
            rank = np.cumsum(present) - 1
            codes.append(rank[k - lo].astype(np.int64))
            uniq.append((np.flatnonzero(present) + lo).astype(k.dtype))
        else:
            u, inv = np.unique(k, return_inverse=True)
            codes.append(inv.reshape(-1).astype(np.int64))
            uniq.append(u)
    combined = np.zeros(len(codes[0]), np.int64)
    for c, u in zip(codes, uniq):
        combined = combined * np.int64(len(u)) + c
    present, gid = np.unique(combined, return_inverse=True)
    out = []
    for u in reversed(uniq):
        out.append(u[present % len(u)])
        present = present // len(u)
    return gid.reshape(-1).astype(np.int64), out[::-1]


def group_sum(gid: np.ndarray, ngroups: int, values: np.ndarray,
              acc) -> np.ndarray:
    """SUM per group in the precision `acc`. Integer inputs give int64."""
    values = np.asarray(values)
    is_int = values.dtype.kind in "iu"
    if acc is np.float64:
        s = np.bincount(gid, weights=values.astype(np.float64),
                        minlength=ngroups)
        return s.astype(np.int64) if is_int else s
    out = np.zeros(ngroups, np.float32)
    if acc is PAIRWISE32:
        order = np.argsort(gid, kind="stable")
        g = gid[order]
        starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]]) if len(g) \
            else np.zeros(0, np.int64)
        if len(starts):
            out[g[starts]] = np.add.reduceat(
                values.astype(np.float32)[order], starts)
    else:
        np.add.at(out, gid, values.astype(np.float32))
    return np.rint(out).astype(np.int64) if is_int else out.astype(np.float64)


def total(values: np.ndarray, acc):
    """SUM over all rows, as a one-row column."""
    return group_sum(np.zeros(len(values), np.int64), 1, values, acc)


def answer(columns: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A result: column name -> decoded values, in output order."""
    return {k: (v.decode() if isinstance(v, Strings) else np.asarray(v))
            for k, v in columns.items()}


def order_by(columns: Dict[str, np.ndarray],
             by: Sequence[Tuple[str, bool]], limit: int = 0
             ) -> Dict[str, np.ndarray]:
    """ORDER BY `by` = [(column, ascending)], then LIMIT (0: none)."""
    keys = []
    for name, asc in reversed(by):
        v = np.asarray(columns[name])
        if not asc:
            v = -v if v.dtype.kind in "iuf" else -_rank(v)
        keys.append(v)
    n = len(next(iter(columns.values()))) if columns else 0
    idx = np.lexsort(tuple(keys)) if keys else np.arange(n)
    if limit:
        idx = idx[:limit]
    return {k: np.asarray(v)[idx] for k, v in columns.items()}


def _rank(v: np.ndarray) -> np.ndarray:
    _, inv = np.unique(v, return_inverse=True)
    return inv.reshape(-1).astype(np.int64)
