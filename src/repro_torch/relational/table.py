"""Columnar Table: host-resident numpy columns + optional dictionaries.

Design notes
------------
* Columns are 1-D numpy arrays (int64 / int32 / float64 / bool). String
  columns are dictionary-encoded: the column stores int32 codes and the
  Column carries the vocabulary (numpy array of python str). All engine
  math operates on codes.
* NULLs are carried as a per-column boolean validity mask (None = all
  valid). Only outer joins introduce nulls in TPC-H, so most columns have
  no mask.
* Tables are immutable; operators return new Tables sharing column buffers
  where possible (gather produces copies, as in any engine).
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np

# monotonic data-version counter: every Table constructed gets a fresh
# version, so "the same catalog Table object" and "the same version"
# are interchangeable — the cross-query artifact caches key on it
# (DESIGN.md §12) and replacing a catalog table automatically changes
# every derived key. Lock-guarded (not itertools.count) so snapshot
# restore can raise the floor: re-adopting a snapshot's version numbers
# (DESIGN.md §16) must guarantee no future Table collides with them.
_version_lock = threading.Lock()
_version_next = 1


def _next_version() -> int:
    global _version_next
    with _version_lock:
        v = _version_next
        _version_next += 1
        return v


def bump_version_floor(floor: int) -> None:
    """Ensure every future `Table.version` exceeds `floor`. Called by
    snapshot restore after re-assigning a snapshot's recorded versions
    to digest-verified catalog tables, so the re-adopted numbers can
    never be handed out again in this process."""
    global _version_next
    with _version_lock:
        _version_next = max(_version_next, int(floor) + 1)


@dataclasses.dataclass(frozen=True)
class Column:
    data: np.ndarray                       # 1-D values or dictionary codes
    dictionary: Optional[np.ndarray] = None  # vocab for string columns
    valid: Optional[np.ndarray] = None       # bool mask; None = all valid

    def __post_init__(self):
        assert self.data.ndim == 1, "columns are 1-D"
        if self.valid is not None:
            assert self.valid.shape == self.data.shape

    def __len__(self) -> int:
        return self.data.shape[0]

    @property
    def is_string(self) -> bool:
        return self.dictionary is not None

    def value_range(self) -> tuple:
        """Cached (min, max) value bounds, computed once per buffer.

        Conservative under row selection: `gather`/`compact` children
        inherit the parent's bounds instead of rescanning, so the
        composite-key packability check (`ops.composite_key`) is O(1)
        after the first touch of a column lineage. Conservative bounds
        may over-report the range — callers that need a data-exact
        answer when these bounds fail a test use `exact_value_range`.
        Empty columns report (0, -1)."""
        r = self.__dict__.get("_vrange")
        if r is None:
            r = self.exact_value_range()
            object.__setattr__(self, "_vrange", r)
        return r

    def exact_value_range(self) -> tuple:
        """(min, max) of *this buffer's valid* values (cached separately
        from the inherited lineage bounds). NULL slots hold unspecified
        representative bytes and must not widen the bounds — the packed
        composite-key decision (`ops._packable`) and the range-hoisting
        in `composite_key` depend only on values that can actually
        participate in matching. All-NULL (and empty) columns report
        (0, -1)."""
        r = self.__dict__.get("_vrange_exact")
        if r is None:
            data = self.data if self.valid is None else self.data[self.valid]
            if len(data) == 0:
                r = (0, -1)
            else:
                r = (int(data.min()), int(data.max()))
            object.__setattr__(self, "_vrange_exact", r)
        return r

    def gather(self, idx: np.ndarray) -> "Column":
        """Take rows by index; idx == -1 yields a NULL row."""
        has_neg = bool((idx < 0).any()) if idx.size else False
        if len(self.data) == 0:
            # gathering from an empty column: only NULL rows are legal
            # (outer join against an empty build side); zero rows get no
            # validity plane, so empty results are byte-identical whether
            # gathered from an empty intermediate or a live base slot
            assert not idx.size or (idx < 0).all(), idx
            return Column(np.zeros(len(idx), self.data.dtype),
                          self.dictionary,
                          np.zeros(len(idx), bool) if idx.size else None)
        safe = np.where(idx < 0, 0, idx) if has_neg else idx
        data = self.data[safe]
        valid = self.valid[safe] if self.valid is not None else None
        if has_neg:
            v = np.ones(idx.shape, dtype=bool) if valid is None else valid.copy()
            v[idx < 0] = False
            valid = v
        out = Column(data, self.dictionary, valid)
        r = self.__dict__.get("_vrange")
        if r is not None:      # bounds survive selection (conservative)
            object.__setattr__(out, "_vrange", r)
        return out

    def decode(self) -> np.ndarray:
        """Materialize strings (testing/debug only)."""
        if self.dictionary is None:
            return self.data
        return self.dictionary[self.data]


class Table:
    """Ordered mapping column-name -> Column, all of equal length."""

    def __init__(self, columns: Mapping[str, Column], name: str = ""):
        self.columns: Dict[str, Column] = dict(columns)
        self.name = name
        self.version = _next_version()
        lens = {len(c) for c in self.columns.values()}
        assert len(lens) <= 1, f"ragged table {name}: {lens}"
        self._nrows = lens.pop() if lens else 0

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_arrays(arrays: Mapping[str, np.ndarray], name: str = "",
                    dictionaries: Optional[Mapping[str, np.ndarray]] = None,
                    validity: Optional[Mapping[str, np.ndarray]] = None
                    ) -> "Table":
        """`validity[k]` (optional, bool per row; absent = all valid)
        marks column k's NULL rows; the values under NULL slots are kept
        as representative bytes, per the engine NULL contract."""
        dictionaries = dictionaries or {}
        validity = validity or {}
        cols = {}
        for k, v in arrays.items():
            v = np.asarray(v)
            valid = validity.get(k)
            if valid is not None:
                valid = np.asarray(valid, bool)
                if bool(valid.all()):
                    valid = None
            if v.dtype.kind in ("U", "S", "O"):
                vocab, codes = np.unique(v, return_inverse=True)
                cols[k] = Column(codes.astype(np.int32), vocab, valid)
            else:
                cols[k] = Column(v, dictionaries.get(k), valid)
        return Table(cols, name)

    # -- basic accessors ---------------------------------------------------
    def __len__(self) -> int:
        return self._nrows

    @property
    def nrows(self) -> int:
        return self._nrows

    @property
    def names(self) -> Sequence[str]:
        return list(self.columns.keys())

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def array(self, name: str) -> np.ndarray:
        return self.columns[name].data

    def nbytes(self) -> int:
        return sum(c.data.nbytes for c in self.columns.values())

    # -- row operations ----------------------------------------------------
    def gather(self, idx: np.ndarray) -> "Table":
        return Table({k: c.gather(idx) for k, c in self.columns.items()},
                     self.name)

    def compact(self, mask: np.ndarray) -> "Table":
        """Keep rows where mask is True (the materialization boundary)."""
        if mask.dtype != bool:
            raise TypeError("compact expects a boolean mask")
        idx = np.flatnonzero(mask)
        return self.gather(idx)

    def select(self, names: Iterable[str]) -> "Table":
        return Table({n: self.columns[n] for n in names}, self.name)

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self.columns.items()},
                     self.name)

    def with_column(self, name: str, column: Column) -> "Table":
        cols = dict(self.columns)
        cols[name] = column
        return Table(cols, self.name)

    def with_prefix(self, prefix: str) -> "Table":
        return Table({prefix + k: v for k, v in self.columns.items()},
                     self.name)

    def head(self, n: int) -> "Table":
        return self.gather(np.arange(min(n, self._nrows)))

    def to_pydict(self, decode: bool = True) -> Dict[str, np.ndarray]:
        return {k: (c.decode() if decode else c.data)
                for k, c in self.columns.items()}

    def __repr__(self) -> str:
        cols = ", ".join(f"{k}:{c.data.dtype}{'*' if c.is_string else ''}"
                         for k, c in self.columns.items())
        return f"Table({self.name!r}, rows={self._nrows}, [{cols}])"


def table_digest(table: Table) -> str:
    """md5 of a table's full decoded content (names, dtypes, values,
    validity) — the bit-exactness oracle the serving tests and benches
    compare concurrent / warm-cache results against. Strings hash via
    their decoded values, so vocabulary-local code assignments cannot
    mask (or fake) a difference."""
    h = hashlib.md5()
    for name in table.names:
        c = table[name]
        data = c.decode()
        if c.valid is not None:
            # NULL slots hold unspecified representative bytes; zero
            # them so only the authoritative (valid, value) pairs hash
            data = data.copy()
            data[~c.valid] = np.zeros((), data.dtype)
        h.update(name.encode())
        h.update(str(data.dtype).encode())
        h.update(np.ascontiguousarray(data).tobytes())
        if c.valid is None:
            h.update(b"|all-valid")
        else:
            h.update(b"|v" + np.ascontiguousarray(c.valid).tobytes())
    return h.hexdigest()


def concat_tables(tables: Sequence[Table]) -> Table:
    """Vertical concat; dictionaries must match (true for shards of one gen)."""
    assert tables
    first = tables[0]
    cols = {}
    for k in first.names:
        dic = first[k].dictionary
        data = np.concatenate([t[k].data for t in tables])
        valids = [t[k].valid for t in tables]
        if any(v is not None for v in valids):
            valid = np.concatenate([
                v if v is not None else np.ones(len(t), bool)
                for v, t in zip(valids, tables)])
        else:
            valid = None
        cols[k] = Column(data, dic, valid)
    return Table(cols, first.name)
