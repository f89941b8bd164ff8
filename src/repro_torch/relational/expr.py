"""Vectorized expression AST evaluated against a Table.

Supports the TPC-H predicate/projection surface: comparisons, arithmetic,
boolean algebra, IN-lists, BETWEEN, LIKE (evaluated against the string
dictionary, then reduced to an integer code test), and date arithmetic
(dates are int32 days-since-epoch).

`Expr.__call__(table) -> ExprValue` evaluates under SQL three-valued
logic (DESIGN.md §10): every node yields a value array *and* a validity
mask (None = every row valid). NULL slots hold unspecified
*representative* bytes — the validity mask is the authoritative NULL
signal, exactly as in `relational.table.Column`:

* comparisons and arithmetic propagate NULL (any NULL operand => NULL);
* ``&`` / ``|`` implement Kleene logic (FALSE & NULL = FALSE,
  TRUE | NULL = TRUE, otherwise NULL); ``~NULL`` = NULL;
* `IsNull` / `Coalesce` are the NULL-observing nodes (always valid);
* `CaseWhen` sends NULL conditions to the ELSE branch (SQL CASE);
* predicates used for filtering reduce through `ExprValue.mask()`,
  which maps NULL to False (SQL WHERE/HAVING/ON drop non-TRUE rows).

NULL-free inputs produce `valid=None` end-to-end, so the pre-validity
fast paths (and TPC-H bit-exactness) are untouched.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Optional, Sequence

import numpy as np

from repro_torch.relational.table import Column, Table


class ExprValue:
    """One expression result: value array + optional validity mask.

    `value` carries representative bytes in NULL slots; `valid` is None
    when every row is valid (the engine-wide NULL contract). Consumers
    must go through `mask()` (predicates) or `column()` (projections);
    `np.asarray(ev)` works only for fully-valid results and raises
    otherwise — a validity-ignorant read of a nullable result is always
    a bug, and this makes it a loud one.
    """

    __slots__ = ("value", "valid")

    def __init__(self, value: Any, valid: Optional[np.ndarray] = None):
        self.value = value
        self.valid = _norm_valid(valid)

    @property
    def all_valid(self) -> bool:
        return self.valid is None

    def mask(self, nrows: Optional[int] = None) -> np.ndarray:
        """Boolean row filter with SQL semantics: NULL counts as False
        (WHERE / HAVING / join ON keep only TRUE rows). Scalar results
        broadcast to `nrows` when given."""
        m = np.asarray(self.value, bool)
        if self.valid is not None:
            m = m & self.valid
        if m.ndim == 0 and nrows is not None:
            m = np.full(nrows, bool(m))
        return m

    def column(self, dictionary: Optional[np.ndarray] = None,
               nrows: Optional[int] = None) -> Column:
        """Materialize as a Column (validity-preserving projection)."""
        v = np.asarray(self.value)
        valid = self.valid
        if v.ndim == 0:
            assert nrows is not None, "scalar result needs nrows"
            v = np.full(nrows, v)
        if valid is not None and np.ndim(valid) == 0:
            valid = np.full(len(v), bool(valid))
        return Column(v, dictionary, valid)

    def __array__(self, dtype=None, copy=None):
        if self.valid is not None:
            raise ValueError(
                "ambiguous conversion of a nullable ExprValue to a plain "
                "array; use .mask() (predicates) or .column() "
                "(projections) to preserve SQL NULL semantics")
        v = np.asarray(self.value)
        return v.astype(dtype) if dtype is not None else v

    def __len__(self) -> int:
        return len(np.asarray(self.value))

    def __repr__(self):
        nulls = ("-" if self.valid is None
                 else int(np.size(self.valid) - np.sum(self.valid)))
        return f"ExprValue({self.value!r}, nulls={nulls})"


def _norm_valid(valid) -> Optional[np.ndarray]:
    """None when every row is valid — keeps NULL-free plans on the
    mask-free fast paths everywhere downstream."""
    if valid is None:
        return None
    valid = np.asarray(valid, bool)
    if valid.ndim == 0:
        return None if bool(valid) else valid
    return None if bool(valid.all()) else valid


def _and_valid(a: Optional[np.ndarray], b: Optional[np.ndarray]
               ) -> Optional[np.ndarray]:
    if a is None:
        return b
    if b is None:
        return a
    return a & b


class Expr:
    # -- comparison --------------------------------------------------------
    def __eq__(self, other):  # type: ignore[override]
        return BinOp("==", self, wrap(other))

    def __ne__(self, other):  # type: ignore[override]
        return BinOp("!=", self, wrap(other))

    def __lt__(self, other):
        return BinOp("<", self, wrap(other))

    def __le__(self, other):
        return BinOp("<=", self, wrap(other))

    def __gt__(self, other):
        return BinOp(">", self, wrap(other))

    def __ge__(self, other):
        return BinOp(">=", self, wrap(other))

    # -- arithmetic --------------------------------------------------------
    def __add__(self, other):
        return BinOp("+", self, wrap(other))

    def __radd__(self, other):
        return BinOp("+", wrap(other), self)

    def __sub__(self, other):
        return BinOp("-", self, wrap(other))

    def __rsub__(self, other):
        return BinOp("-", wrap(other), self)

    def __mul__(self, other):
        return BinOp("*", self, wrap(other))

    def __rmul__(self, other):
        return BinOp("*", wrap(other), self)

    def __truediv__(self, other):
        return BinOp("/", self, wrap(other))

    # -- boolean -----------------------------------------------------------
    def __and__(self, other):
        return BinOp("&", self, wrap(other))

    def __or__(self, other):
        return BinOp("|", self, wrap(other))

    def __invert__(self):
        return UnaryOp("~", self)

    def __hash__(self):
        return id(self)

    # -- NULL observation ---------------------------------------------------
    def is_null(self) -> "IsNull":
        return IsNull(self)

    def is_not_null(self) -> "UnaryOp":
        return UnaryOp("~", IsNull(self))

    def __call__(self, table: Table) -> ExprValue:
        raise NotImplementedError

    def columns(self) -> set:
        """Column names referenced by this expression."""
        raise NotImplementedError


class Col(Expr):
    def __init__(self, name: str):
        self.name = name

    def __call__(self, table: Table) -> ExprValue:
        c = table[self.name]
        return ExprValue(c.data, c.valid)

    def column(self, table: Table) -> Column:
        return table[self.name]

    def columns(self) -> set:
        return {self.name}

    def __repr__(self):
        return f"col({self.name!r})"


class Lit(Expr):
    """Literal; `Lit(None)` is the SQL NULL literal (scalar-invalid,
    broadcasting NULL into every row it combines with)."""

    def __init__(self, value: Any):
        self.value = value

    def __call__(self, table: Table) -> ExprValue:
        if self.value is None:
            return ExprValue(np.int64(0), np.zeros((), bool))
        return ExprValue(self.value)  # numpy broadcasting handles scalars

    def columns(self) -> set:
        return set()

    def __repr__(self):
        return f"lit({self.value!r})"


_OPS: dict = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
}

_CMP = ("==", "!=", "<", "<=", ">", ">=")


def _known(ev: ExprValue) -> tuple:
    """(known-true, known-false) planes of a boolean ExprValue —
    the Kleene truth-table primitives."""
    v = np.asarray(ev.value, bool)
    if ev.valid is None:
        return v, ~v
    return v & ev.valid, ~v & ev.valid


class BinOp(Expr):
    def __init__(self, op: str, left: Expr, right: Expr):
        self.op, self.left, self.right = op, left, right

    def __call__(self, table: Table) -> ExprValue:
        lv, rv = self.left(table), self.right(table)
        if self.op in ("&", "|"):
            # Kleene logic: a NULL operand only stays NULL when the
            # other side cannot force the result (x & FALSE = FALSE,
            # x | TRUE = TRUE regardless of x)
            lt, lf = _known(lv)
            rt, rf = _known(rv)
            if self.op == "&":
                kt, kf = lt & rt, lf | rf
            else:
                kt, kf = lt | rt, lf & rf
            return ExprValue(kt, kt | kf)
        l, r = lv.value, rv.value
        # string-dictionary comparison: translate the literal to a code test
        if self.op in _CMP:
            l, r = _align_dict_operands(self.left, self.right, l, r, table)
        valid = _and_valid(lv.valid, rv.valid)
        if valid is not None:
            # NULL slots hold representative bytes; keep their garbage
            # arithmetic from raising (e.g. x / 0 in a NULL row)
            with np.errstate(all="ignore"):
                return ExprValue(_OPS[self.op](l, r), valid)
        return ExprValue(_OPS[self.op](l, r))

    def columns(self) -> set:
        return self.left.columns() | self.right.columns()

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


class UnaryOp(Expr):
    def __init__(self, op: str, operand: Expr):
        self.op, self.operand = op, operand

    def __call__(self, table: Table) -> ExprValue:
        ev = self.operand(table)
        if self.op == "~":
            return ExprValue(~np.asarray(ev.value), ev.valid)
        raise ValueError(self.op)

    def columns(self) -> set:
        return self.operand.columns()


class IsNull(Expr):
    """SQL `x IS NULL` — observes validity, always yields a valid bool."""

    def __init__(self, operand: Expr):
        self.operand = wrap(operand)

    def __call__(self, table: Table) -> ExprValue:
        ev = self.operand(table)
        if ev.valid is None:
            return ExprValue(np.zeros(np.shape(ev.value), bool))
        return ExprValue(~np.broadcast_to(ev.valid,
                                          np.shape(ev.value)))

    def columns(self) -> set:
        return self.operand.columns()

    def __repr__(self):
        return f"is_null({self.operand!r})"


class Coalesce(Expr):
    """SQL COALESCE over numeric operands: first non-NULL value per row.
    (Dictionary-encoded string operands are not supported — their codes
    are vocabulary-local and cannot be mixed across columns.)"""

    def __init__(self, *operands: Any):
        assert operands, "coalesce needs at least one operand"
        self.operands = [wrap(o) for o in operands]

    def __call__(self, table: Table) -> ExprValue:
        for op in self.operands:
            # dict codes are vocabulary-local: mixing codes from two
            # string columns would be silent garbage, so fail loudly
            if isinstance(op, Col) and table[op.name].is_string:
                raise TypeError(
                    f"coalesce over dictionary-encoded string column "
                    f"{op.name!r} is unsupported (codes are "
                    f"vocabulary-local; see DESIGN §10)")
            if hasattr(op, "result_column"):     # DictMap: also strings
                raise TypeError(
                    "coalesce over a dict_map result is unsupported "
                    "(codes are vocabulary-local; see DESIGN §10)")
        ev = self.operands[0](table)
        value = np.asarray(ev.value)
        valid = (None if ev.valid is None
                 else np.broadcast_to(ev.valid, value.shape))
        for op in self.operands[1:]:
            if valid is None:
                break
            nxt = op(table)
            nv = np.asarray(nxt.value)
            value = np.where(valid, value, nv)
            nvalid = (np.ones(value.shape, bool) if nxt.valid is None
                      else np.broadcast_to(nxt.valid, value.shape))
            valid = _norm_valid(valid | nvalid)
        return ExprValue(value, valid)

    def columns(self) -> set:
        out: set = set()
        for o in self.operands:
            out |= o.columns()
        return out

    def __repr__(self):
        return f"coalesce({', '.join(map(repr, self.operands))})"


class IsIn(Expr):
    """SQL IN-list. A NULL probe value yields NULL; a None entry in the
    list follows SQL: rows that match a real entry are TRUE, every other
    row is NULL (x IN (..., NULL) can never be FALSE)."""

    def __init__(self, operand: Expr, values: Sequence[Any]):
        self.operand, self.values = operand, list(values)

    def __call__(self, table: Table) -> ExprValue:
        had_null = any(v is None for v in self.values)
        vals = [v for v in self.values if v is not None]
        if isinstance(self.operand, Col):
            c = table[self.operand.name]
            v, valid = c.data, c.valid
            if c.is_string:
                vals = _codes_for(c.dictionary, vals)
        elif hasattr(self.operand, "result_column"):  # DictMap etc.
            c = self.operand.result_column(table)
            v, valid = c.data, c.valid
            if c.is_string:
                vals = _codes_for(c.dictionary, vals)
        else:
            ev = self.operand(table)
            v, valid = ev.value, ev.valid
        hit = np.isin(v, np.asarray(vals))
        if had_null:
            # non-matching rows become NULL (they might equal the NULL)
            valid = _and_valid(valid, hit.copy())
        return ExprValue(hit, valid)

    def columns(self) -> set:
        return self.operand.columns()


class Like(Expr):
    """SQL LIKE on a dictionary-encoded column ('%' and '_' wildcards).
    NULL LIKE anything is NULL (so is NOT LIKE)."""

    def __init__(self, operand: Col, pattern: str, negate: bool = False):
        self.operand, self.pattern, self.negate = operand, pattern, negate

    def __call__(self, table: Table) -> ExprValue:
        c = table[self.operand.name]
        assert c.is_string, "LIKE needs a string column"
        regex = re.compile(
            "^" + re.escape(self.pattern).replace("%", ".*").replace("_", ".")
            .replace("\\%", "%").replace("\\_", "_") + "$")
        match_codes = np.array(
            [i for i, s in enumerate(c.dictionary) if regex.match(str(s))],
            dtype=c.data.dtype)
        m = np.isin(c.data, match_codes)
        return ExprValue(~m if self.negate else m, c.valid)

    def columns(self) -> set:
        return self.operand.columns()


class Func(Expr):
    """Escape hatch for odd projections (e.g. extract-year). The python
    function sees raw values (representative bytes in NULL slots); the
    result is NULL wherever any operand was NULL."""

    def __init__(self, fn: Callable[..., np.ndarray], *operands: Expr,
                 cols: Optional[set] = None):
        self.fn, self.operands = fn, [wrap(o) for o in operands]
        self._cols = cols

    def __call__(self, table: Table) -> ExprValue:
        evs = [o(table) for o in self.operands]
        valid = None
        for ev in evs:
            valid = _and_valid(valid, ev.valid)
        if valid is not None:
            with np.errstate(all="ignore"):
                return ExprValue(self.fn(*[ev.value for ev in evs]), valid)
        return ExprValue(self.fn(*[ev.value for ev in evs]))

    def columns(self) -> set:
        if self._cols is not None:
            return self._cols
        out: set = set()
        for o in self.operands:
            out |= o.columns()
        return out


class DictMap(Expr):
    """Apply a python string function over a dict column's vocabulary
    (e.g. substring); evaluation is O(|vocab|), the per-row cost is a
    recode. Returns recoded values; `result_column` also returns the new
    dictionary (used by Project to keep string-ness). NULL rows stay
    NULL (their codes are recoded representative bytes)."""

    def __init__(self, operand: Col, fn: Callable[[str], str]):
        self.operand, self.fn = operand, fn

    def _mapped(self, table: Table):
        c = table[self.operand.name]
        assert c.is_string, "dict_map needs a string column"
        mapped = np.array([self.fn(str(s)) for s in c.dictionary])
        vocab, codes = np.unique(mapped, return_inverse=True)
        return vocab, codes.astype(c.data.dtype)[c.data]

    def __call__(self, table: Table) -> ExprValue:
        return ExprValue(self._mapped(table)[1],
                         table[self.operand.name].valid)

    def result_column(self, table: Table) -> Column:
        vocab, data = self._mapped(table)
        return Column(data, vocab, table[self.operand.name].valid)

    def columns(self) -> set:
        return self.operand.columns()


class CaseWhen(Expr):
    """SQL CASE WHEN cond THEN a ELSE b: a NULL condition selects the
    ELSE branch (only a TRUE condition selects THEN)."""

    def __init__(self, cond: Expr, then: Expr, otherwise: Expr):
        self.cond, self.then, self.otherwise = cond, wrap(then), wrap(otherwise)

    def __call__(self, table: Table) -> ExprValue:
        cm = self.cond(table).mask(len(table))
        t, o = self.then(table), self.otherwise(table)
        value = np.where(cm, t.value, o.value)
        if t.valid is None and o.valid is None:
            return ExprValue(value)
        tv = (np.ones(value.shape, bool) if t.valid is None
              else np.broadcast_to(t.valid, value.shape))
        ov = (np.ones(value.shape, bool) if o.valid is None
              else np.broadcast_to(o.valid, value.shape))
        return ExprValue(value, np.where(cm, tv, ov))

    def columns(self) -> set:
        return (self.cond.columns() | self.then.columns()
                | self.otherwise.columns())


# -- helpers ---------------------------------------------------------------

def wrap(v: Any) -> Expr:
    return v if isinstance(v, Expr) else Lit(v)


def col(name: str) -> Col:
    return Col(name)


def lit(v: Any) -> Lit:
    return Lit(v)


def isin(e: Expr, values: Sequence[Any]) -> IsIn:
    return IsIn(e, values)


def between(e: Expr, lo: Any, hi: Any) -> Expr:
    return (e >= lo) & (e <= hi)


def like(c: Col, pattern: str) -> Like:
    return Like(c, pattern)


def not_like(c: Col, pattern: str) -> Like:
    return Like(c, pattern, negate=True)


def dict_map(c: Col, fn: Callable[[str], str]) -> DictMap:
    return DictMap(c, fn)


def substring(c: Col, start: int, length: int) -> DictMap:
    """SQL substring (1-based start)."""
    return DictMap(c, lambda s: s[start - 1: start - 1 + length])


def case(cond: Expr, then: Any, otherwise: Any) -> CaseWhen:
    return CaseWhen(cond, then, otherwise)


def is_null(e: Expr) -> IsNull:
    return IsNull(e)


def is_not_null(e: Expr) -> Expr:
    return wrap(e).is_not_null()


def coalesce(*es: Any) -> Coalesce:
    return Coalesce(*es)


def _codes_for(dictionary: np.ndarray, values: Sequence[Any]) -> np.ndarray:
    """Map string literals to dictionary codes (missing -> -1, matches none)."""
    lookup = {str(s): i for i, s in enumerate(dictionary)}
    return np.array([lookup.get(str(v), -1) for v in values], dtype=np.int64)


def _align_dict_operands(le: Expr, re_: Expr, l: Any, r: Any, table: Table):
    """If one side is a dict column and the other a string literal, compare
    on codes. Ordered comparisons use the fact that np.unique sorts the
    vocabulary, so code order == lexicographic order."""
    def dict_of(e):
        if isinstance(e, Col):
            c = table[e.name]
            if c.is_string:
                return c.dictionary
        return None

    ld, rd = dict_of(le), dict_of(re_)
    if ld is not None and isinstance(re_, Lit) and isinstance(re_.value, str):
        r = _scalar_code(ld, re_.value)
    if rd is not None and isinstance(le, Lit) and isinstance(le.value, str):
        l = _scalar_code(rd, le.value)
    return l, r


def _scalar_code(dictionary: np.ndarray, s: str) -> float:
    """Comparable stand-in for a string literal in code space.

    np.unique sorts the vocabulary, so code order == lexicographic order.
    If the literal is present we return its exact code; otherwise the
    insertion point minus 0.5, which makes every ordered comparison (and
    the impossibility of equality) come out right in float space."""
    idx = int(np.searchsorted(dictionary, s))
    if idx < len(dictionary) and str(dictionary[idx]) == s:
        return float(idx)
    return idx - 0.5
