"""The comparison that decides `correct`: an answer against the
reference's.

An answer is a dict column name -> decoded values (NumPy arrays), as
`reflib.answer` gives it. `compare` returns two numbers:

- `bad_cells`: cells of the answer that are wrong where the answer has
  to be exact: every column the reference gives as other than float
  (keys, names, counts, integer sums), a column missing or extra, a row
  missing or extra (each counts its width), and each row out of the
  ORDER BY's order.
- `float_rel_err`: the largest relative error of a cell of a column the
  reference gives as float, |answer - reference| / max(|reference|,
  1e-300).

Rows are matched after putting both answers in one canonical order (the
ORDER BY's keys first, then every non-float column, then the float
ones), so that rows tied on the ORDER BY's keys may come in any order,
as SQL lets them; the answer's own order is checked apart.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

Answer = Dict[str, np.ndarray]


def _sortable(v: np.ndarray, asc: bool = True) -> np.ndarray:
    v = np.asarray(v)
    if v.dtype.kind in "iub":
        v = v.astype(np.int64)
    elif v.dtype.kind != "f":
        v = np.unique(v, return_inverse=True)[1].reshape(-1).astype(np.int64)
    return v if asc else -v


def _canonical(ans: Answer, order_by: Sequence[Tuple[str, bool]],
               names: Sequence[str]) -> np.ndarray:
    floats = [n for n in names if ans[n].dtype.kind == "f"]
    rest = [n for n in names if ans[n].dtype.kind != "f"]
    keys = [_sortable(ans[n], asc) for n, asc in order_by]
    keys += [_sortable(ans[n]) for n in rest + floats]
    return np.lexsort(tuple(reversed(keys))) if keys else np.arange(0)


def order_violations(ans: Answer, order_by: Sequence[Tuple[str, bool]]
                     ) -> int:
    """Rows that come before a row they should follow under ORDER BY."""
    if not order_by:
        return 0
    n = len(ans[order_by[0][0]])
    if n < 2:
        return 0
    tied = np.ones(n - 1, bool)         # rows i and i + 1 tie so far
    for name, asc in order_by:
        v = ans[name]
        if v.dtype.kind not in "iubf":
            v = _sortable(v)
        a, b = v[:-1], v[1:]
        less, more = (a < b, a > b) if asc else (a > b, a < b)
        bad = tied & more
        if bad.any():
            return int(bad.sum())
        tied &= ~less & ~more
    return 0


def compare(ans: Answer, ref: Answer,
            order_by: Sequence[Tuple[str, bool]]) -> Tuple[int, float]:
    """(bad_cells, float_rel_err) of `ans` against `ref`."""
    names = list(ref)
    width = max(len(names), 1)
    if list(ans) != names:
        rows = max([len(v) for v in ans.values()] + [len(v)
                                                     for v in ref.values()])
        return max(rows, 1) * width, 0.0
    n_ans = len(ans[names[0]]) if names else 0
    n_ref = len(ref[names[0]]) if names else 0
    if n_ans != n_ref:
        return max(abs(n_ans - n_ref), 1) * width, 0.0
    bad = order_violations(ans, order_by)
    if n_ref == 0:
        return bad, 0.0
    ia = _canonical(ans, order_by, names)
    ir = _canonical(ref, order_by, names)
    err = 0.0
    for name in names:
        a, r = ans[name][ia], ref[name][ir]
        if r.dtype.kind == "f":
            a = a.astype(np.float64)
            r = r.astype(np.float64)
            with np.errstate(invalid="ignore"):
                rel = np.abs(a - r) / np.maximum(np.abs(r), 1e-300)
            rel = np.where(np.isnan(a) & np.isnan(r), 0.0, rel)
            rel = np.where(np.isnan(rel), np.inf, rel)
            err = max(err, float(rel.max()))
        else:
            bad += int(np.sum(a != r))
    return bad, err
