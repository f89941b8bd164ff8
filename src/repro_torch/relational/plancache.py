"""Canonical plan fingerprints and the cross-query plan cache.

Candidate identity follows the canonical-hash discipline: a plan's
fingerprint is a typed digest of its *structure* — node kinds, join
keys and kinds, canonical expression trees, literals — and deliberately
excludes the volatile per-process `leaf_id` counters, so two
independently built instances of the same query hash identically.
Leaves are addressed by their deterministic `plan.leaves()` position
instead, which is what lets cached per-plan artifacts (join-graph edge
templates, join depths, needed-column sets) be re-bound to fresh leaf
ids on every hit.

Anything the token vocabulary cannot express (an opaque C callable in a
`Func`) makes the fingerprint None, and unknown plans simply bypass the
caches — correctness never depends on a fingerprint existing, only on
equal fingerprints implying equal semantics.

`PlanCache` maps (fingerprint, catalog signature) to the derived
planning artifacts the executor otherwise recomputes per query
(`collect_columns`, `extract_join_graph` adjacency, `annotate_join_depth`).
The catalog signature (table `version`s) is part of the key because
join depths depend on which leaves are *informative* — a data property,
not a plan property.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from repro_torch.core import provenance
from repro_torch.relational import expr as ex
from repro_torch.relational import plan as pl


# --------------------------------------------------------------------------
# expression fingerprints
# --------------------------------------------------------------------------


def expr_tokens(e: ex.Expr,
                rename: Optional[Callable[[str], str]] = None):
    """Canonical token tree for an expression (raises UnsupportedToken
    via provenance.digest later if a literal is exotic; raises
    TypeError here for unknown node classes). `rename` canonicalizes
    column names (e.g. stripping scan-alias prefixes)."""
    r = rename or (lambda n: n)
    if isinstance(e, ex.Col):
        return ("col", r(e.name))
    if isinstance(e, ex.Lit):
        return ("lit", e.value)
    if isinstance(e, ex.BinOp):
        return ("bin", e.op, expr_tokens(e.left, rename),
                expr_tokens(e.right, rename))
    if isinstance(e, ex.UnaryOp):
        return ("un", e.op, expr_tokens(e.operand, rename))
    if isinstance(e, ex.IsNull):
        return ("isnull", expr_tokens(e.operand, rename))
    if isinstance(e, ex.Coalesce):
        return ("coalesce",
                tuple(expr_tokens(o, rename) for o in e.operands))
    if isinstance(e, ex.IsIn):
        return ("isin", expr_tokens(e.operand, rename), tuple(e.values))
    if isinstance(e, ex.Like):
        return ("like", expr_tokens(e.operand, rename), e.pattern,
                e.negate)
    if isinstance(e, ex.DictMap):
        return ("dictmap", expr_tokens(e.operand, rename),
                provenance.callable_fp(e.fn))
    if isinstance(e, ex.Func):
        return ("func", provenance.callable_fp(e.fn),
                tuple(expr_tokens(o, rename) for o in e.operands),
                tuple(sorted(e._cols)) if e._cols is not None else None)
    if isinstance(e, ex.CaseWhen):
        return ("case", expr_tokens(e.cond, rename),
                expr_tokens(e.then, rename),
                expr_tokens(e.otherwise, rename))
    raise provenance.UnsupportedToken(
        f"unknown expression node {type(e).__name__}")


def expr_fingerprint(e: Optional[ex.Expr],
                     rename: Optional[Callable[[str], str]] = None
                     ) -> Optional[bytes]:
    """16-byte digest of an expression; None when unfingerprintable.
    `expr_fingerprint(None)` is the canonical no-predicate digest."""
    if e is None:
        return provenance.digest(("no-filter",))
    try:
        return provenance.digest(expr_tokens(e, rename))
    except provenance.UnsupportedToken:
        return None


# --------------------------------------------------------------------------
# plan fingerprints
# --------------------------------------------------------------------------


def _plan_tokens(node: pl.PlanNode, tables: List[str]):
    if isinstance(node, pl.Scan):
        tables.append(node.table)
        cols = tuple(sorted(node.columns)) if node.columns is not None \
            else None
        return ("scan", node.table, node.alias,
                expr_tokens(node.filter) if node.filter is not None
                else ("no-filter",), cols)
    if isinstance(node, pl.SubqueryScan):
        return ("sub", node.alias, _plan_tokens(node.plan, tables))
    if isinstance(node, pl.Join):
        return ("join", node.how, tuple(node.left_on),
                tuple(node.right_on),
                expr_tokens(node.extra) if node.extra is not None
                else None,
                _plan_tokens(node.left, tables),
                _plan_tokens(node.right, tables))
    if isinstance(node, pl.Filter):
        return ("filter", expr_tokens(node.predicate),
                _plan_tokens(node.child, tables))
    if isinstance(node, pl.Project):
        # dict order is output column order — it matters, keep it
        return ("project",
                tuple((k, expr_tokens(e))
                      for k, e in node.exprs.items()),
                _plan_tokens(node.child, tables))
    if isinstance(node, pl.GroupBy):
        return ("groupby", tuple(node.keys),
                tuple(tuple(a) for a in node.aggs),
                expr_tokens(node.having) if node.having is not None
                else None,
                _plan_tokens(node.child, tables))
    if isinstance(node, pl.Bind):
        return ("bind", node.name, node.sub_col,
                _plan_tokens(node.subplan, tables),
                _plan_tokens(node.child, tables))
    if isinstance(node, pl.Sort):
        return ("sort", tuple((c, bool(a)) for c, a in node.by),
                _plan_tokens(node.child, tables))
    if isinstance(node, pl.Limit):
        return ("limit", int(node.n), _plan_tokens(node.child, tables))
    raise provenance.UnsupportedToken(
        f"unknown plan node {type(node).__name__}")


def plan_fingerprint(plan: pl.PlanNode
                     ) -> Tuple[Optional[bytes], Tuple[str, ...]]:
    """(fingerprint, referenced base tables). The table list covers
    every Scan in the tree *including* Bind/Subquery subplans — it is
    the catalog-signature footprint. Fingerprint is None when any
    component is unfingerprintable (the table list is still valid)."""
    tables: List[str] = []
    try:
        toks = _plan_tokens(plan, tables)
    except provenance.UnsupportedToken:
        _collect_tables(plan, tables)
        return None, tuple(sorted(set(tables)))
    names = tuple(sorted(set(tables)))
    return provenance.try_digest("plan", toks), names


def _collect_tables(node: pl.PlanNode, tables: List[str]) -> None:
    if isinstance(node, pl.Scan):
        tables.append(node.table)
        return
    if isinstance(node, pl.SubqueryScan):
        _collect_tables(node.plan, tables)
        return
    if isinstance(node, pl.Bind):
        _collect_tables(node.subplan, tables)
    for c in node.children():
        _collect_tables(c, tables)


# --------------------------------------------------------------------------
# plan cache
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanInfo:
    """Planning artifacts derived from (plan shape, catalog data),
    leaf-position addressed so they re-bind to any fresh leaf ids."""
    needed: frozenset                     # projection-pushdown column set
    # (u_pos, v_pos, u_cols, v_cols, fwd_ok, bwd_ok) per join-graph edge
    edges: tuple
    depths: tuple                         # join_depth per leaf position


class PlanCache:
    """Thread-safe LRU over (plan fingerprint, catalog signature) ->
    PlanInfo. Entry count is the bound (entries are tiny)."""

    def __init__(self, max_entries: int = 512):
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, PlanInfo]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple) -> Optional[PlanInfo]:
        with self._lock:
            info = self._entries.get(key)
            if info is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return info

    def put(self, key: tuple, info: PlanInfo) -> None:
        with self._lock:
            self._entries[key] = info
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses,
                    "hit_rate": self.hits / max(self.hits + self.misses,
                                                1)}

    # -- snapshot/restore (DESIGN.md §16) ------------------------------
    def export_entries(self) -> list:
        """LRU-ordered (key, PlanInfo) rows; everything is picklable
        (frozensets/tuples/bytes) for the serving layer's snapshots."""
        with self._lock:
            return list(self._entries.items())

    def absorb(self, rows) -> int:
        for key, info in rows:
            self.put(key, info)
        return len(rows)


# --------------------------------------------------------------------------
# per-edge selectivity history (DESIGN §14)
# --------------------------------------------------------------------------


class SelHistory:
    """Thread-safe LRU of measured transfer-edge selectivities, keyed
    like the plan cache — (plan fingerprint, catalog signature) — so
    history only ever feeds a query with identical semantics over
    identical data. Per key it keeps an EWMA of each
    (edge_label, pass_idx)'s measured actual removed-row fraction; the
    executor passes the map to `Strategy.prefilter(hints=...)` on the
    second query onward, where the adaptive scheduler substitutes it
    for its KMV estimate (`TransferStats.hints_used` counts the
    substitutions). Transfer filters have no false negatives, so a
    hint that flips a gate decision changes survivor sets but never
    query results."""

    def __init__(self, max_entries: int = 512, alpha: float = 0.3):
        self.max_entries = int(max_entries)
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, dict]" = OrderedDict()

    def get(self, key: tuple) -> Optional[dict]:
        """{(edge_label, pass_idx): ewma_act_sel} for this plan, or
        None before the first observation."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return None
            self._entries.move_to_end(key)
            return dict(ent)

    def observe(self, key: tuple, edges) -> None:
        """Fold one query's measured `EdgeDecision` actuals in. Only
        *applied* edges that actually probed rows carry a measurement;
        their `act_sel` is conditional on the edge's LIP position,
        which the (edge, pass) key pins."""
        obs = {}
        for d in edges:
            if d.action != "applied" or d.rows_probed <= 0:
                continue
            a = d.act_sel
            if not isinstance(a, float) or a != a:    # NaN guard
                continue
            obs.setdefault((d.edge, d.pass_idx),
                           min(max(float(a), 0.0), 1.0))
        if not obs:
            return
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self._entries[key] = dict(obs)
            else:
                for k, a in obs.items():
                    prev = ent.get(k)
                    ent[k] = a if prev is None else \
                        (1.0 - self.alpha) * prev + self.alpha * a
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "edges": sum(len(e)
                                 for e in self._entries.values())}

    # -- snapshot/restore (DESIGN.md §16) ------------------------------
    def export_entries(self) -> list:
        with self._lock:
            return [(k, dict(v)) for k, v in self._entries.items()]

    def absorb(self, rows) -> int:
        with self._lock:
            for key, ent in rows:
                self._entries[key] = dict(ent)
                self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        return len(rows)
