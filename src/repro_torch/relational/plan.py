"""Logical plan IR.

A deliberately small algebra sufficient for the TPC-H join queries and the
data-curation pipeline, with the properties the predicate-transfer core
needs:

* every base relation appears as a `Scan` leaf with an alias (self-joins),
  its local predicate attached (predicate pushdown is the baseline, as in
  the paper's No-Pred-Trans);
* `SubqueryScan` wraps a subplan whose *output* participates in the outer
  join graph as a vertex (paper §3.4: single-table/aggregation subqueries
  are executed first, then treated as base tables for transfer);
* `Join` declares equi-join keys by column name; the build side is `right`
  by convention (paper Table 1: HT = right/build rows, PR = left/probe
  rows).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.relational.expr import Expr

_ids = itertools.count()


class PlanNode:
    def leaves(self) -> List["LeafNode"]:
        raise NotImplementedError

    def children(self) -> Sequence["PlanNode"]:
        raise NotImplementedError


class LeafNode(PlanNode):
    leaf_id: int
    alias: str

    def children(self):
        return ()

    def leaves(self):
        return [self]


@dataclasses.dataclass(eq=False)
class Scan(LeafNode):
    """Scan base table `table` under `alias` (column names get `alias`
    prefixes applied by the catalog, e.g. n1_nationkey)."""
    table: str
    alias: str = ""
    filter: Optional[Expr] = None
    # columns actually needed downstream; None = all (projection pushdown)
    columns: Optional[Sequence[str]] = None

    def __post_init__(self):
        self.alias = self.alias or self.table
        self.leaf_id = next(_ids)

    def __repr__(self):
        return f"Scan({self.alias})"


@dataclasses.dataclass(eq=False)
class SubqueryScan(LeafNode):
    """A subplan whose output acts as a base vertex in the outer join
    graph. `blocking` marks operators that stop transfer through this
    vertex in a given direction (paper §3.4); aggregations that keep the
    join key in the group key are non-blocking."""
    plan: PlanNode
    alias: str

    def __post_init__(self):
        self.leaf_id = next(_ids)

    def __repr__(self):
        return f"SubqueryScan({self.alias})"


@dataclasses.dataclass(eq=False)
class Join(PlanNode):
    """Equi-join. left = probe/outer side, right = build/inner side.

    how: inner | left (left outer on the probe side) | semi | anti.
    extra: residual non-equi predicate evaluated on the joined row.
    """
    left: PlanNode
    right: PlanNode
    left_on: Sequence[str]
    right_on: Sequence[str]
    how: str = "inner"
    extra: Optional[Expr] = None

    def children(self):
        return (self.left, self.right)

    def leaves(self):
        return self.left.leaves() + self.right.leaves()

    def __repr__(self):
        return (f"Join({self.left!r} ⋈ {self.right!r} on "
                f"{list(self.left_on)}={list(self.right_on)}, {self.how})")


@dataclasses.dataclass(eq=False)
class Filter(PlanNode):
    child: PlanNode
    predicate: Expr

    def children(self):
        return (self.child,)

    def leaves(self):
        return self.child.leaves()


@dataclasses.dataclass(eq=False)
class Project(PlanNode):
    child: PlanNode
    exprs: Dict[str, Expr]   # out_name -> expression (Col for passthrough)

    def children(self):
        return (self.child,)

    def leaves(self):
        return self.child.leaves()


@dataclasses.dataclass(eq=False)
class GroupBy(PlanNode):
    child: PlanNode
    keys: Sequence[str]
    aggs: Sequence[Tuple[str, str, str]]  # (out, agg, in)
    having: Optional[Expr] = None

    def children(self):
        return (self.child,)

    def leaves(self):
        return self.child.leaves()


@dataclasses.dataclass(eq=False)
class Bind(PlanNode):
    """Scalar (uncorrelated) subquery: evaluate `subplan` (must yield one
    row), broadcast column `sub_col` of its result as constant column
    `name` over `child`'s output. The subplan is executed first with its
    own transfer phase (paper §3.4 'beyond a single transfer graph')."""
    child: PlanNode
    name: str
    subplan: PlanNode
    sub_col: str

    def children(self):
        return (self.child,)

    def leaves(self):
        # subplan leaves are NOT part of the outer transfer graph
        return self.child.leaves()


@dataclasses.dataclass(eq=False)
class Sort(PlanNode):
    child: PlanNode
    by: Sequence[Tuple[str, bool]]        # (col, ascending)

    def children(self):
        return (self.child,)

    def leaves(self):
        return self.child.leaves()


@dataclasses.dataclass(eq=False)
class Limit(PlanNode):
    child: PlanNode
    n: int

    def children(self):
        return (self.child,)

    def leaves(self):
        return self.child.leaves()
