"""Plan optimizer passes.

`collect_columns(plan)` — every column name the plan can observe: join
keys, filter/projection/aggregation/sort inputs. Used by the executor for
projection pushdown: leaf scans materialize only referenced columns
(standard columnar practice; cuts gather traffic through every join for
every strategy — §Perf DB iteration 3).

Subquery internals (SubqueryScan.plan, Bind.subplan) are *not* walked:
those plans are executed by nested executors which do their own pushdown.
"""
from __future__ import annotations

from typing import Set

from repro_torch.relational.plan import (
    Bind, Filter, GroupBy, Join, Limit, PlanNode, Project, Scan, Sort,
    SubqueryScan,
)


def collect_columns(plan: PlanNode) -> Set[str]:
    out: Set[str] = set()

    def walk(node: PlanNode):
        if isinstance(node, Scan):
            if node.filter is not None:
                out.update(node.filter.columns())
            if node.columns is not None:
                out.update(node.columns)
            return
        if isinstance(node, SubqueryScan):
            return                       # nested executor's concern
        if isinstance(node, Join):
            out.update(node.left_on)
            out.update(node.right_on)
            if node.extra is not None:
                out.update(node.extra.columns())
        elif isinstance(node, Filter):
            out.update(node.predicate.columns())
        elif isinstance(node, Project):
            for e in node.exprs.values():
                out.update(e.columns())
        elif isinstance(node, GroupBy):
            out.update(node.keys)
            for _, agg, in_col in node.aggs:
                if in_col:
                    out.add(in_col)
            if node.having is not None:
                out.update(node.having.columns())
        elif isinstance(node, Sort):
            out.update(n for n, _ in node.by)
        elif isinstance(node, Bind):
            out.add(node.name)
        for c in node.children():
            walk(c)
        if isinstance(node, SubqueryScan):
            pass

    walk(plan)
    return out
