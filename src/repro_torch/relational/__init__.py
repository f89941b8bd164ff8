"""Columnar relational substrate.

A minimal-but-real in-memory columnar engine: `Table` holds named columns
(numpy arrays on host; bulk math is dispatched to the CUDA kernels),
`expr` provides a vectorized predicate/projection AST, `ops` the physical
operators (hash/sort-merge equi-join, semi/anti join, group-agg, sort,
top-k), and `plan`/`executor` the logical plan IR and the strategy-aware
executor used by the predicate-transfer core.

Strings are dictionary-encoded at ingest; all engine math is on integer /
float codes (standard columnar practice, and what lets the engine move
its key columns to the device as plain integer tensors).
"""

from repro_torch.relational.table import Table, Column
from repro_torch.relational.expr import (
    col, lit, isin, between, like, Expr, ExprValue, is_null, is_not_null,
    coalesce,
)
from repro_torch.relational import ops
from repro_torch.relational.plan import (
    Scan, Join, GroupBy, Project, Sort, Limit, SubqueryScan, PlanNode,
)
from repro_torch.relational.executor import ExecConfig, Executor, ExecStats

__all__ = [
    "Table", "Column", "col", "lit", "isin", "between", "like", "Expr",
    "ExprValue", "is_null", "is_not_null", "coalesce",
    "ops", "Scan", "Join", "GroupBy", "Project", "Sort", "Limit",
    "SubqueryScan", "PlanNode", "ExecConfig", "Executor", "ExecStats",
]
