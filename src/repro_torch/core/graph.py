"""Join-graph primitives shared by the executor and the transfer strategies.

Kept free of imports from `repro_torch.relational.executor` to avoid cycles:
executor -> graph <- transfer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import provenance

if TYPE_CHECKING:  # type-only: keeps this module import-cycle-free
    from repro_torch.relational.table import Table


# --------------------------------------------------------------------------
# graph model
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Vertex:
    leaf_id: int
    alias: str
    table: Table                  # post local-predicate, pre transfer
    mask: np.ndarray              # current validity (bool, len == table)
    base_rows: int = -1           # catalog rows before local predicates
    derived: bool = False         # subquery output (always informative)
    # composite join keys computed by the transfer phase, stashed per
    # key-column tuple so the join runtime reuses them (compacted by
    # the executor) instead of re-deriving per join — "hash once per
    # query" across both phases
    raw_keys: Dict[Tuple[str, ...], "np.ndarray"] = dataclasses.field(
        default_factory=dict)
    # AND-of-validity per key-column tuple (None = every row valid),
    # cached like raw_keys: the NULL-tight build path and the min-max
    # range computation both exclude invalid-key rows
    key_valids: Dict[Tuple[str, ...], Optional["np.ndarray"]] = \
        dataclasses.field(default_factory=dict)
    # number of join nodes this leaf's rows flow through before the
    # first join that can kill them (one whose other side was locally
    # filtered) — annotated from the plan by the executor
    # (`annotate_join_depth`); the adaptive scheduler's benefit model
    # multiplies by it (a removed row saves every join it would have
    # paid). 1 when unknown.
    join_depth: int = 1
    # provenance state signature (repro_torch.core.provenance): identifies
    # (table version, local predicate, every transfer event applied to
    # `mask` so far). None = unknown — never cached, never reused.
    # Set by the executor at leaf resolution; every strategy that
    # mutates `mask` must either chain the mutation event
    # (`chain_event` / `apply_filters_sig`) or null the signature out.
    state_sig: Optional[bytes] = None
    # Table.version set this vertex's current state was derived from
    # (its own scan plus every source whose filter touched its mask) —
    # the artifact cache's invalidation index
    dep_versions: frozenset = frozenset()

    def canon_cols(self, cols: Sequence[str]) -> Tuple[str, ...]:
        """Key columns with the scan alias stripped (n1_nationkey ->
        nationkey): two aliases of one base table under one predicate
        state hash to the same filter signature and share one build."""
        if self.derived or self.alias == self.table.name:
            return tuple(cols)
        prefix = self.alias + "_"
        return tuple(c[len(prefix):] if c.startswith(prefix) else c
                     for c in cols)

    def chain_event(self, event, deps: frozenset = frozenset()) -> None:
        """Append one mask-mutation event to the provenance chain."""
        self.state_sig = provenance.chain(self.state_sig, event)
        if deps and self.state_sig is not None:
            self.dep_versions = self.dep_versions | deps

    def apply_filters_sig(self, items: Sequence[Tuple[Optional[bytes],
                                                      Tuple[str, ...]]],
                          deps: Sequence[frozenset]) -> None:
        """Chain a fused multi-filter probe; `items` pairs each applied
        filter's signature with the local (canonical) key columns it
        probed — the same filter over two different key columns is two
        different mask transformations. Apply order must not split
        states (intersection commutes), so the pairs are sorted; one
        unknown source poisons the chain."""
        if self.state_sig is None:
            return
        if any(s is None for s, _ in items):
            self.state_sig = None
            return
        self.chain_event(("bloom", tuple(sorted(items))),
                         frozenset().union(*deps) if deps
                         else frozenset())

    @property
    def live(self) -> int:
        # count_nonzero is cheaper than bool .sum() (SIMD popcount)
        return int(np.count_nonzero(self.mask))

    def key(self, cols: Sequence[str]) -> "np.ndarray":
        """Composite join key over `table` for `cols`, computed once per
        column set and stashed in `raw_keys` — the single get-or-compute
        site every strategy shares, so the cross-phase key-reuse
        contract cannot desynchronize."""
        cols = tuple(cols)
        k = self.raw_keys.get(cols)
        if k is None:
            from repro_torch.relational import ops
            k = ops.composite_key(self.table, cols)
            self.raw_keys[cols] = k
        return k

    def key_valid(self, cols: Sequence[str]) -> Optional["np.ndarray"]:
        """Rows whose key columns are all non-NULL (None = every row).
        NULL slots hold representative bytes that never equi-match, so
        filter *builds* may exclude them for free (NULL-tight
        transfer)."""
        cols = tuple(cols)
        if cols not in self.key_valids:
            from repro_torch.relational import ops
            self.key_valids[cols] = ops.key_validity(self.table, cols)
        return self.key_valids[cols]

    @property
    def informative(self) -> bool:
        """False iff this is a complete, untouched base relation — a filter
        built from it cannot reject any FK-valid row (transfer-path
        pruning, paper §3.2)."""
        if self.derived or self.base_rows < 0:
            return True
        return len(self.table) < self.base_rows or self.live < len(self.table)


@dataclasses.dataclass
class Edge:
    u: int                        # leaf_id
    v: int
    u_cols: Sequence[str]
    v_cols: Sequence[str]
    fwd_ok: bool = True           # transfer u -> v allowed
    bwd_ok: bool = True           # transfer v -> u allowed

    def endpoint_cols(self, leaf: int) -> Sequence[str]:
        return self.u_cols if leaf == self.u else self.v_cols

    def other(self, leaf: int) -> int:
        return self.v if leaf == self.u else self.u

    def allows(self, src: int, dst: int) -> bool:
        if (src, dst) == (self.u, self.v):
            return self.fwd_ok
        if (src, dst) == (self.v, self.u):
            return self.bwd_ok
        raise ValueError("edge does not connect these vertices")


@dataclasses.dataclass
class EdgeDecision:
    """One per-edge per-pass scheduling decision (adaptive scheduler,
    DESIGN.md §11; the plain strategies record their `pruned` skips
    here too so skipped transfers never vanish from the accounting).

    `action` is one of:
      applied        — filter built (or reused) and probed;
      skipped        — cost gate: modeled cost exceeded modeled benefit;
      pruned         — source is a complete, untouched base relation
                       (transfer-path pruning / sel_est == 0);
      minmax-cut     — build/probe ranges provably disjoint, the whole
                       probe side was cut without a Bloom probe;
      skipped-forced — mode="force_skip" sweep (tests).

    A non-applied edge reports `rows_probed == 0`. `est_sel` is the
    modeled removed-row fraction (NaN only for gate-1 skips, which
    never estimate); `act_sel` the measured one. Actual selectivity is
    *conditional* — measured on the rows still alive when this edge's
    filter ran in LIP order. `act_sel` is always finite: an edge whose
    probe never ran (skipped, pruned, batched away by a min-max cut or
    an earlier empty survivor set) measures 0.0 removed over
    `rows_probed == 0` rows, so q-error stays NaN-free by
    construction."""

    edge: str                     # "src->dst[cols]"
    pass_idx: int
    action: str
    build_rows: int = 0
    probe_rows: int = 0
    rows_probed: int = 0
    est_sel: float = 0.0
    act_sel: float = math.nan
    cost_ns: float = 0.0
    benefit_ns: float = 0.0
    filter_bytes: int = 0         # bytes built (0 when skipped/reused)
    src: str = ""                 # source vertex alias ("" = unknown)
    dst: str = ""                 # destination vertex alias

    @property
    def skipped(self) -> bool:
        return self.action != "applied"

    def qerror(self) -> float:
        """Querytorque-style q-error of this edge's survivor-cardinality
        estimate: max(est/act, act/est) over clamped-to-1 surviving row
        counts. 1.0 = perfect (or no information: an edge that never
        probed has no measured actual to compare against — reporting
        1.0 instead of NaN keeps aggregates finite)."""
        if (self.rows_probed <= 0 or math.isnan(self.est_sel)
                or math.isnan(self.act_sel)):
            return 1.0
        est_keep = max(1.0, (1.0 - self.est_sel) * self.rows_probed)
        act_keep = max(1.0, (1.0 - self.act_sel) * self.rows_probed)
        return max(est_keep / act_keep, act_keep / est_keep)


@dataclasses.dataclass
class TransferStats:
    strategy: str = ""
    backend: str = ""             # bloom engine backend (numpy/cuda)
    seconds: float = 0.0
    filters_built: int = 0
    # filter builds satisfied by the cross-query artifact cache (the
    # signature matched an unchanged survivor state, DESIGN.md §12)
    filters_reused: int = 0
    # True when this whole stats record was replayed from a cached
    # post-transfer slot entry (no scan/transfer work ran this query)
    from_cache: bool = False
    filter_bytes: int = 0
    # rows_probed counts rows actually tested against a filter (the live
    # set at the moment each filter is applied), NOT the survivors
    rows_probed: int = 0
    # rows tested against a min-max range filter (cheap comparisons,
    # counted separately so rows_probed keeps meaning "Bloom-probed")
    rows_range_tested: int = 0
    rows_semijoin_build: int = 0
    rows_semijoin_probe: int = 0
    per_vertex: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)  # alias -> (rows_before, rows_after)
    # per-edge per-pass scheduling decisions (adaptive scheduler; the
    # plain strategies record their prune skips here too)
    edges: List[EdgeDecision] = dataclasses.field(default_factory=list)
    passes_run: int = 0
    # gate decisions whose sel_est came from plancache.SelHistory
    # (second-query-onward correction) instead of the KMV estimator
    hints_used: int = 0

    def record_vertices(self, vertices: Dict[int, Vertex],
                        before: Dict[int, int],
                        after: Optional[Dict[int, int]] = None):
        """`after` lets a strategy that already tracks live counts
        (the adaptive scheduler's cache) skip re-summing every mask."""
        for lid, v in vertices.items():
            n = after.get(lid) if after is not None else None
            self.per_vertex[v.alias] = (before[lid],
                                        v.live if n is None else n)

    def decision_counts(self) -> Dict[str, int]:
        return decision_counts(self.edges)

    @property
    def edges_applied(self) -> int:
        return sum(not d.skipped for d in self.edges)

    @property
    def edges_skipped(self) -> int:
        return sum(d.skipped for d in self.edges)


def decision_counts(edges: Sequence[EdgeDecision]) -> Dict[str, int]:
    """Per-action tally over any `EdgeDecision` list (one stats object
    or a query's merged outer+subquery edges) — the single counting
    site the benches share."""
    out: Dict[str, int] = {}
    for d in edges:
        out[d.action] = out.get(d.action, 0) + 1
    return out


# --------------------------------------------------------------------------
# strategies
# --------------------------------------------------------------------------


class Strategy:
    """Pre-filtering strategy interface. `prefilter` mutates vertex masks
    before the join phase. `per_join_filter` is the one-hop hook used by
    BloomJoin inside the join phase."""

    name = "base"
    uses_per_join_filter = False

    def prefilter(self, vertices: Dict[int, Vertex], edges: List[Edge],
                  ctx=None, hints=None) -> TransferStats:
        """`ctx` is an optional `repro_torch.core.errors.QueryContext`;
        strategies that do real transfer work call `ctx.check()` per
        pass and per vertex so a deadline or cancellation aborts within
        one pass (DESIGN.md §13). `hints` is an optional
        {(edge_label, pass_idx): measured_sel} mapping from
        `plancache.SelHistory` — strategies that estimate selectivity
        may substitute these measured actuals for their own estimates;
        others ignore it."""
        return TransferStats(strategy=self.name)

    def cache_signature(self) -> Optional[tuple]:
        """Token tuple identifying every parameter that can change the
        survivor masks `prefilter` produces (DESIGN.md §12). Strategies
        with equal signatures produce bit-identical post-transfer slot
        state on the same plan and catalog; the bloom-engine backend is
        deliberately excluded (all backends build identical filters).
        None = unknown semantics, never cached (the base-class default,
        so third-party strategies are safe by construction)."""
        return None

    def per_join_filter(self, build: Table, probe: Table,
                        build_keys: Sequence[str], probe_keys: Sequence[str],
                        stats: TransferStats) -> np.ndarray:
        raise NotImplementedError


class NoPredTrans(Strategy):
    name = "no-pred-trans"

    def cache_signature(self) -> Optional[tuple]:
        # a no-op prefilter: slot state is the bare compacted scan,
        # shared with every other prefilter-free strategy ("none")
        return ("none",)


