"""Runtime-feedback join ordering (DESIGN.md §14).

The transfer phase ends with *exact* per-vertex cardinalities: every
leaf's post-filter live count is known before a single join runs. That
is the 2502.15181 observation ("Debunking the Myth of Join Ordering"):
predicate-transfer-first execution makes join ordering robust enough to
re-derive at runtime from actuals, instead of trusting optimizer
estimates baked into the plan. This module does exactly that for every
maximal *inner-join region* of a plan:

* `collect_region` — the maximal subtree of consecutive inner `Join`
  nodes; anything else (leaves, filters, semi/anti/outer joins,
  subquery scans) hangs below as an opaque *unit*, executed exactly as
  the static plan would execute it;
* `greedy_order` — min-intermediate-size greedy enumeration over the
  units, fed by *actuals*: exact live counts and exact per-column
  distinct-key counts from the post-transfer cursors, per-edge match
  fractions from `EdgeDecision` actuals/estimates (`ReorderInfo`), and
  the adaptive scheduler's calibrated per-backend `TransferCosts` (so the radix/
  memory-bound crossover — and, under the distributed engine, modeled
  wire bytes — price each candidate step);
* `execute_region` — run the units, then join them in the chosen order
  as a left-deep chain, restoring the static plan's exact output row
  and column order at the end (see below). Anything the region walk
  cannot prove safe (ambiguous column ownership, a disconnected join
  graph, cross joins) raises `ReorderFallback` and the region runs its
  original static tree instead — same cursors, same stats, zero rework.

Bit-exactness argument: the join engines emit probe-side rows in probe
order and, per probe row, build matches in the build side's stable key
order — so by induction any static inner-join tree's output is
lex-ordered by its units' row positions in spine (left-to-right) order,
and is a *set* determined only by the conjunction of the join
predicates. The chain computes the same set (same equi-pairs, same
NULL-key drops, same residuals), carries a position-tracker slot per
unit through the chain, and lexsorts the final selection vectors by
those positions in spine order — reproducing the static order exactly,
for left-deep and bushy static trees alike. Multi-pair steps join on
up to two column pairs when every involved column provably takes
`composite_key`'s loss-less packed path (the same encoding the static
plan's own multi-pair joins use), and apply the remaining pairs as
exact single-column equality filters — the probabilistic hash-combine
fallback is never introduced where the static plan didn't already use
it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine_join import JoinCursor, Slot
from repro_torch.core.engine_join_dist import (
    KEY_WIRE_BYTES, ROW_WIRE_BYTES, WIRE_NS_PER_BYTE,
)
from repro_torch.relational import ops
from repro_torch.relational.plan import Join, LeafNode, PlanNode, Scan
from repro_torch.relational.table import Table

if False:  # type-only (repro_torch.core.transfer imports repro_torch.relational)
    from repro_torch.core.transfer import TransferCosts


def _default_costs() -> "TransferCosts":
    # lazy: repro_torch.core.transfer imports repro_torch.relational.ops, so a
    # module-level import here would be circular
    from repro_torch.core.transfer import DEFAULT_COSTS
    return DEFAULT_COSTS["numpy"]


class ReorderFallback(Exception):
    """Region cannot be safely reordered; run the static tree."""


# --------------------------------------------------------------------------
# transfer-phase snapshot
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ReorderInfo:
    """What the ordering decision needs from the transfer phase, keyed
    by leaf id / vertex alias so it survives into the join phase after
    the `Vertex` objects are gone (and is reconstructable on the warm
    slot-replay path, where they never existed)."""

    alias: Dict[int, str]
    base_rows: Dict[int, int]          # Scan leaves only
    derived: Dict[int, bool]
    # (src_alias, dst_alias) -> fraction of dst's post-transfer rows
    # expected to match src (1.0 = transfer already applied the filter)
    match: Dict[Tuple[str, str], float]
    costs: TransferCosts
    shards: Optional[int] = None       # distributed engine only


def build_info(leaves: Sequence[LeafNode], transfer, catalog,
               costs: Optional[TransferCosts],
               shards: Optional[int]) -> ReorderInfo:
    """Snapshot the ordering inputs right after the transfer phase.

    Match fractions come from the per-edge decisions: an edge that was
    applied (or min-max cut, or pruned as uninformative — a complete
    base relation cannot reject FK-valid rows) leaves the destination
    fully filtered against the source, fraction 1.0; a *skipped* edge
    left an estimated `est_sel` fraction of non-matching rows behind.
    The last decision per direction wins, except that any applied pass
    pins 1.0 (a later skip estimates residual selectivity the earlier
    application already removed)."""
    alias: Dict[int, str] = {}
    base_rows: Dict[int, int] = {}
    derived: Dict[int, bool] = {}
    for leaf in leaves:
        alias[leaf.leaf_id] = leaf.alias
        if isinstance(leaf, Scan):
            derived[leaf.leaf_id] = False
            base_rows[leaf.leaf_id] = len(catalog[leaf.table])
        else:
            derived[leaf.leaf_id] = True
    match: Dict[Tuple[str, str], float] = {}
    applied = set()
    for d in (transfer.edges if transfer is not None else []):
        if not d.src or not d.dst:
            continue
        key = (d.src, d.dst)
        if d.action in ("applied", "minmax-cut", "pruned"):
            applied.add(key)
        elif not math.isnan(d.est_sel):
            match[key] = max(0.0, 1.0 - d.est_sel)
    for key in applied:
        match[key] = 1.0
    return ReorderInfo(alias=alias, base_rows=base_rows, derived=derived,
                       match=match,
                       costs=costs or _default_costs(),
                       shards=shards)


# --------------------------------------------------------------------------
# region collection
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Region:
    root: Join
    units: List[PlanNode]    # spine (left-to-right leaf) order
    joins: List[Join]        # interior inner joins, pre-order


def collect_region(node: Join) -> Optional[Region]:
    """The maximal inner-join subtree rooted at `node`. None when the
    region has fewer than 3 units — with 2 there is no order to choose
    (build/probe roles are the engines' concern, not the planner's)."""
    units: List[PlanNode] = []
    joins: List[Join] = []

    def walk(n: PlanNode) -> None:
        if isinstance(n, Join) and n.how == "inner":
            joins.append(n)
            walk(n.left)
            walk(n.right)
        else:
            units.append(n)

    walk(node)
    if len(units) < 3:
        return None
    return Region(root=node, units=units, joins=joins)


@dataclasses.dataclass
class _Pair:
    """One equi-join column pair, resolved to owning units. `dom` is
    filled by `region_edges` (the larger side's exact post-transfer
    distinct-key count — the containment-estimator denominator) so the
    chain can rank a step's connecting
    pairs without re-scanning intermediate cursors; it stays 0.0 on
    the `reorder_fn` path, where ranking degrades to plan order."""

    a: int
    b: int
    a_col: str
    b_col: str
    dom: float = 0.0


def _link(region: Region, cursors: Sequence[JoinCursor]
          ) -> Tuple[List[_Pair], List[Tuple[object, List[str]]]]:
    """Resolve every join column pair and residual predicate to unit
    ownership. Raises `ReorderFallback` on anything the chain cannot
    reproduce faithfully: a column name owned by two units (the chain's
    shadowing could bind the wrong occurrence mid-chain), an unowned
    column, a pair inside one unit, or a cross join."""
    owner: Dict[str, int] = {}
    dup = set()
    for i, c in enumerate(cursors):
        for n, _sid in c.cols:
            if n in owner:
                dup.add(n)
            else:
                owner[n] = i

    def own(col: str) -> int:
        if col in dup:
            raise ReorderFallback(f"ambiguous column {col!r}")
        if col not in owner:
            raise ReorderFallback(f"unowned column {col!r}")
        return owner[col]

    pairs: List[_Pair] = []
    residuals: List[Tuple[object, List[str]]] = []
    for j in region.joins:
        if not j.left_on:
            raise ReorderFallback("cross join in region")
        for lc, rc in zip(j.left_on, j.right_on):
            a, b = own(lc), own(rc)
            if a == b:
                raise ReorderFallback(f"intra-unit pair {lc}={rc}")
            pairs.append(_Pair(a, b, lc, rc))
        if j.extra is not None:
            cols = sorted(j.extra.columns())
            for col in cols:
                own(col)
            residuals.append((j.extra, cols))
    return pairs, residuals


def validate_order(order: Sequence[int], k: int,
                   adj: Dict[int, set]) -> List[int]:
    """A usable order is a permutation of range(k) where every unit
    after the first joins something already placed (no cartesian
    steps). Raises ValueError — an invalid order is a caller bug, not a
    fallback condition."""
    order = [int(x) for x in order]
    if sorted(order) != list(range(k)):
        raise ValueError(f"order {order} is not a permutation of "
                         f"range({k})")
    placed = {order[0]}
    for v in order[1:]:
        if not (adj[v] & placed):
            raise ValueError(f"order {order}: unit {v} joins nothing "
                             "already placed (cartesian step)")
        placed.add(v)
    return order


def seeded_order(meta: dict, seed: int) -> List[int]:
    """A deterministic pseudo-random *valid* order — the raw material
    for the permutation property test and the adversarial robustness
    bench (`reorder_fn=lambda m: seeded_order(m, s)`)."""
    k = len(meta["rows"])
    adj: Dict[int, set] = {i: set() for i in range(k)}
    for a, b in meta["edges"]:
        adj[a].add(b)
        adj[b].add(a)
    rng = np.random.default_rng(seed)
    order = [int(rng.integers(0, k))]
    placed = set(order)
    while len(order) < k:
        frontier = sorted(v for v in range(k) if v not in placed
                          and adj[v] & placed)
        if not frontier:      # disconnected graph: caller falls back
            frontier = sorted(v for v in range(k) if v not in placed)
        v = frontier[int(rng.integers(0, len(frontier)))]
        order.append(v)
        placed.add(v)
    return order


# --------------------------------------------------------------------------
# greedy min-intermediate-size enumeration
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _REdge:
    """All pairs between one unit pair, with transfer-derived match
    fractions and the containment denominators: per column pair, the
    larger side's *exact* post-transfer distinct-key count. `dom` is
    the best (largest) of them — the single-pair join denominator —
    and `doms` keeps every pair's, because a chain step joins on up to
    *two* pairs at once when the packed composite encoding allows, so
    the two largest denominators jointly size the step's output."""

    a: int
    b: int
    m_a: float = 1.0     # fraction of a's live rows matching b
    m_b: float = 1.0
    dom: float = 1.0
    doms: List[float] = dataclasses.field(default_factory=list)


def _step_cost(n_build: float, n_probe: float, est_out: float,
               costs: TransferCosts, shards: Optional[int]) -> float:
    """Modeled ns for one chain step: build + probe at the per-row
    coefficients, output assembly at the cache-resident or memory-bound
    join rate (the radix-crossover regime switch, `costs.large_n`),
    plus — under the distributed engine — the cheaper of the modeled
    broadcast / shuffle wire volumes (`engine_join_dist`'s own
    per-join cost choice, priced in ns)."""
    rate = costs.join_large if max(n_build, n_probe) >= costs.large_n \
        else costs.join_small
    c = costs.build * n_build + costs.probe * n_probe + rate * est_out
    if shards is not None and shards > 1:
        wire = min((shards - 1) * KEY_WIRE_BYTES * n_build,
                   (1.0 - 1.0 / shards) * ROW_WIRE_BYTES
                   * (n_build + n_probe))
        c += WIRE_NS_PER_BYTE * wire
    return c


def ndistinct(cur: JoinCursor, col: str) -> int:
    """Exact distinct count of one join column's valid (non-NULL) keys
    — the denominator that makes join-size estimates trustworthy on
    post-transfer data (a modeled domain bound cannot see that transfer
    left only 5 live nations behind a many-to-many nationkey edge)."""
    if len(cur) == 0:
        return 0
    arr = np.asarray(cur.key((col,)))
    valid = cur.key_valid((col,))
    if valid is not None:
        arr = arr[np.asarray(valid)]
    return int(np.unique(arr).size)


def _chain_packable(cur: JoinCursor, col: str) -> bool:
    """May `col` participate in a 2-pair composite chain join? True iff
    the *full slot* column provably takes `composite_key`'s loss-less
    packed path (values in [0, 2^31)); any row subset inherits the
    bounds and packs too, so both sides of the step are guaranteed the
    same exact encoding — the probabilistic hash-combine fallback is
    never newly introduced. O(1) via the column's cached bounds."""
    c = cur.slots[cur.colmap[col]].table[col]
    return len(c) == 0 or ops._packable(c)


def region_edges(region: Region, cursors: Sequence[JoinCursor],
                 pairs: Sequence[_Pair], info: Optional[ReorderInfo]
                 ) -> Dict[Tuple[int, int], _REdge]:
    alias: List[Optional[str]] = []
    for u in region.units:
        alias.append(info.alias.get(u.leaf_id)
                     if isinstance(u, LeafNode) and info is not None
                     else None)
    match = info.match if info is not None else {}
    nd_cache: Dict[Tuple[int, str], int] = {}

    def nd(i: int, col: str) -> int:
        if (i, col) not in nd_cache:
            nd_cache[(i, col)] = ndistinct(cursors[i], col)
        return nd_cache[(i, col)]

    edges: Dict[Tuple[int, int], _REdge] = {}
    for p in pairs:
        a, b = min(p.a, p.b), max(p.a, p.b)
        a_col, b_col = ((p.a_col, p.b_col) if p.a <= p.b
                        else (p.b_col, p.a_col))
        # containment estimator: |R ⋈ S| = |R|·|S| / max(V_R, V_S).
        # The *max* matters when the two sides' live key sets diverge —
        # an un-transferred fact side keeps its full key domain while
        # the filtered build side holds a sliver, and dividing by the
        # sliver overprices every such join ~V_big/V_small-fold
        d = max(1.0, float(max(nd(a, a_col), nd(b, b_col))))
        p.dom = d
        e = edges.get((a, b))
        if e is None:
            m_a = m_b = 1.0
            if alias[a] is not None and alias[b] is not None:
                m_a = match.get((alias[b], alias[a]), 1.0)
                m_b = match.get((alias[a], alias[b]), 1.0)
            edges[(a, b)] = _REdge(a, b, m_a=m_a, m_b=m_b, dom=d,
                                   doms=[d])
        else:
            e.dom = max(e.dom, d)
            e.doms.append(d)
    return edges


#: exact subset-DP bound: 2^k * k step evaluations; 13 units ≈ 100k
#: evaluations, still microseconds next to any join
_DP_MAX_UNITS = 13

#: deadline granularity inside the subset DP: `QueryContext.check` runs
#: once per this many DP states, bounding overrun to a few hundred
#: cheap arithmetic steps past the deadline
_CTX_CHECK_MASKS = 256

#: spine-keep hysteresis: keep the plan's own tree unless the DP's
#: best order is modeled at least this much cheaper. A reorder that
#: wins small-to-moderate on the model loses in practice — the chain
#: pays real overhead (trackers, restoration sort, composite-key
#: gathers) the model does not price — while 2502.15181's own
#: conclusion is that post-transfer ordering rarely matters on a sane
#: plan. Runtime ordering is insurance against *misestimates*:
#: genuinely broken spines (the many-to-many hub plan of
#: `q5(join_order=3)`) clear this bar by an order of magnitude; every
#: sane spine in the TPC-H suite stays on the zero-overhead static
#: path. The ratio is the reference package's, not re-tuned here.
_SPINE_KEEP_RATIO = 3.0


def _spine_steps(region: Region) -> List[Tuple[int, int]]:
    """The plan's own joins as (left_mask, right_mask) unit-bitmask
    pairs, bottom-up — the tree's *actual shape*, so the hysteresis
    prices what the static fast path would really execute. (Flattening
    a bushy tree to its left-deep spine misprices it: a bushy plan that
    builds two small sides before linking them shares a leaf order with
    the fact-table-first chain yet costs nothing like it.)"""
    uidx = {id(u): i for i, u in enumerate(region.units)}
    steps: List[Tuple[int, int]] = []

    def walk(n) -> int:
        i = uidx.get(id(n))
        if i is not None:
            return 1 << i
        lm, rm = walk(n.left), walk(n.right)
        steps.append((lm, rm))
        return lm | rm

    walk(region.root)
    return steps


def _dp_order(k: int, rows: Sequence[float],
              edges: Dict[Tuple[int, int], _REdge],
              adj: Dict[int, set], costs, shards: Optional[int],
              spine: Sequence[Tuple[int, int]], ctx=None
              ) -> Tuple[List[int], List[float]]:
    """Exact min-modeled-cost left-deep order by DP over subsets
    (Selinger over the `greedy_order` cost model). Cartesian steps are
    never considered; ties break toward the lowest unit index, so the
    result is deterministic. `ctx` (a `QueryContext`) is consulted
    every `_CTX_CHECK_MASKS` DP states — the subset walk is the one
    ordering-phase loop whose work grows 2^k, so a deadline must be
    able to interrupt it mid-search."""
    full = (1 << k) - 1
    # per-unit incidence + adjacency bitmasks, hoisted out of the mask
    # loops: the DP visits 2^k masks, and iterating edges.items() per
    # mask is the difference between microseconds and milliseconds
    inc: List[List[Tuple[int, float, float, List[float]]]] = \
        [[] for _ in range(k)]
    adj_mask = [0] * k
    for (a, b), e in edges.items():
        ds = sorted(e.doms, reverse=True)
        sel = e.m_a * e.m_b / e.dom
        inc[a].append((b, e.m_a, sel, ds))
        inc[b].append((a, e.m_b, sel, ds))
        adj_mask[a] |= 1 << b
        adj_mask[b] |= 1 << a

    card = [1.0] * (full + 1)
    for i in range(k):
        card[1 << i] = max(rows[i], 1.0)
    for mask in range(3, full + 1):
        if mask & (mask - 1) == 0:
            continue
        w = (mask & -mask).bit_length() - 1
        rest = mask ^ (1 << w)
        c = card[rest] * max(rows[w], 1.0)
        for u, _m, sel, _ds in inc[w]:
            if (rest >> u) & 1:
                c *= sel
        card[mask] = max(c, 1.0)

    def join_size(tmask: int, v: int) -> float:
        # every connecting pair's denominator; the chain joins on the
        # best TWO at once when the packed composite encoding allows
        # (TPC-H keys always pack), so the two largest divide the
        # step's output — each edge's match fraction applied once
        terms: List[Tuple[float, float]] = []
        for u, m, _sel, ds in inc[v]:
            if (tmask >> u) & 1:
                terms.append((ds[0], m))
                for d in ds[1:]:
                    terms.append((d, 1.0))
        terms.sort(key=lambda t: -t[0])
        cap = card[tmask] * max(rows[v], 1.0)
        join = cap
        for d, m in terms[:2]:
            join = join * m / d
        return min(join, cap)

    cost = [math.inf] * (full + 1)
    parent = [-1] * (full + 1)
    for i in range(k):
        cost[1 << i] = 0.0
    for step, mask in enumerate(sorted(range(3, full + 1),
                                key=lambda m: (bin(m).count("1"), m))):
        if ctx is not None and step % _CTX_CHECK_MASKS == 0:
            ctx.check("join")
        if mask & (mask - 1) == 0:
            continue
        for v in range(k):
            if not (mask >> v) & 1:
                continue
            t = mask ^ (1 << v)
            if math.isinf(cost[t]) or not (t & adj_mask[v]):
                continue
            sc = cost[t] + _step_cost(min(card[t], rows[v]),
                                      max(card[t], rows[v]),
                                      join_size(t, v), costs, shards)
            if sc < cost[mask]:
                cost[mask], parent[mask] = sc, v
    if parent[full] == -1:
        raise ReorderFallback("disconnected region join graph")
    order: List[int] = []
    mask = full
    while parent[mask] != -1:
        v = parent[mask]
        order.append(v)
        mask ^= 1 << v
    order.append(mask.bit_length() - 1)
    order.reverse()

    # spine-keep hysteresis: price the plan's own tree — its actual
    # shape, step by step — under the same model, and keep it unless
    # the DP order is decisively cheaper; keeping means the
    # zero-overhead static tree fast path in execute_region. A step
    # extending by a single unit prices like a chain step; a
    # multi-multi step's output is card[lm | rm] (the tree applies
    # every cross pair inside the join itself).
    spine_cost = 0.0
    for lm, rm in spine:
        if rm & (rm - 1) == 0:
            est = join_size(lm, rm.bit_length() - 1)
        elif lm & (lm - 1) == 0:
            est = join_size(rm, lm.bit_length() - 1)
        else:
            est = card[lm | rm]
        spine_cost += _step_cost(min(card[lm], card[rm]),
                                 max(card[lm], card[rm]),
                                 est, costs, shards)
    if spine_cost <= cost[full] * _SPINE_KEEP_RATIO:
        order = list(range(k))

    est_rows: List[float] = []
    mask = 1 << order[0]
    for v in order[1:]:
        mask |= 1 << v
        est_rows.append(card[mask])
    return order, est_rows


def greedy_order(region: Region, cursors: Sequence[JoinCursor],
                 pairs: Sequence[_Pair], adj: Dict[int, set],
                 info: Optional[ReorderInfo], ctx=None
                 ) -> Tuple[List[int], List[float]]:
    """Min-modeled-cost left-deep order. Cardinality estimates combine
    exact post-transfer live counts, exact per-column distinct-key
    counts, and per-edge match fractions: a subset S's cardinality is
    the order-independent

        card(S) = Π_{i∈S} rows_i · Π_{e⊆S} m_a(e) · m_b(e) / d_e

    (d_e: the edge's containment denominator, `_REdge.dom`), and one
    step
    S+v materializes the join on its best one or two pairs (the packed
    composite path) before the remaining edges filter:

        join(S, v) = card(S) · rows_v · Π_{best ≤2 pairs} m / d.

    Each step is priced by `_step_cost` (build + probe + output at the
    radix-crossover join rate, plus distributed wire bytes). Regions up
    to `_DP_MAX_UNITS` are solved *exactly* by subset DP over connected
    left-deep orders (2^k·k steps — trivial for TPC-H's ≤8-unit
    regions); larger regions fall back to greedy frontier extension
    under the same model. Raises `ReorderFallback` for a disconnected
    region graph (a cartesian step models infinitely badly — let the
    static tree do whatever it did)."""
    k = len(cursors)
    seen = {0}
    queue = [0]
    while queue:
        for w in adj[queue.pop()]:
            if w not in seen:
                seen.add(w)
                queue.append(w)
    if len(seen) != k:
        raise ReorderFallback("disconnected region join graph")

    costs = info.costs if info is not None else _default_costs()
    shards = info.shards if info is not None else None
    rows = [float(len(c)) for c in cursors]
    edges = region_edges(region, cursors, pairs, info)

    if k <= _DP_MAX_UNITS:
        return _dp_order(k, rows, edges, adj, costs, shards,
                         _spine_steps(region), ctx=ctx)

    # seed: the cheapest-modeled first join (the single-pair join
    # output is what the step materializes; match fractions from the
    # remaining filters shrink the *carried* cardinality afterwards)
    best = None
    for e in edges.values():
        join = rows[e.a] * rows[e.b] / e.dom
        sc = _step_cost(min(rows[e.a], rows[e.b]),
                        max(rows[e.a], rows[e.b]), join, costs, shards)
        key = (sc, min(e.a, e.b), max(e.a, e.b))
        if best is None or key < best[0]:
            best = (key, e, join * e.m_a * e.m_b)
    _, e0, card = best
    first, second = ((e0.a, e0.b) if (rows[e0.a], e0.a)
                     <= (rows[e0.b], e0.b) else (e0.b, e0.a))
    order = [first, second]
    in_s = {first, second}
    est_rows = [card]

    while len(order) < k:
        if ctx is not None:
            ctx.check("join")
        cand = None
        for v in range(k):
            if v in in_s or not (adj[v] & in_s):
                continue
            m_s, fan = 1.0, math.inf
            for (a, b), e in edges.items():
                if v == a and b in in_s:
                    m_side_s, m_side_v = e.m_b, e.m_a
                elif v == b and a in in_s:
                    m_side_s, m_side_v = e.m_a, e.m_b
                else:
                    continue
                m_s *= m_side_s
                fan = min(fan, rows[v] * m_side_v / e.dom)
            join = min(card * fan, card * rows[v])
            sc = _step_cost(min(card, rows[v]), max(card, rows[v]),
                            join, costs, shards)
            if cand is None or (sc, v) < (cand[0], cand[1]):
                cand = (sc, v, min(join * m_s, card * rows[v]))
        _, v, card = cand
        order.append(v)
        in_s.add(v)
        est_rows.append(card)
    return order, est_rows


# --------------------------------------------------------------------------
# region execution
# --------------------------------------------------------------------------


def execute_region(ex, region: Region, slots, stats) -> JoinCursor:
    """Execute one inner-join region under the executor's runtime
    order. Units run exactly as the static plan would run them; the
    ordering decision (and any fallback) is recorded in
    `stats.join_order`. The result is bit-identical to the static tree
    — same rows, same row order, same column order."""
    from repro_torch.relational.executor import JoinStat  # noqa: F401 (cycle)
    cursors = [ex._as_cursor(ex._exec_node(u, slots, stats))
               for u in region.units]
    k = len(cursors)
    entry = {"units": [c.name for c in cursors],
             "rows": [len(c) for c in cursors],
             "chosen": list(range(k)), "changed": False,
             "source": "greedy", "fallback": None, "est_rows": None}
    stats.join_order.append(entry)

    try:
        pairs, residuals = _link(region, cursors)
        adj: Dict[int, set] = {i: set() for i in range(k)}
        for p in pairs:
            adj[p.a].add(p.b)
            adj[p.b].add(p.a)
        fn: Optional[Callable] = ex.reorder_fn
        if fn is not None:
            meta = {"names": [c.name for c in cursors],
                    "rows": [len(c) for c in cursors],
                    "edges": sorted({(min(p.a, p.b), max(p.a, p.b))
                                     for p in pairs}),
                    "static": list(range(k))}
            order = validate_order(fn(meta), k, adj)
            entry["source"] = "fn"
        else:
            order, est_rows = greedy_order(region, cursors, pairs, adj,
                                           ex._reorder_info,
                                           ctx=ex._ctx)
            entry["est_rows"] = [round(float(r), 1) for r in est_rows]
    except ReorderFallback as f:
        entry["fallback"] = str(f)
        return _run_static_tree(ex, region, cursors, stats)

    entry["chosen"] = list(order)
    if order == list(range(k)):
        # chosen order IS the plan's spine order: run the original
        # static tree — no trackers, no restoration sort to pay
        return _run_static_tree(ex, region, cursors, stats)
    entry["changed"] = True
    return _run_chain(ex, region, cursors, order, pairs, residuals,
                      stats)


def _run_static_tree(ex, region: Region, cursors: Sequence[JoinCursor],
                     stats) -> JoinCursor:
    """The region's original static tree over the already-executed unit
    cursors — the fallback and the chosen-order-equals-spine fast path.
    Mirrors the executor's Join node handling exactly (per-join-filter
    strategies never reach the reorder path)."""
    from repro_torch.relational.executor import JoinStat
    by_id = {id(u): c for u, c in zip(region.units, cursors)}

    def run(n: PlanNode) -> JoinCursor:
        cur = by_id.get(id(n))
        if cur is not None:
            return cur
        if ex._ctx is not None:
            ex._ctx.check("join")
        probe, build = run(n.left), run(n.right)
        bidx, pidx = ops.join_indices_nullsafe(
            build.key(n.right_on), probe.key(n.left_on), how="inner",
            build_valid=build.key_valid(n.right_on),
            probe_valid=probe.key_valid(n.left_on),
            engine=ex.join_engine)
        out = JoinCursor.join(probe, build, bidx, pidx, "inner")
        stats.joins.append(JoinStat("inner", len(build), len(probe),
                                    len(probe), len(out)))
        if n.extra is not None:
            view = out.columns_view(sorted(n.extra.columns()))
            out = out.take(np.flatnonzero(n.extra(view).mask(len(out))))
        return out

    return run(region.root)


def _run_chain(ex, region: Region, cursors: Sequence[JoinCursor],
               order: Sequence[int], pairs: List[_Pair],
               residuals: List[Tuple[object, List[str]]],
               stats) -> JoinCursor:
    """Left-deep chain in `order`, then canonical-order restoration.

    Each step joins on its best one or two column pairs (two only when
    every column provably takes the loss-less packed composite path —
    exactly the encoding the static plan's own multi-pair joins use)
    and applies every other pair connecting the new unit — and every
    residual predicate whose columns are now present — as an exact
    equality/NULL-dropping filter. Position
    trackers (one empty-table slot per unit carrying an arange
    selection vector) ride through the chain; the final lexsort over
    them in spine order reproduces the static output order."""
    from repro_torch.relational.executor import JoinStat
    tracked: List[JoinCursor] = []
    tr_sids: List[int] = []
    for c in cursors:
        tr = Slot(Table({}, "__pos__"))
        sl = dict(c.slots)
        sl[tr.sid] = tr
        sel = dict(c.sel)
        sel[tr.sid] = np.arange(len(c), dtype=np.int64)
        tracked.append(JoinCursor(sl, sel, list(c.cols),
                                  set(c.nullable), len(c), c.name))
        tr_sids.append(tr.sid)

    pend_pairs = list(pairs)
    pend_res = list(residuals)

    def apply_residuals(cur: JoinCursor) -> JoinCursor:
        nonlocal pend_res
        rest = []
        for expr, cols in pend_res:
            if all(col in cur.colmap for col in cols):
                view = cur.columns_view(cols)
                cur = cur.take(np.flatnonzero(
                    expr(view).mask(len(cur))))
            else:
                rest.append((expr, cols))
        pend_res = rest
        return cur

    def pair_filter(cur: JoinCursor, p: _Pair) -> JoinCursor:
        keep = cur.key((p.a_col,)) == cur.key((p.b_col,))
        for col in (p.a_col, p.b_col):
            valid = cur.key_valid((col,))
            if valid is not None:
                keep &= valid
        return cur.take(np.flatnonzero(keep))

    in_s = {order[0]}
    cur = apply_residuals(tracked[order[0]])
    for v in order[1:]:
        if ex._ctx is not None:
            ex._ctx.check("join")
        conn = [p for p in pend_pairs
                if (p.a == v and p.b in in_s)
                or (p.b == v and p.a in in_s)]
        pend_pairs = [p for p in pend_pairs if p not in conn]

        def svcols(p: _Pair) -> Tuple[str, str]:
            return ((p.b_col, p.a_col) if p.a == v
                    else (p.a_col, p.b_col))

        if len(conn) > 1:
            # largest exact distinct-key overlap first (smallest
            # expected join output) — `_Pair.dom` was measured on the
            # post-transfer unit cursors by `region_edges`, so no
            # intermediate re-scan; stable on ties and on the
            # `reorder_fn` path (doms 0.0 -> plan order)
            conn = sorted(conn,
                          key=lambda p: (-p.dom, conn.index(p)))
        join_on = conn[:1]
        if len(conn) > 1 and all(
                _chain_packable(cur, svcols(p)[0])
                and _chain_packable(tracked[v], svcols(p)[1])
                for p in conn[:2]):
            # the best two pairs join as one packed composite key —
            # same exact encoding the static plan's own multi-pair
            # joins use (e.g. Q5's (l_suppkey, c_nationkey))
            join_on = conn[:2]
        s_on = tuple(svcols(p)[0] for p in join_on)
        v_on = tuple(svcols(p)[1] for p in join_on)
        vcur = tracked[v]
        if len(cur) >= len(vcur):
            probe, build = cur, vcur
            p_on, b_on = s_on, v_on
        else:
            probe, build = vcur, cur
            p_on, b_on = v_on, s_on
        bidx, pidx = ops.join_indices_nullsafe(
            build.key(b_on), probe.key(p_on), how="inner",
            build_valid=build.key_valid(b_on),
            probe_valid=probe.key_valid(p_on),
            engine=ex.join_engine)
        out = JoinCursor.join(probe, build, bidx, pidx, "inner")
        stats.joins.append(JoinStat("inner", len(build), len(probe),
                                    len(probe), len(out)))
        for p in conn:
            if all(p is not q for q in join_on):
                out = pair_filter(out, p)
        in_s.add(v)
        cur = apply_residuals(out)

    # canonical restoration: the static output is lex-ordered by unit
    # row positions in spine order (see module docstring)
    if len(cur) > 1:
        keys = []
        for sid in reversed(tr_sids):   # lexsort: last key is primary
            s = cur.sel[sid]
            keys.append(s if s is not None
                        else np.arange(len(cur), dtype=np.int64))
        idx = np.lexsort(tuple(keys))
        if not np.array_equal(idx,
                              np.arange(len(cur), dtype=np.int64)):
            cur = cur.take(idx)

    # strip trackers; restore the static column order (spine-order
    # accumulation with first-occurrence name shadowing — what the
    # static tree's probe-cols-first merge produces, left-deep or bushy)
    trset = set(tr_sids)
    cols: List[Tuple[str, int]] = []
    seen = set()
    for c in cursors:
        for n, sid in c.cols:
            if n not in seen:
                seen.add(n)
                cols.append((n, sid))
    return JoinCursor({sid: s for sid, s in cur.slots.items()
                       if sid not in trset},
                      {sid: s for sid, s in cur.sel.items()
                       if sid not in trset},
                      cols, set(cur.nullable) - trset, len(cur),
                      cursors[0].name)
