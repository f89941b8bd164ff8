"""Predicate transfer core: join graph, transfer graph, schedules, strategies.

Implements the paper's §3 exactly:

* the *join graph* is extracted from the query plan (vertex = base relation
  after local predicates, edge = equi-join);
* the *predicate transfer graph* orients every edge from the smaller
  (post-local-filter) relation to the larger one — a total order on
  vertices, hence a DAG, with no edge removed (works on cyclic graphs);
* the schedule is one **forward pass** (topological order; each vertex
  applies all incoming Bloom filters in one scan, then emits transformed
  outgoing filters) and one symmetric **backward pass**;
* outer/anti joins restrict the allowed transfer direction (§3.4);
* `Yannakakis` replaces Bloom filters with precise semi-joins over a BFS
  join tree (cycle edges dropped), `BloomJoin` does one-hop build→probe
  filtering inside each join, `NoPredTrans` does nothing — the paper's
  three baselines.

All per-row work (hashing, Bloom build/probe/transfer) runs through the
batched engine layer `repro_torch.core.engine_bloom` — backend-pluggable
over the `repro_torch.core.bloom` host mirror and the
`repro_torch.kernels.bloom` CUDA kernels, all with identical filter
semantics.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import bloom, provenance
from repro_torch.core.bloom import MinMaxFilter

from repro_torch.core.engine_bloom import BloomEngine, EngineKeys, get_engine
from repro_torch.core.graph import (  # noqa: F401  (re-exported)
    Edge, EdgeDecision, NoPredTrans, Strategy, TransferStats, Vertex,
)
from repro_torch.relational import ops

# strategies that take a `backend=` engine switch (numpy | cuda)
BACKEND_AWARE = {"bloom-join", "pred-trans", "pred-trans-opt",
                 "pred-trans-adaptive"}


class BloomJoin(Strategy):
    """One-hop, one-direction Bloom filtering inside each join (paper §2.1)."""

    name = "bloom-join"
    uses_per_join_filter = True

    def __init__(self, bits_per_key: int = bloom.DEFAULT_BITS_PER_KEY,
                 k: int = bloom.DEFAULT_K, backend: str = "numpy",
                 device_resident: Optional[bool] = None,
                 device="cuda"):
        self.bits_per_key = bits_per_key
        self.engine: BloomEngine = get_engine(
            backend, k=k, device_resident=device_resident,
            device=device)

    def prefilter(self, vertices, edges, ctx=None, hints=None):
        # no transfer phase, but record which engine the per-join
        # filters below will run on
        return TransferStats(strategy=self.name,
                             backend=self.engine.backend)

    def cache_signature(self):
        # prefilter is a no-op, so post-transfer slot state is the bare
        # compacted scan — shared with NoPredTrans (the per-join
        # filtering happens later, inside the join phase)
        return ("none",)

    def per_join_filter(self, build, probe, build_keys, probe_keys, stats):
        bk = self.engine.keys(ops.composite_key(build, build_keys))
        # NULL-tight: NULL build keys never match, so they stay out of
        # the filter (and its sizing)
        filt = self.engine.build_filter(
            bk, bits_per_key=self.bits_per_key,
            valid=ops.key_validity(build, build_keys))
        pk = self.engine.keys(ops.composite_key(probe, probe_keys))
        hit = self.engine.probe_filter(filt, pk)
        stats.filters_built += 1
        stats.filter_bytes += filt.nbytes()
        stats.rows_probed += len(pk)
        return hit


def _edge_label(src: Vertex, dst: Vertex, cols: Sequence[str]) -> str:
    return f"{src.alias}->{dst.alias}[{','.join(cols)}]"


def _transfer_order(vertices: Dict[int, Vertex],
                    live: Optional[Dict[int, int]] = None) -> List[int]:
    """Small -> large total order (paper §3.2 heuristic). Ties broken by
    leaf id; the orientation is therefore acyclic by construction."""
    if live is None:
        live = {lid: v.live for lid, v in vertices.items()}
    return [lid for lid in sorted(vertices,
                                  key=lambda lid: (live[lid], lid))]


class PredTrans(Strategy):
    """The paper's contribution. Forward + backward Bloom-filter passes over
    the small→large DAG; each vertex applies all incoming filters and emits
    transformed outgoing filters from a single scan, executed by the
    batched `repro_torch.core.engine_bloom` runtime (`backend=` selects the
    numpy host mirror or the CUDA kernels; `device=` where the latter
    run)."""

    name = "pred-trans"

    def __init__(self, bits_per_key: int = bloom.DEFAULT_BITS_PER_KEY,
                 k: int = bloom.DEFAULT_K, passes: int = 2,
                 prune: bool = False, lip_order: bool = True,
                 backend: str = "numpy",
                 device_resident: Optional[bool] = None,
                 device="cuda",
                 artifact_cache: Optional[object] = None):
        self.bits_per_key = bits_per_key
        self.k = k
        self.passes = passes  # 2 = forward+backward (paper); more allowed
        # prune: skip filters built from complete, untouched base relations
        # (they cannot reject FK-valid rows). The paper names this
        # "transfer path pruning" but leaves it out of its prototype, so
        # the faithful default is off; "pred-trans-opt" turns it on.
        self.prune = prune
        # lip_order: apply incoming filters most-selective-first (LIP-style
        # ordering, explicitly sanctioned in paper §3.2).
        self.lip_order = lip_order
        self.engine: BloomEngine = get_engine(
            backend, k=k, device_resident=device_resident,
            device=device)
        # cross-query transfer-artifact cache (DESIGN.md §12): filter
        # builds whose provenance signature matches an entry are reused
        # instead of rebuilt; None = per-query behavior, no sharing
        self.artifact_cache = artifact_cache

    def cache_signature(self):
        return ("pred-trans", self.bits_per_key, self.k, self.passes,
                self.prune, self.lip_order)

    # -- cross-query filter reuse (DESIGN.md §12) ----------------------
    def _cached_filter(self, fsig: Optional[bytes]):
        """(words, minmax) from the shared cache, or None."""
        if self.artifact_cache is None or fsig is None:
            return None
        return self.artifact_cache.get(("bloom", fsig))

    def _store_filter(self, fsig: Optional[bytes], words, mm,
                      v: Vertex, cost_ns: Optional[float] = None
                      ) -> None:
        if self.artifact_cache is None or fsig is None:
            return
        from repro_torch.core import device_plane
        # host-resident: shareable across engine backends
        # (bit-identical); a device-resident build syncs here, counted
        # (device words are the int32 bit pattern of the uint32 words)
        host = device_plane.to_host(words).view(np.uint32)
        self.artifact_cache.put(
            ("bloom", fsig), (host, mm), nbytes=host.nbytes + 32,
            versions=v.dep_versions, cost_ns=cost_ns)

    def prefilter(self, vertices, edges, ctx=None, hints=None):
        self._ctx = ctx
        # history-corrected selectivity estimates, keyed
        # (edge_label, pass_idx) — per-query scratch, supplied by the
        # executor from `plancache.SelHistory` on repeat fingerprints
        self._hints = hints or {}
        stats = TransferStats(strategy=self.name,
                              backend=self.engine.backend)
        # initial live counts, shared with the adaptive scheduler's
        # live cache (mask.sum() is O(rows) — never re-sum a mask
        # nothing touched)
        self._live0 = before = {lid: v.live
                                for lid, v in vertices.items()}
        t0 = time.perf_counter()
        order = _transfer_order(vertices, before)
        rank = {lid: i for i, lid in enumerate(order)}
        self._hk_cache: Dict[Tuple[int, Tuple[str, ...]],
                             EngineKeys] = {}
        # per-vertex edge adjacency, computed once per prefilter (the
        # passes below are O(V + E) per pass, not O(V·E))
        adj: Dict[int, List[Tuple[int, Edge]]] = {lid: []
                                                 for lid in vertices}
        for ei, e in enumerate(edges):
            if e.u in adj:
                adj[e.u].append((ei, e))
            if e.v in adj and e.v != e.u:
                adj[e.v].append((ei, e))

        self._run_passes(order, rank, vertices, adj, stats)

        # NaN-free actual-selectivity contract (graph.EdgeDecision): an
        # edge whose probe never ran — skipped, pruned, batched away by
        # a min-max cut or an earlier empty survivor set — measured
        # zero removed rows over zero probed rows
        for d in stats.edges:
            if math.isnan(d.act_sel):
                d.act_sel = 0.0

        stats.seconds = time.perf_counter() - t0
        stats.record_vertices(vertices, before,
                              after=getattr(self, "_lives", None))
        return stats

    def _run_passes(self, order, rank, vertices, adj, stats):
        for p in range(self.passes):
            if self._ctx is not None:
                self._ctx.check("transfer")
            forward = (p % 2 == 0)
            seq = order if forward else order[::-1]
            self._one_pass(seq, rank, forward, vertices, adj, stats, p)
            stats.passes_run += 1

    def _hashed(self, v: Vertex, cols: Sequence[str]) -> EngineKeys:
        """Hash a vertex's key column once and reuse across all edges and
        passes (the paper's one-scan transformation, vectorized). The
        raw composite key is stashed on the vertex so the join phase
        reuses it too (`repro_torch.core.engine_join`)."""
        key = (v.leaf_id, tuple(cols))
        hk = self._hk_cache.get(key)
        if hk is None:
            hk = self.engine.keys(v.key(cols))
            self._hk_cache[key] = hk
        return hk

    def _one_pass(self, seq, rank, forward, vertices, adj, stats,
                  pass_idx):
        """Process vertices in `seq` order; a filter flows along edge
        (a,b) iff rank order matches the pass direction and the edge
        allows that direction."""
        # pending[edge_idx] = (filter, source selectivity estimate,
        #                      filter provenance sig, source versions)
        pending: Dict[int, Tuple[bloom.BloomFilter, float,
                                 Optional[bytes], frozenset]] = {}

        def flows(src: int, dst: int, e: Edge) -> bool:
            ok_dir = (rank[src] < rank[dst]) == forward and src != dst
            return ok_dir and e.allows(src, dst)

        for lid in seq:
            if self._ctx is not None:
                self._ctx.check()       # per-vertex cancellation point
            v = vertices[lid]
            scan = self.engine.begin(v.mask)
            # 1. apply all incoming filters — one fused multi-filter
            #    probe over a single shrinking survivor set (rows leave
            #    the working set as soon as one filter misses)
            incoming = []
            for ei, e in adj[lid]:
                src = e.other(lid)
                if flows(src, lid, e) and ei in pending:
                    incoming.append((pending[ei][1], ei, e))
            if self.lip_order:          # most selective first (LIP-style)
                incoming.sort(key=lambda t: t[0])
            if incoming:
                before = scan.live
                stats.rows_probed += scan.probe(
                    [(pending[ei][0].words,
                      self._hashed(v, e.endpoint_cols(lid)))
                     for _, ei, e in incoming])
                v.mask = scan.mask
                # a probe that removed nothing left the survivor row
                # set — and so its provenance signature — unchanged
                if scan.live != before:
                    v.apply_filters_sig(
                        [(pending[ei][2],
                          v.canon_cols(e.endpoint_cols(lid)))
                         for _, ei, e in incoming],
                        [pending[ei][3] for _, ei, e in incoming])
            # 2. build transformed outgoing filters from the same
            #    survivor set — probe→build is one scan, never a rescan
            out_edges = [(ei, e) for ei, e in adj[lid]
                         if flows(lid, e.other(lid), e)]
            if not out_edges:
                continue
            live = scan.live
            if self.prune and not v.informative:
                # transfer-path pruning (§3.2) — skipped edges still
                # report a decision (0 probed rows), never vanish.
                # Destination counts come from the pre-transfer cache:
                # stats bookkeeping must not re-popcount masks inside
                # the timed loop.
                for ei, e in out_edges:
                    dv = vertices[e.other(lid)]
                    stats.edges.append(EdgeDecision(
                        _edge_label(v, dv, e.endpoint_cols(lid)),
                        pass_idx, "pruned", build_rows=live,
                        probe_rows=self._live0.get(dv.leaf_id, 0),
                        src=v.alias, dst=dv.alias))
                continue
            nblocks = bloom.blocks_for(max(live, 1), self.bits_per_key)
            sel = live / max(v.base_rows if v.base_rows > 0
                             else len(v.table), 1)
            built: Dict[int, tuple] = {}        # same cols => same filter
            for ei, e in out_edges:
                cols = e.endpoint_cols(lid)
                hk = self._hashed(v, cols)
                hit = built.get(id(hk))
                if hit is None:
                    fsig = provenance.filter_sig(
                        v.state_sig, v.canon_cols(cols), nblocks,
                        self.k)
                    ent = self._cached_filter(fsig)
                    if ent is not None:
                        words = ent[0]
                        stats.filters_reused += 1
                    else:
                        # NULL-tight: invalid-key rows never match, so
                        # they never earn filter bits (the vertex mask —
                        # and the filter sizing by live rows — stay
                        # untouched)
                        t0b = time.perf_counter_ns()
                        words = scan.build(hk, nblocks,
                                           valid=v.key_valid(cols))
                        self._store_filter(
                            fsig, words, None, v,
                            cost_ns=time.perf_counter_ns() - t0b)
                    built[id(hk)] = hit = (words, fsig)
                words, fsig = hit
                filt = bloom.BloomFilter(words, self.k)
                pending[ei] = (filt, sel, fsig, v.dep_versions)
                stats.filters_built += 1
                stats.filter_bytes += filt.nbytes()


# --------------------------------------------------------------------------
# adaptive cost-gated scheduling (DESIGN.md §11)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransferCosts:
    """Per-row cost coefficients (ns) for the adaptive scheduler's
    skip/apply decision (DESIGN.md §11).

    The *cost* side is linear: hash+probe per probe-side row and
    hash+build per build-side row, calibrated per backend (the
    reference package's calibration, `DEFAULT_COSTS` below).

    The *benefit* side is two-regime: the per-row join work a removed
    row saves depends on scale. Below `large_n` rows a join's build
    side is cache-resident and its probe+assembly costs about as much
    as the Bloom probe itself (`join_small`); above it, sorts and
    searches go memory-bound and each surviving row is several times
    more expensive (`join_large`). The boundary is the same
    measurement family as the sorted-vs-radix crossover
    (`engine_join.RADIX_MIN`). Absolute accuracy is not required — only
    the cost/benefit *ratio* gates an edge."""

    probe: float        # Bloom probe (incl. hash) per probe-side row
    build: float        # filter build (incl. hash) per build-side row
    join_small: float   # downstream join ns/row, cache-resident case
    join_large: float   # downstream join ns/row, memory-bound case
    # fixed per-applied-edge cost (ns): hash/probe/build dispatch and
    # estimation overhead is size-independent at the bottom (a 25-row
    # probe costs the same as a 1000-row one: the probe time at tiny
    # n). Edges whose whole benefit is
    # below this are pure overhead no matter how selective.
    fixed: float = 300_000.0
    # the large regime needs the vertex itself past this row count …
    # (same measurement family as the sorted-vs-radix crossover,
    # engine_join.RADIX_MIN — the join goes memory-bound about one
    # power of two before radix partitioning starts paying)
    large_n: int = 1 << 17
    # … and its joins to actually be expensive: either some partner
    # brings enough rows to pay repeated searches into the
    # DRAM-resident structure, or the vertex's own join key is
    # unsorted (its build-side argsort is O(n log n) random access;
    # a presorted key — TPC-H's o_orderkey — sorts as one run)
    partner_min: int = 1 << 12
    # transfer reductions propagate: a vertex shrunk here emits
    # smaller, more selective filters to its downstream neighbors in
    # the same pass. gamma discounts that transitive benefit per hop.
    gamma: float = 0.5


#: operating point of the reference package's host engine (its
#: `kernel_bench.calibrate` sweep, tuned end-to-end on TPC-H — the
#: *ratios* are what gate an edge). The reference's device rows were
#: calibrated for its JAX backends and do not carry over; until the H100
#: calibration exists (ROADMAP Queue 1 item 6) the cuda backend uses the
#: numpy row.
DEFAULT_COSTS: Dict[str, TransferCosts] = {
    "numpy": TransferCosts(probe=45.0, build=45.0,
                           join_small=40.0, join_large=110.0),
}
DEFAULT_COSTS["cuda"] = DEFAULT_COSTS["numpy"]


@dataclasses.dataclass
class _Emitted:
    """One emitted (or cached) filter in flight along an edge."""

    words: np.ndarray
    mm: Optional[MinMaxFilter]
    sel_est: float
    decision: EdgeDecision
    sig: Optional[bytes] = None       # filter provenance signature
    deps: frozenset = frozenset()     # source Table.version set


class AdaptivePredTrans(PredTrans):
    """Cost-gated predicate transfer (`pred-trans-adaptive`).

    Plain PredTrans pays for every edge in every pass; on queries where
    a transfer's build+probe cost exceeds the work its removed rows
    would have caused downstream, pre-filtering is a net loss. Per edge
    and per pass this strategy:

    * models the transfer cost ``c_build·|build live| +
      c_probe·|probe live|`` against the benefit ``sel_est · |probe
      live| · c_downstream`` and skips the edge when it cannot pay —
      `sel_est` is the estimated removed-row fraction, derived from the
      build side's live distinct-key count (KMV over the hash state the
      build needs anyway, `bloom.kmv_distinct`) over the edge's key
      domain (the smaller endpoint's base cardinality);
    * publishes a min-max range filter next to each Bloom filter
      (`bloom.MinMaxFilter`, built from the same live-key scan):
      provably disjoint ranges short-circuit the edge without a single
      probe (and an emptied vertex's empty range cascades for free),
      a contained probe range skips the range test, anything else
      applies the O(1)-per-row comparison *before* the Bloom probe;
    * early-exits the pass loop when a pass's total removed-row count
      falls below `early_exit_frac` of the live rows entering it, and
      caches filter builds across passes so a vertex whose survivor
      set did not change never rebuilds (or re-ranges) its filter;
    * records every decision as an `EdgeDecision` (estimated vs actual
      selectivity, modeled cost/benefit, 0 probed rows for skips) in
      `TransferStats.edges` — `benchmarks/run.py` persists them.

    Skipping any subset of edges only *grows* survivor sets; the join
    phase recomputes exact matches, so query results are bit-identical
    to the always-apply oracle (tests/test_transfer_adaptive.py sweeps
    `mode="force_skip" | "force_apply" | "auto"` across all engines).
    The distributed runtime reuses the same decisions — the transfer
    phase runs once on the host graph regardless of join engine — so a
    skipped edge also skips its filter broadcast
    (benchmarks/distributed_transfer.py accounts the saved bytes)."""

    name = "pred-trans-adaptive"

    MODES = ("auto", "force_apply", "force_skip")

    def __init__(self, bits_per_key: int = bloom.DEFAULT_BITS_PER_KEY,
                 k: int = bloom.DEFAULT_K, passes: int = 2,
                 lip_order: bool = True, backend: str = "numpy",
                 device_resident: Optional[bool] = None,
                 device="cuda",
                 mode: str = "auto",
                 costs: Optional[TransferCosts] = None,
                 minmax: bool = True,
                 early_exit_frac: float = 0.001,
                 artifact_cache: Optional[object] = None):
        super().__init__(bits_per_key=bits_per_key, k=k, passes=passes,
                         prune=False, lip_order=lip_order,
                         backend=backend,
                         device_resident=device_resident, device=device,
                         artifact_cache=artifact_cache)
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, "
                             f"got {mode!r}")
        self.mode = mode
        self.costs = costs or DEFAULT_COSTS[self.engine.backend]
        # min-max only makes sense when edges actually run (force_apply
        # must reproduce the always-apply oracle's survivor sets)
        self.minmax = minmax and mode == "auto"
        self.early_exit_frac = early_exit_frac

    def cache_signature(self):
        # the cost model gates which edges apply, so every coefficient
        # shapes the survivor masks — the per-backend DEFAULT_COSTS
        # differ, which is why `costs` is in and `backend` stays out
        return (("pred-trans-adaptive", self.bits_per_key, self.k,
                 self.passes, self.lip_order, self.mode, self.minmax,
                 self.early_exit_frac)
                + dataclasses.astuple(self.costs))

    # -- pass loop with early exit ------------------------------------
    def _run_passes(self, order, rank, vertices, adj, stats):
        # key-domain bounds per (vertex, endpoint cols): the smallest
        # base cardinality among the non-derived endpoints of every
        # edge sharing those columns. A dimension PK bounds the FK
        # domain of *every* relation joining on it — e.g. a derived
        # subquery carrying all 20k partkeys estimates sel 0 against
        # lineitem because `part` (base 20k) bounds l_partkey's
        # domain. Derived sources are excluded: their keys are a
        # filtered subset of some larger domain, so their row count
        # bounds nothing.
        self._dom: Dict[Tuple, int] = {}
        for lid, pairs in adj.items():
            v = vertices[lid]
            for ei, e in pairs:
                o = vertices.get(e.other(lid))
                if o is None:
                    continue
                key = (lid, tuple(e.endpoint_cols(lid)))
                cur = self._dom.get(key)
                if cur is None:
                    cur = v.base_rows if (not v.derived
                                          and v.base_rows > 0) \
                        else len(v.table)
                if not o.derived and o.base_rows > 0:
                    cur = min(cur, o.base_rows)
                self._dom[key] = cur
        # per-prefilter caches: filters/ranges by (leaf, cols) with the
        # live count AND provenance signature they were built at;
        # distinct estimates by (leaf, cols, live); conservative
        # probe-side ranges by (leaf, cols)
        self._fcache: Dict[Tuple, Tuple[np.ndarray,
                                        Optional[MinMaxFilter],
                                        int, Optional[bytes],
                                        int]] = {}
        self._dcache: Dict[Tuple, int] = {}
        self._rcache: Dict[Tuple, Optional[Tuple[int, int]]] = {}
        self._rcache2: Dict[int, float] = {}    # per-vertex join rate
        # live-count cache: mask.sum() is O(rows) and the scheduler
        # reads counts per edge — seeded from the prefilter's initial
        # counts, refreshed from the scan only when a vertex's mask
        # actually changed
        self._lives: Dict[int, int] = dict(self._live0)
        before = sum(self._lives.values())
        for p in range(self.passes):
            if self._ctx is not None:
                self._ctx.check("transfer")
            forward = (p % 2 == 0)
            seq = order if forward else order[::-1]
            self._one_pass(seq, rank, forward, vertices, adj, stats, p)
            stats.passes_run += 1
            after = sum(self._lives[lid] for lid in vertices)
            removed, entering = before - after, before
            before = after
            if self.mode == "force_apply":
                continue            # the always-apply oracle runs all
            if removed < max(1, int(self.early_exit_frac * entering)):
                break               # pass early-exit (DESIGN §11)

    # -- helpers -------------------------------------------------------
    def _fcache_get(self, lid: int, cols: Tuple[str, ...], live: int,
                    sig: Optional[bytes]):
        """Per-query filter-cache lookup, validated by the provenance
        signature of the vertex's *current* survivor state. The PR-5
        key validated by live count alone and could collide across
        predicate states that keep equal row counts over different
        rows; the signature cannot. The live-count check survives only
        as the fallback for signature-less vertices (constructed
        outside the executor), where it is sound: masks shrink
        monotonically within one prefilter, so an unchanged count means
        an unchanged mask."""
        cached = self._fcache.get((lid, cols))
        if cached is None:
            return None
        _, _, clive, csig, _ = cached
        if sig is None and csig is None:
            return cached if clive == live else None
        return cached if csig == sig else None

    def _rangeable(self, v: Vertex, cols: Tuple[str, ...]) -> bool:
        """Ranges are only meaningful for order-preserving composite
        encodings: single non-dictionary columns, or the packed
        two-column path. The hash-combine fallback scrambles order."""
        if any(v.table[c].dictionary is not None for c in cols):
            return False
        if len(cols) == 1:
            return True
        if len(cols) == 2:
            return ops.stable_key_encoding(v.table, cols)
        return False

    def _cons_range(self, v: Vertex, cols: Tuple[str, ...]
                    ) -> Optional[Tuple[int, int]]:
        """Conservative (possibly inherited, never rescanned) bounds on
        the vertex's key values — the probe side of the disjoint /
        contained tests. Wider-than-live bounds only make the checks
        more conservative, never wrong."""
        key = (v.leaf_id, cols)
        if key not in self._rcache:
            if not self._rangeable(v, cols):
                self._rcache[key] = None
            elif len(cols) == 1:
                self._rcache[key] = v.table[cols[0]].value_range()
            else:
                (alo, ahi) = v.table[cols[0]].value_range()
                (blo, bhi) = v.table[cols[1]].value_range()
                self._rcache[key] = ((alo << 32) | blo,
                                     (ahi << 32) | bhi)
        return self._rcache[key]

    def _sel_est(self, v: Vertex, scan, cols: Tuple[str, ...],
                 dv: Vertex, dcols: Tuple[str, ...]) -> float:
        """Estimated fraction of `dv`'s live rows an edge filter from
        `v` would remove: 1 - d_live / domain, where d_live is the KMV
        distinct estimate over the build side's live key hashes (reused
        by the build itself) and domain is the edge's key-domain bound
        (`self._dom`) — the smallest non-derived base cardinality among
        the endpoints of every edge sharing the destination's key
        columns (a derived build side's keys are a filtered subset of
        some larger domain, so its own row count bounds nothing)."""
        live = scan.live
        if live == 0:
            return 1.0
        ck = (v.leaf_id, cols, live)
        d = self._dcache.get(ck)
        if d is None:
            hk = self._hashed(v, cols)
            d = bloom.kmv_distinct(scan.live_hashes(hk))
            self._dcache[ck] = d
        dom = self._dom.get((dv.leaf_id, dcols),
                            dv.base_rows if dv.base_rows > 0
                            else len(dv.table))
        if not v.derived and v.base_rows > 0:
            dom = min(dom, v.base_rows)
        return 1.0 - min(1.0, d / max(dom, 1))

    def _live_range(self, v: Vertex, scan, cols: Tuple[str, ...]
                    ) -> Optional[MinMaxFilter]:
        """Exact [lo, hi] of the live, valid keys — the emitted edge's
        min-max filter, computed from the same survivor scan the Bloom
        build reads."""
        if not self._rangeable(v, cols):
            return None
        rng = scan.key_range(v.key(cols), ek=self._hashed(v, cols),
                             valid=v.key_valid(cols))
        if rng is None:
            # no live, valid key: the empty (inverted) range — disjoint
            # with everything, so an emptied vertex cascades for free
            return MinMaxFilter(0, -1)
        return MinMaxFilter(*rng)

    # -- the scheduled pass --------------------------------------------
    def _join_rate(self, lid: int, vertices, adj) -> float:
        """Modeled ns saved downstream per removed row of vertex `lid`
        (DESIGN §11): the per-join rate — memory-bound `join_large`
        when the vertex is big and its joins are actually expensive
        (some partner past the cache-resident build size, or its own
        join key unsorted so the build-side argsort pays full price),
        else cache-resident `join_small` — times the number of joins a
        surviving row flows through (`Vertex.join_depth`)."""
        rate = self._rcache2.get(lid)
        if rate is not None:
            return rate
        costs = self.costs
        v = vertices[lid]
        live0 = self._live0[lid]
        base = costs.join_small
        if live0 >= costs.large_n:
            maxp = max((self._live0[e.other(lid)]
                        for ei, e in adj[lid]
                        if e.other(lid) in self._live0), default=0)
            if maxp >= costs.partner_min:
                base = costs.join_large
            else:
                for ei, e in adj[lid]:
                    k = v.key(e.endpoint_cols(lid))
                    if len(k) and not bool(np.all(k[1:] >= k[:-1])):
                        base = costs.join_large
                        break
        rate = base * v.join_depth
        self._rcache2[lid] = rate
        return rate

    def _reach(self, seq, vertices, adj, flows) -> Dict[int, float]:
        """Damped downstream row-mass per vertex for this pass:
        R(x) = live(x)·join_rate(x) + gamma·Σ R(y) over the vertices
        x's filters flow to. The benefit of removing a fraction of x's
        rows is that fraction of R(x): the rows' own downstream join
        work plus the (per-hop discounted) shrinkage of the filters x
        emits later in the pass. A downstream edge only contributes if
        it is itself gate-1 feasible (probing y must cost less than
        y's reach) — a chain that dead-ends in an edge the scheduler
        will skip propagates nothing. One O(V+E) walk in reverse pass
        order (downstream vertices are later in `seq`, so their R is
        already final when x is visited)."""
        costs = self.costs
        lives = self._lives
        R: Dict[int, float] = {}
        for lid in reversed(seq):
            r = lives[lid] * self._join_rate(lid, vertices, adj)
            for ei, e in adj[lid]:
                dst = e.other(lid)
                if flows(lid, dst, e) \
                        and costs.probe * lives[dst] < R[dst]:
                    r += costs.gamma * R[dst]
            R[lid] = r
        return R

    def _one_pass(self, seq, rank, forward, vertices, adj, stats,
                  pass_idx):
        pending: Dict[int, _Emitted] = {}
        costs = self.costs

        def flows(src: int, dst: int, e: Edge) -> bool:
            ok_dir = (rank[src] < rank[dst]) == forward and src != dst
            return ok_dir and e.allows(src, dst)

        lives = self._lives

        def live_of(dv: Vertex) -> int:
            n = lives.get(dv.leaf_id)
            if n is None:
                lives[dv.leaf_id] = n = dv.live
            return n

        reach = self._reach(seq, vertices, adj, flows) \
            if self.mode == "auto" else {}
        # expected surviving fraction per destination this pass: edges
        # into one vertex share a fused probe, so a later filter only
        # probes — and only removes — what the earlier ones left.
        # Costs and benefits both shrink by the accumulated factor.
        surv: Dict[int, float] = {}

        for lid in seq:
            if self._ctx is not None:
                self._ctx.check()       # per-vertex cancellation point
            v = vertices[lid]
            scan = self.engine.begin(v.mask)

            # 1. incoming filters: min-max first (disjoint ranges cut
            #    the edge — and possibly the vertex — without a probe),
            #    then one fused Bloom probe in LIP order
            incoming = [(pending[ei], ei, e) for ei, e in adj[lid]
                        if flows(e.other(lid), lid, e) and ei in pending]
            if self.lip_order:      # most selective (est.) first
                incoming.sort(key=lambda t: -t[0].sel_est)
            cut = False
            for pf, ei, e in incoming:
                cols = tuple(e.endpoint_cols(lid))
                if pf.mm is None or not self.minmax:
                    continue
                cons = self._cons_range(v, cols)
                if cons is None:
                    continue
                if pf.mm.disjoint(*cons):
                    # no live key can pass: the edge removes everything
                    # without one hash — incl. the empty-build cascade
                    # (an emptied vertex emits an empty range)
                    scan.clear()
                    if pf.sig is None:
                        v.state_sig = None
                    else:
                        v.chain_event(("cut", pf.sig), pf.deps)
                    pf.decision.action = "minmax-cut"
                    pf.decision.act_sel = 1.0
                    cut = True
                    break
                if not pf.mm.contains(*cons):
                    # the O(1)-per-row test pays only when the overlap
                    # suggests it removes rows: under uniform keys the
                    # expected removal is 1 - overlap/width
                    lo = max(cons[0], pf.mm.lo)
                    hi = min(cons[1], pf.mm.hi)
                    width = max(cons[1] - cons[0] + 1, 1)
                    if (hi - lo + 1) / width < 0.98:
                        n0 = scan.live
                        stats.rows_range_tested += scan.probe_range(
                            v.key(cols), pf.mm.lo, pf.mm.hi,
                            ek=self._hashed(v, cols))
                        # the signature names the survivor *row set*:
                        # a cut that removed nothing left it unchanged
                        if scan.live != n0:
                            v.chain_event(("range", v.canon_cols(cols),
                                           int(pf.mm.lo),
                                           int(pf.mm.hi)),
                                          pf.deps)
            if cut:
                v.mask = scan.mask
            elif incoming:
                enter = before = scan.live
                stats.rows_probed += scan.probe(
                    [(pf.words, self._hashed(v, e.endpoint_cols(lid)))
                     for pf, ei, e in incoming])
                for (pf, ei, e), after in zip(incoming,
                                              scan.live_after):
                    pf.decision.rows_probed += enter
                    if enter > 0:
                        pf.decision.act_sel = 1.0 - after / enter
                    enter = after
                v.mask = scan.mask
                # `enter` is now the post-probe live count: a fused
                # probe that removed nothing left the row set — and so
                # its signature — unchanged (cross-pass filter reuse)
                if enter != before:
                    v.apply_filters_sig(
                        [(pf.sig, v.canon_cols(e.endpoint_cols(lid)))
                         for pf, ei, e in incoming],
                        [pf.deps for pf, ei, e in incoming])

            if cut or incoming:
                lives[lid] = scan.live

            # 2. outgoing filters, cost-gated per edge
            out_edges = [(ei, e) for ei, e in adj[lid]
                         if flows(lid, e.other(lid), e)]
            if not out_edges:
                continue
            live = lives[lid]
            for ei, e in out_edges:
                dv = vertices[e.other(lid)]
                cols = tuple(e.endpoint_cols(lid))
                dec = EdgeDecision(_edge_label(v, dv, cols), pass_idx,
                                   "applied", build_rows=live,
                                   probe_rows=live_of(dv),
                                   src=v.alias, dst=dv.alias)
                stats.edges.append(dec)
                if self.mode == "force_skip":
                    dec.action = "skipped-forced"
                    continue
                cached = self._fcache_get(lid, cols, live, v.state_sig)
                c_build = 0.0 if cached is not None \
                    else costs.build * live
                dlive = dec.probe_rows
                if self.mode == "auto":
                    # Vertex.informative with the already-known live
                    # count (the property would re-popcount the mask)
                    informative = (v.derived or v.base_rows < 0
                                   or len(v.table) < v.base_rows
                                   or live < len(v.table))
                    if not informative and live > 0:
                        # complete untouched base relation: its filter
                        # cannot reject FK-valid rows (paper §3.2)
                        dec.action = "pruned"
                        dec.cost_ns = c_build + costs.probe * dlive
                        continue
                    frac = surv.get(dv.leaf_id, 1.0)
                    dec.cost_ns = cost = \
                        costs.fixed + c_build + \
                        costs.probe * dlive * frac
                    # gate 1: even removing every remaining probe row
                    # (sel = 1) can't pay — kills big-build and
                    # small-reach edges before any estimation work
                    cap = frac * reach[dv.leaf_id]
                    if cost >= cap:
                        dec.action = "skipped"
                        dec.est_sel = float("nan")
                        dec.benefit_ns = cap
                        continue
                    dec.est_sel = sel = self._sel_est(
                        v, scan, cols, dv,
                        tuple(e.endpoint_cols(e.other(lid))))
                    # second-query-onward correction: a measured actual
                    # for this (edge, pass) from an earlier run of the
                    # same plan fingerprint overrides the KMV estimate.
                    # Transfer filters have no false negatives, so a
                    # different gate outcome changes survivor sets but
                    # never query results.
                    hint = self._hints.get((dec.edge, pass_idx))
                    if hint is not None:
                        dec.est_sel = sel = min(max(hint, 0.0), 1.0)
                        stats.hints_used += 1
                    dec.benefit_ns = benefit = sel * cap
                    if benefit <= cost:
                        dec.action = "skipped"
                        continue
                    surv[dv.leaf_id] = frac * (1.0 - sel)
                else:
                    dec.cost_ns = c_build + costs.probe * dlive
                nblocks = bloom.blocks_for(max(live, 1),
                                           self.bits_per_key)
                fsig = provenance.filter_sig(
                    v.state_sig, v.canon_cols(cols), nblocks, self.k,
                    self.minmax)
                if cached is not None:
                    words, mm, _, _, nbytes = cached
                else:
                    ent = self._cached_filter(fsig)
                    if ent is not None:
                        words, mm = ent
                        nbytes = bloom.BloomFilter(words,
                                                   self.k).nbytes()
                        stats.filters_reused += 1
                    else:
                        t0b = time.perf_counter_ns()
                        hk = self._hashed(v, cols)
                        words = scan.build(hk, nblocks,
                                           valid=v.key_valid(cols))
                        mm = self._live_range(v, scan, cols) \
                            if self.minmax else None
                        build_ns = time.perf_counter_ns() - t0b
                        nbytes = bloom.BloomFilter(words,
                                                   self.k).nbytes()
                        stats.filters_built += 1
                        stats.filter_bytes += nbytes
                        dec.filter_bytes = nbytes
                        self._store_filter(fsig, words, mm, v,
                                           cost_ns=build_ns)
                    self._fcache[(lid, cols)] = (words, mm, live,
                                                 v.state_sig, nbytes)
                pending[ei] = _Emitted(words, mm, dec.est_sel, dec,
                                       fsig, v.dep_versions)


class Yannakakis(Strategy):
    """Semi-join reduction baseline (paper §2.2 / §4.1 extensions):
    BFS join tree from `root_seed`-chosen root (cycle edges dropped),
    bottom-up then top-down precise semi-join passes."""

    name = "yannakakis"

    def __init__(self, root_seed: int = 0):
        self.root_seed = root_seed

    def cache_signature(self):
        # the BFS tree (and so the final masks) depends only on the
        # seed-chosen root; semi-joins are exact, no filter params
        return ("yannakakis", self.root_seed)

    def prefilter(self, vertices, edges, ctx=None, hints=None):
        stats = TransferStats(strategy=self.name)
        before = {lid: v.live for lid, v in vertices.items()}
        t0 = time.perf_counter()

        ids = sorted(vertices.keys())
        if not ids:
            return stats
        rng = np.random.default_rng(self.root_seed)
        root = ids[int(rng.integers(0, len(ids)))]

        # BFS tree; keep first edge reaching each vertex, drop cycle edges
        adj: Dict[int, List[Tuple[int, Edge]]] = {i: [] for i in ids}
        for e in edges:
            adj[e.u].append((e.v, e))
            adj[e.v].append((e.u, e))
        parent: Dict[int, Optional[Tuple[int, Edge]]] = {root: None}
        bfs_order = [root]
        frontier = [root]
        while frontier:
            nxt = []
            for a in frontier:
                for b, e in adj[a]:
                    if b not in parent:
                        parent[b] = (a, e)
                        bfs_order.append(b)
                        nxt.append(b)
            frontier = nxt
        # disconnected leaves (cartesian subplans) just skip transfer
        reachable = [i for i in bfs_order if i in vertices]

        def semi(dst: int, src: int, e: Edge):
            """dst.mask &= dst ⋉ src (precise)."""
            if ctx is not None:
                ctx.check("transfer")   # per-semi-join cancellation
            if not e.allows(src, dst):
                return
            vd, vs = vertices[dst], vertices[src]
            dkeys = vd.key(e.endpoint_cols(dst))
            # NULL-tight: a NULL build key's representative bytes must
            # not keep spurious dst rows alive
            svalid = vs.key_valid(e.endpoint_cols(src))
            smask = vs.mask if svalid is None else vs.mask & svalid
            skeys = vs.key(e.endpoint_cols(src))[smask]
            hit = ops.semi_join_mask(dkeys, skeys)
            vd.mask &= hit
            # semi-join mask mutations are outside the transfer event
            # protocol — poison the provenance chain rather than let a
            # stale signature certify a filter from the wrong rows
            vd.state_sig = None
            stats.rows_semijoin_build += len(skeys)
            stats.rows_semijoin_probe += len(dkeys)

        # forward: bottom-up (children filter parents)
        for b in reversed(reachable):
            pa = parent.get(b)
            if pa is not None:
                a, e = pa
                semi(a, b, e)
        # backward: top-down (parents filter children)
        for b in reachable:
            pa = parent.get(b)
            if pa is not None:
                a, e = pa
                semi(b, a, e)

        stats.seconds = time.perf_counter() - t0
        stats.record_vertices(vertices, before)
        return stats


def _pred_trans_opt(**kw):
    kw.setdefault("prune", True)
    return PredTrans(**kw)


STRATEGIES = {
    "no-pred-trans": NoPredTrans,
    "bloom-join": BloomJoin,
    "yannakakis": Yannakakis,
    "pred-trans": PredTrans,          # paper-faithful (no pruning)
    "pred-trans-opt": _pred_trans_opt,  # + transfer-path pruning
    "pred-trans-adaptive": AdaptivePredTrans,  # + cost-gated scheduling
}


def make_strategy(name: str, **kw) -> Strategy:
    """`backend="numpy"|"cuda"` selects the bloom engine for the
    strategies in BACKEND_AWARE, `device=` where the cuda engine runs
    (default "cuda"; "cpu" runs the kernels' plain versions, for tests)
    and `device_resident=` its data plane; other strategies reject all
    three (they do no Bloom work)."""
    for knob in ("backend", "device", "device_resident"):
        if knob in kw and name not in BACKEND_AWARE:
            raise ValueError(f"strategy {name!r} takes no bloom {knob}")
    return STRATEGIES[name](**kw)
