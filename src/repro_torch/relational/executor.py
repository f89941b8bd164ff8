"""Strategy-aware plan executor.

Phases (paper §3.1):
  0. scan/local-filter: resolve leaves, apply pushed-down local predicates
     (and execute subquery leaves first, per §3.4);
  1. transfer: the chosen `Strategy` pre-filters the leaf tables
     (no-op for No-Pred-Trans / Bloom-Join);
  2. join: execute the plan bottom-up over the reduced leaves through the
     late-materialized join runtime (`repro_torch.core.engine_join`): join
     subtrees flow as selection-vector cursors, payload columns are
     gathered once at the first value-needing operator, and join keys are
     the per-leaf composites already computed by the transfer phase.
     Bloom-Join applies its one-hop filter inside each join here.

`late_materialize=False` runs the legacy eager path (`ops.hash_join` at
every node) — kept as the bit-exactness oracle for the lazy runtime.

The executor records the paper's accounting: per-join build (HT) and probe
(PR) input rows, phase wall-times, per-vertex reduction factors, and the
join phase's materialization traffic in bytes.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import (
    Callable, Dict, List, Mapping, Optional, Tuple, Union,
)

import numpy as np

from repro_torch.core import device_plane, provenance
from repro_torch.core.engine_join import JoinCursor, Slot, get_join_engine
from repro_torch.core.errors import (
    BackendError, DeadlineExceeded, QueryCancelled, QueryContext,
    ResourceExhausted,
)
from repro_torch.core.graph import (
    Edge, NoPredTrans, Strategy, TransferStats, Vertex, decision_counts,
)
from repro_torch.relational import ops, reorder as reorder_mod
from repro_torch.relational.expr import Col
from repro_torch.relational.plan import (
    Bind, Filter, GroupBy, Join, LeafNode, Limit, PlanNode, Project, Scan,
    Sort, SubqueryScan,
)
from repro_torch.relational.plancache import (
    PlanInfo, expr_fingerprint, plan_fingerprint,
)
from repro_torch.relational.table import Column, Table


@dataclasses.dataclass
class JoinStat:
    how: str
    ht_rows: int
    pr_rows: int
    pr_rows_pre_bloom: int
    out_rows: int


@dataclasses.dataclass
class ExecStats:
    strategy: str = ""
    phase_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    transfer: Optional[TransferStats] = None
    joins: List[JoinStat] = dataclasses.field(default_factory=list)
    result_rows: int = 0
    # bytes gathered by the join phase when materializing intermediate /
    # final payload columns (the late-materialization win metric)
    join_materialized_bytes: int = 0
    # distributed runtime accounting (engine="distributed" only):
    # per-join strategy + shuffle/broadcast wire bytes
    # (repro_torch.core.engine_join_dist.DistStats)
    dist: Optional[object] = None
    subqueries: List["ExecStats"] = dataclasses.field(default_factory=list)
    # degradation-ladder record (DESIGN.md §13): one dict per fallback
    # taken before this result was produced — {"from", "to", "phase",
    # "error", "detail"}. Empty = the query ran on its requested config.
    degraded: List[dict] = dataclasses.field(default_factory=list)
    # runtime join-ordering record (DESIGN.md §14): one dict per
    # inner-join region — {"units", "rows", "chosen", "changed",
    # "source", "fallback", "est_rows"}. Empty = no reorderable region
    # (or reorder off / eager oracle / per-join-filter strategy).
    join_order: List[dict] = dataclasses.field(default_factory=list)
    # host<->device traffic accounting (DESIGN.md §15,
    # `repro_torch.core.device_plane.DeviceStats`): sync and byte counts for
    # every transfer/join device crossing of this query, subqueries
    # folded in. Always present; all-zero on pure-host runs.
    device: "device_plane.DeviceStats" = dataclasses.field(
        default_factory=device_plane.DeviceStats)
    # recovery events carried over from ladder rungs that ultimately
    # failed (their DistStats die with the discarded attempt): the
    # retries/replays a rung burned before degrading stay visible in
    # `report()["recoveries"]` alongside the final rung's own events
    recovery_carry: List[dict] = dataclasses.field(default_factory=list)

    @property
    def total_seconds(self) -> float:
        # subquery time is already inside this executor's phase wall-times
        # (subqueries run during leaf resolution / Bind evaluation)
        return sum(self.phase_seconds.values())

    def join_input_rows(self) -> int:
        return sum(j.ht_rows + j.pr_rows for j in self.joins)

    def transfer_edges(self) -> List[object]:
        """Every per-edge transfer scheduling decision of this query —
        this executor's plus every (nested) subquery's (`EdgeDecision`
        records; the adaptive scheduler fills them, the plain
        strategies record their prune skips). The benches persist these
        so skip/apply decision quality is measurable per query."""
        out = list(self.transfer.edges) if self.transfer is not None \
            else []
        for sub in self.subqueries:
            out += sub.transfer_edges()
        return out

    def join_order_entries(self) -> List[dict]:
        """Every runtime join-ordering decision of this query — this
        executor's plus every (nested) subquery's."""
        out = list(self.join_order)
        for sub in self.subqueries:
            out += sub.join_order_entries()
        return out

    def report(self) -> dict:
        """The one structured stats surface (JSON-safe: plain
        ints/floats/strs, NaN mapped to None). Benches and the serving
        layer's `ServerMetrics` consume this instead of poking fields —
        per-phase seconds, transfer decisions with per-edge q-error,
        runtime-vs-static join order, degradations, device crossings,
        distributed wire bytes and shard-level recoveries."""
        def num(x):
            if x is None:
                return None
            x = float(x)
            return None if math.isnan(x) else x

        edges = []
        for d in self.transfer_edges():
            q = d.qerror()
            edges.append({
                "edge": d.edge, "pass": int(d.pass_idx),
                "action": d.action,
                "src": d.src or None, "dst": d.dst or None,
                "build_rows": int(d.build_rows),
                "probe_rows": int(d.probe_rows),
                "rows_probed": int(d.rows_probed),
                "est_sel": num(d.est_sel), "act_sel": num(d.act_sel),
                "qerror": round(q, 4)})
        qerrs = [e["qerror"] for e in edges if e["rows_probed"] > 0]
        orders = self.join_order_entries()
        tr = self.transfer
        out = {
            "strategy": self.strategy,
            "phase_seconds": {k: float(v)
                              for k, v in self.phase_seconds.items()},
            "total_seconds": float(self.total_seconds),
            "result_rows": int(self.result_rows),
            "join": {
                "joins": len(self.joins),
                "input_rows": int(self.join_input_rows()),
                "materialized_bytes": int(self.join_materialized_bytes),
            },
            "join_order": orders,
            "reordered": any(o.get("changed") for o in orders),
            "transfer": None if tr is None else {
                "strategy": tr.strategy, "backend": tr.backend,
                "seconds": float(tr.seconds),
                "filters_built": int(tr.filters_built),
                "filters_reused": int(tr.filters_reused),
                "from_cache": bool(tr.from_cache),
                "filter_bytes": int(tr.filter_bytes),
                "rows_probed": int(tr.rows_probed),
                "passes_run": int(tr.passes_run),
                "hints_used": int(tr.hints_used),
                "decisions": decision_counts(self.transfer_edges()),
            },
            "edges": edges,
            "qerror": {
                "n": len(qerrs),
                "max": max(qerrs) if qerrs else None,
                "geomean": (float(np.exp(np.mean(np.log(qerrs))))
                            if qerrs else None),
            },
            "degraded": list(self.degraded),
            "device": self.device.report(),
            "dist": None,
        }
        if self.dist is not None:
            out["dist"] = {
                "nshards": int(self.dist.nshards),
                "device_backed": bool(self.dist.device_backed),
                "shuffle_bytes": int(self.dist.shuffle_bytes),
                "broadcast_bytes": int(self.dist.broadcast_bytes),
                "strategies": self.dist.strategy_counts(),
            }
        # shard-level recovery record (DESIGN.md §16): every retry /
        # lineage replay / hedge the distributed runtime absorbed while
        # producing this result, plus the attempts burned by ladder
        # rungs that still failed (carried out of their discarded stats
        # so "all"-schedule faults leave an exhaustion trace here too)
        events = list(self.recovery_carry)
        if self.dist is not None:
            events.extend(getattr(self.dist, "recoveries", ()))
        kinds: Dict[str, int] = {}
        for e in events:
            kinds[e.get("kind", "?")] = kinds.get(e.get("kind", "?"), 0) + 1
        out["recoveries"] = {
            "events": events,
            "retries": kinds.get("retry", 0),
            "replays": kinds.get("replay", 0),
            "hedges": kinds.get("hedge", 0),
            "exhausted": kinds.get("retry_exhausted", 0),
        }
        return out


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """The executor's full knob surface as one validated, immutable
    value (three PRs of kwargs sprawl, consolidated).

    `engine="single"` (default) runs the late-materialized join
    runtime on one host; `engine="distributed"` routes every join
    through `repro_torch.core.engine_join_dist` — row-sharded cursors,
    broadcast/all-to-all key exchange over `dist_shards` shards
    (default: a mesh of the visible CUDA devices when `torch_device` is
    a CUDA device and more than one is visible, else 4 simulated
    shards), each shard's local join on `join_backend`.
    `dist_device` forces the device-backed exchange (True) or the
    simulated one (False). Results are bit-identical; the single-host
    engine is the distributed runtime's correctness oracle.

    `plan_cache` (`repro_torch.relational.plancache.PlanCache`) skips
    planning/annotation work on canonically-identical plans;
    `artifact_cache` (`repro_torch.core.artifact_cache.ArtifactCache`)
    replays whole post-transfer slot states on exact repeats;
    `sel_history` (`repro_torch.relational.plancache.SelHistory`) feeds
    measured per-edge selectivities back into the adaptive scheduler's
    estimates on repeat plan fingerprints (DESIGN.md §12/§14). All
    shared, thread-safe, and optional — the serving layer
    (`repro_torch.serve`) wires them in.

    `degrade=True` arms the degradation ladder (DESIGN.md §13): a
    backend failure retries the query on the next-safer rung
    (distributed → late-numpy → eager oracle; pred-trans-adaptive →
    pred-trans → no-prefilter), recorded in `ExecStats.degraded`. Off
    by default so engine-vs-oracle tests can never silently pass via a
    fallback. A rung that runs on the cuda backends, or on the torch
    backends on a CUDA device, never steps down: every rung below it
    runs on the host, so a kernel that fails to build or launch (or a
    device op that fails) re-raises instead of being answered on the
    CPU.

    `mem_budget_bytes` caps the join phase's payload-gather bytes
    per query, estimated *before* allocation — exceeding it raises
    `ResourceExhausted` (which the ladder answers by switching
    materialization mode) instead of OOMing.

    `reorder` controls runtime join ordering from transfer actuals
    (DESIGN.md §14, `repro_torch.relational.reorder`): "auto" (default)
    re-derives each inner-join region's order after the transfer phase
    wherever the runtime supports it (late-materialized cursors,
    non-per-join-filter strategies; the eager oracle always keeps the
    static order as the bit-exactness reference), "off" keeps the
    plan's static order everywhere, "on" is an explicit alias of
    "auto". `reorder_fn` overrides the greedy chooser with a callable
    `meta -> order` (permutation tests and the robustness bench inject
    adversarial orders through it; see `reorder.seeded_order`).

    `device` controls the device-resident data plane (DESIGN.md §15)
    for the torch and cuda join backends: "auto" (default) keeps join indices on
    the device when `torch_device` is a CUDA device and takes the
    plane-off route on the CPU, "on" forces the device path on any
    `torch_device` (the CPU test configuration), "off" takes the
    plane-off route: the hash-map join (kernels K4/K5 on cuda, plain
    torch on torch) for duplicate-free build sides, host index vectors,
    the host engine for the rest. The strategy's bloom engine picks its
    own plane (`make_strategy(..., device_resident=)`). `torch_device`
    (default "cuda") is the torch device the torch and cuda join
    backends run on; without
    CUDA a CUDA device raises RuntimeError — pass "cpu" to run on the
    CPU. The numpy backend ignores both. The distributed engine ignores
    `device`: its local engine resolves the plane from `torch_device`.

    Recovery knobs (DESIGN.md §16, all optional,
    `repro_torch.core.recovery`): `retry_policy` overrides the
    distributed engine's default seeded-jitter backoff for transient
    exchange faults; `retry_budget` is a shared `RetryBudget` every
    retry/replay spends (the serving layer passes one per server so
    retry storms cannot amplify overload); `hedge` arms `HedgePolicy`
    straggler hedging on the per-shard local joins; `breakers` is a
    shared `BreakerBoard` the degradation ladder consults before
    attempting a rung — an open breaker skips the rung outright
    (recorded in `ExecStats.degraded` as a "CircuitOpen" move) instead
    of rediscovering the failure."""

    strategy: Optional[Strategy] = None
    join_backend: str = "numpy"
    late_materialize: bool = True
    engine: str = "single"
    dist_shards: Optional[int] = None
    dist_device: Optional[bool] = None
    plan_cache: Optional[object] = None
    artifact_cache: Optional[object] = None
    sel_history: Optional[object] = None
    degrade: bool = False
    mem_budget_bytes: Optional[int] = None
    reorder: str = "auto"
    reorder_fn: Optional[Callable] = None
    device: str = "auto"
    torch_device: str = "cuda"
    retry_policy: Optional[object] = None
    retry_budget: Optional[object] = None
    hedge: Optional[object] = None
    breakers: Optional[object] = None

    def __post_init__(self):
        if self.engine not in ("single", "distributed"):
            raise ValueError(f"unknown engine {self.engine!r}; "
                             "choose 'single' or 'distributed'")
        if self.device not in ("auto", "on", "off"):
            raise ValueError(f"device must be 'auto', 'on' or 'off', "
                             f"got {self.device!r}")
        if self.reorder not in ("auto", "on", "off"):
            raise ValueError(f"reorder must be 'auto', 'on' or 'off', "
                             f"got {self.reorder!r}")
        if (self.mem_budget_bytes is not None
                and self.mem_budget_bytes <= 0):
            raise ValueError("mem_budget_bytes must be positive, got "
                             f"{self.mem_budget_bytes!r}")
        if self.dist_shards is not None and self.dist_shards < 1:
            raise ValueError(f"dist_shards must be >= 1, "
                             f"got {self.dist_shards!r}")

    def replace(self, **overrides) -> "ExecConfig":
        return dataclasses.replace(self, **overrides)


_UNSET = object()
_LEGACY_KWARGS = ("join_backend", "late_materialize", "engine",
                  "dist_shards", "dist_device", "plan_cache",
                  "artifact_cache", "sel_history", "degrade",
                  "mem_budget_bytes", "reorder", "reorder_fn")
_legacy_warned = False


def _warn_legacy_kwargs() -> None:
    global _legacy_warned
    if _legacy_warned:
        return
    _legacy_warned = True
    warnings.warn(
        "passing Executor knobs as individual kwargs is deprecated; "
        "pass one ExecConfig instead: "
        "Executor(catalog, ExecConfig(strategy=..., engine=..., ...))",
        DeprecationWarning, stacklevel=3)


def _reset_legacy_warning() -> None:
    """Test hook: make the next legacy-kwargs use warn again."""
    global _legacy_warned
    _legacy_warned = False


class Executor:
    def __init__(self, catalog: Mapping[str, Table],
                 strategy: Optional[Strategy] = None,
                 config: Optional[ExecConfig] = None,
                 **legacy):
        """Preferred construction: `Executor(catalog, ExecConfig(...))`
        (the config may also be passed in `strategy`'s position, or as
        `config=`). The pre-ExecConfig kwargs (`join_backend=`,
        `engine=`, `dist_shards=`, ... — see `_LEGACY_KWARGS`) keep
        working through a shim that builds the equivalent config and
        emits one DeprecationWarning per process. See `ExecConfig` for
        what every knob means."""
        if isinstance(strategy, ExecConfig):
            if config is not None:
                raise ValueError("pass the ExecConfig once, not twice")
            config, strategy = strategy, None
        if config is not None:
            if strategy is not None or legacy:
                raise ValueError(
                    "pass either an ExecConfig or individual kwargs, "
                    "not both")
        else:
            bad = sorted(set(legacy) - set(_LEGACY_KWARGS))
            if bad:
                raise TypeError(f"unknown Executor kwargs: {bad}")
            if legacy:
                _warn_legacy_kwargs()
            config = ExecConfig(strategy=strategy, **legacy)
        self.config = config
        self.catalog = dict(catalog)
        self.strategy = config.strategy or NoPredTrans()
        self.join_backend = config.join_backend
        self.late_materialize = config.late_materialize
        self.engine = config.engine
        self.dist_shards = config.dist_shards
        self.dist_device = config.dist_device
        self.plan_cache = config.plan_cache
        self.artifact_cache = config.artifact_cache
        self.sel_history = config.sel_history
        self.degrade = config.degrade
        self.mem_budget_bytes = config.mem_budget_bytes
        self.reorder = config.reorder
        self.reorder_fn = config.reorder_fn
        self.device = config.device
        self._ctx: Optional[QueryContext] = None
        self._phase = "scan"
        self._reorder_info: Optional[reorder_mod.ReorderInfo] = None
        # "auto" defers to the engine's default: on for a CUDA device,
        # off for the CPU
        dr = {"auto": None, "on": True, "off": False}[config.device]
        if config.engine == "distributed":
            from repro_torch.core.engine_join_dist import (
                get_distributed_engine,
            )
            self.join_engine = get_distributed_engine(
                config.dist_shards, config.join_backend,
                config.dist_device, config.torch_device)
        else:
            self.join_engine = get_join_engine(config.join_backend,
                                               device_resident=dr,
                                               device=config.torch_device)

    def _sub_executor(self) -> "Executor":
        # degrade stays off: a subquery failure propagates to the outer
        # query, whose ladder retries the *whole* query on a safer rung
        # (partial per-subquery fallbacks would mix rungs in one result)
        return Executor(self.catalog, self.config.replace(
            strategy=self.strategy, degrade=False))

    def _clone(self, **overrides) -> "Executor":
        """This executor's config with `overrides` applied — the ladder
        builds each fallback rung this way (degrade stays off on the
        clone: the loop in `_execute_degrading` owns the retries)."""
        kw = dict(strategy=self.strategy, degrade=False)
        kw.update(overrides)
        return Executor(self.catalog, self.config.replace(**kw))

    # -- degradation ladder (DESIGN.md §13) -----------------------------
    #: strategy rungs, each mapping to its next-safer neighbor; the
    #: terminal rung (no-pred-trans) does no engine-backed transfer work
    STRATEGY_LADDER = {
        "pred-trans-adaptive": "pred-trans",
        "pred-trans-opt": "pred-trans",
        "pred-trans": "no-pred-trans",
        "bloom-join": "no-pred-trans",
        "yannakakis": "no-pred-trans",
    }

    def _rung_desc(self) -> str:
        mode = "late" if self.late_materialize else "eager"
        return (f"{self.engine}/{mode}/{self.join_backend}"
                f"+{self.strategy.name}")

    def _degrade_strategy(self) -> Optional["Executor"]:
        nxt = self.STRATEGY_LADDER.get(self.strategy.name)
        if nxt is None:
            return None
        from repro_torch.core.transfer import BACKEND_AWARE, make_strategy
        kw = {"backend": "numpy"} if nxt in BACKEND_AWARE else {}
        return self._clone(strategy=make_strategy(nxt, **kw))

    def _degrade_engine(self) -> Optional["Executor"]:
        if self.engine == "distributed":
            return self._clone(engine="single", join_backend="numpy")
        if self.late_materialize and self.join_backend != "numpy":
            return self._clone(join_backend="numpy")
        if self.late_materialize:
            return self._clone(late_materialize=False,
                               join_backend="numpy")
        return None

    def _on_device(self) -> bool:
        """Does this rung run on the GPU: the cuda backends (bloom or
        join) on any device, or the torch backends on a CUDA device?"""
        import torch
        eng = getattr(self.strategy, "engine", None)
        bloom = getattr(eng, "backend", None)
        return (self.join_backend == "cuda" or bloom == "cuda"
                or (self.join_backend == "torch" and torch.device(
                    self.config.torch_device).type == "cuda")
                or (bloom == "torch" and eng.device.type == "cuda"))

    def _next_rung(self, err: Exception) -> Optional["Executor"]:
        """Classify a failure to a ladder move. Injected/engine faults
        carry a `point`; real failures fall back to the phase the
        executor was in. Transfer-side failures step the strategy rung
        first; join/engine-side failures step the engine rung, falling
        over to the strategy ladder once the engine rungs are spent.
        A rung on the GPU (`_on_device`) has no move: every rung below
        it runs on the host, and a failed kernel build or launch must
        surface, not be answered on the CPU."""
        if self._on_device():
            return None
        if isinstance(err, ResourceExhausted):
            # the memory guard fires on payload-gather estimates; the
            # only rung that changes gather volume is the
            # materialization mode, so this move is its own ladder
            if not self.late_materialize:
                return self._clone(late_materialize=True,
                                   join_backend="numpy")
            return None
        point = getattr(err, "point", None)
        transfer_side = (point in ("engine.probe", "engine.build")
                         or (point is None
                             and self._phase == "transfer"))
        if transfer_side:
            return self._degrade_strategy() or self._degrade_engine()
        return self._degrade_engine() or self._degrade_strategy()

    # ------------------------------------------------------------------
    def execute(self, plan: PlanNode,
                ctx: Optional[QueryContext] = None
                ) -> Tuple[Table, ExecStats]:
        if not self.degrade:
            return self._execute_once(plan, ctx)
        return self._execute_degrading(plan, ctx)

    def _execute_degrading(self, plan: PlanNode,
                           ctx: Optional[QueryContext]
                           ) -> Tuple[Table, ExecStats]:
        """Run the query, stepping down the ladder on backend failure.
        Cooperative aborts (deadline/cancel) always propagate — the
        client asked for the abort, a cheaper rung is not an answer."""
        degraded: List[dict] = []
        carried: List[dict] = []
        board = self.config.breakers
        cur = self
        for _ in range(12):             # > total rung count, by margin
            rung = cur._rung_desc()
            if board is not None and not board.allow(rung):
                # open breaker: skip the rung without rediscovering the
                # failure (half-open probes pass `allow` after cooldown)
                err = BackendError(f"circuit open for rung {rung}",
                                   phase="admission")
                nxt = cur._next_rung(err)
                if nxt is None:
                    raise err
                degraded.append({
                    "from": rung, "to": nxt._rung_desc(),
                    "phase": "admission", "error": "CircuitOpen",
                    "detail": f"breaker open for {rung}"})
                cur = nxt
                continue
            pre_dist = getattr(getattr(cur, "join_engine", None),
                               "stats", None)
            try:
                result, stats = cur._execute_once(plan, ctx)
                if board is not None:
                    board.record(rung, True)
                stats.degraded = degraded
                stats.recovery_carry = carried
                return result, stats
            except (DeadlineExceeded, QueryCancelled):
                raise
            except Exception as e:
                if board is not None:
                    board.record(rung, False)
                # keep the failed rung's recovery attempts: its stats
                # object dies with the discarded attempt. Only a stats
                # object forked *during* this attempt counts — a rung
                # that failed pre-fork still points at an older query's
                # stats, which must not leak in here.
                failed_dist = getattr(getattr(cur, "join_engine", None),
                                      "stats", None)
                if failed_dist is not None and failed_dist is not pre_dist:
                    carried.extend(getattr(failed_dist, "recoveries", ()))
                nxt = cur._next_rung(e)
                if nxt is None:
                    raise
                degraded.append({
                    "from": rung, "to": nxt._rung_desc(),
                    "phase": getattr(e, "point", None) or cur._phase,
                    "error": type(e).__name__,
                    "detail": str(e)[:160]})
                cur = nxt
        raise RuntimeError("degradation ladder did not terminate")

    def _execute_once(self, plan: PlanNode,
                      ctx: Optional[QueryContext] = None
                      ) -> Tuple[Table, ExecStats]:
        """One attempt on this executor's exact config. The whole run
        sits inside a `device_plane.track` window, so every
        host<->device crossing the transfer and join phases make lands
        in `stats.device` (subquery crossings are merged in where their
        stats are collected — `track` re-points the thread-local)."""
        stats = ExecStats(strategy=self.strategy.name)
        with device_plane.track(stats.device):
            return self._execute_tracked(plan, ctx, stats)

    def _execute_tracked(self, plan: PlanNode,
                         ctx: Optional[QueryContext],
                         stats: ExecStats) -> Tuple[Table, ExecStats]:
        self._ctx = ctx
        self._phase = "scan"
        self._reorder_info = None
        if ctx is not None:
            ctx.check("scan")
        if self.engine == "distributed":
            # fresh fork per execute(): a prior call's returned stats
            # object must keep describing that call
            self.join_engine = self.join_engine.fork()
            self.join_engine.ctx = ctx   # forks are per-query: safe
            self.join_engine.arm_recovery(
                retry=self.config.retry_policy,
                budget=self.config.retry_budget,
                hedge=self.config.hedge)
            stats.dist = self.join_engine.stats

        # -- cache identity: canonical plan fingerprint (DESIGN §12) ----
        t0 = time.perf_counter()
        leaves = plan.leaves()
        fp = cat_sig = info = slot_key = None
        if (self.plan_cache is not None
                or self.artifact_cache is not None
                or self.sel_history is not None):
            fp, tables = plan_fingerprint(plan)
            if fp is not None:
                cat_sig = tuple((t, self.catalog[t].version)
                                for t in tables)
                if self.plan_cache is not None:
                    info = self.plan_cache.get((fp, cat_sig))
                if self.artifact_cache is not None:
                    ssig = self.strategy.cache_signature()
                    if ssig is not None:
                        slot_key = ("slots", fp, cat_sig, ssig)

        # -- warm path: replay the post-transfer slot state -------------
        if slot_key is not None:
            ent = self.artifact_cache.get(slot_key)
            if ent is not None:
                cached_slots, transfer_snap = ent
                # per-hit Slot copies: slot tables are immutable and
                # shared, but Slot.keys is a lazily-growing dict the
                # join phase mutates — each query gets its own
                slots = {leaf.leaf_id: Slot(tbl, dict(keys))
                         for leaf, (tbl, keys)
                         in zip(leaves, cached_slots)}
                stats.transfer = self._replay_transfer(transfer_snap)
                stats.phase_seconds["scan"] = time.perf_counter() - t0
                stats.phase_seconds["transfer"] = 0.0
                self._arm_reorder(leaves, stats.transfer)
                t0 = time.perf_counter()
                self._phase = "join"
                if ctx is not None:
                    ctx.check("join")
                result = self._exec(plan, slots, stats)
                stats.phase_seconds["join"] = time.perf_counter() - t0
                stats.result_rows = len(result)
                return result, stats

        # -- phase 0: leaves (with projection pushdown) ------------------
        from repro_torch.relational.optimize import collect_columns
        needed = set(info.needed) if info is not None \
            else collect_columns(plan)
        vertices: Dict[int, Vertex] = {}
        for leaf in leaves:
            vertices[leaf.leaf_id] = self._resolve_leaf(leaf, stats,
                                                        needed)
        stats.phase_seconds["scan"] = time.perf_counter() - t0

        # -- phase 1: transfer -----------------------------------------
        t0 = time.perf_counter()
        self._phase = "transfer"
        if ctx is not None:
            ctx.check("transfer")
        if info is not None:
            # plan-cache hit: re-bind the edge templates and join
            # depths to this plan's fresh leaf ids (leaves() order is
            # deterministic, so positions are a stable address)
            edges = [Edge(leaves[u].leaf_id, leaves[w].leaf_id,
                          list(uc), list(wc), fwd_ok=fwd, bwd_ok=bwd)
                     for u, w, uc, wc, fwd, bwd in info.edges]
            for pos, leaf in enumerate(leaves):
                vertices[leaf.leaf_id].join_depth = info.depths[pos]
        else:
            edges = extract_join_graph(plan, vertices)
            annotate_join_depth(plan, vertices)
            if self.plan_cache is not None and fp is not None:
                pos = {leaf.leaf_id: i for i, leaf in enumerate(leaves)}
                self.plan_cache.put((fp, cat_sig), PlanInfo(
                    needed=frozenset(needed),
                    edges=tuple((pos[e.u], pos[e.v], tuple(e.u_cols),
                                 tuple(e.v_cols), e.fwd_ok, e.bwd_ok)
                                for e in edges),
                    depths=tuple(vertices[leaf.leaf_id].join_depth
                                 for leaf in leaves)))
        hints = None
        if self.sel_history is not None and fp is not None:
            hints = self.sel_history.get((fp, cat_sig))
        stats.transfer = self.strategy.prefilter(vertices, edges,
                                                 ctx=ctx, hints=hints)
        if self.sel_history is not None and fp is not None:
            self.sel_history.observe((fp, cat_sig),
                                     stats.transfer.edges)
        # compact each vertex once; the transfer phase's composite keys
        # are compacted alongside and seed the join runtime's key cache
        slots: Dict[int, Slot] = {}
        for lid, v in vertices.items():
            idx = np.flatnonzero(v.mask)
            full = idx.size == len(v.mask)
            table = v.table if full else v.table.gather(idx)
            # seed only keys whose encoding cannot flip under row
            # filtering (ops.stable_key_encoding) — an unstable 2-col
            # key is recomputed on the compacted table instead, exactly
            # as the eager oracle would
            keys = {cols: (raw if full else raw[idx])
                    for cols, raw in v.raw_keys.items()
                    if ops.stable_key_encoding(v.table, cols)}
            slots[lid] = Slot(table, keys)
        if slot_key is not None:
            self._store_slots(slot_key, leaves, slots, stats.transfer,
                              cat_sig)
        stats.phase_seconds["transfer"] = time.perf_counter() - t0
        self._arm_reorder(leaves, stats.transfer)

        # -- phase 2: join ---------------------------------------------
        t0 = time.perf_counter()
        self._phase = "join"
        if ctx is not None:
            ctx.check("join")
        result = self._exec(plan, slots, stats)
        stats.phase_seconds["join"] = time.perf_counter() - t0
        stats.result_rows = len(result)
        return result, stats

    # -- runtime join ordering (DESIGN §14) -----------------------------
    def _reorder_active(self) -> bool:
        """Runtime ordering needs the late-materialized cursor runtime
        (the eager oracle keeps the plan's static order as the
        bit-exactness reference) and a strategy without per-join
        filters (BloomJoin's hook is defined against the static tree's
        build/probe sides)."""
        return (self.reorder != "off" and self.late_materialize
                and not self.strategy.uses_per_join_filter)

    def _arm_reorder(self, leaves, transfer) -> None:
        """Snapshot the transfer phase's ordering inputs (exact live
        counts come from the slots at region-execution time; match
        fractions, domains and cost coefficients come from here).
        Works on both the cold path and the warm slot-replay path."""
        if not self._reorder_active():
            return
        shards = getattr(self.join_engine, "nshards", None) \
            if self.engine == "distributed" else None
        self._reorder_info = reorder_mod.build_info(
            leaves, transfer, self.catalog,
            getattr(self.strategy, "costs", None), shards)

    # -- slot-state caching (DESIGN §12) --------------------------------
    def _store_slots(self, slot_key, leaves, slots: Dict[int, Slot],
                     transfer: TransferStats, cat_sig) -> None:
        """Store this query's whole scan+transfer output: compacted leaf
        tables + composite keys (leaf-position addressed) and a transfer
        stats snapshot for faithful warm-hit accounting. Stored dicts
        are copies taken *now* — later join-phase key additions on the
        live slots never leak into the shared entry."""
        entry_slots = tuple((slots[leaf.leaf_id].table,
                             dict(slots[leaf.leaf_id].keys))
                            for leaf in leaves)
        snap = dataclasses.replace(
            transfer, per_vertex=dict(transfer.per_vertex),
            edges=list(transfer.edges))
        nbytes = sum(t.nbytes() for t, _ in entry_slots)
        nbytes += sum(k.nbytes for _, ks in entry_slots
                      for k in ks.values())
        self.artifact_cache.put(slot_key, (entry_slots, snap),
                                nbytes=nbytes,
                                versions=[ver for _, ver in cat_sig])

    def _replay_transfer(self, snap: TransferStats) -> TransferStats:
        """Fresh per-query stats from a cached snapshot: counters are
        replayed (the work they describe was genuinely saved), mutable
        containers are copied (BloomJoin's per-join hook appends), and
        the strategy/backend names reflect *this* query — strategies
        with equal cache signatures may share one entry."""
        eng = getattr(self.strategy, "engine", None)
        return dataclasses.replace(
            snap, strategy=self.strategy.name,
            backend=eng.backend if eng is not None else snap.backend,
            per_vertex=dict(snap.per_vertex), edges=list(snap.edges),
            from_cache=True)

    # ------------------------------------------------------------------
    def _resolve_leaf(self, leaf: LeafNode, stats: ExecStats,
                      needed: Optional[set] = None) -> Vertex:
        if isinstance(leaf, SubqueryScan):
            sub = self._sub_executor()
            table, sub_stats = sub.execute(leaf.plan, ctx=self._ctx)
            stats.subqueries.append(sub_stats)
            stats.device.merge(sub_stats.device)
            table = Table(table.columns, leaf.alias)
            # a derived leaf's row set is determined by (subplan shape,
            # source table versions, transfer strategy) — strategy
            # included defensively: results are strategy-bit-exact, but
            # signatures must never *depend* on that proof
            sub_fp, sub_tables = plan_fingerprint(leaf.plan)
            ssig = self.strategy.cache_signature()
            sig, deps = None, frozenset()
            if sub_fp is not None and ssig is not None:
                versions = tuple(self.catalog[t].version
                                 for t in sub_tables)
                sig = provenance.try_digest("sub", sub_fp, versions,
                                            ssig)
                deps = frozenset(versions)
            return Vertex(leaf.leaf_id, leaf.alias, table,
                          np.ones(len(table), bool),
                          base_rows=len(table), derived=True,
                          state_sig=sig, dep_versions=deps)
        assert isinstance(leaf, Scan)
        base = self.catalog[leaf.table]
        base_rows = len(base)
        table = base
        if leaf.alias != leaf.table:
            table = base.with_prefix(leaf.alias + "_")
        # projection pushdown: filter first (may need dropped columns),
        # then keep only plan-referenced columns
        if leaf.filter is not None:
            table = table.compact(leaf.filter(table).mask(len(table)))
        keep = set(table.names)
        if needed is not None:
            keep &= needed | set(leaf.columns or ())
        if leaf.columns is not None:
            keep &= set(leaf.columns) | (needed or set())
        if keep != set(table.names):
            table = table.select([n for n in table.names if n in keep])
        # provenance leaf signature: (base table version, canonical
        # local predicate) pins the scan's survivor row set; predicate
        # columns hash alias-stripped so two aliases of one base table
        # under one predicate share downstream filter builds. Projection
        # is deliberately excluded — it never changes the row set.
        prefix = leaf.alias + "_"
        rename = ((lambda n: n[len(prefix):] if n.startswith(prefix)
                   else n) if leaf.alias != leaf.table else None)
        pred_fp = expr_fingerprint(leaf.filter, rename)
        sig = (provenance.try_digest("scan", leaf.table, base.version,
                                     pred_fp)
               if pred_fp is not None else None)
        return Vertex(leaf.leaf_id, leaf.alias, table,
                      np.ones(len(table), bool), base_rows=base_rows,
                      state_sig=sig,
                      dep_versions=frozenset({base.version}))

    # ------------------------------------------------------------------
    def _exec(self, node: PlanNode, slots: Dict[int, Slot],
              stats: ExecStats) -> Table:
        out = self._exec_node(node, slots, stats)
        if isinstance(out, JoinCursor):
            out = self._materialize(out, stats)
        return out

    def _mem_budget(self) -> Optional[int]:
        ctx = self._ctx
        if ctx is not None and ctx.mem_budget_bytes is not None:
            return ctx.mem_budget_bytes
        return self.mem_budget_bytes

    def _materialize(self, cur: JoinCursor, stats: ExecStats,
                     names: Optional[set] = None) -> Table:
        avail = None
        if names is not None:
            avail = [n for n, _ in cur.cols if n in names]
            if not avail and cur.cols:
                # a value-free operator (e.g. bare count(*)) still needs
                # the row count, which a zero-column Table loses
                avail = [cur.cols[0][0]]
        budget = self._mem_budget()
        if budget is not None:
            # pre-gather guard: estimate rows × row bytes before any
            # allocation; exceeding the budget degrades instead of OOMs
            est = stats.join_materialized_bytes + cur.gather_bytes(avail)
            if est > budget:
                raise ResourceExhausted(
                    f"payload gather needs ~{est} bytes "
                    f"(budget {budget})", phase="join",
                    tag=self._ctx.tag if self._ctx else "")
        if avail is not None:
            table, nbytes = cur.materialize(avail)
        else:
            table, nbytes = cur.materialize()
        stats.join_materialized_bytes += nbytes
        return table

    @staticmethod
    def _as_cursor(out: Union[Table, JoinCursor]) -> JoinCursor:
        return out if isinstance(out, JoinCursor) \
            else JoinCursor.from_table(out)

    def _group_cursor(self, cur: JoinCursor, node: GroupBy,
                      stats: ExecStats) -> Optional[Table]:
        """GROUP BY straight off the cursor (DESIGN.md §15): group
        codes come from the cursor's composite key (the transfer
        phase's cached encoding, selection-vector sliced), key columns
        are gathered at one representative row per group, and only the
        agg input columns materialize at full row length — a bare
        count(*) gathers nothing full-length at all.

        Bit-exactness requires NULL-free key columns: then
        `ops._grouping_codes` reduces to `composite_key`, which is what
        `JoinCursor.key` computes. Nullable keys (outer-join NULLs or
        column validity) return None and the materializing path runs,
        exactly as before."""
        if not node.keys:
            return None                  # keyless: nothing to save
        for n in node.keys:
            sid = cur.colmap.get(n)
            if sid is None:
                return None
            if sid in cur.nullable:
                return None              # outer-join NULLs in play
            col = cur.slots[sid].table[cur._src(n)]
            if col.valid is not None and not bool(col.valid.all()):
                return None              # NULL keys need rank-coding
        inputs = sorted({ic for _, _, ic in node.aggs if ic})
        budget = self._mem_budget()
        if budget is not None:
            # the lazy path still allocates one full-row-length int64
            # vector that lives through aggregation (the group codes);
            # the budget guard must see it even when no agg input
            # gathers full-length (bare count(*))
            est = (stats.join_materialized_bytes
                   + cur.gather_bytes(inputs) + 8 * len(cur))
            if est > budget:
                raise ResourceExhausted(
                    f"payload gather needs ~{est} bytes "
                    f"(budget {budget})", phase="join",
                    tag=self._ctx.tag if self._ctx else "")
        inverse, ngroups = ops.group_codes(cur.key(tuple(node.keys)))
        rep = ops.group_rep_rows(inverse, ngroups)
        kview = cur.take(rep).columns_view(node.keys)
        in_tbl, nbytes = cur.materialize(inputs)
        stats.join_materialized_bytes += nbytes
        return ops.aggregate_by_codes(
            inverse, ngroups, {k: kview[k] for k in node.keys},
            in_tbl, node.aggs, cur.name)

    def _exec_node(self, node: PlanNode, slots: Dict[int, Slot],
                   stats: ExecStats) -> Union[Table, JoinCursor]:
        if isinstance(node, LeafNode):
            if not self.late_materialize:
                return slots[node.leaf_id].table
            return JoinCursor.from_slot(slots[node.leaf_id])

        if isinstance(node, Join):
            if self._ctx is not None:
                self._ctx.check("join")  # per-join cancellation point
            if not self.late_materialize:
                return self._exec_join_eager(node, slots, stats)
            if node.how == "inner" and self._reorder_info is not None:
                # runtime join ordering (DESIGN §14): the maximal
                # inner-join region rooted here executes under the
                # order derived from transfer actuals; interior joins
                # are consumed by the region, everything else recurses
                # back through this method
                region = reorder_mod.collect_region(node)
                if region is not None:
                    return reorder_mod.execute_region(self, region,
                                                      slots, stats)
            probe = self._as_cursor(self._exec_node(node.left, slots,
                                                    stats))
            build = self._as_cursor(self._exec_node(node.right, slots,
                                                    stats))
            pr_pre = len(probe)
            if (self.strategy.uses_per_join_filter
                    and node.how in ("inner", "semi")):
                hit = self.strategy.per_join_filter(
                    build.columns_view(node.right_on),
                    probe.columns_view(node.left_on),
                    node.right_on, node.left_on, stats.transfer)
                probe = probe.take(np.flatnonzero(
                    np.asarray(hit, bool)))
            bidx, pidx = ops.join_indices_nullsafe(
                build.key(node.right_on), probe.key(node.left_on),
                how=node.how,
                build_valid=build.key_valid(node.right_on),
                probe_valid=probe.key_valid(node.left_on),
                engine=self.join_engine)
            out = JoinCursor.join(probe, build, bidx, pidx, node.how)
            stats.joins.append(JoinStat(node.how, len(build), len(probe),
                                        pr_pre, len(out)))
            if node.extra is not None:
                # join ON residuals follow WHERE semantics: NULL = drop
                view = out.columns_view(sorted(node.extra.columns()))
                out = out.take(np.flatnonzero(
                    node.extra(view).mask(len(out))))
            return out

        if isinstance(node, Filter):
            t = self._exec_node(node.child, slots, stats)
            if isinstance(t, JoinCursor):
                # NULL predicates are false (SQL WHERE): ExprValue.mask
                view = t.columns_view(sorted(node.predicate.columns()))
                keep = node.predicate(view).mask(len(t))
                return t.take(np.flatnonzero(keep))
            return t.compact(node.predicate(t).mask(len(t)))

        if isinstance(node, Project):
            t = self._exec_node(node.child, slots, stats)
            if isinstance(t, JoinCursor):
                if all(isinstance(e, Col) for e in node.exprs.values()):
                    # pure column select/rename: stay a cursor — the
                    # passthrough payload is gathered once, later, by
                    # whichever operator first needs values
                    return t.project({name: e.name
                                      for name, e in node.exprs.items()})
                needed = set()
                for e in node.exprs.values():
                    needed |= e.columns()
                t = self._materialize(t, stats, needed)
            cols = {}
            for name, e in node.exprs.items():
                if isinstance(e, Col):
                    cols[name] = t[e.name]
                elif hasattr(e, "result_column"):  # DictMap keeps vocab
                    cols[name] = e.result_column(t)
                else:
                    cols[name] = e(t).column(nrows=len(t))
            return Table(cols, t.name)

        if isinstance(node, Bind):
            t = self._exec(node.child, slots, stats)
            sub = self._sub_executor()
            sub_t, sub_stats = sub.execute(node.subplan, ctx=self._ctx)
            stats.subqueries.append(sub_stats)
            stats.device.merge(sub_stats.device)
            assert len(sub_t) == 1, "Bind subplan must yield one row"
            c = sub_t[node.sub_col]
            v = c.data[0]
            # a NULL scalar subquery result (e.g. AVG over zero rows)
            # broadcasts as an all-NULL constant column
            valid = (None if c.valid is None or bool(c.valid[0])
                     else np.zeros(len(t), bool))
            return t.with_column(node.name,
                                 Column(np.full(len(t), v), c.dictionary,
                                        valid))

        if isinstance(node, GroupBy):
            t = self._exec_node(node.child, slots, stats)
            if isinstance(t, JoinCursor):
                out = self._group_cursor(t, node, stats)
                if out is None:
                    # having filters aggregate *outputs*, so only the
                    # group keys and agg inputs need values
                    needed = set(node.keys) | {ic for _, _, ic
                                               in node.aggs if ic}
                    t = self._materialize(t, stats, needed)
                    out = ops.group_aggregate(t, node.keys, node.aggs)
            else:
                out = ops.group_aggregate(t, node.keys, node.aggs)
            if node.having is not None:
                out = out.compact(node.having(out).mask(len(out)))
            return out

        if isinstance(node, Sort):
            t = self._exec_node(node.child, slots, stats)
            if isinstance(t, JoinCursor):
                # order from a thin key view; the payload stays lazy and
                # is gathered once, already in output order (or trimmed
                # further by a Limit above)
                view, nbytes = t.materialize([n for n, _ in node.by])
                stats.join_materialized_bytes += nbytes
                return t.take(ops.sort_indices(view, node.by))
            return ops.sort_table(t, node.by)

        if isinstance(node, Limit):
            t = self._exec_node(node.child, slots, stats)
            if isinstance(t, JoinCursor):
                n = min(node.n, len(t))
                return t.take(np.arange(n, dtype=np.int64))
            return ops.limit(t, node.n)

        raise TypeError(f"unknown plan node {type(node)}")

    # -- legacy eager join (oracle path) --------------------------------
    def _exec_join_eager(self, node: Join, slots: Dict[int, Slot],
                         stats: ExecStats) -> Table:
        probe = self._exec(node.left, slots, stats)
        build = self._exec(node.right, slots, stats)
        pr_pre = len(probe)
        if (self.strategy.uses_per_join_filter
                and node.how in ("inner", "semi")):
            ts = stats.transfer
            hit = self.strategy.per_join_filter(
                build, probe, node.right_on, node.left_on, ts)
            probe = probe.compact(hit)
        out = ops.hash_join(build, probe, node.right_on, node.left_on,
                            how=node.how)
        stats.join_materialized_bytes += out.nbytes()
        budget = self._mem_budget()
        if budget is not None and stats.join_materialized_bytes > budget:
            # eager joins materialize whole intermediates; over budget
            # the ladder's answer is the late-materialized runtime,
            # which gathers payload once instead of per join
            raise ResourceExhausted(
                f"eager join materialized "
                f"{stats.join_materialized_bytes} bytes "
                f"(budget {budget})", phase="join",
                tag=self._ctx.tag if self._ctx else "")
        stats.joins.append(JoinStat(node.how, len(build), len(probe),
                                    pr_pre, len(out)))
        if node.extra is not None:
            out = out.compact(node.extra(out).mask(len(out)))
        return out


# --------------------------------------------------------------------------
# join-graph extraction
# --------------------------------------------------------------------------


def annotate_join_depth(plan: PlanNode, vertices: Dict[int, Vertex]
                        ) -> None:
    """Set `Vertex.join_depth`: how many Join nodes a leaf's surviving
    rows pay before the first join that can *kill* them — one whose
    other side's subtree contains an informative (locally filtered or
    derived) leaf. Rows joined only against complete base relations
    are FK-preserved and keep paying the next join; that multiplies
    what removing one of them up front is worth (the adaptive
    scheduler's benefit model, DESIGN §11). A GroupBy ends the flow —
    rows above it are new."""
    depth = {lid: 0 for lid in vertices}
    alive = {lid: True for lid in vertices}

    def walk(node: PlanNode):
        """-> (leaf ids below, subtree contains an informative leaf)"""
        if isinstance(node, LeafNode):
            v = vertices.get(node.leaf_id)
            if v is None:
                return set(), False
            return {node.leaf_id}, v.informative
        if isinstance(node, Join):
            lset, linf = walk(node.left)
            rset, rinf = walk(node.right)
            for side, other_inf in ((lset, rinf), (rset, linf)):
                for lid in side:
                    if alive[lid]:
                        depth[lid] += 1
                        if other_inf:
                            alive[lid] = False
            return lset | rset, linf or rinf
        if isinstance(node, GroupBy):
            leaves, _ = walk(node.child)
            for lid in leaves:
                alive[lid] = False
            return leaves, True         # aggregate output: new rows
        out, inf = set(), False
        for c in node.children():
            s, i = walk(c)
            out |= s
            inf = inf or i
        return out, inf

    walk(plan)
    for lid, v in vertices.items():
        v.join_depth = max(1, depth[lid])


def extract_join_graph(plan: PlanNode, vertices: Dict[int, Vertex]
                       ) -> List[Edge]:
    """Walk the plan; each equi-join contributes an edge between the leaf
    relations owning the key columns. Outer/semi/anti joins restrict the
    allowed transfer direction (paper §3.4):

      inner: both directions;
      left outer (probe side preserved): only probe->build;
      semi: both (filtering the build side never changes the semi result,
            Bloom filters have no false negatives);
      anti: only probe->build (filtering probe rows by build membership
            would delete exactly the rows an anti-join must keep).
    """
    owner: Dict[str, int] = {}
    for lid, v in vertices.items():
        for c in v.table.names:
            if c in owner:
                raise ValueError(
                    f"ambiguous column {c!r} (leaves {owner[c]} and {lid}); "
                    f"alias one of the scans")
            owner[c] = lid

    edges: List[Edge] = []

    def walk(node: PlanNode):
        if isinstance(node, Join):
            walk(node.left)
            walk(node.right)
            # one edge per key-column pair: a join like
            #   supplier ON (l_suppkey = s_suppkey AND c_nationkey = s_nationkey)
            # contributes supplier—lineitem and supplier—customer edges —
            # the paper's Fig 1a cyclic join graph for Q5.
            groups: Dict[Tuple[int, int], Tuple[List[str], List[str]]] = {}
            for lc, rc in zip(node.left_on, node.right_on):
                u, v = owner.get(lc), owner.get(rc)
                if u is None or v is None or u == v:
                    continue
                groups.setdefault((u, v), ([], []))
                groups[(u, v)][0].append(lc)
                groups[(u, v)][1].append(rc)
            for (u, v), (lcols, rcols) in groups.items():
                fwd_ok = True                       # probe -> build
                bwd_ok = node.how in ("inner", "semi")
                edges.append(Edge(u, v, lcols, rcols,
                                  fwd_ok=fwd_ok, bwd_ok=bwd_ok))
        else:
            for c in node.children():
                walk(c)

    walk(plan)
    return edges
