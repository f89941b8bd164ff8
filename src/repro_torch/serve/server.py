"""Concurrent query-serving front end (DESIGN.md §12).

`QueryServer` admits many queries concurrently over one shared immutable
catalog and makes repeat traffic cheap through two cross-query caches:

* a **plan cache** (`repro_torch.relational.plancache.PlanCache`) keyed on the
  canonical plan fingerprint + catalog signature — hits skip
  `collect_columns`, `extract_join_graph` and `annotate_join_depth`;
* a **transfer-artifact cache** (`repro_torch.core.artifact_cache.
  ArtifactCache`) holding Bloom/min-max filters keyed by provenance
  filter signature and whole post-transfer slot states keyed by
  (plan fingerprint, catalog signature, strategy cache signature) —
  a slot hit replays the scan+transfer phases for free.

Concurrency model: a bounded admission queue feeds a fixed pool of
worker threads. Each admitted query gets its *own* `Executor` and its
own `Strategy` instance (strategies carry per-run scratch state and are
not concurrently shareable; the engines underneath them are cached
singletons, created under a lock, and safe to share). The caches are
the only deliberately shared mutable state, and both take their own
locks. Admission policy: ``"block"`` (backpressure, default) or
``"reject"`` (raise `ServerSaturated` when the queue is full).

Catalog updates go through `update_table`, which swaps the table under
the catalog lock and drops every cached artifact derived from the old
version — cache keys embed `Table.version`, so stale entries also
become unreachable by construction; invalidation just frees the bytes.

Overload control & warm restart (DESIGN.md §16): per-rung circuit
breakers short-circuit the degradation ladder past rungs that keep
failing; deadline-aware admission sheds queries whose estimated queue
wait already exceeds their deadline (typed `ResourceExhausted` at
admission, instead of a doomed `DeadlineExceeded` later); a per-server
`RetryBudget` caps exchange retries across all concurrent queries; a
`worker.crash` fault kills one worker thread — the victim's query gets
a typed error and the pool respawns a replacement, isolating the blast
radius to that single query. `drain_to_snapshot` / `snapshot_path`
persist and restore the cache tier across restarts (see
`repro_torch.serve.snapshot`).

In the port the server runs the cuda backends on the card by default
(`join_backend="cuda"`, `torch_device="cuda"`); `torch_device="cpu"`
runs the kernels' plain versions (tests), `join_backend="torch"` the
plain-torch backends (no hand kernel), and `join_backend="numpy"` the
host mirror. Worker threads launch the kernels on the current
stream of their own thread, which for a new thread is the default
stream, so the card serialises the queries' kernels: concurrency
overlaps host work. Cached artifacts are host values, so snapshots
load without a card. `engine="distributed"` runs the joins through
the distributed runtime (`repro_torch.core.engine_join_dist`), whose
per-shard local joins run on `join_backend`; the server's
`retry_budget` and `hedge` reach its exchange recovery through
`ExecConfig`, as in the reference. A query whose
kernel fails to build or launch errors its Future: the degradation
ladder has no move from a rung on the cuda backends (every rung below
runs on the host), and the per-rung breaker records the failure.
"""
from __future__ import annotations

import asyncio
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core import faultinject, recovery
from repro_torch.core.artifact_cache import ArtifactCache
from repro_torch.core.errors import (
    BackendError, DeadlineExceeded, QueryCancelled, QueryContext,
    ResourceExhausted,
)
from repro_torch.core.transfer import BACKEND_AWARE, STRATEGIES, make_strategy
from repro_torch.relational.executor import ExecConfig, ExecStats, Executor
from repro_torch.relational.plan import PlanNode
from repro_torch.relational.plancache import PlanCache, SelHistory
from repro_torch.relational.table import Table

# strategies whose constructor accepts the shared artifact cache (the
# Bloom/min-max filter reuse path; slot-state reuse needs no strategy
# cooperation and works for every cacheable strategy)
FILTER_CACHED = {"pred-trans", "pred-trans-opt", "pred-trans-adaptive"}


class ServerSaturated(RuntimeError):
    """Raised by admission="reject" when the queue is full."""


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs. `strategy`/`strategy_kw` are per-server defaults;
    every submit may override them per query."""
    strategy: str = "pred-trans-adaptive"
    strategy_kw: dict = dataclasses.field(default_factory=dict)
    join_backend: str = "cuda"
    # the torch device the torch and cuda backends run on ("cpu": on the
    # CPU, the kernels' plain versions); the numpy backend ignores it
    torch_device: str = "cuda"
    engine: str = "single"
    late_materialize: bool = True
    workers: int = 4
    max_queue: int = 64                 # admission bound (0 = unbounded)
    admission: str = "block"            # "block" | "reject"
    plan_cache_entries: int = 512
    artifact_cache_bytes: int = 256 << 20
    # fault tolerance (DESIGN.md §13): serving degrades by default — a
    # backend failure retries the query on the next-safer rung instead
    # of erroring the Future; per-query `submit(timeout=...)` overrides
    # `default_timeout`; `mem_budget_bytes` caps each query's payload
    # gather (None = unbounded)
    degrade: bool = True
    default_timeout: Optional[float] = None
    mem_budget_bytes: Optional[int] = None
    # runtime join reordering (DESIGN.md §14): "auto" reorders wherever
    # the executor supports it, "off" pins the plan's static order
    reorder: str = "auto"
    # overload control + warm restart (DESIGN.md §16). `shed` enables
    # deadline-aware admission shedding (only queries *with* a deadline
    # are ever shed); breaker_* parameterize the per-rung circuit
    # breakers the ladder consults; retry_budget_* bound exchange
    # retries server-wide; `hedge` arms straggler re-dispatch on
    # distributed shard joins; `snapshot_path`, when set, is restored
    # at construction (if present) — pair with `drain_to_snapshot`.
    shed: bool = True
    breaker_window: int = 8
    breaker_threshold: int = 4
    breaker_cooldown: float = 5.0
    retry_budget_capacity: float = 64.0
    retry_budget_refill: float = 8.0
    hedge: bool = False
    snapshot_path: Optional[str] = None

    def __post_init__(self):
        if self.admission not in ("block", "reject"):
            raise ValueError(f"unknown admission {self.admission!r}; "
                             "choose 'block' or 'reject'")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.join_backend not in ("numpy", "torch", "cuda"):
            raise ValueError(f"unknown join_backend {self.join_backend!r}; "
                             "choose 'numpy', 'torch' or 'cuda'")
        if self.reorder not in ("auto", "on", "off"):
            raise ValueError(f"unknown reorder {self.reorder!r}; "
                             "choose 'auto', 'on' or 'off'")
        if self.breaker_threshold > self.breaker_window:
            raise ValueError(
                f"breaker_threshold ({self.breaker_threshold}) cannot "
                f"exceed breaker_window ({self.breaker_window})")


class ServerMetrics:
    """Aggregate per-query accounting, lock-guarded: latency quantiles
    per tag, admission counters, warm-replay counts."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lat: Dict[str, List[float]] = {}
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.warm_replays = 0           # queries served from slot state
        # fault-tolerance counters (DESIGN.md §13). failed = every query
        # resolving its Future with an exception; timeouts/cancellations
        # split that by cause. degradations counts *successful* queries
        # that took at least one ladder fallback — they are completed,
        # not failed.
        self.errors = 0
        self.timeouts = 0
        self.cancellations = 0
        self.degradations = 0
        # runtime join reordering (DESIGN.md §14)
        self.reordered = 0              # queries whose order changed
        self._qerr: List[Tuple[float, float, int]] = []
        # overload control & recovery (DESIGN.md §16). `shed` counts
        # admission-time rejections for deadline reasons (distinct from
        # `rejected` = queue-full); recovery counters aggregate the
        # per-query `report()["recoveries"]` sections.
        self.shed = 0
        self.worker_deaths = 0
        self.retries = 0
        self.replays = 0
        self.hedges = 0
        self._service_ewma: Optional[float] = None   # seconds/query

    def record_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def record_worker_death(self) -> None:
        with self._lock:
            self.worker_deaths += 1

    def service_estimate(self) -> Optional[float]:
        """EWMA of per-query service seconds (None before the first
        completion) — the admission shedder's wait model."""
        with self._lock:
            return self._service_ewma

    def record_done(self, tag: str, seconds: float,
                    report: Optional[dict],
                    error: Optional[BaseException] = None) -> None:
        """Fold one finished query in. `report` is the structured
        `ExecStats.report()` dict (None for a failed query) — the one
        stats surface the server reads; it never pokes ExecStats
        internals."""
        with self._lock:
            if report is None:
                self.failed += 1
                if isinstance(error, DeadlineExceeded):
                    self.timeouts += 1
                elif isinstance(error, QueryCancelled):
                    self.cancellations += 1
                else:
                    self.errors += 1
                return
            self.completed += 1
            if report.get("degraded"):
                self.degradations += 1
            rec = report.get("recoveries") or {}
            self.retries += int(rec.get("retries", 0))
            self.replays += int(rec.get("replays", 0))
            self.hedges += int(rec.get("hedges", 0))
            self._service_ewma = seconds if self._service_ewma is None \
                else 0.8 * self._service_ewma + 0.2 * seconds
            self._lat.setdefault(tag, []).append(seconds)
            tr = report.get("transfer")
            if tr is not None and tr.get("from_cache"):
                self.warm_replays += 1
            if report.get("reordered"):
                self.reordered += 1
            qe = report.get("qerror") or {}
            if qe.get("n"):
                self._qerr.append((float(qe["geomean"]),
                                   float(qe["max"]), int(qe["n"])))

    @staticmethod
    def _quantiles(lat: List[float]) -> dict:
        a = np.asarray(lat)
        return {"n": int(a.size),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p99_ms": float(np.percentile(a, 99) * 1e3),
                "mean_ms": float(a.mean() * 1e3)}

    def snapshot(self) -> dict:
        with self._lock:
            every = [s for lat in self._lat.values() for s in lat]
            out = {"submitted": self.submitted,
                   "completed": self.completed,
                   "failed": self.failed, "rejected": self.rejected,
                   "warm_replays": self.warm_replays,
                   "errors": self.errors, "timeouts": self.timeouts,
                   "cancellations": self.cancellations,
                   "degradations": self.degradations,
                   "reordered": self.reordered,
                   "shed": self.shed,
                   "worker_deaths": self.worker_deaths,
                   "retries": self.retries, "replays": self.replays,
                   "hedges": self.hedges}
            if self._qerr:
                # edge-count-weighted geomean across queries; max is
                # the worst single-edge misestimate seen anywhere
                logs = sum(n * np.log(max(g, 1.0))
                           for g, _m, n in self._qerr)
                edges = sum(n for _g, _m, n in self._qerr)
                out["qerror"] = {
                    "queries": len(self._qerr),
                    "edges": int(edges),
                    "max": max(m for _g, m, _n in self._qerr),
                    "geomean": float(np.exp(logs / max(edges, 1)))}
            if every:
                out["latency"] = self._quantiles(every)
                out["per_tag"] = {t: self._quantiles(lat)
                                  for t, lat in sorted(self._lat.items())}
            return out


class _Request:
    __slots__ = ("plan", "strategy", "strategy_kw", "tag", "future",
                 "ctx")

    def __init__(self, plan, strategy, strategy_kw, tag, future, ctx):
        self.plan = plan
        self.strategy = strategy
        self.strategy_kw = strategy_kw
        self.tag = tag
        self.future = future
        self.ctx = ctx


class QueryServer:
    """Thread-pooled serving loop over one shared catalog + caches.

    >>> with QueryServer(catalog) as srv:
    ...     table, stats = srv.query(build_query(5, sf))
    ...     fut = srv.submit(build_query(3, sf))        # async
    ...     table3, stats3 = fut.result()
    """

    def __init__(self, catalog: Mapping[str, Table],
                 config: Optional[ServeConfig] = None):
        self.config = config or ServeConfig()
        self._catalog_lock = threading.Lock()
        self.catalog: Dict[str, Table] = dict(catalog)
        self.plan_cache = PlanCache(self.config.plan_cache_entries)
        self.artifact_cache = ArtifactCache(
            self.config.artifact_cache_bytes)
        self.sel_history = SelHistory()
        self.metrics = ServerMetrics()
        # overload control & recovery (DESIGN.md §16): shared across
        # every query this server runs
        self.breakers = recovery.BreakerBoard(
            window=self.config.breaker_window,
            threshold=self.config.breaker_threshold,
            cooldown=self.config.breaker_cooldown)
        self.retry_budget = recovery.RetryBudget(
            capacity=self.config.retry_budget_capacity,
            refill_per_s=self.config.retry_budget_refill)
        self.hedge = recovery.HedgePolicy() if self.config.hedge \
            else None
        # warm restart: absorb a drained predecessor's cache tier
        # before any query (or worker) can observe the caches
        self.restore_info: Optional[dict] = None
        if self.config.snapshot_path:
            from repro_torch.serve import snapshot as _snap
            self.restore_info = _snap.restore_if_present(
                self.config.snapshot_path, self.catalog,
                artifact_cache=self.artifact_cache,
                plan_cache=self.plan_cache,
                sel_history=self.sel_history)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            self.config.max_queue)
        self._closed = False
        self._workers_lock = threading.Lock()
        self._spawned = 0
        self._workers: List[threading.Thread] = []
        for _ in range(max(1, self.config.workers)):
            self._spawn_worker_locked()
        for t in self._workers:
            t.start()

    def _spawn_worker_locked(self) -> None:
        """Append (without starting) one worker thread; caller owns
        `_workers_lock` or is still single-threaded in `__init__`."""
        t = threading.Thread(target=self._worker, daemon=True,
                             name=f"repro-serve-{self._spawned}")
        self._spawned += 1
        self._workers.append(t)

    # -- strategy / executor construction ---------------------------------
    def _make_strategy(self, name: str, kw: dict):
        kw = dict(kw)
        if name in FILTER_CACHED:
            kw.setdefault("artifact_cache", self.artifact_cache)
        if name in BACKEND_AWARE:
            kw.setdefault("backend", self.config.join_backend)
            kw.setdefault("device", self.config.torch_device)
        return make_strategy(name, **kw)

    def _execute(self, req: _Request) -> Tuple[Table, ExecStats]:
        # a fresh Strategy + Executor per query: per-run scratch state
        # stays private, while the catalog snapshot, engines and caches
        # are the shared (and individually locked) parts
        with self._catalog_lock:
            catalog = dict(self.catalog)
        cfg = ExecConfig(
            strategy=self._make_strategy(req.strategy, req.strategy_kw),
            join_backend=self.config.join_backend,
            torch_device=self.config.torch_device,
            late_materialize=self.config.late_materialize,
            engine=self.config.engine,
            plan_cache=self.plan_cache,
            artifact_cache=self.artifact_cache,
            sel_history=self.sel_history,
            degrade=self.config.degrade,
            mem_budget_bytes=self.config.mem_budget_bytes,
            reorder=self.config.reorder,
            retry_budget=self.retry_budget,
            hedge=self.hedge,
            breakers=self.breakers)
        return Executor(catalog, cfg).execute(req.plan, ctx=req.ctx)

    # -- worker loop -------------------------------------------------------
    def _respawn_worker(self) -> None:
        """Replace a crashed worker thread (no-op once closed)."""
        with self._workers_lock:
            if self._closed:
                return
            self._spawn_worker_locked()
            self._workers[-1].start()

    def _worker(self) -> None:
        while True:
            req = self._queue.get()
            if req is None:             # shutdown sentinel
                self._queue.task_done()
                return
            if not req.future.set_running_or_notify_cancel():
                self._queue.task_done()
                continue
            try:
                faultinject.fire("worker.crash")
            except BaseException as e:   # noqa: BLE001 — isolate death
                # worker-death isolation: the victim query gets a typed
                # error, a replacement thread takes over the pool slot,
                # and this thread exits — no other query is affected
                err = BackendError(
                    f"worker thread died mid-query: {e}",
                    phase="serve", tag=req.tag)
                self.metrics.record_done(req.tag, 0.0, None, error=err)
                self.metrics.record_worker_death()
                req.future.set_exception(err)
                self._queue.task_done()
                self._respawn_worker()
                return
            t0 = time.perf_counter()
            try:
                result = self._execute(req)
            except BaseException as e:   # noqa: BLE001 — relayed to caller
                # one failing query errors its own Future; the worker
                # thread survives to serve the next request
                self.metrics.record_done(req.tag,
                                         time.perf_counter() - t0, None,
                                         error=e)
                req.future.set_exception(e)
            else:
                self.metrics.record_done(req.tag,
                                         time.perf_counter() - t0,
                                         result[1].report())
                req.future.set_result(result)
            finally:
                self._queue.task_done()

    # -- submission --------------------------------------------------------
    def submit(self, plan: PlanNode, strategy: Optional[str] = None,
               tag: str = "", timeout: Optional[float] = None,
               **strategy_kw) -> "Future[Tuple[Table, ExecStats]]":
        """Admit one query; returns a `concurrent.futures.Future`
        resolving to (result table, ExecStats). Admission follows
        `config.admission`: "block" applies backpressure, "reject"
        raises `ServerSaturated` when the queue is full.

        `timeout` (seconds, overriding `config.default_timeout`) starts
        at admission; a query past its deadline aborts at the next
        cancellation point with `DeadlineExceeded` on the Future. The
        returned Future carries its `QueryContext` as `query_context`;
        `QueryServer.cancel(fut)` is the cooperative cancel API."""
        if self._closed:
            raise RuntimeError("server is closed")
        name = strategy or self.config.strategy
        kw = dict(self.config.strategy_kw) if strategy is None else {}
        kw.update(strategy_kw)
        ctx = QueryContext(
            timeout=(timeout if timeout is not None
                     else self.config.default_timeout),
            tag=tag or name,
            mem_budget_bytes=self.config.mem_budget_bytes)
        if self.config.shed and ctx.deadline is not None:
            est = self.estimated_wait()
            rem = ctx.remaining()
            if est is not None and rem is not None and est > rem:
                self.metrics.record_shed()
                raise ResourceExhausted(
                    f"load shed at admission: estimated queue wait "
                    f"{est:.3f}s exceeds deadline ({max(rem, 0.0):.3f}s"
                    f" remaining)", phase="admission", tag=tag or name)
        fut: "Future[Tuple[Table, ExecStats]]" = Future()
        fut.query_context = ctx
        req = _Request(plan, name, kw, tag or name, fut, ctx)
        if self.config.admission == "reject":
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                self.metrics.record_reject()
                raise ServerSaturated(
                    f"admission queue full "
                    f"({self.config.max_queue} pending)") from None
        else:
            self._queue.put(req)
        self.metrics.record_submit()
        if self._closed and fut.cancel():
            # raced close(): our request may sit behind the shutdown
            # sentinels where no worker will ever see it — resolve its
            # Future (cancelled) so nothing is left permanently pending
            raise RuntimeError("server is closed")
        return fut

    def estimated_wait(self) -> Optional[float]:
        """Expected queue wait for a query admitted *now*: queue depth
        over pool width, times the service-time EWMA. None until the
        first completion calibrates the model (never shed blind)."""
        svc = self.metrics.service_estimate()
        if svc is None:
            return None
        width = max(1, self.config.workers)
        return (self._queue.qsize() / width) * svc

    def cancel(self, fut: Future) -> bool:
        """Cancel a submitted query. Still queued: the Future is
        cancelled outright. Already running: its cooperative token is
        flipped, and the query aborts at the next cancellation point
        (phase boundary / transfer vertex / join) with `QueryCancelled`
        on the Future. Returns False only for a Future this server
        never issued (no attached context)."""
        if fut.cancel():
            return True
        ctx = getattr(fut, "query_context", None)
        if ctx is None:
            return False
        ctx.cancel()
        return True

    def query(self, plan: PlanNode, strategy: Optional[str] = None,
              tag: str = "", timeout: Optional[float] = None,
              **strategy_kw) -> Tuple[Table, ExecStats]:
        """Synchronous submit-and-wait."""
        return self.submit(plan, strategy, tag, timeout,
                           **strategy_kw).result()

    async def aquery(self, plan: PlanNode,
                     strategy: Optional[str] = None, tag: str = "",
                     timeout: Optional[float] = None,
                     **strategy_kw) -> Tuple[Table, ExecStats]:
        """Awaitable submit — many `aquery` coroutines run concurrently
        over the worker pool from one event loop."""
        return await asyncio.wrap_future(
            self.submit(plan, strategy, tag, timeout, **strategy_kw))

    def session(self, strategy: Optional[str] = None, tag: str = "",
                **strategy_kw) -> "Session":
        return Session(self, strategy, tag, strategy_kw)

    # -- catalog updates / invalidation ------------------------------------
    def update_table(self, name: str, table: Table) -> int:
        """Replace a catalog table and drop every cached artifact the
        old version contributed to. Queries admitted after this see the
        new table; in-flight queries keep their snapshot (and their
        results stay internally consistent — each query snapshots the
        whole catalog once). Returns entries invalidated."""
        with self._catalog_lock:
            old = self.catalog.get(name)
            self.catalog[name] = table
        if old is None:
            return 0
        return self.artifact_cache.invalidate_table(old)

    # -- observability / lifecycle -----------------------------------------
    def metrics_snapshot(self) -> dict:
        out = {"server": self.metrics.snapshot(),
               "plan_cache": self.plan_cache.snapshot(),
               "artifact_cache": self.artifact_cache.snapshot(),
               "sel_history": self.sel_history.snapshot(),
               "breakers": self.breakers.snapshot(),
               "retry_budget": self.retry_budget.snapshot()}
        if self.restore_info is not None:
            out["restore"] = dict(self.restore_info)
        return out

    # -- warm restart (DESIGN.md §16) --------------------------------------
    def snapshot_to(self, path: str) -> dict:
        """Write the current cache tier to `path` (atomic). Safe on a
        live server — caches are internally locked — but a *drained*
        snapshot (`drain_to_snapshot`) is the warm-restart contract:
        nothing mutates the caches mid-serialization."""
        from repro_torch.serve import snapshot as _snap
        with self._catalog_lock:
            catalog = dict(self.catalog)
        return _snap.write_snapshot(
            path, catalog, artifact_cache=self.artifact_cache,
            plan_cache=self.plan_cache, sel_history=self.sel_history)

    def drain_to_snapshot(self, path: str) -> dict:
        """Graceful drain: stop admissions, run every queued query to
        completion, then persist the fully warmed cache tier. A new
        server constructed with ``snapshot_path=path`` serves its first
        query warm."""
        self.close(wait=True)
        return self.snapshot_to(path)

    def _drain_pending(self) -> int:
        """Pop every queued request and cancel its Future (shutdown
        sentinels pass through). Returns requests cancelled."""
        n = 0
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return n
            if req is not None and req.future.cancel():
                n += 1
            self._queue.task_done()

    def close(self, wait: bool = True,
              cancel_pending: bool = False) -> None:
        """Shut the server down deterministically: after `close(wait=
        True)` returns, every Future this server issued is resolved —
        queued requests either ran to completion (default) or were
        cancelled (`cancel_pending=True`); none is left pending."""
        if self._closed:
            return
        with self._workers_lock:
            # under the lock so a concurrent crash-respawn either
            # completes first (its thread gets a sentinel) or observes
            # `_closed` and declines to spawn
            self._closed = True
            workers = list(self._workers)
        if cancel_pending:
            self._drain_pending()
        for _ in workers:
            self._queue.put(None)
        if wait:
            for t in workers:
                t.join()
            # submits that raced close() may have landed behind the
            # sentinels, where no (now exited) worker can reach them
            self._drain_pending()

    def __enter__(self) -> "QueryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Session:
    """A client handle bound to one server with a default strategy —
    the unit the serving benches/tests hand to each simulated client."""

    def __init__(self, server: QueryServer, strategy: Optional[str],
                 tag: str, strategy_kw: dict):
        self.server = server
        self.strategy = strategy
        self.tag = tag
        self.strategy_kw = dict(strategy_kw)

    def submit(self, plan: PlanNode, tag: str = "",
               timeout: Optional[float] = None):
        return self.server.submit(plan, self.strategy,
                                  tag or self.tag, timeout,
                                  **self.strategy_kw)

    def query(self, plan: PlanNode, tag: str = "",
              timeout: Optional[float] = None):
        return self.submit(plan, tag, timeout).result()

    async def aquery(self, plan: PlanNode, tag: str = ""):
        return await asyncio.wrap_future(self.submit(plan, tag))
