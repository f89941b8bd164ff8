"""Typed error taxonomy + per-query execution context (DESIGN.md §13).

Every fault the query pipeline can surface deliberately is a
`QueryError` subclass carrying *where* it happened (`phase`: scan /
transfer / join) and which query it belongs to (`tag`). The split
matters operationally:

* `DeadlineExceeded` / `QueryCancelled` — cooperative aborts raised by
  `QueryContext.check()`; the degradation ladder never retries them
  (the client asked for the abort, a cheaper rung is not an answer);
* `ResourceExhausted` — the pre-gather memory guard tripped; retried
  once on the memory-safe rung (eager → late materialization);
* `BackendError` — an engine / exchange / kernel fault; retried on the
  next-safer rung (distributed → late-numpy → eager oracle,
  pred-trans-adaptive → pred-trans → no-prefilter);
* `CacheCorruption` — a transfer artifact failed verify-on-hit. The
  cache self-heals (drop + recompute), so this type normally shows up
  in counters, not raises.

`QueryContext` is the cooperative cancellation token threaded through
`Executor`, the transfer strategies and the join engines: a deadline
(monotonic-clock absolute), a cancel flag any thread may set, and an
optional per-query memory budget. `check()` is called at phase
boundaries and per transfer pass/vertex, so a query stops within one
pass of its deadline without any preemption machinery.

Kept stdlib-only: everything under `repro_torch.core` (and `repro_torch.ft`, which
re-exports the taxonomy) may import this module without cycles.
"""
from __future__ import annotations

import time
from typing import Callable, Optional


class QueryError(RuntimeError):
    """Base of the query fault taxonomy; knows its phase and query."""

    def __init__(self, msg: str = "", *, phase: Optional[str] = None,
                 tag: str = ""):
        super().__init__(msg)
        self.phase = phase
        self.tag = tag

    def __str__(self) -> str:
        base = super().__str__()
        ctx = [p for p in (self.phase and f"phase={self.phase}",
                           self.tag and f"query={self.tag}") if p]
        return f"{base} [{', '.join(ctx)}]" if ctx else base


class DeadlineExceeded(QueryError):
    """The query's deadline passed; raised at the next check point."""


class QueryCancelled(QueryError):
    """`QueryContext.cancel()` was called (possibly from another
    thread); raised at the next check point."""


class ResourceExhausted(QueryError):
    """The estimated payload-gather bytes exceed the query's memory
    budget — raised *before* the allocation, instead of an OOM."""


class BackendError(QueryError):
    """An engine/exchange/kernel failure the degradation ladder may
    retry on a safer rung."""


class CacheCorruption(QueryError):
    """A cached transfer artifact failed its integrity check. The
    artifact cache handles this internally (drop + recompute); the type
    exists so callers that *must not* self-heal can still name it."""


class QueryContext:
    """Per-query deadline + cooperative cancellation token + resource
    budget. One instance per query, shared across every layer that
    query touches (executor, strategy, join engine) and across threads
    (a client thread calls `cancel()`, the worker thread `check()`s).

    `check(phase=...)` records the pipeline's current phase and raises
    `QueryCancelled` / `DeadlineExceeded` when the token says stop.
    Writes to the cancel flag are plain attribute stores (atomic under
    the GIL); there is deliberately no lock on this object.

    `clock` is injectable for deterministic deadline tests; it defaults
    to `time.monotonic` and is only consulted when a deadline is set.
    """

    __slots__ = ("deadline", "tag", "mem_budget_bytes", "phase",
                 "_cancelled", "_clock")

    def __init__(self, timeout: Optional[float] = None,
                 deadline: Optional[float] = None, tag: str = "",
                 mem_budget_bytes: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        if deadline is None and timeout is not None:
            deadline = clock() + float(timeout)
        self.deadline = deadline
        self.tag = tag
        self.mem_budget_bytes = mem_budget_bytes
        self.phase: Optional[str] = None
        self._cancelled = False

    def cancel(self) -> None:
        """Request cooperative cancellation (safe from any thread)."""
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def remaining(self) -> Optional[float]:
        """Seconds until the deadline (None = no deadline)."""
        if self.deadline is None:
            return None
        return self.deadline - self._clock()

    def check(self, phase: Optional[str] = None) -> None:
        if phase is not None:
            self.phase = phase
        if self._cancelled:
            raise QueryCancelled("query cancelled", phase=self.phase,
                                 tag=self.tag)
        if self.deadline is not None and self._clock() > self.deadline:
            raise DeadlineExceeded(
                f"deadline exceeded by {self._clock() - self.deadline:.3f}s",
                phase=self.phase, tag=self.tag)
