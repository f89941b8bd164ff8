"""Proportionate-recovery primitives (DESIGN.md §16).

The degradation ladder (DESIGN.md §13) treats every fault as rung-sized: one
transient ``exchange.send`` blip and the whole distributed engine is
abandoned for the single-host rung. This module supplies the smaller
hammers the runtime and the serving layer compose instead:

* `RetryPolicy` — bounded exponential backoff with **seeded jitter**
  (deterministic per (key, attempt), so two runs of the same query
  sleep the same schedule), an injectable clock/sleep pair, and
  deadline awareness: a backoff never sleeps past the query's
  `QueryContext.remaining()`.
* `RetryBudget` — a per-server token bucket spent by every retry and
  lineage replay. Under overload, retries stop amplifying load: an
  empty budget turns exhaustion into an immediate ladder step instead
  of another storm of collectives.
* `CircuitBreaker` / `BreakerBoard` — per-rung sliding-window breakers
  (closed → open after N failures in the last W outcomes → half-open
  probe after a cooldown → closed on probe success). The ladder
  consults the board before *attempting* a rung, so a rung that keeps
  failing is skipped outright instead of rediscovered per query.
* `HedgePolicy` — straggler hedging: per-label latency history, a
  p99-based hedge delay (with a floor so cold histories never hedge
  instantly), and the simulated-straggler sleep used by the
  ``shard.delay`` fault point.

Everything here is stdlib-only and clock-injectable; determinism is
what makes the chaos bench's bit-exactness assertions meaningful.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Callable, Dict, List


def _hash01(*parts) -> float:
    """Deterministic uniform [0, 1) from the blake2b of the parts —
    the seeded jitter source (no process-global RNG state)."""
    h = hashlib.blake2b(":".join(str(p) for p in parts).encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big") / float(1 << 64)


# --------------------------------------------------------------------------
# retry
# --------------------------------------------------------------------------


class RetryPolicy:
    """Bounded exponential backoff with seeded jitter.

    ``attempts`` counts *retries* (total tries = attempts + 1). The
    delay before retry ``i`` (1-based) is ``base * mult**(i-1)`` capped
    at ``max_delay``, scaled by a jitter factor in [0.5, 1.0) derived
    from ``(seed, key, i)`` — deterministic, so recovery schedules
    replay identically. Stateless and shareable across threads."""

    def __init__(self, attempts: int = 2, base: float = 0.002,
                 mult: float = 2.0, max_delay: float = 0.05,
                 seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        if attempts < 0:
            raise ValueError("attempts must be >= 0")
        self.attempts = int(attempts)
        self.base = float(base)
        self.mult = float(mult)
        self.max_delay = float(max_delay)
        self.seed = int(seed)
        self._sleep = sleep

    def delay(self, key: str, attempt: int) -> float:
        """Deterministic backoff before retry `attempt` (1-based)."""
        raw = min(self.base * self.mult ** (attempt - 1), self.max_delay)
        return raw * (0.5 + 0.5 * _hash01(self.seed, key, attempt))

    def backoff(self, key: str, attempt: int, ctx=None) -> None:
        """Sleep the jittered delay, deadline-aware: the sleep is capped
        at the context's remaining time and a passed deadline raises
        `DeadlineExceeded` (via ``ctx.check``) instead of burning the
        remaining attempts on a query that can no longer finish."""
        d = self.delay(key, attempt)
        if ctx is not None:
            rem = ctx.remaining()
            if rem is not None:
                d = min(d, max(rem, 0.0))
        if d > 0:
            self._sleep(d)
        if ctx is not None:
            ctx.check("retry")


class RetryBudget:
    """Token bucket bounding retries per server (thread-safe).

    Starts full at `capacity`; each retry/replay spends one token;
    tokens refill at `refill_per_s`. When empty, `try_spend` refuses —
    callers give up the fine-grained recovery and let the coarse
    ladder handle the fault, so retry storms cannot amplify overload."""

    def __init__(self, capacity: float = 64.0, refill_per_s: float = 8.0,
                 clock: Callable[[], float] = time.monotonic):
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._clock = clock
        self._tokens = float(capacity)
        self._last = clock()
        self._lock = threading.Lock()
        self.spent = 0
        self.refused = 0

    def _refill_locked(self) -> None:
        now = self._clock()
        dt = max(now - self._last, 0.0)
        self._last = now
        self._tokens = min(self.capacity,
                           self._tokens + dt * self.refill_per_s)

    def try_spend(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                self.spent += 1
                return True
            self.refused += 1
            return False

    def remaining(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens

    def snapshot(self) -> dict:
        with self._lock:
            self._refill_locked()
            return {"capacity": self.capacity, "tokens": self._tokens,
                    "spent": self.spent, "refused": self.refused}


# --------------------------------------------------------------------------
# circuit breaker
# --------------------------------------------------------------------------


class CircuitBreaker:
    """Sliding-window breaker: closed / open / half-open (thread-safe).

    `record(ok)` appends to a window of the last `window` outcomes;
    `threshold` failures among them open the breaker. While open,
    `allow()` refuses until `cooldown` seconds pass, then the breaker
    goes half-open and admits probe calls; a probe success closes it
    (window reset), a probe failure re-opens with a fresh cooldown."""

    def __init__(self, window: int = 8, threshold: int = 4,
                 cooldown: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if window < 1 or threshold < 1 or threshold > window:
            raise ValueError("need 1 <= threshold <= window")
        self.window = int(window)
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self._clock = clock
        self._lock = threading.Lock()
        self._outcomes: List[bool] = []
        self._state = "closed"
        self._opened_at = 0.0
        self.opens = 0
        self.skips = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if (self._state == "open"
                and self._clock() - self._opened_at >= self.cooldown):
            self._state = "half-open"
        return self._state

    def allow(self) -> bool:
        with self._lock:
            st = self._state_locked()
            if st == "open":
                self.skips += 1
                return False
            return True              # closed, or half-open probe

    def record(self, ok: bool) -> None:
        with self._lock:
            st = self._state_locked()
            if st == "half-open":
                if ok:               # probe succeeded: close + reset
                    self._state = "closed"
                    self._outcomes = [True]
                else:                # probe failed: fresh cooldown
                    self._state = "open"
                    self._opened_at = self._clock()
                    self.opens += 1
                return
            self._outcomes.append(bool(ok))
            if len(self._outcomes) > self.window:
                self._outcomes = self._outcomes[-self.window:]
            fails = sum(1 for o in self._outcomes if not o)
            if st == "closed" and fails >= self.threshold:
                self._state = "open"
                self._opened_at = self._clock()
                self.opens += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state_locked(),
                    "failures": sum(1 for o in self._outcomes if not o),
                    "window": len(self._outcomes),
                    "opens": self.opens, "skips": self.skips}


class BreakerBoard:
    """Per-rung breakers keyed by the ladder's rung descriptors
    (``engine/mode/backend+strategy`` strings). Lazily creates one
    breaker per rung with shared parameters; thread-safe."""

    def __init__(self, window: int = 8, threshold: int = 4,
                 cooldown: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self._kw = dict(window=window, threshold=threshold,
                        cooldown=cooldown, clock=clock)
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def breaker(self, rung: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(rung)
            if b is None:
                b = self._breakers[rung] = CircuitBreaker(**self._kw)
            return b

    def allow(self, rung: str) -> bool:
        return self.breaker(rung).allow()

    def record(self, rung: str, ok: bool) -> None:
        self.breaker(rung).record(ok)

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._breakers.items())
        return {rung: b.snapshot() for rung, b in items}


# --------------------------------------------------------------------------
# hedging
# --------------------------------------------------------------------------


class HedgePolicy:
    """Straggler hedging policy: when a (pure) shard task has run
    longer than a p99-based threshold, dispatch a second attempt and
    take whichever finishes first — bit-exact because the tasks are
    deterministic functions of host-resident inputs.

    `observe` feeds per-task latencies; `delay()` returns
    ``max(min_delay, factor * p99(history))`` so a cold history never
    hedges instantly and a warm one hedges only genuine outliers.
    `straggle_seconds` is the simulated-straggler sleep the
    ``shard.delay`` fault point injects at the instrumentation site."""

    def __init__(self, min_delay: float = 0.02, factor: float = 3.0,
                 history: int = 128, straggle_seconds: float = 0.25):
        self.min_delay = float(min_delay)
        self.factor = float(factor)
        self.history = int(history)
        self.straggle_seconds = float(straggle_seconds)
        self._lock = threading.Lock()
        self._lat: List[float] = []

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._lat.append(float(seconds))
            if len(self._lat) > self.history:
                self._lat = self._lat[-self.history:]

    def delay(self) -> float:
        with self._lock:
            lat = sorted(self._lat)
        if not lat:
            return self.min_delay
        p99 = lat[min(int(0.99 * len(lat)), len(lat) - 1)]
        return max(self.min_delay, self.factor * p99)


_HEDGE_POOL = None
_HEDGE_POOL_LOCK = threading.Lock()


def hedge_pool():
    """Shared small thread pool for hedged shard tasks. Lazy: plain
    (non-hedged) execution never creates a thread."""
    global _HEDGE_POOL
    with _HEDGE_POOL_LOCK:
        if _HEDGE_POOL is None:
            from concurrent.futures import ThreadPoolExecutor
            _HEDGE_POOL = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="repro-hedge")
        return _HEDGE_POOL
