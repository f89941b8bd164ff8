"""Deterministic, seedable fault injection (DESIGN.md §13).

A process-global registry of *named fault points* instrumented at the
pipeline's failure-prone seams. Each site calls ``fire(point)``; when
no schedule is armed that is a single global read and a return, so the
hooks are free in production. Tests and `benchmarks/chaos_bench.py` arm
a `FaultSchedule` to make a chosen point raise `InjectedFault` (a
`BackendError`, so the executor's degradation ladder treats it exactly
like a real kernel/exchange failure) at deterministic call indices.

Registered points:

* ``engine.probe``   — Bloom-engine survivor probe (`VertexScan.probe`)
* ``engine.build``   — Bloom filter build (`VertexScan.build`)
* ``join.indices``   — join-index computation (host + device engines)
* ``exchange.send``  — distributed exchange collective, send side
  (all-to-all / all-gather entry, simulated and mesh-backed alike)
* ``exchange.recv``  — distributed exchange collective, receive side
  (after the collective returns, before reassembly — inside the same
  retry scope as the send, DESIGN.md §16)
* ``shard.delay``    — per-shard local-join straggler: with hedging
  armed the task sleeps `HedgePolicy.straggle_seconds` instead of
  raising, exercising hedged re-dispatch
* ``cache.deserialize`` — artifact-cache read-out; an injected fault
  here is absorbed by verify-on-hit (counted as corruption, entry
  dropped, miss returned) and never propagates
* ``gather.payload`` — late-materialization payload gather
  (`JoinCursor.materialize`)
* ``snapshot.load``  — serve-layer cache-snapshot restore; an injected
  fault is treated as a corrupt snapshot (dropped, cold start)
* ``worker.crash``   — `QueryServer` worker thread death mid-query;
  the pool sets a typed error on the Future and respawns the worker

Schedules are deterministic by construction: a point fires at explicit
call indices (``{"join.indices": 0}``), at every call
(``{"engine.probe": "all"}``), or at indices chosen by a seeded hash
(`FaultSchedule.seeded`) — never by wall clock or `random`. Call
counts reset when a schedule is armed, so per-query `inject()` blocks
are reproducible regardless of what ran before.
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Dict, Iterable, Optional, Union

from repro_torch.core.errors import BackendError

#: every registered fault point (chaos_bench sweeps this tuple)
FAULT_POINTS = (
    "engine.probe",
    "engine.build",
    "join.indices",
    "exchange.send",
    "exchange.recv",
    "shard.delay",
    "cache.deserialize",
    "gather.payload",
    "snapshot.load",
    "worker.crash",
)


class InjectedFault(BackendError):
    """Raised by an armed fault point. Subclasses `BackendError` so the
    degradation ladder retries it like any real backend failure."""

    def __init__(self, point: str, call_index: int):
        super().__init__(f"injected fault at {point!r} "
                         f"(call {call_index})")
        self.point = point
        self.call_index = call_index


def _seeded_fire(seed: int, point: str, idx: int, rate: float) -> bool:
    h = hashlib.blake2b(f"{seed}:{point}:{idx}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64 < rate


class FaultSchedule:
    """Which calls of which points raise.

    ``spec`` maps a point name to one of:
      * an int (or iterable of ints) — fire at those 0-based call
        indices of that point;
      * ``"all"`` — fire at every call (optionally capped by ``limit``).

    ``FaultSchedule.seeded(seed, rate, points, limit)`` instead fires
    each call with probability ``rate`` under a seeded hash of
    (seed, point, call index) — deterministic across runs for the same
    call sequence.

    Thread-safe; `calls` / `fired` are per-point counters tests and the
    chaos bench assert on (a scheduled fault that never fired means the
    instrumented path never ran).
    """

    def __init__(self, spec: Dict[str, Union[int, str, Iterable[int]]],
                 limit: Optional[int] = None):
        unknown = set(spec) - set(FAULT_POINTS)
        if unknown:
            raise ValueError(f"unknown fault points {sorted(unknown)}; "
                             f"registered: {FAULT_POINTS}")
        self._at: Dict[str, Optional[frozenset]] = {}
        for point, sel in spec.items():
            if sel == "all":
                self._at[point] = None          # every call
            elif isinstance(sel, int):
                self._at[point] = frozenset({sel})
            else:
                self._at[point] = frozenset(int(i) for i in sel)
        self._seed: Optional[int] = None
        self._rate = 0.0
        self.limit = limit
        self._lock = threading.Lock()
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    @classmethod
    def seeded(cls, seed: int, rate: float,
               points: Iterable[str] = FAULT_POINTS,
               limit: Optional[int] = None) -> "FaultSchedule":
        sched = cls({}, limit=limit)
        for point in points:
            if point not in FAULT_POINTS:
                raise ValueError(f"unknown fault point {point!r}")
            sched._at[point] = frozenset()      # decided by the hash
        sched._seed = int(seed)
        sched._rate = float(rate)
        return sched

    def total_fired(self) -> int:
        with self._lock:
            return sum(self.fired.values())

    def fire(self, point: str) -> None:
        with self._lock:
            sel = self._at.get(point)
            if point not in self._at:
                return
            idx = self.calls.get(point, 0)
            self.calls[point] = idx + 1
            should = (sel is None or idx in sel
                      or (self._seed is not None
                          and _seeded_fire(self._seed, point, idx,
                                           self._rate)))
            if should and self.limit is not None \
                    and self.fired.get(point, 0) >= self.limit:
                should = False
            if should:
                self.fired[point] = self.fired.get(point, 0) + 1
        if should:
            raise InjectedFault(point, idx)


_ACTIVE: Optional[FaultSchedule] = None
_ARM_LOCK = threading.Lock()


def active() -> Optional[FaultSchedule]:
    return _ACTIVE


def fire(point: str) -> None:
    """Instrumentation hook: no-op unless a schedule is armed."""
    sched = _ACTIVE
    if sched is not None:
        sched.fire(point)


@contextlib.contextmanager
def inject(schedule: Union[FaultSchedule, Dict[str, object]]):
    """Arm `schedule` for the dynamic extent of the block (process-wide
    — concurrent queries all see it, which is the point of chaos
    testing; schedules may not nest)."""
    global _ACTIVE
    if not isinstance(schedule, FaultSchedule):
        schedule = FaultSchedule(schedule)
    with _ARM_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a fault schedule is already armed")
        _ACTIVE = schedule
    try:
        yield schedule
    finally:
        _ACTIVE = None
