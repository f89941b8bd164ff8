"""Distributed late-materialized join runtime (DESIGN.md §9).

Predicate transfer is already sharded (`repro_torch.core.distributed`, §6);
this module distributes the *join* phase it feeds. The unit of
distribution is the selection-vector cursor (DESIGN §8): a join
intermediate is never a table, it is per-leaf row-index vectors, and
those vectors are **row-sharded contiguously** across the `data` axis
of a `repro_torch.launch.mesh.DataMesh` — shard ``s`` owns cursor
rows ``[bounds[s], bounds[s+1])``. Because the join output contract
emits probe rows in original order, every join
maps a contiguous probe range to a contiguous output range, so cursor
shards stay contiguous through arbitrary join trees and the host-side
global vector is exactly the concatenation of the shard-local ones
(the host-mirror idiom from §7/§8).

Per join edge the runtime picks one of two exchange strategies, by
modeled wire cost:

* **broadcast-build** — all-gather the (transfer-shrunk) build-side key
  vector so every shard joins its probe range against the full build
  side locally. Wire: ``(p-1)·8·|B|`` bytes. This mirrors
  `distributed_bloom_build`'s OR-all-reduce shape and is the common
  case after predicate transfer, where build sides are dimension
  tables cut to thousands of live rows.
* **radix all-to-all shuffle** — both sides hash-partition by the top
  ``log2(p)`` bits of the same Fibonacci hash the single-host radix
  join uses; partition ``t`` of every shard travels to shard ``t`` in
  one all-to-all; each shard sorted-joins its partition and results
  scatter back to global probe order. Wire: ``≈ (1-1/p)·12·(|B|+|P|)``
  bytes (12 = packed key halves + row id). The large–large fact-join
  case.

Both strategies reproduce `sorted_join_indices` bit for bit: broadcast
because each shard sees the whole build side and a contiguous probe
slice; shuffle because equal keys share a partition, the stable
partitioning + source-ordered all-to-all reassembly preserve global
relative order within each partition, and the scatter-back is the same
`assemble_partitioned_join` the single-host radix path uses.

The exchange itself is backend-pluggable, same split as every engine in
this tree: `MeshExchange` moves the blocks between the devices of a 1-D
`DataMesh` from one controller process (each source's slab uploaded to
its own device, each target's receive buffer stacked from `.to(device)`
copies — peer copies between distinct GPUs; int64 keys travel as
`(lo, hi)` uint32 halves, `repro_torch.core.hashing`, held as their
int32 bit pattern on the device, and blocks pad to power-of-two
buckets); `SimulatedExchange` is the numpy mirror used when fewer than
two CUDA devices are visible. Results are identical; tests assert it on
`make_data_mesh(p, devices=["cpu"] * p)`
(tests/test_torch_engine_join_dist.py)
and on one card (tests/test_torch_dist_gpu.py).

The local engine of a shard may return device index vectors (the
`cuda` backend with the device-resident plane on); the broadcast
strategy downloads them (`device_plane.to_host`, counted) before it
joins the shards' results on the host.

Faults recover proportionately (DESIGN.md §16) instead of costing the
whole engine a ladder rung: every collective runs under an
`ExchangeRecovery` that retries transient ``exchange.send`` /
``exchange.recv`` faults in place (`repro_torch.core.recovery.RetryPolicy` —
seeded-jitter backoff, deadline-aware, budget-bounded); on retry
exhaustion the engine **replays the failed edge's whole exchange** from
its host-resident key inputs (everything the strategies consume is
recomputable — lineage replay, one shot) before letting the fault reach
the degradation ladder. Straggler shards (``shard.delay``) get hedged
re-dispatch after a p99-based delay, first result wins. All recovery
events land in ``DistStats.recoveries`` and surface through
``ExecStats.report()["recoveries"]``; every path is bit-exact because
retries/replays/hedges re-run pure functions of host-resident inputs.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core import faultinject, recovery
from repro_torch.core.errors import BackendError
from repro_torch.core.engine_join import (
    JoinEngine, _partition_ids, assemble_partitioned_join, get_join_engine,
    join_partition,
)

#: wire bytes per shuffled row: packed (key_lo, key_hi, row_id) uint32
ROW_WIRE_BYTES = 12
#: wire bytes per broadcast key: (key_lo, key_hi) uint32
KEY_WIRE_BYTES = 8
#: extra wire bytes per row when a validity plane travels alongside the
#: key halves (nullable join keys only; all-valid sides ship without it)
VALID_WIRE_BYTES = 4
#: modeled ns per wire byte for the runtime join-ordering cost model
#: (repro_torch.relational.reorder): ~2 GB/s effective exchange bandwidth,
#: the same order as the simulated collectives' memcpy cost. Only the
#: *ratio* against TransferCosts' per-row join coefficients matters —
#: it prices large-build steps out of the distributed chain order.
WIRE_NS_PER_BYTE = 0.5


def shard_bounds(n: int, nshards: int) -> np.ndarray:
    """Contiguous near-even row ranges: shard s owns [b[s], b[s+1])."""
    return (np.arange(nshards + 1, dtype=np.int64) * n) // nshards


def shard_cursor(cursor, nshards: int) -> List:
    """Row-shard a `JoinCursor` into its per-shard cursors (the device
    layout this runtime distributes; the input cursor is their host
    mirror). Materializing the shards in order and concatenating equals
    materializing the whole cursor — the cursor-sharding invariant."""
    b = shard_bounds(len(cursor), nshards)
    return [cursor.take(np.arange(b[s], b[s + 1], dtype=np.int64))
            for s in range(nshards)]


def _pack(keys: np.ndarray, rowids: Optional[np.ndarray] = None,
          valid: Optional[np.ndarray] = None) -> np.ndarray:
    """int64 keys (+ row ids, + validity plane) -> uint32 [n, 2..4]
    wire blocks. The validity plane travels last and only when the side
    actually has NULL keys — all-valid sides keep the original block
    layout (and wire byte counts) untouched."""
    from repro_torch.core.hashing import key_halves
    lo, hi = key_halves(keys)
    cols = [lo, hi]
    if rowids is not None:
        cols.append(rowids.astype(np.uint32))
    if valid is not None:
        cols.append(valid.astype(np.uint32))
    return np.stack(cols, axis=1)


def _unpack_keys(block: np.ndarray) -> np.ndarray:
    u = block[:, 0].astype(np.uint64) | (block[:, 1].astype(np.uint64) << 32)
    return u.view(np.int64)


def _unpack_rowids(block: np.ndarray) -> np.ndarray:
    return block[:, 2].astype(np.int64)


def _drop_invalid(block: np.ndarray, has_valid: bool) -> np.ndarray:
    """Receiver-side NULL filter: rows whose validity plane is 0 never
    match, so they leave the partition before the local join. Dropping
    preserves the block's (global, stable) row order, which is what
    makes the result bit-identical to the compact-then-join oracle."""
    if not has_valid:
        return block
    return block[block[:, -1] != 0]


# --------------------------------------------------------------------------
# exchange backends
# --------------------------------------------------------------------------


class SimulatedExchange:
    """Host mirror of the device collectives: same block layout, same
    source-ordered reassembly, no device involved. Used when the process
    sees fewer than two CUDA devices (the CPU tests, and one card)."""

    device_backed = False

    def __init__(self, nshards: int):
        if nshards < 1 or nshards & (nshards - 1):
            raise ValueError(f"nshards must be a power of two, "
                             f"got {nshards}")
        self.nshards = nshards

    def all_to_all(self, blocks: List[List[np.ndarray]]) -> List[np.ndarray]:
        """blocks[s][t] = shard s's rows bound for shard t; returns
        received[t] = concat over sources s in shard order (global row
        order, since shards own ascending contiguous ranges)."""
        faultinject.fire("exchange.send")
        p = self.nshards
        out = [np.concatenate([blocks[s][t] for s in range(p)])
               for t in range(p)]
        faultinject.fire("exchange.recv")
        return out

    def all_gather(self, shards: List[np.ndarray]) -> np.ndarray:
        faultinject.fire("exchange.send")
        out = np.concatenate(shards)
        faultinject.fire("exchange.recv")
        return out


class MeshExchange:
    """Device collectives over a 1-D `DataMesh`, driven by one
    controller process. Blocks pad to a shared power-of-two bucket (as
    the reference's do for its jit cache); source `s`'s `[p, B, C]` slab
    is uploaded to `devices[s]`, target `t`'s receive buffer is stacked
    from `slab[s][t].to(devices[t])` over `s` in shard order, and the
    buffers are downloaded and reassembled with the counts. One counted
    upload and one counted download per collective, as the reference's
    `_put` and `device_plane.to_host`."""

    device_backed = True

    def __init__(self, mesh=None, axis: str = "data",
                 nshards: Optional[int] = None):
        from repro_torch.launch.mesh import make_data_mesh
        from repro_torch.parallel.sharding import axis_size
        if mesh is None:
            mesh = make_data_mesh(nshards, axis=axis)
        self.mesh, self.axis = mesh, axis
        self.nshards = axis_size(mesh, axis)
        if self.nshards < 1 or self.nshards & (self.nshards - 1):
            raise ValueError(f"nshards must be a power of two, "
                             f"got {self.nshards}")

    def _bucket(self, n: int) -> int:
        from repro_torch.core.bloom import _bucket
        return _bucket(n, floor=8)

    def _put(self, arr: np.ndarray) -> list:
        """Host uint32 [p, ...] -> slab s on devices[s], one counted
        upload."""
        import torch

        from repro_torch.core import device_plane
        device_plane.count_h2d(arr.nbytes)
        i32 = np.ascontiguousarray(arr).view(np.int32)
        return [torch.from_numpy(i32[s]).to(dev)
                for s, dev in enumerate(self.mesh.devices)]

    def _get(self, bufs: list) -> np.ndarray:
        """Every target's receive buffer -> host uint32 [p, ...], one
        counted download."""
        import torch

        from repro_torch.core import device_plane
        host = torch.stack([b.cpu() for b in bufs])
        return device_plane.to_host(host).view(np.uint32)

    def all_to_all(self, blocks: List[List[np.ndarray]]) -> List[np.ndarray]:
        import torch
        faultinject.fire("exchange.send")
        p = self.nshards
        width = blocks[0][0].shape[1]
        cnt = np.array([[len(blocks[s][t]) for t in range(p)]
                        for s in range(p)], np.int64)
        bucket = self._bucket(int(cnt.max()))
        send = np.zeros((p, p, bucket, width), np.uint32)
        for s in range(p):
            for t in range(p):
                send[s, t, :cnt[s, t]] = blocks[s][t]
        slabs = self._put(send)
        recv = self._get([torch.stack([slabs[s][t].to(dev)
                                       for s in range(p)])
                          for t, dev in enumerate(self.mesh.devices)])
        faultinject.fire("exchange.recv")
        # recv[t, s] = block s->t; concat sources in shard order
        return [np.concatenate([recv[t, s, :cnt[s, t]] for s in range(p)])
                for t in range(p)]

    def all_gather(self, shards: List[np.ndarray]) -> np.ndarray:
        import torch
        faultinject.fire("exchange.send")
        p = self.nshards
        width = shards[0].shape[1]
        cnt = [len(s) for s in shards]
        bucket = self._bucket(max(cnt))
        send = np.zeros((p, bucket, width), np.uint32)
        for s in range(p):
            send[s, :cnt[s]] = shards[s]
        slabs = self._put(send)
        recv = self._get([torch.stack([slabs[s].to(dev) for s in range(p)])
                          for dev in self.mesh.devices])
        faultinject.fire("exchange.recv")
        # every shard holds the full gather; reassemble from shard 0's
        # copy (source-ordered => original global order)
        return np.concatenate([recv[0, s, :cnt[s]] for s in range(p)])


# --------------------------------------------------------------------------
# shard-level recovery (DESIGN.md §16)
# --------------------------------------------------------------------------

#: fault points a retry/replay may absorb — transient exchange faults
#: only; anything else is a real engine bug and must reach the ladder
RECOVERABLE_POINTS = ("exchange.send", "exchange.recv")


class ExchangeRecovery:
    """Per-query recovery runtime threaded through the exchange
    strategies: retry-wrapped collectives, one-shot lineage replay
    authorization, hedged shard tasks, and the event log that becomes
    ``ExecStats.report()["recoveries"]``.

    `collective` retries transient exchange faults in place with the
    engine's `RetryPolicy` (each retry re-invokes the collective, so an
    at-index fault schedule clears on the second call while an "all"
    schedule exhausts the attempts). `replayable` spends the retry
    budget to authorize one whole-edge re-execution from host-resident
    inputs. `shard_tasks` runs the per-shard pure local-join tasks,
    hedging stragglers past `HedgePolicy.delay()` with a second
    dispatch — first result wins, bit-identical by purity."""

    def __init__(self, retry: Optional[recovery.RetryPolicy] = None,
                 budget: Optional[recovery.RetryBudget] = None,
                 hedge: Optional[recovery.HedgePolicy] = None,
                 ctx=None, events: Optional[List[dict]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.retry = retry
        self.budget = budget
        self.hedge = hedge
        self.ctx = ctx
        self.events = events if events is not None else []
        self._clock = clock

    @staticmethod
    def _transient(err: BaseException) -> bool:
        return getattr(err, "point", None) in RECOVERABLE_POINTS

    def collective(self, label: str, fn, *args):
        if self.retry is None:
            return fn(*args)
        attempt = 0
        while True:
            try:
                return fn(*args)
            except BackendError as err:
                if not self._transient(err):
                    raise
                attempt += 1
                if attempt > self.retry.attempts or (
                        self.budget is not None
                        and not self.budget.try_spend()):
                    self.events.append(
                        {"kind": "retry_exhausted", "label": label,
                         "point": getattr(err, "point", None),
                         "attempts": attempt - 1})
                    raise
                self.events.append(
                    {"kind": "retry", "label": label,
                     "point": getattr(err, "point", None),
                     "attempt": attempt})
                self.retry.backoff(label, attempt, self.ctx)

    def replayable(self, err: BaseException) -> bool:
        if not self._transient(err):
            return False
        return self.budget is None or self.budget.try_spend()

    def note_replay(self, label: str, err: BaseException,
                    ok: bool) -> None:
        self.events.append({"kind": "replay", "label": label,
                            "point": getattr(err, "point", None),
                            "ok": bool(ok)})

    def _wrap(self, task):
        """``shard.delay`` instrumentation: with hedging armed the
        fault becomes a simulated straggler sleep; without, it
        propagates like any backend fault (ladder territory)."""
        hedge = self.hedge

        def run():
            try:
                faultinject.fire("shard.delay")
            except faultinject.InjectedFault:
                if hedge is None:
                    raise
                time.sleep(hedge.straggle_seconds)
            return task()
        return run

    def shard_tasks(self, label: str, tasks) -> list:
        if self.hedge is None:
            return [self._wrap(t)() for t in tasks]
        pool = recovery.hedge_pool()
        out = []
        for i, task in enumerate(tasks):
            t0 = self._clock()
            fut = pool.submit(self._wrap(task))
            try:
                res = fut.result(timeout=self.hedge.delay())
            except _FutureTimeout:
                res = self._wrap(task)()          # hedged re-dispatch
                winner = "hedge"
                if fut.done():                    # primary finished in
                    res = fut.result()            # the meantime: wins
                    winner = "primary"
                self.events.append({"kind": "hedge", "label": label,
                                    "shard": i, "winner": winner})
            self.hedge.observe(self._clock() - t0)
            out.append(res)
        return out


def _run_shard_tasks(tasks, recover: Optional[ExchangeRecovery],
                     label: str) -> list:
    if recover is None:
        return [t() for t in tasks]
    return recover.shard_tasks(label, tasks)


def _collective(recover: Optional[ExchangeRecovery], label: str,
                fn, *args):
    if recover is None:
        return fn(*args)
    return recover.collective(label, fn, *args)


# --------------------------------------------------------------------------
# distributed join strategies
# --------------------------------------------------------------------------


def broadcast_join_indices(build_key: np.ndarray, probe_key: np.ndarray,
                           how: str, exchange, engine: JoinEngine,
                           build_valid: Optional[np.ndarray] = None,
                           probe_valid: Optional[np.ndarray] = None,
                           recover: Optional[ExchangeRecovery] = None
                           ) -> Tuple[np.ndarray, np.ndarray, int]:
    """All-gather the build keys; each shard joins its contiguous probe
    range against the full build side. Returns (build_idx, probe_idx,
    wire_bytes).

    A nullable build side ships its validity plane alongside the key
    halves (gathered NULL build rows must not match anywhere); probe
    validity never travels — probe rows stay on their home shard, so
    each shard applies its own probe-validity slice locally."""
    p = exchange.nshards
    bb = shard_bounds(len(build_key), p)
    gathered = _collective(
        recover, "broadcast.all_gather", exchange.all_gather,
        [_pack(build_key[bb[s]:bb[s + 1]],
               valid=None if build_valid is None
               else build_valid[bb[s]:bb[s + 1]])
         for s in range(p)])
    full = _unpack_keys(gathered)
    full_valid = None if build_valid is None else gathered[:, -1] != 0
    pb = shard_bounds(len(probe_key), p)

    def _shard_join(s):
        def run():
            return engine.join_indices_valid(
                full, probe_key[pb[s]:pb[s + 1]], how=how,
                build_valid=full_valid,
                probe_valid=None if probe_valid is None
                else probe_valid[pb[s]:pb[s + 1]])
        return run

    bidx, pidx = [], []
    for s, (gb, gp) in enumerate(_run_shard_tasks(
            [_shard_join(s) for s in range(p)], recover, "broadcast")):
        bidx.append(_host_i64(gb))
        pidx.append(_host_i64(gp) + pb[s])
    row_bytes = KEY_WIRE_BYTES + (VALID_WIRE_BYTES
                                  if build_valid is not None else 0)
    wire = (p - 1) * len(build_key) * row_bytes
    return np.concatenate(bidx), np.concatenate(pidx), wire


def _host_i64(idx) -> np.ndarray:
    """A shard's local-join index vector on the host as int64: device
    tensors (the cuda engine's plane-on output) are downloaded, each a
    counted sync."""
    if isinstance(idx, np.ndarray):
        return idx.astype(np.int64, copy=False)
    from repro_torch.core import device_plane
    return device_plane.to_host(idx).astype(np.int64)


def shuffle_join_indices(build_key: np.ndarray, probe_key: np.ndarray,
                         how: str, exchange,
                         build_valid: Optional[np.ndarray] = None,
                         probe_valid: Optional[np.ndarray] = None,
                         recover: Optional[ExchangeRecovery] = None
                         ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Hash-partition both sides to their owning shard with one
    all-to-all, sorted-join each partition locally, scatter back to
    global probe order. Returns (build_idx, probe_idx, wire_bytes).

    Nullable sides ship a validity plane alongside (key halves, row id);
    the receiving shard drops invalid rows before its partition join
    (`_drop_invalid`). NULL-key probe rows therefore keep their match
    count at 0, which is exactly the NULL contract: inner/semi drop
    them, left emits them unmatched, anti keeps them — all in global
    probe order, bit-identical to the compact-then-join oracle."""
    p = exchange.nshards
    bits = int(np.log2(p))
    npr = len(probe_key)
    wire = 0
    sides = []
    for keys, kvalid in ((build_key, build_valid),
                         (probe_key, probe_valid)):
        bounds = shard_bounds(len(keys), p)
        pid = _partition_ids(keys, bits)
        row_bytes = ROW_WIRE_BYTES + (VALID_WIRE_BYTES
                                      if kvalid is not None else 0)
        blocks = []
        for s in range(p):
            seg = slice(bounds[s], bounds[s + 1])
            rows = np.arange(bounds[s], bounds[s + 1], dtype=np.int64)
            order = np.argsort(pid[seg], kind="stable")
            cuts = np.searchsorted(pid[seg][order], np.arange(p + 1))
            packed = _pack(keys[seg][order], rows[order],
                           valid=None if kvalid is None
                           else kvalid[seg][order])
            blocks.append([packed[cuts[t]:cuts[t + 1]] for t in range(p)])
            moved = len(rows) - int(cuts[s + 1] - cuts[s])
            wire += moved * row_bytes
        side = "build" if keys is build_key else "probe"
        sides.append(_collective(recover, f"shuffle.all_to_all.{side}",
                                 exchange.all_to_all, blocks))
    recv_b, recv_p = sides

    def _part_join(t):
        def run():
            bblock = _drop_invalid(recv_b[t], build_valid is not None)
            pblock = _drop_invalid(recv_p[t], probe_valid is not None)
            brows = _unpack_rowids(bblock)
            prows = _unpack_rowids(pblock)
            if brows.size == 0 or prows.size == 0:
                return None
            part = join_partition(_unpack_keys(bblock), brows,
                                  _unpack_keys(pblock), prows)
            return prows, part
        return run

    counts = np.zeros(npr, np.int64)
    parts = []
    for res in _run_shard_tasks([_part_join(t) for t in range(p)],
                                recover, "shuffle"):
        if res is None:
            continue
        prows, part = res
        counts[prows] = part[-1]
        parts.append(part)
    bidx, pidx = assemble_partitioned_join(npr, counts, parts, how)
    return bidx, pidx, wire


# --------------------------------------------------------------------------
# engine + stats
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DistJoinStat:
    how: str
    strategy: str            # broadcast | shuffle | local
    build_rows: int
    probe_rows: int
    shuffle_bytes: int
    broadcast_bytes: int


@dataclasses.dataclass
class DistStats:
    nshards: int
    device_backed: bool
    joins: List[DistJoinStat] = dataclasses.field(default_factory=list)
    #: recovery events (retry / retry_exhausted / replay / hedge dicts)
    #: appended by `ExchangeRecovery`; surfaced via ExecStats.report()
    recoveries: List[dict] = dataclasses.field(default_factory=list)

    @property
    def shuffle_bytes(self) -> int:
        return sum(j.shuffle_bytes for j in self.joins)

    @property
    def broadcast_bytes(self) -> int:
        return sum(j.broadcast_bytes for j in self.joins)

    def strategy_counts(self):
        out = {}
        for j in self.joins:
            out[j.strategy] = out.get(j.strategy, 0) + 1
        return out


class DistributedJoinEngine(JoinEngine):
    """`join_indices` over row-sharded key vectors.

    Plugs into the same `ops.join_indices_nullsafe` seam as every other
    engine, so NULL-key handling (-1 cursor slots excluded before the
    engine, re-mapped after) and the executor's cursor composition are
    shared with the single-host path — which stays the bit-exactness
    oracle. `stats` accumulates per-join strategy/byte accounting; the
    executor `fork()`s the engine per `execute()` so each query's stats
    object stays immutable after the call returns.

    `device` keeps the reference's meaning: a device-backed exchange
    (`MeshExchange`, True), the simulated one (False), or None to pick
    by the visible CUDA devices. `torch_device` is the torch device the
    local engine runs on (the `cuda` backend's; "cpu" runs the kernels'
    plain versions; without CUDA a CUDA device raises).
    """

    backend = "distributed"

    def __init__(self, nshards: Optional[int] = None,
                 local_backend: str = "numpy",
                 device: Optional[bool] = None, mesh=None,
                 torch_device="cuda"):
        self.ctx = None          # per-query QueryContext (set on forks)
        # shard-level recovery defaults (§16): transient exchange faults
        # retry in place out of the box; hedging and the budget are
        # opt-in (armed per fork by ExecConfig / the serving layer)
        self.retry: Optional[recovery.RetryPolicy] = recovery.RetryPolicy()
        self.retry_budget: Optional[recovery.RetryBudget] = None
        self.hedge: Optional[recovery.HedgePolicy] = None
        self.local = get_join_engine(local_backend, device=torch_device)
        if device is None:
            # auto: device-backed only when the requested shard count
            # actually fits the device mesh (a power of two no larger
            # than the device count); otherwise simulate — an explicit
            # dist_shards must not crash on a smaller machine
            dc = _device_count(torch_device)
            fits = nshards is None or (nshards <= dc
                                       and nshards & (nshards - 1) == 0)
            device = mesh is not None or (dc > 1 and fits)
        if device:
            self.exchange = MeshExchange(mesh=mesh, nshards=nshards)
        else:
            self.exchange = SimulatedExchange(nshards or 4)
        self.nshards = self.exchange.nshards
        self.stats = DistStats(self.nshards, self.exchange.device_backed)

    def fork(self) -> "DistributedJoinEngine":
        """A view sharing this engine's exchange and local engine
        with a fresh stats sink — one per executor, so per-query byte
        accounting never mixes across executors or subqueries."""
        eng = object.__new__(DistributedJoinEngine)
        eng.ctx = None
        eng.retry = self.retry
        eng.retry_budget = self.retry_budget
        eng.hedge = self.hedge
        eng.local = self.local
        eng.exchange = self.exchange
        eng.nshards = self.nshards
        eng.stats = DistStats(self.nshards, self.exchange.device_backed)
        return eng

    def arm_recovery(self, retry=None, budget=None, hedge=None) -> None:
        """Override recovery knobs on this fork (ExecConfig plumbing)."""
        if retry is not None:
            self.retry = retry
        if budget is not None:
            self.retry_budget = budget
        if hedge is not None:
            self.hedge = hedge

    def join_indices(self, build_key, probe_key, how="inner"):
        return self.join_indices_valid(build_key, probe_key, how=how)

    def join_indices_valid(self, build_key, probe_key, how="inner",
                           build_valid=None, probe_valid=None):
        """NULL-aware distributed join. Unlike the host engines (which
        compact invalid rows out up front — a host-global gather this
        runtime must not depend on), nullable sides keep their rows
        sharded in place and ship a validity plane alongside the key
        halves through the exchange; invalid rows are dropped shard-
        locally on the receiving side. All-valid joins are bit-and-byte
        identical to the pre-validity wire format."""
        ctx = getattr(self, "ctx", None)
        if ctx is not None:
            ctx.check()
        if build_valid is not None and bool(build_valid.all()):
            build_valid = None
        if probe_valid is not None and bool(probe_valid.all()):
            probe_valid = None
        nb, npr = len(build_key), len(probe_key)
        p = self.nshards
        if p == 1 or nb == 0 or npr == 0 or max(nb, npr) >= 1 << 32:
            self.stats.joins.append(
                DistJoinStat(how, "local", nb, npr, 0, 0))
            return self.local.join_indices_valid(
                build_key, probe_key, how=how,
                build_valid=build_valid, probe_valid=probe_valid)
        # modeled wire cost; the crossover the bench measures (§9)
        bkey_bytes = KEY_WIRE_BYTES + (VALID_WIRE_BYTES
                                       if build_valid is not None else 0)
        row_b = ROW_WIRE_BYTES + (VALID_WIRE_BYTES
                                  if build_valid is not None else 0)
        row_p = ROW_WIRE_BYTES + (VALID_WIRE_BYTES
                                  if probe_valid is not None else 0)
        est_bcast = (p - 1) * nb * bkey_bytes
        est_shuf = (nb * row_b + npr * row_p) * (p - 1) // p
        rec = ExchangeRecovery(retry=self.retry, budget=self.retry_budget,
                               hedge=self.hedge, ctx=ctx,
                               events=self.stats.recoveries)
        if est_bcast <= est_shuf:
            bidx, pidx, wire = self._with_replay(
                rec, "broadcast", lambda: broadcast_join_indices(
                    build_key, probe_key, how, self.exchange, self.local,
                    build_valid=build_valid, probe_valid=probe_valid,
                    recover=rec))
            self.stats.joins.append(
                DistJoinStat(how, "broadcast", nb, npr, 0, wire))
        else:
            bidx, pidx, wire = self._with_replay(
                rec, "shuffle", lambda: shuffle_join_indices(
                    build_key, probe_key, how, self.exchange,
                    build_valid=build_valid, probe_valid=probe_valid,
                    recover=rec))
            self.stats.joins.append(
                DistJoinStat(how, "shuffle", nb, npr, wire, 0))
        return bidx, pidx

    @staticmethod
    def _with_replay(rec: ExchangeRecovery, label: str, fn):
        """Lineage replay: when in-place retries exhaust, re-execute the
        whole edge's exchange once from host-resident inputs (the keys /
        validity planes the strategy closures capture never left the
        host, so the replay is a pure re-run — bit-identical on
        success). A second failure reaches the degradation ladder."""
        try:
            return fn()
        except BackendError as err:
            if not rec.replayable(err):
                raise
            try:
                out = fn()
            except BackendError:
                rec.note_replay(label, err, ok=False)
                raise
            rec.note_replay(label, err, ok=True)
            return out


_BASE_ENGINES = {}
_BASE_LOCK = threading.Lock()


def get_distributed_engine(nshards: Optional[int] = None,
                           local_backend: str = "numpy",
                           device: Optional[bool] = None,
                           torch_device="cuda") -> DistributedJoinEngine:
    """Forked engine over a cached base — the exchange and the local
    engine are shared across executors and queries (mirrors
    `get_join_engine`), the stats sink is private to the caller. Base
    creation is locked for the server's concurrent queries
    (repro_torch.serve)."""
    key = (nshards, local_backend, device, str(torch_device))
    with _BASE_LOCK:
        base = _BASE_ENGINES.get(key)
        if base is None:
            base = DistributedJoinEngine(nshards=nshards,
                                         local_backend=local_backend,
                                         device=device,
                                         torch_device=torch_device)
            _BASE_ENGINES[key] = base
    return base.fork()


def _device_count(torch_device="cuda") -> int:
    """Devices a mesh could span: the visible CUDA devices when the
    local engine runs on CUDA, else 1 (simulate)."""
    import torch
    if torch.device(torch_device).type != "cuda":
        return 1
    return torch.cuda.device_count()
