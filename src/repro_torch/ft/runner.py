"""Fault tolerance of the training loop: checkpoint/restart, preemption
handling, straggler detection — the reference's, over the port's
`CheckpointManager`.

The restart agent is a process-level loop, so every behaviour is
testable: a `Preempted` (or any crash and rerun) resumes from the last
checkpoint. The train step updates its state in place, so a save copies
the state to host memory before the next step runs
(`CheckpointManager.save`).

Relation to query-level fault tolerance (DESIGN.md §13): this module
covers the *training* loop, where the unit of recovery is a checkpointed
step and the response to a fault is restart-with-resume. The *query*
pipeline's counterpart lives in `repro_torch.core.errors` (typed
taxonomy + `QueryContext` deadlines/cancellation) and the executor's
degradation ladder. The shared error taxonomy is re-exported here so
fault-handling code on either side can catch one family of types.
"""
from __future__ import annotations

import signal
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.errors import (                    # noqa: F401
    BackendError, CacheCorruption, DeadlineExceeded, QueryCancelled,
    QueryContext, QueryError, ResourceExhausted,
)


class Preempted(Exception):
    """Raised inside the step loop when a preemption signal arrived."""


class StragglerMonitor:
    """Tracks step wall-times; flags steps slower than `threshold` x the
    trailing median (detection + a counter tests can assert)."""

    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.times = deque(maxlen=window)
        self.threshold = threshold
        self.flagged = 0

    def record(self, seconds: float) -> bool:
        is_straggler = False
        if len(self.times) >= 8:
            med = float(np.median(self.times))
            if seconds > self.threshold * med:
                self.flagged += 1
                is_straggler = True
        self.times.append(seconds)
        return is_straggler


def _opt_shardings(opt_state, shardings):
    """The optimizer state's `NamedSharding` tree for parameters placed
    by `shardings`: `launch.dryrun.opt_shardings` of their specs."""
    from repro_torch.launch.dryrun import opt_shardings
    from repro_torch.parallel.sharding import NamedSharding, map_specs
    from repro_torch.train.tree import leaves, tree_map
    mesh = leaves(shardings)[0].mesh
    specs = tree_map(lambda s: s.spec, shardings)
    return map_specs(lambda s: NamedSharding(mesh, s),
                     opt_shardings(opt_state, specs, mesh))


class FaultTolerantTrainer:
    """Drives train_step with periodic async checkpoints, preemption-safe
    shutdown, and restart-with-resume."""

    def __init__(self, train_step: Callable, ckpt: CheckpointManager,
                 save_every: int = 50,
                 install_signal_handler: bool = False):
        self.train_step = train_step
        self.ckpt = ckpt
        self.save_every = save_every
        self.monitor = StragglerMonitor()
        self._preempted = False
        if install_signal_handler:
            signal.signal(signal.SIGTERM, self._on_signal)

    def _on_signal(self, *_):
        self._preempted = True

    def preempt(self):
        """Test hook: simulate a preemption notice."""
        self._preempted = True

    def resume_or_init(self, params, opt_state, shardings=None):
        """Restore the latest checkpoint if present, else return the
        fresh state. The checkpoint's leaves go onto the devices and
        dtypes of `params` and `opt_state` (a sharded leaf onto its
        spec), or, given `shardings` (the parameters' `NamedSharding`
        tree, `sharding.param_shardings`), the parameters onto those and
        the optimizer state onto `launch.dryrun.opt_shardings` of their
        specs: the reference's resume onto a new mesh."""
        state = {"params": params, "opt": opt_state, "step": 0}
        step, restored = self.ckpt.restore_latest(
            {"params": params, "opt": opt_state},
            None if shardings is None else
            {"params": shardings,
             "opt": _opt_shardings(opt_state, shardings)})
        if restored is not None:
            state = {"params": restored["params"],
                     "opt": restored["opt"], "step": step}
        return state

    def run(self, state: Dict[str, Any], batches, max_steps: int,
            on_metrics: Optional[Callable] = None) -> Dict[str, Any]:
        params, opt_state = state["params"], state["opt"]
        step = state["step"]
        for batch in batches:
            if step >= max_steps:
                break
            if self._preempted:
                self.ckpt.save(step, {"params": params, "opt": opt_state})
                self.ckpt.wait()
                raise Preempted(f"checkpointed at step {step}")
            t0 = time.perf_counter()
            params, opt_state, metrics = self.train_step(
                params, opt_state, batch)
            # block on the loss so the timer reflects real step time
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            slow = self.monitor.record(dt)
            step += 1
            if on_metrics:
                on_metrics(step, dict(metrics, loss=loss,
                                      step_seconds=dt, straggler=slow))
            if step % self.save_every == 0:
                self.ckpt.save(step, {"params": params, "opt": opt_state})
        self.ckpt.save(step, {"params": params, "opt": opt_state})
        self.ckpt.wait()
        return {"params": params, "opt": opt_state, "step": step}
