"""Port parity of the recovery primitives (`repro_torch.core.recovery`,
a copy of `repro.core.recovery`): under the same injected clock and the
same seeded inputs, every delay, state, counter and snapshot equals the
reference's step for step."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import recovery as rrec
from repro.core.errors import DeadlineExceeded as RDeadlineExceeded
from repro.core.errors import QueryContext as RQueryContext
from repro_torch.core import recovery as prec
from repro_torch.core.errors import DeadlineExceeded, QueryContext


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_retry_policy_delays_equal_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(attempts=3, base=float(rng.uniform(0.001, 0.1)),
              mult=float(rng.uniform(1.5, 4.0)),
              max_delay=float(rng.uniform(0.05, 1.0)), seed=seed)
    ref, port = rrec.RetryPolicy(**kw), prec.RetryPolicy(**kw)
    for key in ("edge", "exchange.send", f"q{seed}"):
        for attempt in range(1, 8):
            assert port.delay(key, attempt) == ref.delay(key, attempt)
    assert prec._hash01(seed, "k", 3) == rrec._hash01(seed, "k", 3)


def test_retry_backoff_sleeps_and_raises_as_reference():
    """Deadline-aware backoff: the same capped sleeps, then the same
    DeadlineExceeded once the deadline has passed."""
    runs = []
    for mod, ctx_cls, exc in ((rrec, RQueryContext, RDeadlineExceeded),
                              (prec, QueryContext, DeadlineExceeded)):
        slept, clock = [], Clock()
        p = mod.RetryPolicy(base=0.4, mult=3.0, max_delay=10.0, seed=3,
                            sleep=slept.append)
        ctx = ctx_cls(deadline=1.0, clock=clock)
        raised = []
        for attempt, now in enumerate((0.0, 0.5, 0.9, 2.0), start=1):
            clock.now = now
            try:
                p.backoff("k", attempt, ctx)
            except exc as e:
                raised.append((attempt, e.phase))
        p.backoff("free", 1)              # no context: the plain delay
        runs.append((slept, raised))
    assert runs[0] == runs[1]
    assert runs[1][1] == [(4, "retry")]


def _budget_ops(seed, n=200):
    rng = np.random.default_rng(seed)
    return [(float(rng.exponential(0.2)), rng.choice(["spend", "spend2",
                                                      "remaining", "snap"]))
            for _ in range(n)]


def _run_budget(mod, ops):
    clock = Clock()
    b = mod.RetryBudget(capacity=5.0, refill_per_s=3.0, clock=clock)
    out = []
    for dt, op in ops:
        clock.now += dt
        if op == "spend":
            out.append(b.try_spend())
        elif op == "spend2":
            out.append(b.try_spend(2.0))
        elif op == "remaining":
            out.append(b.remaining())
        else:
            out.append(b.snapshot())
    return out, b.spent, b.refused


@pytest.mark.parametrize("seed", [1, 2])
def test_retry_budget_sequence_equals_reference(seed):
    ops = _budget_ops(seed)
    assert _run_budget(prec, ops) == _run_budget(rrec, ops)


def _breaker_ops(seed, n=300):
    rng = np.random.default_rng(seed)
    return [(float(rng.exponential(1.5)),
             rng.choice(["ok", "fail", "allow", "state", "snap"],
                        p=[0.3, 0.3, 0.2, 0.1, 0.1]))
            for _ in range(n)]


def _run_breaker(mod, ops):
    clock = Clock()
    b = mod.CircuitBreaker(window=5, threshold=3, cooldown=4.0, clock=clock)
    out = []
    for dt, op in ops:
        clock.now += dt
        if op in ("ok", "fail"):
            b.record(op == "ok")
            out.append(b.state)
        elif op == "allow":
            out.append(b.allow())
        elif op == "state":
            out.append(b.state)
        else:
            out.append(b.snapshot())
    return out


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_circuit_breaker_sequence_equals_reference(seed):
    ops = _breaker_ops(seed)
    got = _run_breaker(prec, ops)
    assert got == _run_breaker(rrec, ops)
    assert {"closed", "open", "half-open"} <= set(
        s for s in got if isinstance(s, str))


def test_breaker_board_sequence_equals_reference():
    rng = np.random.default_rng(6)
    rungs = ["single/late/cuda+pred-trans", "single/late/numpy+pred-trans",
             "single/eager/numpy+no-pred-trans"]
    ops = [(float(rng.exponential(1.0)), rungs[rng.integers(3)],
            bool(rng.random() < 0.5), bool(rng.random() < 0.3))
           for _ in range(300)]

    def run(mod):
        clock = Clock()
        board = mod.BreakerBoard(window=4, threshold=2, cooldown=3.0,
                                 clock=clock)
        out = []
        for dt, rung, ok, ask in ops:
            clock.now += dt
            out.append(board.allow(rung) if ask else board.record(rung, ok))
        return out, board.snapshot()
    assert run(prec) == run(rrec)


def test_breaker_validation_equals_reference():
    for kw in (dict(window=0), dict(threshold=0),
               dict(window=2, threshold=3)):
        with pytest.raises(ValueError):
            rrec.CircuitBreaker(**kw)
        with pytest.raises(ValueError):
            prec.CircuitBreaker(**kw)
    with pytest.raises(ValueError):
        prec.RetryPolicy(attempts=-1)


@pytest.mark.parametrize("seed", [8, 9])
def test_hedge_policy_delays_equal_reference(seed):
    rng = np.random.default_rng(seed)
    lat = rng.lognormal(-4.0, 1.0, 400)
    ref = rrec.HedgePolicy(min_delay=0.01, factor=2.5, history=64)
    port = prec.HedgePolicy(min_delay=0.01, factor=2.5, history=64)
    assert port.delay() == ref.delay() == 0.01
    for x in lat:
        ref.observe(float(x))
        port.observe(float(x))
        assert port.delay() == ref.delay()
    assert port.straggle_seconds == ref.straggle_seconds


def test_hedge_pool_is_one_shared_pool():
    pools = []
    barrier = threading.Barrier(4)

    def touch():
        barrier.wait()
        pools.append(prec.hedge_pool())

    threads = [threading.Thread(target=touch) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len({id(p) for p in pools}) == 1
    assert pools[0].submit(lambda: 41 + 1).result(30) == 42
