"""The traced run's instruments: host ranges around the executor's
phases, a log of the K1 and K2 calls' shapes, and the reduction of the
torch.profiler trace to device busy time, kernel time by name, the top
device operations and the device's idle time by what the host was doing.

Everything here is installed for a `--trace 1` run only, by patching the
program's classes and kernel wrappers from outside; `uninstall` puts the
originals back. torch.profiler records the device's activity; the host
ranges are kept by the wrappers themselves, since the server's worker
threads run outside the profiler's own thread.
"""
from __future__ import annotations

import contextlib
import functools
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

#: host ranges the traced run opens, by executor phase
SCAN, TRANSFER, JOIN, WINDOW = ("bench.scan", "bench.transfer", "bench.join",
                                "bench.window")


class Instruments:
    """Wrappers installed on the program for one traced window."""

    def __init__(self):
        self.calls: List[dict] = []       # K1 / K2 calls while recording
        # executor phases while recording: (start, end, thread, label),
        # host perf_counter_ns; worker threads are not the profiler's
        # own, so the ranges are kept here and not in its trace
        self.ranges: List[Tuple[int, int, int, str]] = []
        self.recording = False
        self._undo: List[Tuple[object, str, object]] = []
        self._lock = threading.Lock()
        self._depth = threading.local()

    def _patch(self, owner, name, wrap):
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig))
        setattr(owner, name, wrap(orig))

    def install(self) -> "Instruments":
        from repro_torch.core import transfer
        from repro_torch.kernels.bloom import ops as kb
        from repro_torch.relational.executor import Executor

        def ranged(label, outermost=False):
            def wrap(fn):
                @functools.wraps(fn)
                def inner(*a, **kw):
                    depth = getattr(self._depth, "n", 0)
                    if outermost and depth:
                        return fn(*a, **kw)
                    self._depth.n = depth + 1
                    t = time.perf_counter_ns()
                    try:
                        return fn(*a, **kw)
                    finally:
                        self._depth.n = depth
                        if self.recording:
                            self._range(t, time.perf_counter_ns(), label)
                return inner
            return wrap

        self._patch(Executor, "_resolve_leaf", ranged(SCAN))
        self._patch(Executor, "_exec", ranged(JOIN, outermost=True))
        for cls in {c for c in vars(transfer).values() if isinstance(c, type)
                    and issubclass(c, transfer.Strategy)
                    and "prefilter" in c.__dict__}:
            self._patch(cls, "prefilter", ranged(TRANSFER))
        self._patch(kb, "multi_probe", self._log_multi_probe)
        self._patch(kb, "build", self._log_build)
        return self

    def uninstall(self) -> None:
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)

    def _record(self, entry: dict) -> None:
        with self._lock:
            self.calls.append(entry)

    def _range(self, start: int, end: int, label: str) -> None:
        with self._lock:
            self.ranges.append((start, end, threading.get_ident(), label))

    def _log_multi_probe(self, fn):
        @functools.wraps(fn)
        def inner(words_list, los, his, idx=None, count=None, **kw):
            out = fn(words_list, los, his, idx=idx, count=count, **kw)
            if self.recording and out.device.type == "cuda":
                m, n = out.shape
                count_ = n if count is None else int(count)
                # rows still alive before each filter after the first: the
                # probe stops at a row's first miss (a device sum, read
                # once the window has closed)
                alive = out[:-1].sum(dim=1) if m > 1 else None
                self._record({"kernel": "k1", "m": m, "n": n,
                              "count": count_, "idx": idx is not None,
                              "blocks": [int(w.shape[0]) for w in words_list],
                              "alive": alive})
            return out
        return inner

    def _log_build(self, fn):
        @functools.wraps(fn)
        def inner(lo, hi, nblocks, idx=None, count=None, valid=None, **kw):
            words = fn(lo, hi, nblocks, idx=idx, count=count, valid=valid,
                       **kw)
            if self.recording and words.device.type == "cuda":
                n = int(idx.shape[0]) if idx is not None else int(lo.shape[0])
                count_ = n if count is None else int(count)
                live = None
                if valid is not None and count_:
                    rows = (idx[:count_].long() if idx is not None
                            else slice(0, count_))
                    live = valid[rows].sum()
                self._record({"kernel": "k2", "count": count_,
                              "idx": idx is not None,
                              "valid": valid is not None,
                              "blocks": int(nblocks), "live": live})
            return words
        return inner

    def resolved_calls(self) -> List[dict]:
        """The logged calls with their device counts read back."""
        out = []
        for c in self.calls:
            c = dict(c)
            if c.get("alive") is not None:
                c["alive"] = [int(x) for x in c["alive"].tolist()]
            if c.get("live") is not None:
                c["live"] = int(c["live"])
            out.append(c)
        return out


class Window:
    """The traced window on the host's perf_counter_ns clock."""
    start = end = 0


@contextlib.contextmanager
def profiled(device: str):
    """torch.profiler over the block: the window's range and, on a card,
    device activity. Yields (profiler, Window)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    win = Window()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            win.start = time.perf_counter_ns()
            try:
                yield prof, win
            finally:
                win.end = time.perf_counter_ns()


class Trace:
    """The reduced trace of one traced window (times in seconds)."""

    def __init__(self, prof, win: Window, ranges):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        self.device: List[Tuple[int, int, str]] = []   # (start, end, name)
        self.window: Optional[Tuple[int, int]] = None
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                self.device.append((e.start_ns(), e.end_ns(), e.name()))
            elif e.name() == WINDOW:
                self.window = (e.start_ns(), e.end_ns())
        self.device.sort()
        # host ranges onto the trace's clock, by the window's two ends
        # on both clocks
        self.ranges: List[Tuple[int, int, int, str]] = []
        if self.window and win.end > win.start:
            (t0, t1), (h0, h1) = self.window, (win.start, win.end)
            scale = (t1 - t0) / (h1 - h0)
            self.ranges = sorted(
                (int(t0 + (s - h0) * scale), int(t0 + (e - h0) * scale),
                 tid, name) for s, e, tid, name in ranges)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9 if self.window else 0.0

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """Merged device intervals, clipped to the window."""
        lo, hi = self.window or (0, 0)
        merged: List[List[int]] = []
        for s, e, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name matches
        `pattern` (a regular expression, searched)."""
        rx = re.compile(pattern)
        hits = [e - s for s, e, name in self.device if rx.search(name)]
        return sum(hits) / 1e9, len(hits)

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for s, e, name in self.device:
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def idle_by_phase(self, k: int = 10) -> List[list]:
        """The device's idle time in the window, summed by what the host
        threads were doing meanwhile: the innermost executor phase open
        on each thread at the gap's middle ('+'-joined when threads
        differ), or 'outside any phase'."""
        if not self.window:
            return []
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        # one sweep: range ends, then starts, then gap middles, in time
        # order; ranges nest on a thread, so each thread keeps a stack
        events = [(s, 1, tid, name) for s, _, tid, name in self.ranges]
        events += [(e, 0, tid, name) for _, e, tid, name in self.ranges]
        events += [((g0 + g1) // 2, 2, i, "") for i, (g0, g1)
                   in enumerate(gaps)]
        events.sort(key=lambda ev: (ev[0], ev[1]))
        stacks: Dict[int, List[str]] = {}
        totals: Dict[str, int] = {}
        for _, kind, key, name in events:
            if kind == 1:
                stacks.setdefault(key, []).append(name)
            elif kind == 0:
                st = stacks.get(key, [])
                if name in st:
                    del st[len(st) - 1 - st[::-1].index(name)]
            else:
                label = "+".join(sorted({st[-1].split(".")[1]
                                         for st in stacks.values() if st}))
                label = label or "outside any phase"
                g0, g1 = gaps[key]
                totals[label] = totals.get(label, 0) + (g1 - g0)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[label, ns / 1e9] for label, ns in top]
