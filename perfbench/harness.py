"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

Everything that belongs to one configuration, cell, query template or
metric lives in a file of its own, found by the name `BENCHMARK.json`
gives it:

- `configs/<config>.json`: the deployment (generator and scale, the
  server's settings, chips, source, cuts, guarantees);
- `workloads/<cell>.json`: the cell (its config, its traffic for
  `traffic.py`, and the limits of its comparison);
- `data/<family>.py`: `generate(scale, seed)`, the database as arrays;
- `queries/<family>/<template>.py`: `plan(sf)`, the program's plan;
  `reference(db, acc)`, the answer worked out again in NumPy; `ORDER_BY`;
- `metrics/<metric>.py`: `read(reading)`, the metric or None.

So a later cell, template or metric is a new file and a new entry, and
no file here changes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import pathlib
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from perfbench import adapter, compare, trace, traffic

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """A file of the benchmark as a module of its own, by path (names of
    cells, templates and metrics need not be Python identifiers)."""
    path = path.resolve()
    name = "perfbench_file_" + hashlib.sha1(
        str(path).encode()).hexdigest()[:16]
    mod = sys.modules.get(name)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    base: pathlib.Path                # the benchmark's folder

    @property
    def family(self) -> str:
        return self.config["generator"]["family"]

    def template(self, name: str):
        return load_module(self.base / "queries" / self.family / f"{name}.py")

    def metric(self, name: str):
        return load_module(self.base / "metrics" / f"{name}.py")

    def generator(self):
        return load_module(self.base / "data" / f"{self.family}.py")


def load_cell(name: str, bench: Optional[dict] = None,
              base: pathlib.Path = HERE) -> Cell:
    """The cell `name` of `bench` (BENCHMARK.json by default), its files
    under `base`."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    workload = load_json(base / "workloads" / f"{name}.json")
    config = load_json(base / "configs" / pathlib.Path(cfg_entry["file"]).name)

    def reports(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in names and reports(m)]
    return Cell(name, workload, config, e2e, per_layer, base)


@dataclasses.dataclass
class Reading:
    """What the metric readers read."""
    setup_s: float
    seconds: float                    # the window's length
    completed: int
    last_done: float                  # seconds from window open
    spans: List[tuple]                # (sent, answered), from window open
    latencies: List[float]
    reports: List[dict]
    trace: Optional[trace.Trace] = None
    calls: Optional[List[dict]] = None
    device_kind: str = ""

    def peak(self, key: str) -> Optional[float]:
        peaks = load_json(HERE / "peaks.json")["devices"]
        for part, row in peaks.items():
            if part in self.device_kind:
                return row.get(key)
        return None


@dataclasses.dataclass
class Done:
    template: str
    seconds: float                    # submit to result
    done_at: float                    # seconds from window open
    table: object = None
    report: Optional[dict] = None
    error: Optional[str] = None


def _serve(server, cell: Cell, sf: float, seed: int, seconds: float
           ) -> List[Done]:
    """The measured window: the cell's traffic against the server, from
    now for `seconds`; requests already sent are waited for."""
    tr = cell.workload["traffic"]
    plans = {t: cell.template(t).plan for t in tr["templates"]}
    out: List[Done] = []
    lock = threading.Lock()
    t0 = time.perf_counter()

    def finish(name, sent, fut):
        now = time.perf_counter()
        try:
            table, stats = fut.result()
            done = Done(name, now - sent, now - t0, table, stats.report())
        except Exception as e:      # noqa: BLE001 — counted as failed
            done = Done(name, now - sent, now - t0,
                        error=f"{type(e).__name__}: {e}")
        with lock:
            out.append(done)

    if tr["loop"] != "closed":
        raise ValueError(f"unknown loop {tr['loop']!r}")
    loop = traffic.ClosedLoop(tr, seed)

    def client():
        while time.perf_counter() - t0 < seconds:
            name = loop.next()
            plan = plans[name](sf)
            sent = time.perf_counter()
            fut = server.submit(plan, tag=name)
            fut.exception()
            finish(name, sent, fut)

    threads = [threading.Thread(target=client)
               for _ in range(int(tr["clients"]))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out


#: the scale of the warm-up's own copy of the data
WARM_SCALE = 0.01


def warm(cell: Cell, seed: int, device: str) -> None:
    """What every request needs before the window: the CUDA context, the
    kernel libraries (built on a checkout's first run) and each
    template's first launches, from every template once, all at once, on
    a server of its own over the cell's generator at `WARM_SCALE`. The
    program's kernels are built ahead of time, so no shape compiles;
    the window's data is left for the window."""
    import torch

    from repro_torch.serve import QueryServer, ServeConfig
    db = cell.generator().generate(WARM_SCALE, seed)
    server = QueryServer(adapter.catalog(db), ServeConfig(
        **cell.config["server"], torch_device=device))
    try:
        futs = [server.submit(cell.template(name).plan(WARM_SCALE), tag=name)
                for name in cell.workload["traffic"]["templates"]]
        for fut in futs:
            fut.result()
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        server.close()


def run(cell_name: str, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda",
        scale: Optional[float] = None, bench: Optional[dict] = None,
        base: pathlib.Path = HERE) -> dict:
    """One run; returns the result line's object. `device="cpu"`, a small
    `scale`, and another `bench` and `base` are for the CPU tests only."""
    import torch

    from repro_torch.serve import QueryServer, ServeConfig

    cell = load_cell(cell_name, bench, base)
    gen = cell.config["generator"]
    sf = float(scale if scale is not None else gen["scale_factor"])
    stages = {"start_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    warm(cell, seed, device)
    stages["warm_s"] = time.perf_counter() - t
    t = time.perf_counter()
    db = cell.generator().generate(sf, seed)
    stages["generate_s"] = time.perf_counter() - t
    t = time.perf_counter()
    server = QueryServer(adapter.catalog(db), ServeConfig(
        **cell.config["server"], torch_device=device))
    stages["catalog_s"] = time.perf_counter() - t
    try:
        instruments = trace.Instruments().install() if traced else None
        setup_s = time.perf_counter() - t_start
        prof = None
        if traced:
            instruments.recording = True
            with trace.profiled(device) as (prof, win):
                done = _serve(server, cell, sf, seed, seconds)
                if device == "cuda":
                    torch.cuda.synchronize()
            instruments.recording = False
        else:
            done = _serve(server, cell, sf, seed, seconds)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        server_snap = server.metrics_snapshot()["server"]
    finally:
        server.close()
    del server
    ok = [d for d in done if d.error is None]
    calls = instruments.resolved_calls() if traced else None
    if traced:
        instruments.uninstall()
    reading = Reading(
        setup_s=setup_s, seconds=seconds, completed=len(ok),
        last_done=max((d.done_at for d in done), default=0.0),
        spans=[(d.done_at - d.seconds, d.done_at) for d in ok],
        latencies=[d.seconds for d in ok], reports=[d.report for d in ok],
        trace=trace.Trace(prof, win, instruments.ranges) if traced else None,
        calls=calls,
        device_kind=torch.cuda.get_device_name() if device == "cuda" else "")
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = cell.metric(m["name"]).read(reading)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    t = time.perf_counter()
    ref_s: Dict[str, float] = {}
    checks = check(cell, db, ok, len(done) - len(ok), ref_s)
    stages["reference_s"] = time.perf_counter() - t
    stages["last_done_s"] = reading.last_done
    stages["answered_to_last_answer_qps"] = (
        len(ok) / reading.last_done if reading.last_done else None)
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": reading.device_kind or device,
           "count": 1 if device == "cuda" else 0,
           "memory_peak_bytes": int(peak)}
    line = {"correct": bool(ok) and all(c["value"] <= c["limit"]
                                        for c in checks.values()),
            "attempted": len(done), "failed": len(done) - len(ok),
            "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = reading.trace.busy_s
        dev["window_s"] = reading.trace.window_s
        line["breakdown"] = {"device_ops": reading.trace.top_ops(),
                             "idle_gaps": reading.trace.idle_by_phase()}
    line["server"] = {k: server_snap[k] for k in (
        "completed", "failed", "errors", "degradations", "rejected")}
    line["errors"] = sorted({d.error for d in done if d.error})[:5]
    line["stages"] = stages
    line["per_template"] = {
        t: [len(ls), float(np.mean(ls)), float(np.max(ls)), ref_s[t]]
        for t in sorted({d.template for d in ok})
        for ls in [[d.seconds for d in ok if d.template == t]]}
    line["checks"] = checks
    return line


def check(cell: Cell, db: dict, ok: List[Done], failed: int,
          seconds: Dict[str, float], acc=np.float64) -> Dict[str, dict]:
    """Every answer of the window against the reference's, worked out
    once a template (all requests of a template ask the same question
    of the same data), its time in `seconds`. Returns each number
    compared with its limit."""
    bad, err = 0, 0.0
    for name in sorted({d.template for d in ok}):
        tpl = cell.template(name)
        t = time.perf_counter()
        ref = tpl.reference(db, acc)
        seconds[name] = time.perf_counter() - t
        for d in ok:
            if d.template == name:
                b, e = compare.compare(adapter.answer(d.table), ref,
                                       tpl.ORDER_BY)
                bad, err = bad + b, max(err, e)
    numbers = {"errors": failed, "bad_cells": bad, "float_rel_err": err}
    limits = dict(cell.workload["limits"], errors=0)
    return {k: {"value": numbers[k], "limit": limits[k]}
            for k in ("errors", "bad_cells", "float_rel_err") if k in limits}
