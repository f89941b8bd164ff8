#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 1.0]

Phases, one JSON line each; any failure raises and exits non-zero:

1. device  — the card's name and, from nvidia-smi, name and power limit;
2. build   — compiles the hand-written CUDA kernels from the sources in
             the checkout (one nvcc per source, started together);
3. kernels — each kernel (K1 fused multi-filter Bloom probe, K2 Bloom
             build) against its plain torch version on the card, at the
             shapes TPC-H SF 1 gives them: 2^23-row (lineitem's bucket)
             and 2^21-row key columns, filters sized for 1.5 M and 6 M
             keys plus a one-block filter, ragged counts, survivor-id
             gathers. As on the main path, each filter of a K1 call
             probes its own key column, and each filter is built from
             its own build-side keys. Results must be bit-exact. Median
             CUDA-event times of kernel and plain version, and the bound
             (bytes moved over the H100's 3.35 TB/s);
4. slice   — generates TPC-H at `--sf` (seed 7) and runs all 20 join
             queries through `Executor` under `pred-trans` with the cuda
             bloom and join backends and the device-resident data plane,
             plus `pred-trans-adaptive` on Q5; every result must have the
             md5 (`table_digest`) of the port's eager numpy oracle; then
             one warm run each of Q5 and Q9 under torch.profiler (device
             busy seconds, idle share, top device ops). Each path reads
             its own kernel launch counts: they are zeroed just before
             the path's runs (cold and warm) and read just after, and
             both kernels must have launched on each path. The profile
             runs come after both readings.

The line before the last is the kernel table
`{"kernels": [{"name", "route", "source", "replaces", "launches",
"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}]}`
and the last line is `{"ok": true, "device": {...}}`. Without CUDA, or
without the repository's `src/` beside it, the script exits non-zero
before printing any result. Imports torch, numpy and `repro_torch` only.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
#: published HBM3 rate of one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: TPC-H SF 1 shapes: lineitem's rows pad to the 2^23 bucket; filters are
#: sized for the orders-sized (1.5 M) and lineitem-sized (6 M) key sets
N_BIG, N_MID = 1 << 23, 1 << 21
KEYS_ORDERS, KEYS_LINEITEM = 1_500_000, 6_000_000
#: the three key columns K1 probes, one per filter, each drawn on its own:
#: (value domain, distinct build-side keys, name). SF 1 orderkeys span
#: [0, 6 M) and 1.5 M of them build the orders-sized filter; 6 M keys over
#: [0, 24 M) build the lineitem-sized one; 5 of the 25 nation keys build a
#: one-block filter (a region's nations)
COLUMNS = ((6_000_000, KEYS_ORDERS, "orders"),
           (24_000_000, KEYS_LINEITEM, "lineitem"),
           (25, 5, "one-block"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """Median CUDA-event milliseconds of `fn` (one launch per sample)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def kernel_phase(torch, np, kb, bloom, hashing, dev):
    """K1/K2 vs their plain versions on the card; returns the record
    of each kernel at the main path's heaviest shape, and each kernel's
    largest error."""
    rng = np.random.default_rng(7)

    def halves(keys):
        return bloom.halves_to_device(*hashing.key_halves(keys), dev)

    cols, filt = [], []
    for domain, nkeys, _ in COLUMNS:
        cols.append(halves(rng.integers(0, domain, N_BIG, dtype=np.int64)))
        blo, bhi = halves(rng.choice(domain, nkeys, replace=False))
        # filters from the plain build, so K1's check does not lean on K2
        filt.append(kb.build_ref(blo, bhi, bloom.blocks_for(nkeys)))
    idx = torch.from_numpy(np.sort(rng.choice(N_BIG, N_MID, replace=False))
                           .astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(N_BIG) < 0.95).to(dev)
    worst = {"multi_probe": 0, "bloom_build": 0}
    rep = {}

    def probe_case(name, which, n, count, ix):
        m = len(which)
        ws = [filt[c] for c in which]
        args = (ws, [cols[c][0] for c in which], [cols[c][1] for c in which])
        got = kb.multi_probe(*args, idx=ix, count=count)
        ref = kb.multi_probe_ref(*args, idx=ix, count=count)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - ref.to(torch.int16)).abs().max())
        worst["multi_probe"] = max(worst["multi_probe"], err)
        check(torch.equal(got, ref), f"multi_probe {name} disagrees")
        # bytes the function must move: each filter's own key column, 8
        # bytes for each row still live before that filter (probing stops
        # at the first miss), the survivor ids, every filter once, and the
        # [m, n] mask
        alive = [count] + [int(x) for x in ref.sum(dim=1)[:-1]]
        nbytes = (8 * sum(alive) + (4 * count if ix is not None else 0)
                  + sum(w.numel() * 4 for w in ws) + m * n)
        ms = cuda_ms(torch, lambda: kb.multi_probe(*args, idx=ix,
                                                   count=count), 20)
        plain = cuda_ms(torch, lambda: kb.multi_probe_ref(
            *args, idx=ix, count=count), 3, warm=1)
        rec = {"kernel": "multi_probe", "case": name, "m": m, "n": n,
               "count": count, "filters": [COLUMNS[c][2] for c in which],
               "nblocks": [int(w.shape[0]) for w in ws],
               "alive": alive, "ms": ms, "plain_ms": plain,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
               "survivors": int(ref[-1].sum()), "max_abs_err": err}
        emit({"phase": "kernels", **rec})
        return rec

    def build_case(name, col, nb, count, ix, v):
        lo, hi = cols[col]
        got = kb.build(lo, hi, nb, idx=ix, count=count, valid=v)
        ref = kb.build_ref(lo, hi, nb, idx=ix, count=count, valid=v)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
        worst["bloom_build"] = max(worst["bloom_build"], err)
        check(torch.equal(got, ref), f"bloom_build {name} disagrees")
        nbytes = (8 * count + (4 * count if ix is not None else 0)
                  + (count if v is not None else 0) + nb * 32)
        ms = cuda_ms(torch, lambda: kb.build(lo, hi, nb, idx=ix,
                                             count=count, valid=v), 20)
        plain = cuda_ms(torch, lambda: kb.build_ref(
            lo, hi, nb, idx=ix, count=count, valid=v), 3, warm=1)
        rec = {"kernel": "bloom_build", "case": name, "n": count,
               "nblocks": nb, "ms": ms, "plain_ms": plain,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
               "max_abs_err": err}
        emit({"phase": "kernels", **rec})
        return rec

    ragged = 6_001_215            # SF 1 lineitem rows
    nb_mid, nb_big = (int(filt[c].shape[0]) for c in (0, 1))
    probe_case("2^23 m=1", [0], N_BIG, ragged, None)
    rep["multi_probe"] = probe_case("2^23 m=2", [0, 1], N_BIG, ragged, None)
    probe_case("2^23 m=3 one-block", [0, 1, 2], N_BIG, ragged, None)
    probe_case("2^21 m=2 gather", [1, 0], N_MID, N_MID - 12345, idx)
    rep["bloom_build"] = build_case("2^23 lineitem", 1, nb_big, ragged,
                                    None, None)
    build_case("2^21 orders gather+valid", 0, nb_mid, N_MID - 777, idx,
               valid)
    build_case("2^21 one-block", 2, 1, N_MID, None, None)
    return rep, worst


def profile_query(torch, run, qn: int) -> dict:
    """One warm run of a query under torch.profiler: wall seconds, the
    seconds the device was busy (kernels and copies; one stream, so
    they do not overlap), the idle share, and the top device ops."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall, _ = run()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
    busy = sum(ms for ms, _ in by_name.values()) / 1e3
    top = sorted(((ms, cnt, name) for name, (ms, cnt) in by_name.items()),
                 reverse=True)[:6]
    return {"phase": "profile", "query": qn, "strategy": "pred-trans",
            "wall_seconds": wall, "device_busy_seconds": busy,
            "device_idle_share": 1.0 - busy / wall,
            "top_device_ms": [{"op": k[:80], "ms": ms, "count": c}
                              for ms, c, k in top]}


def slice_phase(torch, kb, sf: float):
    from repro_torch.core.transfer import make_strategy
    from repro_torch.relational import ExecConfig, Executor
    from repro_torch.relational.table import table_digest
    from repro_torch.tpch import QUERIES, build_query, generate

    t0 = time.perf_counter()
    cat = generate(sf=sf, seed=7)
    emit({"phase": "slice", "step": "generate", "sf": sf,
          "seconds": time.perf_counter() - t0,
          "lineitem_rows": len(cat["lineitem"])})

    def cfg(strategy):
        return ExecConfig(
            strategy=make_strategy(strategy, backend="cuda",
                                   device_resident=True),
            join_backend="cuda", device="on")

    def run(strategy, qn):
        before = dict(kb.LAUNCHES)
        t = time.perf_counter()
        res, st = Executor(cat, cfg(strategy)).execute(
            build_query(qn, sf=sf))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        return res, st, sec, {k: kb.LAUNCHES[k] - before[k] for k in before}

    oracle = {}
    for qn in sorted(QUERIES):
        res, _ = Executor(cat, ExecConfig(late_materialize=False)).execute(
            build_query(qn, sf=sf))
        oracle[qn] = table_digest(res)

    per_query, launches = {}, {}
    for strategy, queries in (("pred-trans", sorted(QUERIES)),
                              ("pred-trans-adaptive", [5])):
        kb.reset_launches()           # this path's counts start at 0 here
        for qn in queries:
            _, _, cold, _ = run(strategy, qn)
            res, st, warm, query_launches = run(strategy, qn)
            check(table_digest(res) == oracle[qn],
                  f"Q{qn} {strategy} differs from the eager oracle")
            rep = st.report()
            rec = {"phase": "slice", "query": qn, "strategy": strategy,
                   "seconds": warm, "cold_seconds": cold,
                   "rows": len(res), "phase_seconds": rep["phase_seconds"],
                   "transfer_seconds": rep["transfer"]["seconds"],
                   "device": rep["device"], "launches": query_launches,
                   "md5_equal": True}
            per_query[(strategy, qn)] = rec
            emit(rec)
        launches[strategy] = dict(kb.LAUNCHES)   # read just after the path
    emit({"kernels": launches})
    for strategy, counts in launches.items():
        for name, cnt in counts.items():
            check(cnt > 0, f"kernel {name} never launched on {strategy}")
    for qn in (5, 9):                 # outside both counted windows
        emit(profile_query(torch, lambda: run("pred-trans", qn), qn))
    return per_query, launches["pred-trans"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor of the slice phase")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import bloom, hashing
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.bloom import ops as kb

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    info = kbuild.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {name: {"seconds": s, "ptxas": [
              ln.strip() for ln in log.splitlines() if "Used" in ln]}
              for name, (s, log) in info.items()}})

    rep, worst = kernel_phase(torch, np, kb, bloom, hashing, dev)
    _, launches = slice_phase(torch, kb, args.sf)

    source = "src/repro_torch/kernels/bloom/csrc/bloom.cu"
    replaces = {"multi_probe": "src/repro/kernels/bloom/bloom.py:151",
                "bloom_build": "src/repro/kernels/bloom/bloom.py:218"}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": worst[name], "ms": rep[name]["ms"],
         "plain_ms": rep[name]["plain_ms"],
         "bound_ms": rep[name]["bound_ms"], "bound_by": "bytes",
         "library_ms": None}
        for name in ("multi_probe", "bloom_build")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
