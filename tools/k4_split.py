#!/usr/bin/env python3
"""K4's device time at `chip_smoke.py`'s "SF 1 orders" case split by
device op (the table's memset, each kernel), on one NVIDIA GPU.

    python3 tools/k4_split.py [--src DIR]

`--src` is the `src/` directory whose `repro_torch` is measured (default:
this checkout's), so another checkout's K4 can be read with this
checkout's inputs (`chip_smoke.joinmap_inputs`: 1.5 M distinct keys in
2^22 slots). Prints one JSON line: CUDA-event ms, device ms (20 builds
under torch.profiler), each device op's ms a build, and the host's ms a
build (100 builds issued back to back, no synchronise between: the time
the wrapper holds the host, which the CUDA events see where the device
waits for it) with the microseconds of its host steps, each alone.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k4_split: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.core import bloom
    from repro_torch.kernels.semijoin import ops as sj

    dev = torch.device("cuda", 0)
    keys = cs.joinmap_inputs(np)[-1]
    lo, hi = bloom.keys_to_device(keys, dev)
    cap = sj.capacity_for(len(keys))
    _, occ = sj.build_rows(lo, hi, cap)
    cs.check(int(occ) == len(keys), "k4_split: occupied")
    calls = 20
    prof = cs.device_busy(torch, lambda: sj.build_rows(lo, hi, cap), calls)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(100):
        sj.build_rows(lo, hi, cap)
    host_ms = (time.perf_counter() - t) * 10
    torch.cuda.synchronize()

    def host_us(fn, reps=1000):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) / reps * 1e6
    lib = sj._lib()
    # the host steps a build takes, alone, in microseconds each
    steps = {
        "check_halves": host_us(lambda: sj._check_halves(lo, hi)),
        "empty_table": host_us(lambda: torch.empty(
            (cap, 4), dtype=torch.int32, device=dev)),
        "empty_scalar": host_us(lambda: torch.empty(
            1, dtype=torch.int64, device=dev)),
        "zeros_scalar": host_us(lambda: torch.zeros(
            1, dtype=torch.int64, device=dev)),
        "current_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "data_ptr": host_us(lambda: lo.data_ptr()),
    }
    if hasattr(lib, "joinmap_build_scratch_bytes"):
        steps["scratch_query"] = host_us(
            lambda: lib.joinmap_build_scratch_bytes(len(keys), cap))
    torch.cuda.synchronize()
    print(json.dumps({
        "tool": "k4_split", "case": "SF 1 orders", "src": args.src,
        "package": sj.__file__, "n": len(keys), "cap": cap,
        "ms": cs.cuda_ms(torch, lambda: sj.build_rows(lo, hi, cap), 20),
        "device_ms": prof["device_busy_seconds"] * 1e3 / calls,
        "host_ms": host_ms, "host_steps_us": steps,
        "device_ops": [{"op": op["op"], "ms": op["ms"] / calls,
                        "count": op["count"]}
                       for op in prof["top_device_ms"]],
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
