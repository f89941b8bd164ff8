#!/usr/bin/env python3
"""K4's partitioned route at other tile, CTA and region sizes, on one
NVIDIA GPU.

    python3 tools/k4_variants.py

Each variant is a copy of `semijoin.cu` with some of its constants
changed, built beside the package's own libraries (one nvcc each, all
started together) and called through the package's wrapper
(`build_rows`, its library swapped in), at `chip_smoke.py`'s "SF 1
orders" case (`chip_smoke.joinmap_inputs`: 1.5 M distinct keys in 2^22
slots). One JSON line: each variant's occupied count (checked against the
distinct count), CUDA-event ms, device ms and device ops a build
(torch.profiler, `chip_smoke.device_busy`), the first variant measured
again last. `base` is `semijoin.cu` as it is.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

#: variant: {constant: value}
VARIANTS = {
    "base": {},
    "region_2^12": {"kRegionLog2": "12"},
    "build_512": {"kBuildThreads": "512"},
    "region_2^12_build_512": {"kRegionLog2": "12", "kBuildThreads": "512"},
    "tile_2048_256": {"kTile": "2048", "kPassThreads": "256"},
    "tile_8192_512": {"kTile": "8192"},
    "tile_8192_1024": {"kTile": "8192", "kPassThreads": "1024"},
    "overflow_132": {"kOverflowCtas": "132"},
}


def variant_source(text: str, consts: dict) -> str:
    for name, value in consts.items():
        text, n = re.subn(rf"(constexpr int {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"semijoin.cu has no constant {name}")
    return text


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k4_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import bloom
    from repro_torch.kernels import build
    from repro_torch.kernels.semijoin import ops as sj

    text = build.SOURCES["semijoin"].read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, consts in VARIANTS.items():
        src = build.BUILD_DIR / f"k4_{name}.cu"
        src.write_text(variant_source(text, consts))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I",
             str(build.INCLUDE_DIR), "-o",
             str(build.BUILD_DIR / f"libk4_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    own, library = sj._lib(), sj.library
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"k4_variants: nvcc {name}:\n{log}")
        sj._LIB = None
        sj.library = lambda _, name=name: ctypes.CDLL(
            str(build.BUILD_DIR / f"libk4_{name}.so"))
        libs[name] = sj._lib()
    sj.library = library

    dev = torch.device("cuda", 0)
    keys = cs.joinmap_inputs(np)[-1]
    lo, hi = bloom.keys_to_device(keys, dev)
    cap = sj.capacity_for(len(keys))
    rec = {"tool": "k4_variants", "case": "SF 1 orders", "n": len(keys),
           "cap": cap, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}
    order = (*VARIANTS, "base")
    calls = 20
    for i, name in enumerate(order):
        sj._LIB = libs[name]
        _, occ = sj.build_rows(lo, hi, cap)
        cs.check(int(occ) == len(keys), f"k4_variants: {name} occupied")
        fn = (lambda: sj.build_rows(lo, hi, cap))
        prof = cs.device_busy(torch, fn, calls)
        key = name if name not in order[:i] else f"{name}_again"
        rec[key] = {
            "ms": cs.cuda_ms(torch, fn, 20),
            "device_ms": prof["device_busy_seconds"] * 1e3 / calls,
            "device_ops": [{"op": op["op"][:48], "ms": op["ms"] / calls}
                           for op in prof["top_device_ms"]]}
    sj._LIB = own
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
