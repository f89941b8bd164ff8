#!/usr/bin/env python3
"""One Nsight Compute reading of K8's prefill kernel at qwen1.5-4b's shape.

    python3 tools/ncu_flash_prefill.py

Runs itself under `ncu` (with `--child`): builds the port's kernels, makes
the inputs of `chip_smoke.py` phase 7's first case (B 4, Sq 2048, Skv
2088, 20 heads, d 128, causal, a fresh ring cache's positions) and calls
`flash_attention` twice; `ncu` profiles the second launch of the prefill
kernel. Prints one JSON line: the card (nvidia-smi's name and power
limit), the kernel's duration under the profiler, the tensor pipe's
active share (`wgmma`), SM throughput, achieved occupancy and the warp
stall reasons (cycles stalled per issued instruction, largest first), or
what `ncu` said when it could not profile. Metrics the card's `ncu` does
not list (`--query-metrics`) are left out. Exits non-zero without CUDA.
"""
from __future__ import annotations

import csv
import io
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
STALLS = ("barrier", "branch_resolving", "dispatch_stall", "drain",
          "imc_miss", "lg_throttle", "long_scoreboard", "math_pipe_throttle",
          "membar", "mio_throttle", "misc", "no_instruction",
          "not_selected", "selected", "short_scoreboard", "sleeping",
          "tex_throttle", "wait")
METRICS = {
    "duration_ns": "gpu__time_duration.sum",
    "tensor_pipe_active_pct": "sm__pipe_tensor_op_gmma_cycles_active.avg."
                              "pct_of_peak_sustained_active",
    "sm_throughput_pct": "sm__throughput.avg.pct_of_peak_sustained_elapsed",
    "warps_active_pct": "sm__warps_active.avg.pct_of_peak_sustained_active",
    **{f"stall_{r}": f"smsp__average_warps_issue_stalled_{r}_per_issue_"
                     f"active.ratio" for r in STALLS},
}


def child() -> None:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flashattn import ops as fa
    from repro_torch.models.layers import _ring_positions
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q, k, v = randn(4, 2048, 20, 128), randn(4, 2088, 20, 128), \
        randn(4, 2088, 20, 128)
    q_pos = torch.arange(2048, dtype=torch.int32, device=dev)[None].repeat(
        4, 1)
    kv_pos, kv_valid = _ring_positions(2048, 2088, 4, dev)
    for _ in range(2):
        fa.flash_attention(q, k, v, q_pos, kv_pos, kv_valid, causal=True)
    torch.cuda.synchronize()


def main() -> int:
    if "--child" in sys.argv:
        child()
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ncu_flash_prefill: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    build.build_all()             # so that the profiled child builds nothing
    ncu = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    listed = subprocess.run([ncu, "--query-metrics"], capture_output=True,
                            text=True, timeout=300).stdout
    names = {key: m for key, m in METRICS.items()
             if m.split(".")[0] in listed}
    cmd = [ncu, "--target-processes", "all", "--kernel-name",
           "regex:prefill_kernel", "--launch-skip", "1", "--launch-count",
           "1", "--csv", "--metrics", ",".join(names.values()),
           sys.executable, __file__, "--child"]
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    rows = [ln for ln in run.stdout.splitlines() if ln.startswith('"')]
    values = {}
    for row in csv.DictReader(io.StringIO("\n".join(rows))):
        values[row["Metric Name"]] = row["Metric Value"].replace(",", "")
    out = {"card": card, "ncu": ncu, "returncode": run.returncode,
           "kernel_shape": {"B": 4, "Sq": 2048, "Skv": 2088, "H": 20,
                            "D": 128}}
    got = {}
    for key, m in names.items():
        try:
            got[key] = float(values[m])
        except (KeyError, ValueError):
            pass
    if not got:
        out["ncu_said"] = (run.stdout + run.stderr)[-2000:]
    stalls = sorted(((v, k[6:]) for k, v in got.items()
                     if k.startswith("stall_")), reverse=True)
    out.update({k: v for k, v in got.items() if not k.startswith("stall_")})
    out["stalls_per_issue"] = {name: v for v, name in stalls}
    out["not_listed"] = sorted(set(METRICS) - set(names))
    print(json.dumps(out), flush=True)
    return 0 if got else 1


if __name__ == "__main__":
    sys.exit(main())
