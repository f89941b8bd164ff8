#!/usr/bin/env python3
"""`chip_smoke.py`'s LM serve paths alone, on one NVIDIA GPU.

    python3 tools/serve_paths.py [--path serve-whisper serve-llava ...]

Builds the kernel libraries from the sources in this checkout, then runs
`chip_smoke.serve_phase` for each named path in turn (the paths of phases
8-11b, `chip_smoke.SERVE_PATHS`: `serve`, `serve-deepseek`,
`serve-mixtral`, `serve-mamba2`, `serve-whisper`, `serve-llava`), or
`chip_smoke.serve_sharded_phase` (phases 11d-11m,
`chip_smoke.SERVE_SHARDED_PATHS`: `serve-sharded`, `serve-sharded-mla`,
`serve-sharded-llava`, `serve-sharded-mamba2`, `serve-sharded-whisper`,
`serve-sharded-cp`, `serve-sharded-b1`, `serve-sharded-b1-mla`,
`serve-sharded-b1-mamba2`, `serve-sharded-seq-mla`),
with the same specs and bounds as the full run:
its serve, check and profile lines, then one line with each path's
launch counts. Any failure raises and exits non-zero.

    python3 tools/serve_paths.py --path serve-sharded-mla serve-sharded-llava
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import chip_smoke
    paths, sharded = chip_smoke.SERVE_PATHS, chip_smoke.SERVE_SHARDED_PATHS
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", nargs="+", choices=[*paths, *sharded],
                    default=["serve-whisper", "serve-llava"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_paths: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.bloom import ops as kb
    from repro_torch.kernels.flashattn import ops as fa
    from repro_torch.kernels.semijoin import ops as sj
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    counts = {}
    for path in args.path:
        if path in sharded:
            spec, tol = sharded[path]
            counts[path] = chip_smoke.serve_sharded_phase(
                torch, kb, sj, fa, torch.device("cuda", 0), smi, path, spec,
                tol)
            continue
        spec, tol = paths[path]
        counts[path] = chip_smoke.serve_phase(torch, kb, sj, fa, path, spec,
                                              tol)
    print(json.dumps({"launches_by_path": counts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
