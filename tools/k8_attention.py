#!/usr/bin/env python3
"""K8's cases alone (phases 7 and 7a of `chip_smoke.py`) from any
checkout, on one NVIDIA GPU.

    python3 tools/k8_attention.py [--root DIR]

Imports `chip_smoke` and `repro_torch` from the checkout at DIR (default:
this one), builds its kernel libraries from its own sources, and runs its
`attention_phase`, every case's plain version over all its query rows
(the smoke takes the last rows of a batch-1 point's 32,744-row prefill,
whose plain call alone takes 36 s): one JSON line a K8 case (CUDA-event
and device ms, errors against `flash_plain` and `sdpa_ref`, bound,
SDPA's times; every
case of phase 7, whisper-base's encoder, cross prefill and cross decode
shapes at (64, 64) among them), its `lse_phase` (decode's log-sum-exp
against `flash_plain`'s, and slot ranges merged against the whole-cache
call: one line a case), then one line with each case's device ms. In a fresh process the profiler's K8 device times read right (in a
full smoke run they read low; PERF.md §7). Two trees are compared by running
each tree's phase in its own process, in turns within one call on one
card: parent, change, change, parent (the parent unpacked with
`git archive` into the ignored `.chip_check/`).
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__)
                                          .resolve().parents[1]))
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    if not torch.cuda.is_available():
        print("k8_attention: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flashattn import ops as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    log = build.build_all().get("flashattn", (0.0, ""))[1]
    lines = []
    emit = chip_smoke.emit

    def keep(obj):
        lines.append(obj)
        emit(obj)
    chip_smoke.emit = keep
    phase = chip_smoke.attention_phase      # an older tree's has no option
    whole = {"whole_plain": True} if "whole_plain" in \
        inspect.signature(phase).parameters else {}
    phase(torch, fa, torch.device("cuda", 0), log, **whole)
    chip_smoke.lse_phase(torch, fa, torch.device("cuda", 0))
    print(json.dumps({"root": str(root), "device_ms": {
        rec["case"]: rec["device_ms"] for rec in lines
        if "device_ms" in rec}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
