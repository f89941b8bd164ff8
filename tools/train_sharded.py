#!/usr/bin/env python3
"""Sharded training over a mesh of GPUs: qwen1.5-4b at its published
config (40 layers, 3.95 B parameters) on a (2, 2) ("data", "model")
mesh of four GPUs, point i on `cuda:i`, through
`repro_torch.train.step.build_train_step(..., mesh=...)`.

    python3 tools/train_sharded.py

The bf16 parameters are drawn on cuda:0 a leaf at a time straight into
their shards (`spmd.init_sharded`), each point makes its own AdamW state
(`spmd.init_state`), and the step runs STEPS times on one repeated
batch of BATCH x SEQ random tokens (numpy, seed 0), each mesh point on
its own thread, FSDP, 2 microbatches, remat on, AdamW on a cosine
schedule (peak 3e-4, 2 warm-up steps), as `chip_smoke.py`'s path
`train-sharded` runs a cut model on four points of one card; then one
more step under torch.profiler. Prints the cards' names and power limits
(nvidia-smi), then one JSON line: each step's loss, gradient norm and
seconds, the mean step seconds after the first and tokens a second, the
collective counts and bytes (`spmd.COMM`, summed over the points) beside
`spmd.train_comm`'s formula for the steps run, each card's parameter
bytes beside `dryrun.local_bytes` of the specs, each card's peak memory,
and the profiled step: its wall seconds, each card's busy seconds and
the seconds of its peer and device copies (the collectives' transfers),
and the top device ops. Exits non-zero unless every loss is finite and
under the one before and the collectives equal the formula.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH, MESH = "qwen1.5-4b", "2x2"
BATCH, SEQ, STEPS = 4, 2048, 4


def profile_step(torch, step, devices) -> dict:
    """`step()` once under torch.profiler: wall seconds (host clock,
    ending in a synchronise of every card), each card's busy seconds
    (its kernels and copies summed over its streams, which may overlap)
    and copy seconds (peer and device-to-device copies), and the top
    device ops over all cards."""
    from torch.profiler import ProfilerActivity, profile
    for d in devices:
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        for d in devices:
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t
    busy, copies, by_name = {}, {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s = e.time_range.elapsed_us() / 1e6
        dev = f"cuda:{e.device_index}"
        busy[dev] = busy.get(dev, 0.0) + s
        if "Memcpy PtoP" in e.name or "Memcpy DtoD" in e.name:
            copies[dev] = copies.get(dev, 0.0) + s
        sec, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (sec + s, cnt + 1)
    top = sorted(((sec, cnt, name) for name, (sec, cnt) in by_name.items()),
                 reverse=True)[:8]
    return {"wall_seconds": wall, "busy_seconds": busy,
            "copy_seconds": copies,
            "top_device_seconds": [{"op": k[:80], "seconds": sec,
                                    "count": c} for sec, c, k in top]}


def run() -> dict:
    """One sharded training run as the module's note says."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import local_bytes, opt_shardings
    from repro_torch.launch.serve import parse_mesh
    from repro_torch.models.common import abstract_params
    from repro_torch.models.model import Batch, Model
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import spmd as SP
    from repro_torch.train import optim as O
    from repro_torch.train.step import TrainConfig, build_train_step
    cfg = get_config(ARCH)
    mesh = parse_mesh(MESH, "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    fsdp = True
    specs = S.param_specs(cfg, mesh, fsdp=fsdp)
    model = Model(cfg)
    first = mesh.devices[0]
    params = SP.init_sharded(
        lambda: model.init(torch.Generator(device=first).manual_seed(0)),
        specs, mesh)
    opt = O.AdamW(lr=O.cosine_schedule(3e-4, 2, STEPS))
    state = SP.init_state(opt.init, params, opt_shardings)
    tc = TrainConfig(microbatches=2, remat=True, loss_chunk=SEQ)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, SEQ)))
    batch = Batch(tok, torch.roll(tok, -1, 1))
    step = build_train_step(model, opt, tc, mesh=mesh)
    devices = sorted({str(d) for d in mesh.devices})
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
    SP.reset_counts()
    losses, norms, secs = [], [], []
    for _ in range(STEPS):
        for d in devices:
            torch.cuda.synchronize(d)
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t)
        norms.append(float(m["grad_norm"]))
    comm = dict(SP.COMM)
    peaks = {d: torch.cuda.max_memory_allocated(d) for d in devices}
    want = {k: x * STEPS for k, x in SP.train_comm(
        cfg, mesh, BATCH, SEQ, tc, fsdp).items()}
    reckoned = local_bytes(abstract_params(cfg), specs, mesh)
    held = {}
    for p in range(mesh.size):
        dev = str(mesh.devices[p])
        held[dev] = held.get(dev, 0) + SP.tree_local_bytes(params, p)
    prof = profile_step(torch, lambda: step(params, state, batch), devices)
    step_s = statistics.mean(secs[1:])
    return {"arch": ARCH, "config": cfg.name, "layers": cfg.n_layers,
            "params": cfg.param_count(), "mesh": MESH,
            "axes": list(mesh.axis_names), "fsdp": fsdp,
            "batch": BATCH, "seq": SEQ,
            "microbatches": tc.microbatches, "remat": tc.remat,
            "steps": STEPS, "losses": losses, "grad_norms": norms,
            "step_seconds_all": secs, "step_seconds": step_s,
            "tokens_per_second": BATCH * SEQ / step_s,
            "collectives": comm, "collectives_formula": want,
            "collectives_ok": comm == want,
            "falling": all(math.isfinite(x) for x in losses + norms)
            and all(y < x for x, y in zip(losses, losses[1:])),
            "param_bytes": held, "param_bytes_per_point_reckoned": reckoned,
            "peak_memory_bytes": peaks, "profile_one_step": prof}


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out = run()
    print(json.dumps({"nvidia_smi": smi.splitlines(), **out}), flush=True)
    return 0 if out["falling"] and out["collectives_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
