"""Dry-run report of every (architecture x input-shape) cell on the
production meshes, without a device.

For every cell and both production meshes (single node group (32, 8),
multi-pod (2, 32, 8): `launch.mesh.make_production_mesh`) it writes
reports/torch/dryrun/<arch>__<shape>__<single|multi>.json with the
reference's keys (`repro/launch/dryrun.py`):

  * `memory.argument_bytes` — the per-device bytes of the step's
    arguments, reckoned from their shapes and partition specs (each
    leaf's local shard): train = parameters + optimizer state
    (`opt_shardings`) + batch; prefill = parameters + batch; decode =
    parameters + tokens + caches (+ whisper's encoder output). The
    port's ring cursors and decode position are host ints, so they
    hold no device bytes (the reference's are int32 arrays);
  * `flops_per_device` — `torch.utils.flop_counter.FlopCounterMode` over
    the port's step traced on the "meta" device at the cell's full
    shape (no storage, no arithmetic), attention on "auto" (plain
    torch: the hand-written kernel is opaque to the counter; its dense
    form, which makes the chunked form's products at these lengths),
    divided by the mesh's devices. A train step counts one microbatch of
    global_batch / m samples (forward, backward and the remat
    recomputation) times the m microbatches (`flops_note`); the
    optimizer's elementwise work counts no FLOPs. The trace runs under
    the cell's mesh, so a MoE routes the mesh's per-shard token groups
    (each adds a spare gather row an expert, and at decode each group's
    capacity is its own token count);
  * `collectives` — the reference's five kinds (`all-gather`,
    `all-reduce`, `reduce-scatter`, `all-to-all`, `collective-permute`),
    each {count, bytes} per device, counted from one mesh point's own
    sharded step (`launch.collectives`: the step as the sharded path
    runs it, `parallel.spmd.counting`, traced on "meta" at the cell's
    full shape, point 0; every point makes the same calls). "bytes" is
    the reference's rule: each collective's output (the gathered tensor,
    the sum in its dtype, the reduce-scatter's slice).
    `collective_bytes_per_device` is their sum, and
    `collective_received_bytes_per_device` the bytes a point receives
    from the others (`spmd.COMM`'s rule: (n - 1) times its tensor in a
    group of n), the wire term the cost model's `coll_bytes` estimates.
    The port's MoE combines by an all-reduce, so `all-to-all` and
    `collective-permute` are 0. `collective_trace_seconds` is the
    count's time, beside the FLOP trace's `trace_seconds`.

The port has no SPMD partitioner and compiles no partitioned program, so
the numbers only XLA's compiler supplied to the reference's report
(`compile_seconds`, `bytes_accessed_per_device`, `memory.output_bytes`,
`temp_bytes`, `generated_code_bytes`) are null and listed under
`not_measured`. Skipped cells (`skip`) come from `shape_skip_reason`.
The roofline (`launch.roofline`) reads these reports beside the
analytic cost model.

Usage (CPU; nothing is allocated at full size):
    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--force] [--reports DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_skip_reason
from repro_torch.launch import analytic
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import (
    make_production_mesh, make_test_mesh, set_mesh,
)
from repro_torch.launch.specs import (
    TRAIN_SETTINGS, input_specs, microbatches_for,
)
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig, abstract_params
from repro_torch.models.model import Batch, Model
from repro_torch.parallel import sharding as S
from repro_torch.parallel.sharding import P
from repro_torch.train import optim as O
from repro_torch.train.step import TrainConfig, build_train_step

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "torch")

NOT_MEASURED = ("compile_seconds", "bytes_accessed_per_device",
                "memory.output_bytes", "memory.temp_bytes",
                "memory.generated_code_bytes")


def opt_shardings(opt_state, param_specs, mesh):
    """Optimizer-state specs: moments follow their parameter; factored
    accumulators follow the parameter minus the reduced dim; scalars
    replicate."""
    def zip_map(fn, specs, tree):
        if isinstance(specs, P):
            return fn(specs, tree)
        if isinstance(specs, dict):
            return {k: zip_map(fn, specs[k], tree[k]) for k in specs}
        return [zip_map(fn, s, t) for s, t in zip(specs, tree)]

    if isinstance(opt_state, O.AdamWState):
        return O.AdamWState(P(), param_specs, param_specs)
    if isinstance(opt_state, O.AdafactorState):
        vr = zip_map(lambda s, leaf: S.fit_spec(
            P(*tuple(s)[:-1]) if len(s) else P(), tuple(leaf.shape), mesh),
            param_specs, opt_state.vr)
        # vc shapes: param.shape[:-2] + param.shape[-1:]
        vc = zip_map(lambda s, leaf: S.fit_spec(
            P(*(tuple(s)[:-2] + tuple(s)[-1:])) if len(s) >= 2 else P(),
            tuple(leaf.shape), mesh), param_specs, opt_state.vc)
        return O.AdafactorState(P(), vr, vc)
    raise TypeError(type(opt_state))


def local_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of a tree of tensors under its spec tree: each
    tensor's local shard (a dim split over the product of its axes,
    rounded up as a padded shard is). Host ints (ring cursors) and None
    hold no device bytes."""
    if tree is None or isinstance(tree, int):
        return 0
    if isinstance(tree, torch.Tensor):
        n = 1
        for dim, ax in zip(tree.shape, tuple(specs) + (None,) * tree.ndim):
            axes = () if ax is None else ax if isinstance(ax, tuple) \
                else (ax,)
            n *= -(-dim // math.prod(S.axis_size(mesh, a) for a in axes))
        return n * tree.element_size()
    if isinstance(tree, dict):
        return sum(local_bytes(tree[k], specs[k], mesh) for k in tree)
    if dataclasses.is_dataclass(tree):
        return sum(local_bytes(getattr(tree, f.name),
                               getattr(specs, f.name), mesh)
                   for f in dataclasses.fields(tree))
    return sum(local_bytes(t, s, mesh) for t, s in zip(tree, specs))


def serve_fsdp(cfg: ModelConfig, mesh) -> bool:
    """Serving keeps weights replicated across data unless the per-TP
    shard slice itself exceeds `analytic.SERVE_FIT_BYTES` (jamba-398B),
    where ZeRO-3 weight sharding stays on even for serving."""
    tp = S.axis_size(mesh, "model")
    return cfg.param_count() * 2.0 / tp > analytic.SERVE_FIT_BYTES


def make_optimizer(arch: str):
    ts = TRAIN_SETTINGS[arch]
    return O.make_optimizer(ts.optimizer,
                            O.cosine_schedule(3e-4, 100, 10_000),
                            state_dtype=ts.opt_state_dtype)


def argument_bytes(arch: str, shape, mesh, cfg: Optional[ModelConfig] = None
                   ) -> Dict[str, Any]:
    """The step's per-device argument bytes on `mesh` (`shape` a name of
    `SHAPES` or a `ShapeSpec`), with the parts it sums and the choices
    that set them (`fsdp`, and for train `microbatches`/`optimizer`)."""
    cfg = cfg or get_config(arch)
    kind, args, arg_specs = input_specs(arch, shape, mesh, cfg)
    params = abstract_params(cfg)
    fsdp = TRAIN_SETTINGS[arch].fsdp if kind == "train" \
        else serve_fsdp(cfg, mesh)
    pspecs = S.param_specs(cfg, mesh, fsdp=fsdp)
    parts = {"params": local_bytes(params, pspecs, mesh)}
    info: Dict[str, Any] = {"fsdp": fsdp}
    if kind == "train":
        spec = SHAPES[shape] if isinstance(shape, str) else shape
        opt = make_optimizer(arch)
        ostate = opt.init(params)
        parts["opt_state"] = local_bytes(
            ostate, opt_shardings(ostate, pspecs, mesh), mesh)
        info.update(microbatches=microbatches_for(arch, cfg, mesh, spec),
                    optimizer=TRAIN_SETTINGS[arch].optimizer)
    if kind == "decode":
        # (tokens, caches, position[, enc]): the position is a host int
        tok, caches, _pos, *enc = args
        tok_sh, cache_sh, _pos_sh, *enc_sh = arg_specs
        parts["tokens"] = local_bytes(tok, tok_sh, mesh)
        parts["caches"] = local_bytes(caches, cache_sh, mesh)
        if enc:
            parts["enc"] = local_bytes(enc[0], enc_sh[0], mesh)
    else:
        parts["batch"] = local_bytes(args[0], arg_specs[0], mesh)
    return {"kind": kind, "argument_bytes": sum(parts.values()),
            "parts": parts, **info}


def step_flops(arch: str, shape, microbatches: int = 1,
               cfg: Optional[ModelConfig] = None, mesh=None
               ) -> Dict[str, Any]:
    """Global FLOPs of the cell's step, counted by `FlopCounterMode` over
    the port's step on the "meta" device, attention on "auto", under
    `mesh` (ambient: it sets the MoE's token groups; None for one)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = cfg or get_config(arch)
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    model = Model(cfg)
    params = abstract_params(cfg)
    # the step's input shapes do not depend on the mesh
    kind, args, _ = input_specs(arch, spec, make_test_mesh((1, 1)), cfg)
    t0 = time.perf_counter()
    note = None
    with L.attention_backend("auto"), set_mesh(mesh), _unchunked():
        if kind == "train":
            m = microbatches
            (batch,) = args
            mb = Batch(*(None if x is None else x[: x.shape[0] // m]
                         for x in batch))
            ts = TRAIN_SETTINGS[arch]
            opt = make_optimizer(arch)
            step = build_train_step(model, opt, TrainConfig(
                microbatches=1, remat=True, loss_chunk=ts.loss_chunk,
                accum_dtype=ts.accum_dtype))
            ostate = opt.init(params)
            with FlopCounterMode(display=False) as fc:
                step(params, ostate, mb)
            flops = fc.get_total_flops() * m
            note = (f"one microbatch of {spec.global_batch // m} samples "
                    f"counted, times m={m}")
        elif kind == "prefill":
            with torch.no_grad(), FlopCounterMode(display=False) as fc:
                model.prefill(params, args[0], cap=spec.seq_len)
            flops = fc.get_total_flops()
        else:
            tok, caches, _pos, *enc = args
            with torch.no_grad(), FlopCounterMode(display=False) as fc:
                model.decode_step(params, tok, caches, spec.seq_len - 1,
                                  *enc)
            flops = fc.get_total_flops()
    return {"flops": float(flops), "trace_seconds":
            time.perf_counter() - t0, "flops_note": note}


@contextlib.contextmanager
def _unchunked():
    """"auto" attention in its dense form for the trace: at the cells'
    lengths (multiples of its chunks) its chunked form makes the same
    products, one chunk pair at a time, and a meta trace of 64 x 32
    chunk pairs a layer takes minutes."""
    saved = L._SDPA_CHUNK_THRESHOLD
    L._SDPA_CHUNK_THRESHOLD = math.inf
    try:
        yield
    finally:
        L._SDPA_CHUNK_THRESHOLD = saved


def build_cell(arch: str, shape: str, mesh,
               counted: Optional[Dict[tuple, dict]] = None
               ) -> Dict[str, Any]:
    """One cell's report. `counted` keeps `step_flops`' results of this
    (arch, shape) across meshes, by microbatch count and, for a MoE, the
    mesh's data-parallel ways (its token groups): nothing else of the
    global count depends on the mesh."""
    cfg = get_config(arch)
    spec = SHAPES[shape]
    args = argument_bytes(arch, shape, mesh, cfg)
    kind = args["kind"]
    m = args.get("microbatches", 1)
    key = (m, math.prod(S.axis_size(mesh, a) for a in S.batch_axes(mesh))
           if cfg.moe else 1)
    counted = {} if counted is None else counted
    if key not in counted:
        counted[key] = step_flops(arch, shape, m, cfg, mesh)
    flops = counted[key]
    t0 = time.perf_counter()
    comm = C.count_cell(arch, shape, mesh, cfg)
    comm_seconds = time.perf_counter() - t0
    stats = C.collective_stats(comm)
    n_dev = math.prod(mesh.shape.values())
    extra = {"fsdp": args["fsdp"]}
    if kind == "train":
        extra.update(microbatches=m, optimizer=args["optimizer"])
    return {
        "arch": arch, "shape": shape, "kind": kind,
        "mesh": dict(mesh.shape), "devices": n_dev,
        "compile_seconds": None,
        "flops_per_device": flops["flops"] / n_dev,
        "flops_global": flops["flops"],
        "flops_note": flops["flops_note"],
        "trace_seconds": flops["trace_seconds"],
        "collective_trace_seconds": comm_seconds,
        "bytes_accessed_per_device": None,
        "collectives": stats,
        "collective_bytes_per_device": C.collective_bytes(stats),
        "collective_received_bytes_per_device": C.received_bytes(comm),
        "memory": {"argument_bytes": args["argument_bytes"],
                   "argument_parts": args["parts"],
                   "output_bytes": None, "temp_bytes": None,
                   "generated_code_bytes": None},
        "not_measured": list(NOT_MEASURED),
        "params": int(cfg.param_count()),
        "global_batch": spec.global_batch, "seq_len": spec.seq_len,
        **extra,
    }


def cell_path(arch: str, shape: str, multi_pod: bool,
              report_dir: str = REPORT_DIR) -> str:
    d = os.path.join(report_dir, "dryrun")
    os.makedirs(d, exist_ok=True)
    tag = "multi" if multi_pod else "single"
    return os.path.join(d, f"{arch}__{shape}__{tag}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reports", default=REPORT_DIR,
                    help="report root (dry-run JSONs go to <root>/dryrun)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            reason = shape_skip_reason(cfg, shape)
            counted: Dict[tuple, dict] = {}   # see build_cell
            for multi in meshes:
                path = cell_path(arch, shape, multi, args.reports)
                if os.path.exists(path) and not args.force:
                    print(f"SKIP (cached) {path}")
                    continue
                if reason is not None:
                    with open(path, "w") as f:
                        json.dump({"arch": arch, "shape": shape,
                                   "skip": reason}, f, indent=1)
                    print(f"SKIP {arch} x {shape}: {reason}")
                    continue
                mesh = make_production_mesh(multi_pod=multi)
                tag = "multi" if multi else "single"
                out = build_cell(arch, shape, mesh, counted)
                with open(path, "w") as f:
                    json.dump(out, f, indent=1)
                print(f"=== {arch} x {shape} x {tag}: flops/dev="
                      f"{out['flops_per_device']:.3e} args="
                      f"{out['memory']['argument_bytes'] / 2**30:.2f}GiB "
                      f"coll/dev={out['collective_bytes_per_device']:.3e}B "
                      f"(trace {out['trace_seconds']:.1f}s, collectives "
                      f"{out['collective_trace_seconds']:.1f}s)", flush=True)
    print("\nALL DRY-RUN CELLS WRITTEN")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
