"""Per-device collectives of a cell's step, counted from one mesh point's
own program: the counterpart of the reference's `launch/hlo.py`.

The reference reads its collectives from the program XLA partitioned,
one device's SPMD module: each all-gather, all-reduce, reduce-scatter,
all-to-all and collective-permute counted once, with the bytes of its
result shape (`hlo.collective_stats`). The port has no partitioner; its
points run the layer library under `parallel.spmd.run`, every point
making every collective in the same order and receiving the same bytes.
So `count` runs the cell's step as the sharded path runs it for one
point, on the "meta" device at the cell's full shape, its collectives
meeting no one (`spmd.counting`), and that point's counts are the
reference's per-device numbers, at any width and on any mesh:

  * train: `train.step.build_train_step(..., mesh=)` (its microbatches,
    remat, the backward and its recomputation, the optimizer update),
    the parameters under `param_specs(cfg, mesh, fsdp)` and the
    optimizer state under `dryrun.opt_shardings`, the full batch given
    as the sharded path takes it;
  * prefill: `Model.prefill` into a cache of `seq_len` slots, the batch
    split over the data axes as `serve.generate_sharded` splits it;
  * decode: one `Model.decode_step` at position `seq_len - 1` against
    the caches a point holds after a prefill into `seq_len` slots (its
    own `init_cache`, as the prefill makes them: under the sequence
    split and at batch 1 that is not `cache_spec`'s layout); the caches'
    making is not counted.

Attention runs on "auto" in its dense form (K8 does not run on "meta");
the collectives around it (a decode step's merge, the sequence split's
gathers) are the served "flash" call's: they do not depend on the
backend.

Two byte rules. `collective_stats` and `collective_bytes` take the
reference's: the bytes of each collective's output (an all-gather's
gathered tensor, an all-reduce's sum in its dtype, the MoE combine's
f32 too, a reduce-scatter's slice). `received_bytes` takes
`spmd.COMM`'s: the bytes a point receives, (n - 1) times its tensor in
a group of n (a reduce-scatter: the slices), the wire term the cost
model's `coll_bytes` estimates. `all-to-all` and `collective-permute`
are always 0: the port's expert-parallel MoE combines by an all-reduce
(ROADMAP Queue 3).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Union

import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.specs import (
    TRAIN_SETTINGS, input_specs, microbatches_for,
)
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig, abstract_params
from repro_torch.models.model import Batch, Model
from repro_torch.parallel import sharding as S
from repro_torch.parallel import spmd as SP
from repro_torch.train.step import TrainConfig, build_train_step

#: the reference's kinds, each with the counts' name of it (None: the
#: port makes no such collective)
KINDS = {"all-gather": "all_gather", "all-reduce": "all_reduce",
         "reduce-scatter": "reduce_scatter", "all-to-all": None,
         "collective-permute": None}


@contextlib.contextmanager
def _counting(cfg: ModelConfig, mesh, fsdp: bool, point: int):
    """`spmd.counting(point)` with attention on "auto" in its dense form,
    yielding the counts and the parameters as the point's meta shards
    under `param_specs(cfg, mesh, fsdp)`."""
    from repro_torch.launch.dryrun import _unchunked
    with L.attention_backend("auto"), _unchunked(), \
            SP.counting(point) as counts:
        yield counts, SP.shard_tree(abstract_params(cfg),
                                    S.param_specs(cfg, mesh, fsdp), mesh)


def count(cfg: ModelConfig, shape: ShapeSpec, mesh, *, fsdp: bool,
          tc: Optional[TrainConfig] = None, optimizer=None,
          point: int = 0) -> Dict[str, int]:
    """Mesh point `point`'s collectives (`spmd.COUNTED`) in the step of
    `shape` (its kind, global batch and length) of the model of `cfg` on
    `mesh`, its parameters split by `param_specs(cfg, mesh, fsdp)`; a
    train step takes `tc` and `optimizer`. Nothing is allocated."""
    from repro_torch.launch.dryrun import opt_shardings
    model = Model(cfg)
    kind, args, _ = input_specs(cfg.name, shape, make_test_mesh((1, 1)),
                                cfg)
    cap = shape.seq_len
    with _counting(cfg, mesh, fsdp, point) as (counts, params):
        if kind == "train":
            state = SP.init_state(optimizer.init, params, opt_shardings)
            step = build_train_step(model, optimizer, tc, mesh=mesh)
            counts.reset()
            step(params, state, args[0])
            return dict(counts)
        ways = serve.batch_ways(mesh, shape.global_batch)
        with torch.no_grad():
            if kind == "prefill":
                batch = Batch(*(serve.split_rows(mesh, t) for t in args[0]))
                SP.run(mesh, model.prefill, params, batch, cap,
                       batch_ways=ways)
            else:
                def decode(params, tok, enc_out):
                    # the point's caches as its prefill makes them (a
                    # decode step's collectives do not depend on the
                    # cursor: `layers._cache_keys`)
                    caches = model.init_cache(tok.shape[0], cap, tok.device)
                    counts.reset()
                    return model.decode_step(params, tok, caches, cap - 1,
                                             enc_out)
                enc = args[3] if len(args) > 3 else None
                SP.run(mesh, decode, params, serve.split_rows(mesh, args[0]),
                       serve.split_rows(mesh, enc), batch_ways=ways)
    return dict(counts)


def count_serve(cfg: ModelConfig, mesh, batch: int, prompt_len: int,
                gen_tokens: int, cap: int, fsdp: bool,
                point: int = 0) -> Dict[str, int]:
    """Mesh point `point`'s collectives in one pass of
    `serve.generate_sharded` (a prefill of `prompt_len` tokens after the
    stub frontend's embeddings, whisper's encoding for the steps, then
    `gen_tokens` greedy decode steps into `cap` slots), the parameters
    split by `param_specs(cfg, mesh, fsdp)`: what `serve.serve_config(...,
    mesh=)` makes a pass. The pass is counted with one decode step, and
    each further step as `count`'s decode step into `cap` slots (every
    step makes the same calls)."""
    n = serve.stub_len(cfg)
    with _counting(cfg, mesh, fsdp, point) as (counts, params):
        prompt = torch.empty((batch, prompt_len), dtype=torch.int64,
                             device="meta")
        extra = None if n is None else torch.empty(
            (batch, n, cfg.d_model), dtype=torch.float32, device="meta")
        with torch.no_grad():
            serve.generate_sharded(Model(cfg), params, prompt,
                                   min(gen_tokens, 1), cap, mesh,
                                   extra=extra)
    out = dict(counts)
    if gen_tokens > 1:
        step = count(cfg, ShapeSpec("decode", cap, batch, "decode"), mesh,
                     fsdp=fsdp, point=point)
        out = {k: x + (gen_tokens - 1) * step[k] for k, x in out.items()}
    return out


def count_cell(arch: str, shape: Union[str, ShapeSpec], mesh,
               cfg: Optional[ModelConfig] = None,
               point: int = 0) -> Dict[str, int]:
    """`count` of the cell's step with the dry run's settings: a train
    step's `TRAIN_SETTINGS` (its optimizer, loss chunk, accumulation
    dtype and FSDP), `microbatches_for` and remat; serving's FSDP by
    `dryrun.serve_fsdp`."""
    from repro_torch.launch import dryrun as D
    cfg = cfg or get_config(arch)
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    if spec.kind != "train":
        return count(cfg, spec, mesh, fsdp=D.serve_fsdp(cfg, mesh),
                     point=point)
    ts = TRAIN_SETTINGS[arch]
    tc = TrainConfig(microbatches=microbatches_for(arch, cfg, mesh, spec),
                     remat=True, loss_chunk=ts.loss_chunk,
                     accum_dtype=ts.accum_dtype)
    return count(cfg, spec, mesh, fsdp=ts.fsdp, tc=tc,
                 optimizer=D.make_optimizer(arch), point=point)


def collective_stats(counts: Dict[str, int]) -> Dict[str, Dict[str, int]]:
    """A point's counts as the reference's per-kind {count, bytes}, the
    bytes its rule's: each collective's output."""
    return {kind: {"count": counts[name] if name else 0,
                   "bytes": counts[name + "_output_bytes"] if name else 0}
            for kind, name in KINDS.items()}


def collective_bytes(stats: Dict[str, Dict[str, int]]) -> int:
    """The bytes of `collective_stats`, summed over the kinds."""
    return sum(v["bytes"] for v in stats.values())


def received_bytes(counts: Dict[str, int]) -> int:
    """The bytes a point receives in all (`spmd.COMM`'s rule)."""
    return sum(counts[name + "_bytes"] for name in KINDS.values() if name)
