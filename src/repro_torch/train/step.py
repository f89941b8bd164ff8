"""train_step / eval / serve step builders, the reference's in torch.

`build_train_step` returns a function (params, opt_state, batch) ->
(params, opt_state, metrics) that implements:
  * microbatched gradient accumulation (a loop over microbatches bounds
    activation memory), into `accum_dtype` buffers — f32 by default over
    bf16 compute: each microbatch's gradient comes back from autograd in
    the parameters' dtype and is added to its buffer in `accum_dtype`,
    never accumulated in a bf16 `.grad`;
  * remat: every block is recomputed in the backward pass
    (`torch.utils.checkpoint`, one block at a time), so the activations
    held are one block's plus each block's input;
  * attention on the "auto" backend (`layers.attention_backend`), in
    this thread only, for the forward and the recomputation: the
    hand-written flash kernel has no backward; the recomputation also
    runs under the ambient mesh of the forward (`launch.mesh.set_mesh`),
    so a MoE block regroups its tokens as it did;
  * optional int8 gradient compression (`parallel.compress.
    fake_quant_int8`) of the accumulated gradient;
  * the optimizer update (`train.optim`), in place.
The parameters are a tree of plain tensors; the step differentiates
`Model.loss` with `torch.autograd.grad` over detached views of them.

With a `mesh` (the reference's GSPMD hook: there distribution comes
from the shardings of the arguments) the step runs the same per-point
function inside `parallel.spmd.run`, one thread a mesh point, on trees
of `spmd.Sharded` leaves: the parameters under `sharding.param_specs`,
the optimizer state under `launch.dryrun.opt_shardings`. The batch
(full tensors, or sharded under `batch_spec`) is cut into microbatches
as the unsharded step cuts it, and each microbatch's rows are split by
`batch_spec`, so the MoE's token groups are the reference's. A point
differentiates the global loss (`Model.loss` under a mesh) on its
shards; the collectives carry the gradients back (`spmd`: a copy's
backward all-reduces, a gather's keeps the point's slice, FSDP's summed
over the data axes), and each point's backward runs in its own thread,
the remat recomputation too. After the microbatches, each leaf's f32
gradient is summed over the batch's axes it is replicated on
(`spmd.data_parallel_sum`), then compressed (the scale the max over
the whole leaf) and handed to the optimizer, which updates each point's
shards in place (`train.optim`: norms and means over a leaf's split
axes). The step returns the parameters and the state as sharded trees
and the metrics of point 0 (the loss and the gradient norm are the
same on every point).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.launch.mesh import get_abstract_mesh, set_mesh
from repro_torch.models import layers as L
from repro_torch.models.model import Batch, Model
from repro_torch.parallel import sharding as S
from repro_torch.parallel import spmd as SP
from repro_torch.train.tree import leaves, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: bool = True
    loss_chunk: int = 2048
    compress_grads: bool = False
    accum_dtype: Any = torch.float32   # bf16 halves the accumulation buffer


def _remat_model(model: Model, enabled: bool) -> Model:
    """A copy of `model` whose blocks run under `torch.utils.checkpoint`
    (nothing of a block is saved but its inputs); the model passed in is
    left as it is."""
    if not enabled:
        return model
    model = copy.copy(model)
    orig = model._apply_block

    def run(kind, is_moe, collect_aux, mesh, p, x, positions):
        # unsharded on CUDA the recomputation runs in autograd's own
        # device thread: set the attention backend and the forward's
        # mesh there too (in spmd.run it runs in the point's thread)
        with L.attention_backend("auto"), set_mesh(mesh):
            return orig(kind, is_moe, p, x, positions, None, None,
                        collect_aux)

    def ckpt_block(kind, is_moe, p, x, positions, cache, ring,
                   collect_aux=False):
        if cache is not None or not torch.is_grad_enabled():
            return orig(kind, is_moe, p, x, positions, cache, ring,
                        collect_aux)
        return torch.utils.checkpoint.checkpoint(
            run, kind, is_moe, collect_aux, get_abstract_mesh(), p, x,
            positions, use_reentrant=False)

    model._apply_block = ckpt_block
    return model


def _split_micro(batch: Batch, m: int):
    def r(x):
        if x is None:
            return None
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} does not split into {m} "
                             "microbatches")
        return x.reshape(m, b // m, *x.shape[1:])
    tok, tgt, ext = r(batch.tokens), r(batch.targets), r(batch.extra)
    return [Batch(tok[i], tgt[i], None if ext is None else ext[i])
            for i in range(m)]


def _shard_micro(batch: Batch, m: int, mesh):
    """The microbatches of `batch` (full tensors, or sharded leaves,
    gathered first), each one's rows split by `batch_spec` on `mesh`;
    and how many ways that splits them (1 where the rows do not
    divide)."""
    full = Batch(*SP.gather_tree(tuple(batch)))
    micro = _split_micro(full, m)
    spec = S.batch_spec(mesh, micro[0].tokens.shape[0])
    ways = math.prod(mesh.shape[a] for a in S.batch_axes(mesh)) \
        if spec[0] is not None else 1

    def split(t):
        if t is None:
            return None
        return SP.shard_leaf(t, S.P(*spec, *([None] * (t.dim() - 2))),
                             mesh)
    return [Batch(*(split(t) for t in mb)) for mb in micro], ways


def build_train_step(model: Model, optimizer, tc: TrainConfig,
                     mesh=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): on the
    device of the parameters, or, given `mesh` (with devices), sharded
    over it as the module's note says."""
    model = _remat_model(model, tc.remat)

    def grads_of(params, mb: Batch):
        ps = [SP.like(p.detach().requires_grad_(True), p)
              for p in leaves(params)]
        with torch.enable_grad(), L.attention_backend("auto"):
            loss = model.loss(unflatten(params, ps), mb,
                              loss_chunk=tc.loss_chunk)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        return loss.detach(), grads

    def point_step(params, opt_state, micro):
        flat = leaves(params)
        acc = [torch.zeros(p.shape, dtype=tc.accum_dtype, device=p.device)
               for p in flat]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=flat[0].device)
        for mb in micro:
            loss, grads = grads_of(params, mb)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g.to(tc.accum_dtype))
            loss_sum = loss_sum + loss
            del grads
        for a in acc:
            a.div_(tc.microbatches)
        acc = [SP.data_parallel_sum(a, p) for a, p in zip(acc, flat)]
        if tc.compress_grads:
            from repro_torch.parallel.compress import fake_quant_int8
            acc = [SP.like(fake_quant_int8(a), a) for a in acc]
        new_params, new_state, metrics = optimizer.update(
            unflatten(params, acc), opt_state, params)
        metrics = dict(metrics, loss=loss_sum / tc.microbatches)
        return new_params, new_state, metrics

    def train_step(params, opt_state, batch: Batch):
        return point_step(params, opt_state,
                          _split_micro(batch, tc.microbatches))

    if mesh is None:
        return train_step

    def sharded_step(params, opt_state, batch: Batch):
        micro, ways = _shard_micro(batch, tc.microbatches, mesh)
        out = SP.run(mesh, point_step, params, opt_state, micro,
                     batch_ways=ways, timeout=SP.DEFAULT_TIMEOUT)
        return (SP.join(params, [o[0] for o in out]),
                SP.join(opt_state, [o[1] for o in out]), out[0][2])

    return sharded_step


def build_eval_loss(model: Model, tc: TrainConfig) -> Callable:
    def eval_loss(params, batch: Batch):
        with torch.no_grad():
            return model.loss(params, batch, loss_chunk=tc.loss_chunk)
    return eval_loss


def build_serve_steps(model: Model, cap: int
                      ) -> Tuple[Callable, Callable]:
    """(prefill, decode) step functions."""
    def prefill(params, batch: Batch):
        with torch.no_grad():
            return model.prefill(params, batch, cap=cap)

    def decode(params, tokens, caches, position):
        with torch.no_grad():
            return model.decode_step(params, tokens, caches, position)

    return prefill, decode
