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
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.launch.mesh import get_abstract_mesh, set_mesh
from repro_torch.models import layers as L
from repro_torch.models.model import Batch, Model
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
        # the recomputation may run in autograd's own thread: set the
        # attention backend and the forward's mesh there too
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


def build_train_step(model: Model, optimizer, tc: TrainConfig
                     ) -> Callable:
    """The step runs on the device of the parameters (the reference's
    GSPMD `mesh` hook has no counterpart yet: ROADMAP item 10e.2)."""
    model = _remat_model(model, tc.remat)

    def grads_of(params, mb: Batch):
        ps = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad(), L.attention_backend("auto"):
            loss = model.loss(unflatten(params, ps), mb,
                              loss_chunk=tc.loss_chunk)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        return loss.detach(), grads

    def train_step(params, opt_state, batch: Batch):
        flat = leaves(params)
        acc = [torch.zeros(p.shape, dtype=tc.accum_dtype, device=p.device)
               for p in flat]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=flat[0].device)
        for mb in _split_micro(batch, tc.microbatches):
            loss, grads = grads_of(params, mb)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g.to(tc.accum_dtype))
            loss_sum = loss_sum + loss
            del grads
        for a in acc:
            a.div_(tc.microbatches)
        if tc.compress_grads:
            from repro_torch.parallel.compress import fake_quant_int8
            acc = [fake_quant_int8(a) for a in acc]
        new_params, new_state, metrics = optimizer.update(
            unflatten(params, acc), opt_state, params)
        metrics = dict(metrics, loss=loss_sum / tc.microbatches)
        return new_params, new_state, metrics

    return train_step


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
