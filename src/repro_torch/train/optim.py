"""Optimizers over pytrees of tensors (no external deps): AdamW with a
configurable state dtype, Adafactor (factored second moment), global-norm
clipping and the cosine schedule — the reference's, in torch.

The state is `NamedTuple`s of dicts of tensors, as the reference's. One
difference, on purpose: `update` writes the parameters and the moments
in place, leaf by leaf, with the reference's f32 arithmetic (the
reference returns new trees: at qwen1.5-4b's full width a second copy of
its parameters and f32 moments is 39.5 GB). It returns the same
parameter tree and a state holding the same moment tensors.

Sharded (inside `parallel.spmd.run`, each point updating its shards of
the parameters and their state; the gradients carry their leaves' specs,
`spmd.like`): a sum or mean over a leaf is the all-reduce of the points'
over the axes that split it (`spmd.leaf_axes`), so a replica counts
once. The global norm reduces each leaf's sum of squares so (one call
for each set of axes), then sums the leaves in order; Adafactor's row
and column means over a split dim are all-reduced and divided by the
whole dim, and its update's RMS is the whole leaf's. The step counter
and the learning rate are the same on every point.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.parallel import spmd as SP
from repro_torch.train.tree import leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares (f32); a
    sharded leaf's sum is the whole leaf's (the points' sums all-reduced
    over its split axes, one call for each set of axes)."""
    xs = leaves(tree)
    sums = [torch.sum(torch.square(x.float())) for x in xs]
    groups = {}
    for i, x in enumerate(xs):
        axes = SP.leaf_axes(x)
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        whole = SP.all_reduce(torch.stack([sums[i] for i in idx]), axes)
        for j, i in enumerate(idx):
            sums[i] = whole[j]
    total = 0.0
    for x in sums:
        total = total + x
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _mean(x: torch.Tensor, dim: int, axes, keepdim: bool = False):
    """The mean of `x` over `dim`, a dim split over `axes` (a point's
    slice of it): the points' sums all-reduced over `axes` and divided by
    the whole dim."""
    if not axes:
        return x.mean(dim=dim, keepdim=keepdim)
    total = SP.all_reduce(x.sum(dim=dim, keepdim=keepdim), axes)
    return total / (x.shape[dim] * SP.context().size(axes))


def _clip_scale(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to global norm <= max_norm, in each leaf's dtype;
    the norm before clipping)."""
    g = global_norm(tree)
    scale = _clip_scale(g, max_norm)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), g


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[Any], torch.Tensor]:
    """Linear warmup to `peak`, then a cosine to `floor * peak` at
    `total`; a step (int or tensor) -> f32 tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def _f32(x: torch.Tensor) -> torch.Tensor:
    """`x` as f32: the tensor itself when it is f32 (then updated in
    place), else an f32 copy (copied back with `_store`)."""
    return x if x.dtype == torch.float32 else x.float()


def _store(dst: torch.Tensor, val: torch.Tensor) -> None:
    if val is not dst:
        dst.copy_(val)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[Any], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: Any = torch.float32
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        z = lambda p: torch.zeros(p.shape, dtype=self.state_dtype,
                                  device=p.device)
        dev = leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          tree_map(z, params), tree_map(z, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, dict]:
        gnorm = torch.zeros((), dtype=torch.float32)
        scale = None
        if self.clip_norm is not None:
            gnorm = global_norm(grads)
            scale = _clip_scale(gnorm, self.clip_norm)
        step = state.step + 1
        t = step.to(torch.float32)
        b1, b2 = self.b1, self.b2
        f32 = dict(dtype=torch.float32, device=t.device)
        bc1 = 1 - torch.tensor(b1, **f32) ** t
        bc2 = 1 - torch.tensor(b2, **f32) ** t
        lr = self.lr(step)
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v)):
            gf = g.float()
            if scale is not None:       # the clipped gradient, in g's dtype
                gf = (gf * scale).to(g.dtype).float()
            mf, vf = _f32(m), _f32(v)
            mf.mul_(b1).add_((1 - b1) * gf)
            vf.mul_(b2).add_((1 - b2) * gf * gf)
            delta = (mf / bc1) / (torch.sqrt(vf / bc2) + self.eps)
            if p.ndim >= 2:     # decoupled weight decay on matrices only
                delta = delta + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            _store(m, mf)
            _store(v, vf)
        return params, AdamWState(step, state.m, state.v), \
            {"lr": lr, "grad_norm": gnorm}


# --------------------------------------------------------------------------
# Adafactor
# --------------------------------------------------------------------------


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any      # row accumulators (or full v for <2D leaves)
    vc: Any      # col accumulators (or [1] zeros for <2D leaves)


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: Callable[[Any], torch.Tensor]
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    state_dtype: Any = torch.float32

    def init(self, params) -> AdafactorState:
        def vrow(p):
            shape = p.shape[:-1] if p.ndim >= 2 else p.shape
            return torch.zeros(shape, dtype=self.state_dtype,
                               device=p.device)

        def vcol(p):
            shape = (p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else (1,))
            return torch.zeros(shape, dtype=self.state_dtype,
                               device=p.device)

        dev = leaves(params)[0].device
        return AdafactorState(torch.zeros((), dtype=torch.int32, device=dev),
                              tree_map(vrow, params), tree_map(vcol, params))

    @torch.no_grad()
    def update(self, grads, state: AdafactorState, params):
        step = state.step + 1
        t = step.to(torch.float32)
        beta = 1.0 - t ** (-self.decay)
        lr = self.lr(step)
        for p, g, vr, vc in zip(leaves(params), leaves(grads),
                                leaves(state.vr), leaves(state.vc)):
            gf = g.float()
            g2 = gf * gf + self.eps
            rows, cols = SP.split_axes(g, -2), SP.split_axes(g, -1)
            if p.ndim >= 2:
                vrf = beta * vr.float() + (1 - beta) * _mean(g2, -1, cols)
                vcf = beta * vc.float() + (1 - beta) * _mean(g2, -2, rows)
                r = vrf / torch.clamp(_mean(vrf, -1, rows, keepdim=True),
                                      min=self.eps)
                # v̂[i,j] ≈ r[i] * vc[j]  (factored second moment)
                upd = gf * torch.rsqrt(r[..., :, None] * vcf[..., None, :]
                                       + self.eps)
                vc.copy_(vcf)
            else:
                vrf = beta * vr.float() + (1 - beta) * g2
                upd = gf * torch.rsqrt(vrf + self.eps)
            vr.copy_(vrf)
            # update clipping (RMS over the whole leaf)
            axes = SP.leaf_axes(g)
            msq = SP.all_reduce((upd * upd).sum(), axes) / (
                upd.numel() * SP.context().size(axes)) if axes \
                else torch.mean(upd * upd)
            rms = torch.sqrt(msq + 1e-12)
            upd = upd / torch.clamp(rms / self.clip_threshold, min=1.0)
            newp = p.float() - lr * upd
            if self.weight_decay and p.ndim >= 2:
                newp = newp - lr * self.weight_decay * p.float()
            p.copy_(newp)
        return params, AdafactorState(step, state.vr, state.vc), {"lr": lr}


def make_optimizer(name: str, lr_fn, **kw):
    if name == "adamw":
        return AdamW(lr=lr_fn, **kw)
    if name == "adafactor":
        return Adafactor(lr=lr_fn, **kw)
    raise ValueError(name)
