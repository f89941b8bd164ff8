"""Gradient compression, the reference's two layers in torch.

* `fake_quant_int8` — per-tensor symmetric int8 quantize/dequantize of
  the accumulated gradient before the optimizer (the information loss of
  an int8 all-reduce, on one device). A point's tensor of a sharded
  leaf (`parallel.spmd`) takes its scale from the whole leaf's largest
  magnitude, a max all-reduced over the leaf's split axes, as the
  reference's per-tensor scale is under GSPMD.
* `compressed_psum_int8` — the int8 all-reduce itself: a max-reduce of
  the per-shard scales, the int8 payloads summed in int32, the mean
  dequantized, with an error-feedback residual per shard carried by the
  caller. Two forms: the reference's, `(g, axis_name, err)` inside
  `spmd.run` over a named mesh axis (its `shard_map` form); and one over
  a `launch.mesh.DataMesh`, `(grads, mesh, errs)`, each shard's tensors
  on its device. One controller drives every shard and a collective is a
  set of `.to(device)` copies, as in `core.distributed`'s OR all-reduce
  (no `torch.distributed`: ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.parallel import spmd as SP


def _scale_of(x: torch.Tensor, axes=()) -> torch.Tensor:
    top = torch.max(torch.abs(x))
    if axes:
        top = SP.all_reduce(top, axes, op="max")
    return torch.clamp(top, min=1e-12) / 127.0


def _quantize(gf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(gf / s), -127, 127).to(torch.int8)


def fake_quant_int8(g: torch.Tensor) -> torch.Tensor:
    gf = g.float()
    s = _scale_of(gf, SP.leaf_axes(g))
    return (_quantize(gf, s).float() * s).to(g.dtype)


def compressed_psum_int8(grads, mesh, errs):
    """int8 all-reduce with error feedback. Inside `spmd.run`, the
    reference's form: `compressed_psum_int8(g, axis_name, err)` over the
    mesh axis (or tuple of axes) `axis_name`, returning (the mean over
    the axis, this point's new residual). Over a `DataMesh`:
    `compressed_psum_int8(grads, mesh, errs)`, `grads[s]` and `errs[s]`
    on `mesh.devices[s]`, returning (the mean on every shard's device,
    each shard's new residual). Wire bytes are 1/4 of an f32 all-reduce
    (the int8 payload; the f32 scale is one number)."""
    if isinstance(mesh, (str, tuple)):
        return _psum_on_axis(grads, mesh, errs)
    return _psum_on_data_mesh(grads, mesh, errs)


def _psum_on_axis(g: torch.Tensor, axis_name, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float() + err
    # shared scale (a max all-reduce) so the integer sum is well-defined
    s = _scale_of(gf, axis_name)
    q = _quantize(gf, s)
    new_err = gf - q.float() * s            # error feedback residual
    total = SP.all_reduce(q, axis_name, dtype=torch.int32)
    n = SP.context().size(axis_name)
    return (total.float() * s / float(n)).to(g.dtype), new_err


def _psum_on_data_mesh(grads: Sequence[torch.Tensor], mesh,
                       errs: Sequence[torch.Tensor]
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    devices = mesh.devices
    if not len(grads) == len(errs) == len(devices):
        raise ValueError(f"{len(grads)} gradients and {len(errs)} "
                         f"residuals over {len(devices)} shards")
    gfs = [g.float() + e for g, e in zip(grads, errs)]
    # shared scale (a max all-reduce) so the integer sum is well-defined
    s = torch.stack([_scale_of(gf).to(devices[0]) for gf in gfs]).max()
    qs, new_errs = [], []
    for gf in gfs:
        sd = s.to(gf.device)
        q = _quantize(gf, sd)
        new_errs.append(gf - q.float() * sd)    # error feedback residual
        qs.append(q)
    out = []
    n = float(len(devices))
    for dev, g in zip(devices, grads):
        total = sum(q.to(dev).to(torch.int32) for q in qs)
        out.append((total.float() * s.to(dev) / n).to(g.dtype))
    return out, new_errs
