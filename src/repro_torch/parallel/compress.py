"""Gradient compression, the reference's two layers in torch.

* `fake_quant_int8` — per-tensor symmetric int8 quantize/dequantize of
  the accumulated gradient before the optimizer (the information loss of
  an int8 all-reduce, on one device).
* `compressed_psum_int8` — the int8 all-reduce itself over a
  `launch.mesh.DataMesh`: a max-reduce of the per-shard scales, the int8
  payloads summed in int32, the mean dequantized, with an error-feedback
  residual per shard carried by the caller. One controller drives every
  shard and a collective is a set of `.to(device)` copies, as in
  `core.distributed`'s OR all-reduce (no `torch.distributed`: ROADMAP
  Queue 1 item 8).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def _scale_of(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0


def _quantize(gf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(gf / s), -127, 127).to(torch.int8)


def fake_quant_int8(g: torch.Tensor) -> torch.Tensor:
    gf = g.float()
    s = _scale_of(gf)
    return (_quantize(gf, s).float() * s).to(g.dtype)


def compressed_psum_int8(grads: Sequence[torch.Tensor], mesh,
                         errs: Sequence[torch.Tensor]
                         ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """int8 all-reduce with error feedback over the shards of `mesh`:
    `grads[s]` and `errs[s]` live on `mesh.devices[s]`.

    Returns (mean-reduced gradient on every shard's device, each shard's
    new error residual). Wire bytes are 1/4 of an f32 all-reduce (the
    int8 payload; the f32 scale is one number)."""
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
