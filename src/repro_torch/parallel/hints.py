"""Activation-sharding hints, read from the ambient mesh.

The reference's `hint(x, *axes)` applies `with_sharding_constraint`
under the ambient mesh (`jax.set_mesh`) so that XLA's SPMD partitioner
lays activations out per arch: heads over "model" when the head count
divides the TP size (Megatron), else query-sequence over "model"
(context parallel), batch over the (pod, data) axes. The port has one
controller and no partitioner, so `hint` returns `x` as it is; the
layer library still calls it where the reference does, and the sizes
the hints read (`tp_size`, `dp_size`, `attn_layout`) follow the mesh
that `launch.mesh.set_mesh` made ambient. `dp_size` also sets the MoE's
token groups (`models.layers.moe_route`), which change the numbers.
Sharded execution (`parallel.spmd.run`) places its collectives at these
sites of the layer library, not through `hint`.
Axis entries may be:
  * None            — unsharded dim
  * "data"/"model"  — mesh axis (dropped if absent/non-dividing)
  * "batch"         — expands to the (pod, data) data-parallel axes
"""
from __future__ import annotations

import math

from repro_torch.launch.mesh import get_abstract_mesh


def _mesh():
    m = get_abstract_mesh()
    return m if m is not None and m.axis_names else None


def hint(x, *axes):
    """`x` itself: a single-controller port has no sharding constraint
    to apply (the reference's is a layout request to XLA)."""
    return x


def tp_size() -> int:
    mesh = _mesh()
    return mesh.shape.get("model", 1) if mesh is not None else 1


def dp_size() -> int:
    """Total data-parallel ways (pod x data)."""
    mesh = _mesh()
    if mesh is None:
        return 1
    return math.prod(mesh.shape.get(a, 1) for a in ("pod", "data"))


def attn_layout(n_heads: int, seq: int) -> str:
    """'heads' (Megatron TP) when divisible, else 'seq' (context
    parallel), else 'none'."""
    tp = tp_size()
    if tp == 1:
        return "none"
    if n_heads % tp == 0:
        return "heads"
    if seq % tp == 0:
        return "seq"
    return "none"


def hint_qkv(q, k, v, layout: str):
    """q/k/v are [B, S, H|KVH, D]."""
    if layout == "heads":
        q = hint(q, "batch", None, "model", None)
        k = hint(k, "batch", None, "model", None)
        v = hint(v, "batch", None, "model", None)
    elif layout == "seq":
        q = hint(q, "batch", "model", None, None)
        k = hint(k, "batch", None, None, None)
        v = hint(v, "batch", None, None, None)
    return q, k, v


def hint_attn_out(o, layout: str):
    """o is [B, S, H, D] pre-reshape."""
    if layout == "heads":
        return hint(o, "batch", None, "model", None)
    if layout == "seq":
        return hint(o, "batch", "model", None, None)
    return o
