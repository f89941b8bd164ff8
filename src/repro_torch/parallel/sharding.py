"""Mesh-axis sizes for the distributed runtime.

Only `axis_size` is ported (the reference's `parallel/sharding.py:35`):
the distributed join runtime reads its shard count through it. The
reference module's named-sharding rules for the LM zoo's parameters
and caches (`fit_spec`, `param_specs`, ...) belong to ROADMAP Queue 1
item 10d and are not ported yet.
"""
from __future__ import annotations


def axis_size(mesh, name: str) -> int:
    """Size of mesh axis `name` (1 when the mesh has no such axis)."""
    return mesh.shape[name] if name in mesh.shape else 1
