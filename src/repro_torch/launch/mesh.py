"""Meshes: the 1-D data mesh of the distributed join and transfer
runtimes, multi-axis meshes, and the ambient mesh of the LM layer.

The reference builds a `jax.sharding.Mesh` and runs its collectives in
one process through `jax.shard_map`. The port's counterpart is an
explicit tuple of torch devices held by one controller process: shard
`s` lives on `devices[s]`, and a collective is a set of `.to(device)`
copies between them (peer copies between distinct GPUs). A device may
appear several times: `["cpu"] * 8` is the counterpart of the
reference tests' `--xla_force_host_platform_device_count=8`, and
`["cuda:0"] * 4` runs four shards on one card.

A `Mesh` has ordered axis names, their sizes and, optionally, a device
for each point of the grid (row-major: on ("pod", "data") shard
`p * n_data + d` is pod `p`'s data shard `d`). Without devices it is an
abstract mesh: the sharding rules (`parallel.sharding`), the cost model
and the LM layer's hints read only its axis sizes. `set_mesh(mesh)`
makes a mesh ambient in the calling thread, as `layers.attention_backend`
sets a backend, and `get_abstract_mesh()` reads it (None when no mesh is
set); the MoE's token groups and the hints (`parallel.hints`) follow it.

The production meshes are (32, 8) over ("data", "model") and (2, 32, 8)
over ("pod", "data", "model"): a model axis of 8 is one HGX H100 node's
NVLink domain, where the reference's TPU v5e pod is 16 x 16; the device
counts (256 and 512) are the reference's, so the tables line up by
devices. The reference module's JAX version shims (`install_jax_compat`,
`AxisType`) fill gaps between JAX releases and have no counterpart.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """Shard `s` of a row-sharded array lives on `devices[s]`."""

    devices: Tuple[object, ...]
    axis: str = "data"

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.axis,)


def make_data_mesh(nshards: Optional[int] = None, axis: str = "data",
                   devices: Optional[Sequence] = None) -> DataMesh:
    """1-D row-sharding mesh for the distributed join/transfer runtimes.

    Without `devices`: `nshards` visible CUDA devices (default: the
    largest power-of-two count of them — the shuffle partitioner needs a
    power of two); CUDA absent raises RuntimeError, fewer visible
    devices than `nshards` ValueError. With `devices`: the first
    `nshards` of them (default: all), each resolved as the port's entry
    points resolve a device (a CUDA device without CUDA raises)."""
    import torch

    from repro_torch.core import device_plane
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_data_mesh: CUDA is not available; pass devices="
                "['cpu'] * nshards to shard on the CPU")
        visible = torch.cuda.device_count()
        if nshards is None:
            nshards = 1 << (max(visible, 1).bit_length() - 1)
        if nshards > visible:
            raise ValueError(f"make_data_mesh: {nshards} shards asked, "
                             f"{visible} CUDA devices visible")
        devices = [f"cuda:{i}" for i in range(nshards)]
    else:
        devices = list(devices)
        if nshards is None:
            nshards = len(devices)
        if nshards > len(devices):
            raise ValueError(f"make_data_mesh: {nshards} shards asked, "
                             f"{len(devices)} devices given")
        devices = devices[:nshards]
    if nshards < 1:
        raise ValueError(f"make_data_mesh: nshards must be >= 1, "
                         f"got {nshards}")
    return DataMesh(tuple(device_plane.resolve_device(d) for d in devices),
                    axis)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of `axis_sizes` over `axis_names`; `devices` (None for an
    abstract mesh) holds one device a point, row-major."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Optional[Tuple[object, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes) \
                or len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} do not match "
                             f"sizes {self.axis_sizes}")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"mesh of {self.size} points given "
                             f"{len(self.devices)} devices")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def _make_mesh(shape, axes, devices=None) -> Mesh:
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if devices is not None:
        from repro_torch.core import device_plane
        devices = tuple(device_plane.resolve_device(d) for d in devices)
    return Mesh(axes, shape, devices)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract production mesh: (32, 8) over ("data", "model"), or
    (2, 32, 8) over ("pod", "data", "model")."""
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   devices: Optional[Sequence] = None) -> Mesh:
    """A small mesh for tests: abstract without `devices`, else one
    device a point, row-major (a device may repeat: `["cpu"] * 8`), each
    resolved as the port's entry points resolve a device."""
    return _make_mesh(shape, axes, devices)


_AMBIENT = threading.local()


def get_abstract_mesh():
    """The mesh `set_mesh` made ambient in this thread, or None."""
    return getattr(_AMBIENT, "mesh", None)


@contextlib.contextmanager
def set_mesh(mesh):
    """`with set_mesh(m):` makes `m` ambient in this thread (nestable;
    None clears it for the block)."""
    prev = get_abstract_mesh()
    _AMBIENT.mesh = mesh
    try:
        yield mesh
    finally:
        _AMBIENT.mesh = prev
