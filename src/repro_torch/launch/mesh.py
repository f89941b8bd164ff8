"""The 1-D data mesh of the distributed join and transfer runtimes.

The reference builds a `jax.sharding.Mesh` and runs its collectives in
one process through `jax.shard_map`. The port's counterpart is an
explicit tuple of torch devices held by one controller process: shard
`s` lives on `devices[s]`, and a collective is a set of `.to(device)`
copies between them (peer copies between distinct GPUs). A device may
appear several times: `["cpu"] * 8` is the counterpart of the
reference tests' `--xla_force_host_platform_device_count=8`, and
`["cuda:0"] * 4` runs four shards on one card.

Only the data mesh is ported. The reference module's JAX version shims
(`get_abstract_mesh`, `set_mesh`, `install_jax_compat`) and its
production and test meshes belong to ROADMAP Queue 1 item 10d.
"""
from __future__ import annotations

import dataclasses
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
