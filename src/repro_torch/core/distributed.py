"""Distributed predicate transfer (paper §5 future work, built here).

Tables are row-partitioned across the `data` mesh axis. One transfer edge
runs as:

  1. each shard builds a *local* Bloom filter over its partition's keys
     (kernel K2, `repro_torch.kernels.bloom.ops.build` — same blocked
     filter as single-node);
  2. the shards combine filters with a **bitwise-OR all-reduce**
     (all_gather + local OR over the gathered filter copies — the filter
     is KBs–MBs, so the wire cost is O(filter) and independent of table
     size);
  3. every shard probes its local partition (kernel K3,
     `ops.probe`) — no row ever crosses the interconnect.

The semi-join alternative (`distributed_semi_join`) must all-gather the
*key column itself* — O(rows) wire bytes; this asymmetry is the paper's
"succinct filter" insight mapped onto device collectives.

A sharded array is a list of per-shard tensors, entry `s` on
`mesh.devices[s]` of a `repro_torch.launch.mesh.DataMesh`, or of a
`Mesh` over ("pod", "data") (shards pod-major); concatenating the shards
on the host gives the global array. On a multi-pod mesh the filter is
OR-all-reduced over "pod" and then over "data", as the reference's is. One controller process
drives every shard, and a collective is a set of `.to(device)` copies
(peer copies between distinct GPUs). On a CPU shard K2 and K3 run their
plain torch versions; the filter is bit-identical either way. Filter
sizing and host-side batching live in `repro_torch.core.engine_bloom`
(the engine's `make_distributed_transfer` / `shard_keys` are the
strategy-facing entry points); this module owns the collectives.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bloom, device_plane, hashing
from repro_torch.parallel.sharding import axis_size

Shards = List[torch.Tensor]


def _on(dev: torch.device):
    """Make a shard's card the current CUDA device for its kernel calls:
    the kernel libraries launch on the current device (and set their
    per-device attributes there), so a shard on another card than the
    current one must switch to it."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _or_all_reduce(words: Shards, devices: Sequence) -> Shards:
    """Bitwise-OR all-reduce via all_gather + local OR (no collective
    library has an OR reduce; the gather payload is the KB-scale
    filter): every shard's words are copied onto each shard's device and
    OR-ed there.

    Wire bytes per device: (p-1)·filter. Fine for small p / small
    filters; `_or_all_reduce_tree` scales as log2(p)·filter."""
    return [functools.reduce(torch.bitwise_or,
                             [w.to(dev) for w in words])
            for dev in devices]


def _or_all_reduce_tree(words: Shards, devices: Sequence) -> Shards:
    """Recursive-doubling OR all-reduce: log2(p) rounds, each pairing
    shard i with shard i ^ step and copying one filter each way."""
    p = len(words)
    assert p & (p - 1) == 0, "power-of-two shards"
    out = list(words)
    step = 1
    while step < p:
        out = [out[i] | out[i ^ step].to(devices[i]) for i in range(p)]
        step <<= 1
    return out


def shard_axes(mesh, axis: str = "data") -> Tuple[str, ...]:
    """The axes rows are sharded over: ("pod", axis) on a multi-pod
    mesh, else (axis,). They must be every axis of a mesh with devices,
    in its order, so that shard `s` lives on `mesh.devices[s]`."""
    axes = ("pod", axis) if "pod" in mesh.axis_names else (axis,)
    if tuple(mesh.axis_names) != axes or mesh.devices is None:
        raise ValueError(f"a transfer mesh has devices and the axes "
                         f"{axes}; got {tuple(mesh.axis_names)}")
    return axes


def _axis_groups(mesh, axis: str) -> List[List[int]]:
    """The shards that differ only in their coordinate along `axis`, one
    list a group (row-major shard order)."""
    names = list(mesh.axis_names)
    sizes = [mesh.shape[a] for a in names]
    i = names.index(axis)
    inner = int(np.prod(sizes[i + 1:], dtype=np.int64))
    outer = int(np.prod(sizes[:i], dtype=np.int64))
    return [[o * sizes[i] * inner + j * inner + r for j in range(sizes[i])]
            for o in range(outer) for r in range(inner)]


def distributed_bloom_build(lo: Shards, hi: Shards, mask: Shards,
                            nblocks: int, mesh, k: int = bloom.DEFAULT_K,
                            tree_or: bool = False,
                            axis: str = "data") -> Shards:
    """Local build on every shard (K2) + OR all-reduce over each shard
    axis in turn ("pod" first on a multi-pod mesh, inside each axis's
    groups) => the global filter's words, one copy on each shard's
    device."""
    from repro_torch.kernels.bloom import ops as kb
    words = []
    for s in range(len(lo)):
        with _on(lo[s].device):
            words.append(kb.build(lo[s], hi[s], nblocks, valid=mask[s],
                                  k=k))
    reduce = _or_all_reduce_tree if tree_or else _or_all_reduce
    for a in shard_axes(mesh, axis):
        for group in _axis_groups(mesh, a):
            out = reduce([words[s] for s in group],
                         [mesh.devices[s] for s in group])
            for s, w in zip(group, out):
                words[s] = w
    return words


def make_distributed_transfer(mesh, nblocks: int,
                              k: int = bloom.DEFAULT_K, axis: str = "data",
                              tree_or: bool = False):
    """Edge transfer over row-sharded tables.

    (build_lo, build_hi, build_mask) live on the building relation's
    shards; (probe_lo, probe_hi, probe_mask) on the probing relation's.
    Returns the probing relation's reduced mask, still sharded. On a
    multi-pod mesh the rows are sharded over ("pod", axis), pod-major,
    and the filter ORed over "pod" and then over `axis`."""
    from repro_torch.kernels.bloom import ops as kb
    shard_axes(mesh, axis)
    p = len(mesh.devices)

    def edge(blo, bhi, bmask, plo, phi, pmask) -> Shards:
        words = distributed_bloom_build(blo, bhi, bmask, nblocks, mesh,
                                        k=k, tree_or=tree_or, axis=axis)
        out = []
        for s in range(p):
            with _on(plo[s].device):
                out.append(pmask[s] & kb.probe(words[s], plo[s], phi[s],
                                               k=k))
        return out
    return edge


def distributed_semi_join(mesh, axis: str = "data"):
    """Precise distributed semi-join baseline: all-gathers the build-side
    key column (O(rows) wire bytes vs the Bloom path's O(filter))."""
    p = axis_size(mesh, axis)

    def edge(bkeys: Shards, bmask: Shards, pkeys: Shards,
             pmask: Shards) -> Shards:
        out = []
        for s in range(p):
            dev = pkeys[s].device
            keys = torch.cat([b.to(dev) for b in bkeys])
            valid = torch.cat([m.to(dev) for m in bmask])
            # membership via sort: replace invalid with a sentinel
            sentinel = torch.iinfo(keys.dtype).max
            keys = torch.where(valid, keys,
                               torch.full_like(keys, sentinel))
            skeys = torch.sort(keys).values
            pos = torch.clamp(torch.searchsorted(skeys, pkeys[s]), 0,
                              len(skeys) - 1)
            out.append(pmask[s] & (skeys[pos] == pkeys[s]))
        return out
    return edge


def shard_table_arrays(keys: np.ndarray, mesh, axis: str = "data",
                       bucket: bool = False
                       ) -> Tuple[Shards, Shards, Shards]:
    """Host helper: split int64 keys into padded (lo, hi, mask) shards,
    row-sharded over `shard_axes(mesh, axis)` (the halves as their
    int32 bit pattern, the mask as bool; each upload counted by
    `device_plane`). With
    `bucket=True` the per-shard row count is rounded up to a
    power-of-two bucket (the engine's padding contract)."""
    n_shards = int(np.prod([axis_size(mesh, a)
                            for a in shard_axes(mesh, axis)]))
    n = len(keys)
    per = -(-n // n_shards)
    if bucket:
        per = bloom._bucket(per)
    pad = per * n_shards - n
    keys_p = np.concatenate([keys, np.zeros(pad, keys.dtype)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    lo, hi = hashing.key_halves(keys_p)
    out = ([], [], [])
    for s, dev in enumerate(mesh.devices):
        cut = slice(s * per, (s + 1) * per)
        for dst, arr in zip(out, (lo, hi, mask)):
            dst.append(device_plane.to_device(arr[cut], dev))
    return out
