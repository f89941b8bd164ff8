"""Step-indexed, async checkpointing of pytrees of tensors, in the
reference's on-disk format:

    step_<n>/
      manifest.json    tree structure, shapes, logical dtypes, save time
      <leaf-id>.npy    one file per leaf, in the reference's leaf order

Leaves are numbered in `train.tree.leaves` order (dict keys sorted,
NamedTuple fields in order), the reference's, and a bf16 leaf is stored
as its uint16 bit pattern with the logical dtype "bfloat16" in the
manifest, as the reference stores it: a checkpoint written by either
package restores in the other, bit for bit. bf16 crosses numpy as a
uint16 view of a torch tensor (`view(torch.bfloat16)` on the way back),
so nothing beyond torch and numpy is needed.

Writes are atomic (tmp dir + rename); `keep` bounds retained steps;
async mode copies the tree to host memory, then writes on a background
thread, so the train loop is blocked only for the device-to-host copy.
Restore places each leaf on the target leaf's device and dtype, or,
given `shardings` (a tree of `parallel.sharding.NamedSharding` on a mesh
with devices, such as `param_shardings`), as its shards on the mesh's
devices (`parallel.spmd.Sharded`): the reference's resharding restore,
which puts a checkpoint written on any mesh (or on one device) onto
another; a target leaf that is itself sharded, with no sharding given,
is restored onto its own spec and mesh. Each leaf is read once. A save
of a sharded leaf writes the whole tensor (gathered from one point a
slice), so a sharded state's checkpoint is the unsharded one's, file
for file.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.parallel import spmd as SP
from repro_torch.train.tree import leaves, unflatten


def _snapshot(tree):
    """(structure description, [(host numpy copy, logical dtype)]) of a
    tree's leaves; bf16 as its uint16 bit pattern. Always a copy: the
    optimizer updates the leaves in place while an async save writes."""
    items = []
    for leaf in leaves(tree):
        if isinstance(leaf, SP.Sharded):
            leaf = SP.gather_leaf(leaf, "cpu")
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu", copy=True)
            if t.dtype == torch.bfloat16:
                items.append((t.view(torch.int16).numpy().view(np.uint16),
                              "bfloat16"))
                continue
            arr = t.numpy()
        else:
            arr = np.array(leaf)
        items.append((arr, str(arr.dtype)))
    return _treedef(tree), items


def _write(path: str, treedef: str, items) -> None:
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"treedef": treedef, "n_leaves": len(items), "leaves": [],
                "time": time.time()}
    for i, (arr, logical) in enumerate(items):
        np.save(os.path.join(tmp, f"{i}.npy"), arr)
        manifest["leaves"].append({"shape": list(arr.shape),
                                   "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def save_tree(tree, path: str) -> None:
    """Synchronous atomic save of a pytree of tensors (or arrays)."""
    _write(path, *_snapshot(tree))


def _treedef(tree) -> str:
    """A readable description of the tree's structure (informational:
    restore takes the structure from its target)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_treedef(v) for v in tree)
        name = type(tree).__name__
        return f"{name}({inner})" if hasattr(tree, "_fields") \
            else f"[{inner}]"
    return "*"


def _from_numpy(arr: np.ndarray, logical: str, ref,
                sharding=None) -> Any:
    arr = np.asarray(arr, order="C")        # keeps a 0-d leaf 0-d
    if logical == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(ref, (torch.Tensor, SP.Sharded)):
        t = t.to(dtype=ref.dtype)
    if sharding is None and isinstance(ref, SP.Sharded):
        sharding = ref
    if sharding is not None:
        return SP.shard_leaf(t, sharding.spec, sharding.mesh)
    if isinstance(ref, torch.Tensor):
        return t.to(device=ref.device)
    return t


def restore_tree(path: str, target_tree: Any,
                 shardings: Optional[Any] = None) -> Any:
    """Restore into `target_tree`'s structure, each leaf in its target
    leaf's dtype: on its device (a sharded target leaf: onto its spec and
    mesh), or, given `shardings` (a tree of `NamedSharding` in the
    target's structure), as its shards on the sharding's mesh. Raises
    AssertionError on a leaf count or shape mismatch, as the reference
    does."""
    flat = leaves(target_tree)
    shard_flat = leaves(shardings) if shardings is not None \
        else [None] * len(flat)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["n_leaves"] == len(flat), \
        f"checkpoint has {manifest['n_leaves']} leaves, target {len(flat)}"
    assert len(shard_flat) == len(flat), \
        f"{len(shard_flat)} shardings for {len(flat)} leaves"
    out = []
    for i, (ref, sh) in enumerate(zip(flat, shard_flat)):
        arr = np.load(os.path.join(path, f"{i}.npy"))
        expect = tuple(ref.shape) if hasattr(ref, "shape") \
            else tuple(np.shape(ref))
        assert tuple(arr.shape) == expect, \
            f"leaf {i}: ckpt {arr.shape} != target {expect}"
        out.append(_from_numpy(arr, manifest["leaves"][i]["dtype"], ref,
                               sh))
    return unflatten(target_tree, out)


class CheckpointManager:
    """Step-indexed manager with retention + async save."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        # snapshot to host now (blocking: the device-to-host copy) ...
        snap = _snapshot(tree)

        def work():
            _write(self._step_dir(step), *snap)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, step: int, target_tree: Any,
                shardings: Optional[Any] = None) -> Any:
        self.wait()
        return restore_tree(self._step_dir(step), target_tree, shardings)

    def restore_latest(self, target_tree: Any,
                       shardings: Optional[Any] = None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target_tree, shardings)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
