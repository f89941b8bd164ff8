"""Sharded execution on a mesh of torch devices, driven by one process.

The reference runs a sharded model through XLA's SPMD partitioner: its
leaves are placed with `jax.device_put(params, param_shardings(...))`
and the same jitted program runs partitioned, the partitioner adding
the collectives. The port has no partitioner. This module is its
counterpart, under the rule of the distributed runtime (ROADMAP item 8):
one controller drives every point of a `launch.mesh.Mesh`, and a
collective is a set of `.to(device)` copies (peer copies between
distinct GPUs, plain copies on one card; a device may repeat).

  * A sharded leaf (`Sharded`) is a partition spec `P`, its mesh and
    one local tensor a mesh point, on that point's device. A dim split
    over axes (a1, a2, ...) is cut into prod(sizes) equal slices, and a
    point takes the slice at its flattened coordinate over those axes in
    the spec's order (a1 major), as `jax.device_put` lays out a
    `NamedSharding`. Points that hold the same slice hold copies.
  * `shard_tree` turns full tensors into sharded leaves under a spec
    tree (`parallel.sharding.param_specs`, `batch_spec`); `gather_tree`
    turns them back. `init_sharded` draws a model's parameters a leaf at
    a time straight into shards (the same values as `init` then
    `shard_tree`), so a model too large for one device never exists
    whole.
  * `run(mesh, fn, *args)` calls `fn` once a mesh point, each on a
    thread of its own, with every sharded leaf of `args` replaced by the
    point's local tensor. Each thread makes the mesh ambient
    (`launch.mesh.set_mesh`), takes the caller's attention backend and
    grad mode (both are per thread), sets its shard context (`context`:
    its coordinates) and, on CUDA, runs on a stream of its own. The
    layer library reads the context and calls the collectives below at
    the reference's hint sites; with no context it runs unsharded.
  * A point's tensor of a sharded leaf carries the leaf's spec, so the
    layer library asks which axes a dim is split over (`split_axes`,
    `offset`) and gathers from that (`whole`) instead of working it out
    from shapes: the split is decided once, in the spec tree. `index`
    takes a stacked leaf's layer and keeps the spec of the other dims.
  * `all_reduce(x, axes)` and `all_gather(x, axes, dim)` run inside the
    groups of points that differ only on `axes` (a name or a tuple of
    names; a name the mesh lacks counts as size 1). Every point calls
    every collective in the same order, so each is one rendezvous of
    the whole mesh. `all_reduce` sums the group's tensors in shard order
    (the flattened coordinate over `axes`) in f32 (or wider) into a new
    tensor, cast once to the input's dtype: every point of a group gets
    the same bits, and no result aliases a point's own buffer.
    `all_gather` concatenates them along `dim` in that order.

Counts. `COMM` counts collective calls and bytes, summed over the
points (every point makes every call): `all_reduce` and `all_gather`
each add one a point a call, and `*_bytes` add the bytes a point
receives, the (n - 1) other tensors of its group of n. A point's share
is the count over the mesh size. For a prefill or decode call of a
model of L layers, attention heads split over a model axis of size
tp > 1 and a vocabulary that tp divides, a point calls `all_reduce`
once for the embedding, once a layer for attention's `wo` and once a
layer for the FFN's `w2` (or the MoE's combine) where the FFN is split,
and `all_gather` once for the logits; with `fsdp` each weight a layer
uses that is split over "data" adds one `all_gather` (wq, wk, wv, wo;
w1, w3, w2; the MoE's router, w1, w3, w2), and the LM head one more.

CUDA streams. A point's collective deposit records an event on its
stream; a reader's stream waits on it before reading, and the deposited
tensor is recorded on the reader's stream, so the caching allocator
does not hand its memory back while a read is pending. Each point's
stream starts after the caller's stream, and the caller's stream waits
on every point's before `run` returns.

Turns. The points' threads share one interpreter lock, and every
torch op lets it go while it dispatches: with several points ready to
dispatch, the lock changes hands at every op. So the points take turns:
a point runs its Python only while it holds the mesh's turn lock, from
one rendezvous to the next, and lets the turn go while it waits at a
rendezvous. On CUDA the device work stays asynchronous, so the points'
kernels still overlap; on the CPU the points' ops run one point at a
time.

No hangs. Every rendezvous waits at most `timeout` seconds. The first
exception a point raises aborts the rendezvous, the other points fail
at their next one, and `run` raises that first exception in the caller
within `timeout`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.build import LaunchCounts
from repro_torch.launch.mesh import set_mesh
from repro_torch.parallel.sharding import P

#: seconds a rendezvous (or a wait for the turn) waits before the run
#: is failed
DEFAULT_TIMEOUT = 300.0

COMM = LaunchCounts("all_reduce", "all_gather", "all_reduce_bytes",
                    "all_gather_bytes")


def reset_counts() -> None:
    COMM.reset()


# --------------------------------------------------------------------------
# sharded leaves
# --------------------------------------------------------------------------


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def point_coords(mesh, point: int) -> Dict[str, int]:
    """A point's coordinate on each axis (points are row-major)."""
    out, rest = {}, point
    for name, size in reversed(list(zip(mesh.axis_names, mesh.axis_sizes))):
        out[name] = rest % size
        rest //= size
    return {name: out[name] for name in mesh.axis_names}


def _flat(mesh, coords: Dict[str, int], axes: Sequence[str]) -> int:
    idx = 0
    for a in axes:
        if a in coords:
            idx = idx * mesh.shape[a] + coords[a]
    return idx


def _ways(mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape.get(a, 1) for a in axes)


def local_slices(shape, spec: P, mesh, point: int) -> Tuple[slice, ...]:
    """The slice of a full tensor of `shape` that `point` holds under
    `spec`; raises ValueError where a dim does not divide."""
    coords = point_coords(mesh, point)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = _axes(entry)
        n = _ways(mesh, axes)
        if dim % n:
            raise ValueError(f"dim {dim} does not split {n} ways over "
                             f"{axes} (spec {spec})")
        size = dim // n
        i = _flat(mesh, coords, axes)
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A tensor of `shape` split over `mesh` by `spec`: `shards[i]` is
    mesh point i's slice, on `mesh.devices[i]`."""

    spec: P
    mesh: Any
    shards: Tuple[torch.Tensor, ...]
    shape: Tuple[int, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def local_bytes(self, point: int) -> int:
        t = self.shards[point]
        return t.numel() * t.element_size()


def _devices(mesh) -> Tuple[torch.device, ...]:
    """The mesh's devices, a CUDA device without an index as the current
    one."""
    if getattr(mesh, "devices", None) is None:
        raise ValueError("sharded execution needs a mesh with devices "
                         "(launch.mesh.make_test_mesh(..., devices=...))")
    devs = [torch.device(d) for d in mesh.devices]
    return tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d
                 for d in devs)


def shard_leaf(t: torch.Tensor, spec: P, mesh) -> Sharded:
    """Full tensor `t` -> its shards on the mesh's devices (each point a
    contiguous copy of its slice, whatever device `t` is on)."""
    devs = _devices(mesh)
    spec = P(*spec)
    shards = tuple(
        _tag(t[local_slices(t.shape, spec, mesh, i)].to(
            devs[i], copy=True, memory_format=torch.contiguous_format),
            spec)
        for i in range(mesh.size))
    return Sharded(spec, mesh, shards, tuple(t.shape))


def gather_leaf(x: Sharded, device=None) -> torch.Tensor:
    """The full tensor of `x` on `device` (default: point 0's), built
    from one point a slice."""
    dev = torch.device(device) if device is not None else \
        x.shards[0].device
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    done = set()
    for i in range(x.mesh.size):
        sl = local_slices(x.shape, x.spec, x.mesh, i)
        key = tuple((s.start, s.stop) for s in sl)
        if key not in done:
            done.add(key)
            out[sl] = x.shards[i].to(dev)
    return out


def _map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (dicts, lists, tuples, NamedTuples
    and dataclass records such as the caches), with the matching nodes
    of `rest` (spec trees)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, *xs) for xs in zip(tree, *rest)]
    if isinstance(tree, tuple) and not isinstance(tree, P):
        vals = [_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, Sharded) \
            and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name),
                         *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def shard_tree(tree, specs, mesh):
    """Every tensor leaf of `tree` sharded by its spec in `specs` (a
    tree of the same structure); sharded leaves, host ints and None are
    kept as they are."""
    def one(leaf, spec):
        if isinstance(leaf, torch.Tensor):
            return shard_leaf(leaf, spec, mesh)
        return leaf
    return _map(one, tree, specs)


def gather_tree(tree, device=None):
    """Every sharded leaf of `tree` as its full tensor on `device`."""
    return _map(lambda x: gather_leaf(x, device)
                if isinstance(x, Sharded) else x, tree)


def local(tree, point: int):
    """`tree` with every sharded leaf replaced by point `point`'s
    tensor."""
    return _map(lambda x: x.shards[point] if isinstance(x, Sharded)
                else x, tree)


def tree_local_bytes(tree, point: int) -> int:
    """Bytes of the tensors point `point` holds in `tree`."""
    total = 0

    def add(x):
        nonlocal total
        if isinstance(x, Sharded):
            total += x.local_bytes(point)
        return x
    _map(add, tree)
    return total


def init_sharded(draw: Callable[[], Any], specs, mesh):
    """`draw()` (a model's `init`: a tree drawn by `models.common.
    init_params`) with each drawn leaf sharded by its spec as soon as it
    is drawn, so the whole tree never exists at once: the device of the
    draws holds the shards so far and one full leaf. The values are
    those of `shard_tree(draw(), specs, mesh)`: `draw` runs twice, first
    drawing nothing (to learn which leaves it draws, in its order), then
    for real."""
    from repro_torch.models import common as C
    order: List[Tuple] = []

    def dry(shape, dtype, _draw):
        return torch.empty(shape, dtype=dtype, device="meta")
    with C.placing(dry):
        skeleton = draw()

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        elif node.device.type == "meta":
            order.append(path)
    walk(skeleton, ())
    del skeleton
    todo = iter(order)

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def place(shape, dtype, _draw):
        return shard_leaf(_draw(), at(specs, next(todo)), mesh)
    with C.placing(place):
        tree = draw()
    return shard_tree(tree, specs, mesh)


# --------------------------------------------------------------------------
# the shard context and the collectives
# --------------------------------------------------------------------------


class _World:
    """What the points of one `run` share: the rendezvous, the turn lock,
    two deposit slots (call k uses slot k % 2: a point deposits call
    k + 2 only after every point has passed call k + 1's rendezvous, so
    after every read of call k), the first error and the groups."""

    def __init__(self, mesh, timeout: float):
        self.mesh = mesh
        self.timeout = timeout
        self.barrier = threading.Barrier(mesh.size, timeout=timeout)
        self.turn = threading.Lock()
        self.slots: List[List[Any]] = [[None] * mesh.size,
                                       [None] * mesh.size]
        self.error: Optional[BaseException] = None
        self.lock = threading.Lock()
        self.groups: Dict[Tuple[int, Tuple[str, ...]], List[int]] = {}

    def fail(self, exc: BaseException) -> None:
        with self.lock:
            if self.error is None:
                self.error = exc
        self.barrier.abort()

    def group(self, point: int, axes: Tuple[str, ...]) -> List[int]:
        key = (point, axes)
        g = self.groups.get(key)
        if g is None:
            mesh = self.mesh
            me = point_coords(mesh, point)
            members = [q for q in range(mesh.size)
                       if all(c == me[a] for a, c in
                              point_coords(mesh, q).items()
                              if a not in axes)]
            g = sorted(members, key=lambda q: _flat(
                mesh, point_coords(mesh, q), axes))
            with self.lock:
                self.groups[key] = g
        return g


@dataclasses.dataclass
class ShardContext:
    """A mesh point's view of a `run`: its index, coordinates and
    device, and how many ways the batch is split over the data axes
    (`batch_ways`: the MoE routes the local tokens in dp_size() /
    batch_ways groups)."""

    mesh: Any
    point: int
    coords: Dict[str, int]
    device: torch.device
    batch_ways: int
    world: _World
    calls: int = 0
    has_turn: bool = False

    def size(self, axes) -> int:
        return _ways(self.mesh, _axes(axes))

    def take_turn(self) -> None:
        if not self.world.turn.acquire(timeout=self.world.timeout):
            raise RuntimeError(f"spmd: point {self.point} waited past its "
                               "timeout for its turn")
        self.has_turn = True

    def give_turn(self) -> None:
        if self.has_turn:
            self.has_turn = False
            self.world.turn.release()


_TLS = threading.local()


def context() -> Optional[ShardContext]:
    """The calling thread's shard context inside `run`, else None."""
    return getattr(_TLS, "ctx", None)


def _need() -> ShardContext:
    ctx = context()
    if ctx is None:
        raise RuntimeError("a collective runs only inside spmd.run")
    return ctx


def _exchange(x: torch.Tensor, axes, kind: str) -> List[torch.Tensor]:
    """Deposit `x`, meet every point, and read the group's tensors over
    `axes` in shard order, each on this point's device (this point's own
    is `x`)."""
    ctx = _need()
    world, axes = ctx.world, _axes(axes)
    slot = world.slots[ctx.calls % 2]
    ctx.calls += 1
    event = None
    if x.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(x.device))
    slot[ctx.point] = (x, event)
    ctx.give_turn()
    try:
        world.barrier.wait()
    except threading.BrokenBarrierError:
        raise RuntimeError(f"spmd: point {ctx.point} left a {kind}: "
                           "another point failed or timed out") from None
    ctx.take_turn()
    out, received = [], 0
    for q in world.group(ctx.point, axes):
        t, ev = slot[q]
        if q != ctx.point:
            if t.is_cuda:
                stream = torch.cuda.current_stream(t.device)
                stream.wait_event(ev)
                t.record_stream(stream)
            t = t.to(ctx.device)
            received += t.numel() * t.element_size()
        out.append(t)
    COMM.bump(kind)
    COMM.bump(kind + "_bytes", received)
    return out


def all_reduce(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of `x` over the group of points that differ on `axes`, in
    shard order, accumulated in f32 (or `x`'s dtype if wider), cast to
    `x`'s dtype; a new tensor on every point."""
    parts = _exchange(x, axes, "all_reduce")
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    acc = parts[0].to(acc_dtype, copy=True)
    for t in parts[1:]:
        acc += t.to(acc_dtype)
    return acc.to(x.dtype)


def all_gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """`x` of every point of the group over `axes`, concatenated along
    `dim` in shard order."""
    return torch.cat(_exchange(x, axes, "all_gather"), dim=dim)


def _tag(t: torch.Tensor, spec) -> torch.Tensor:
    """`t`, marked as a point's tensor of a leaf split by `spec`."""
    t._spmd_spec = P(*spec)
    return t


def split_axes(t: torch.Tensor, dim: int) -> Tuple[str, ...]:
    """The axes along which a point's tensor `t` of a sharded leaf is
    split at `dim` (its spec's entry, where those axes hold more than one
    point); () outside `run`, at a whole dim, and for any other tensor."""
    ctx, spec = context(), getattr(t, "_spmd_spec", None)
    if ctx is None or spec is None:
        return ()
    axes = _axes((tuple(spec) + (None,) * t.dim())[dim % t.dim()])
    return axes if _ways(ctx.mesh, axes) > 1 else ()


def offset(t: torch.Tensor, dim: int) -> int:
    """Where this point's slice of the leaf starts along `dim` (0 where
    the dim is whole)."""
    axes = split_axes(t, dim)
    if not axes:
        return 0
    ctx = _need()
    return _flat(ctx.mesh, ctx.coords, axes) * t.shape[dim]


def whole(t: torch.Tensor, axis: str) -> torch.Tensor:
    """A point's tensor `t` of a sharded leaf all-gathered along every
    dim split over `axis` (over all that dim's axes), keeping the spec of
    the others; `t` itself where no dim is."""
    for dim in range(t.dim()):
        axes = split_axes(t, dim)
        if axis in axes:
            spec = list(t._spmd_spec) + [None] * (t.dim() - len(t._spmd_spec))
            spec[dim] = None
            t = _tag(all_gather(t, axes, dim), spec)
    return t


def index(t: torch.Tensor, r: int) -> torch.Tensor:
    """`t[r]`: a stacked leaf's layer r, keeping the spec of the other
    dims where `t` is a point's tensor of a sharded leaf."""
    out = t[r]
    spec = getattr(t, "_spmd_spec", None)
    return out if spec is None else _tag(out, tuple(spec)[1:])


def require_unsharded(what: str) -> None:
    """Raise where `what` runs inside `run` on more than one point: the
    sharded execution of the block kinds outside the serving slice is
    ROADMAP item 10e.2."""
    ctx = context()
    if ctx is not None and ctx.mesh.size > 1:
        raise NotImplementedError(
            f"{what} does not run sharded yet (ROADMAP item 10e.2)")


# --------------------------------------------------------------------------
# run
# --------------------------------------------------------------------------


def _cuda_tensors(tree):
    found = []

    def visit(x):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            found.append(x)
        return x
    _map(visit, tree)
    return found


def run(mesh, fn: Callable, *args, timeout: float = DEFAULT_TIMEOUT,
        batch_ways: int = 1) -> List[Any]:
    """`fn(*args)` once a mesh point, each on its own thread, every
    sharded leaf of `args` replaced by the point's tensor; returns the
    points' results in point order. `batch_ways` is how many ways the
    batch in `args` is split over the data axes (1: every point holds
    the whole batch). Raises the first exception a point raised (within
    `timeout` of it), or RuntimeError if a rendezvous waited longer than
    `timeout`."""
    from repro_torch.models import layers as L
    devs = _devices(mesh)
    world = _World(mesh, timeout)
    backend = L.current_attention_backend()
    grad = torch.is_grad_enabled()
    callers = {d: torch.cuda.current_stream(d) for d in set(devs)
               if d.type == "cuda"}
    results: List[Any] = [None] * mesh.size
    ends: List[Optional[torch.cuda.Event]] = [None] * mesh.size
    done = threading.Semaphore(0)

    def body(point: int) -> None:
        dev = devs[point]
        ctx = _TLS.ctx = ShardContext(mesh, point, point_coords(mesh, point),
                                      dev, batch_ways, world)
        try:
            ctx.take_turn()
            with contextlib.ExitStack() as stack:
                stack.enter_context(set_mesh(mesh))
                stack.enter_context(L.attention_backend(backend))
                stack.enter_context(torch.set_grad_enabled(grad))
                if dev.type == "cuda":
                    stream = torch.cuda.Stream(dev)
                    stream.wait_stream(callers[dev])
                    stack.enter_context(torch.cuda.device(dev))
                    stack.enter_context(torch.cuda.stream(stream))
                results[point] = fn(*local(args, point))
                if dev.type == "cuda":
                    ends[point] = torch.cuda.Event()
                    ends[point].record(stream)
        except BaseException as exc:        # handed to the caller below
            world.fail(exc)
        finally:
            ctx.give_turn()
            _TLS.ctx = None
            done.release()

    threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                name=f"spmd-point-{i}")
               for i in range(mesh.size)]
    for t in threads:
        t.start()
    finished = 0
    while finished < mesh.size:
        # a failed point aborts the rendezvous: the others end at their
        # next one, so wait for them at most `timeout` more
        if done.acquire(timeout=timeout if world.error is not None
                        else 1.0):
            finished += 1
        elif world.error is not None:
            break
    if world.error is not None:
        raise world.error
    for point, ev in enumerate(ends):
        if ev is not None:
            callers[devs[point]].wait_event(ev)
    for point, res in enumerate(results):
        for t in _cuda_tensors(res):
            t.record_stream(callers[t.device])
    return results


def gather_results(mesh, spec: P, parts: Sequence[torch.Tensor],
                   device=None) -> torch.Tensor:
    """The full tensor of which `parts[i]` is point i's slice under
    `spec` (such as each point's logits rows under `batch_spec`)."""
    shape = list(parts[0].shape)
    for d, entry in enumerate(tuple(spec)[:len(shape)]):
        shape[d] *= _ways(mesh, _axes(entry))
    return gather_leaf(Sharded(spec, mesh, tuple(parts), tuple(shape)),
                       device)
