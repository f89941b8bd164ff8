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

Gradients. Under autograd the collectives are `torch.autograd.Function`s
with the conjugate backward, in the Megatron convention: over the model
axes a point's gradient of a value every point holds alike is the whole
gradient (the same on every point), over the axes that split the batch
(`ShardContext.batch_axes`) it is the point's own data's share.
`all_reduce` (partial outputs summed) backs the identity; `all_gather`
keeps the point's slice of the gradient, summed over the gathered axes
that split the batch (a reduce-scatter: FSDP's weights, used by every
data shard) and taken as it is over the others (the vocab-parallel
logits); `copy`, where an activation held alike enters compute split
over some axes, all-reduces its gradient over them. A training step
then sums each leaf's gradient over the batch's axes the leaf is not
split over (`data_parallel_sum`). Each Function keeps its point's
context from the forward and raises if its backward runs on another
thread: `run` turns multithreaded backward off in each point's thread
(`torch.autograd.set_multithreading_enabled(False)`), so a backward, and
a remat recomputation within it, runs on the point's own thread,
context, stream and turn (on CUDA autograd would otherwise run it on
one worker thread per device, which the points of one card share).

Counts. `COMM` counts collective calls and bytes, summed over the
points (every point makes every call): `all_reduce`, `all_gather` and
`reduce_scatter` each add one a point a call, and `*_bytes` add the
bytes a point receives, the (n - 1) other tensors (a reduce-scatter:
their slices) of its group of n. A point's share
is the count over the mesh size. For a prefill or decode call of a
model of L layers, attention heads split over a model axis of size
tp > 1 and a vocabulary that tp divides, a point calls `all_reduce`
once for the embedding, once a layer for attention's `wo` and once a
layer for the FFN's `w2` (or the MoE's combine) where the FFN is split,
and `all_gather` once for the logits; with `fsdp` each weight a layer
uses that is split over "data" adds one `all_gather` (wq, wk, wv, wo;
w1, w3, w2; the MoE's router, w1, w3, w2), and the LM head one more.
An MLA layer that splits over "model" (`layers.mla_split` tp > 1) calls,
for a call of S tokens on b local batch rows, latent rank r, rope dims
dr, width d and element bytes e, against a cache of cap slots:
`all_gather` 3 times, the latent and rope caches along their last dim
and w_kr whole, (tp - 1) e (b cap (r + dr) + d dr) / tp bytes in all;
without a cache (the loss) twice, the latent of the call and w_kr,
(tp - 1) e (b S r + d dr) / tp bytes; `all_reduce` once, wo's,
(tp - 1) e b S d bytes; with `fsdp` over a data axis of dp > 1, 7
gathers more, wq, w_qr, w_dkv, w_kr, w_uk, w_uv and wo over "data",
(dp - 1) e W / (dp tp) bytes for their W elements. The patch prefix
(llava) adds one `all_gather` a call, (tp - 1) e b P d / tp bytes for P
patches, and whisper's frames the same for its Se frames a call that
encodes (with `fsdp`, one gather more each, of `patch_proj` or
`frame_proj` over "data"). A Mamba-2 layer that splits over "model"
(`layers.mamba_split` tp > 1), with d_inner = expand d, H heads, state
N, conv channels c = d_inner + 2 N and in_proj's W = d_inner + c + H
columns, calls `all_gather` twice, in_proj's output and the conv's,
(tp - 1) e b S (W + c) / tp bytes, and `all_reduce` once, out_proj's,
(tp - 1) e b S d bytes; with `fsdp` over a data axis of dp > 1, 2
gathers more, in_proj and out_proj over "data", (dp - 1) e d (W +
d_inner) / (dp tp) bytes. Whisper's encoder layer (attention without a
cache, then the MLP) calls `all_reduce` twice, and a cross-attention
layer once (wo's, (tp - 1) e b S d bytes; with `fsdp`, 4 gathers more,
wq, wk, wv and wo); a vocabulary tp does not divide (whisper's) is
whole on every point, so the embedding adds no all-reduce and the
logits no gather. A stacked leaf whose layer dim is split (deepseek's
shared experts under expert parallelism: the rules give them the
experts' spec) is all-gathered along it once a call (`models.model.
Model.backbone`), the layers a point does not hold.

Context parallelism. An attention layer whose heads tp does not split
whole (`layers.seq_split` tp > 1; H query and KVH kv heads of hd, width
d) gathers its leaves that "model" splits (wq, wk, wv, wo and the QKV
biases, flattened into one: `whole_all`) at every call, one gather of
(tp - 1) e W / tp bytes for their W elements (none where "model" splits
no leaf), and no wo all-reduce; where tp divides the call's S tokens it also
gathers k and v, (tp - 1) e b S KVH hd 2 / tp bytes, and y, (tp - 1) e b
S d / tp bytes (3 gathers). An MLA layer that tp splits by sequence
(where tp divides none of its heads, r and dr) calls the same, its 7
leaves in the one gather and c_kv and k_rope in place of k and v,
(tp - 1) e b S (r + dr) / tp bytes. A cache whose slots are split over n points
(`layers.cache_split`: over "data" where the batch does not divide the
data axes, and over "model" under the sequence split) adds one gather a
decode step a layer, of each point's f32 output and log-sum-exp, (n -
1) 4 b h (hd + 1) bytes for its h query heads (H, or H / tp where the
heads split); a prefill into an empty cache that holds it adds none, and
any other call with more than one token gathers the written K and V
slots, 2 gathers of (n - 1) e b cap KVH' hd / n bytes (KVH' the point's
kv heads; MLA's latent and rope slots, (n - 1) e b cap (r + dr) / n).

Batch 1. At a batch the data axes do not divide (`layers.whole_batch`)
MLA's latent and rope caches hold a point's range of the slots over
"data" at every column, and a Mamba-2 layer's SSM state the heads of its
"data" coordinate (`layers.ssm_split`), as `cache_spec` lays them out.
An MLA layer that splits over "model" then calls, for a call of S
tokens: `all_gather` twice, w_kr whole and the call's latent along r,
(tp - 1) e (d dr + b S r) / tp bytes (no cache is gathered over
"model"), and `all_reduce` once, wo's, (tp - 1) e b S d bytes; where
its slots are split over n data points a decode step adds the merge,
one gather of (n - 1) 4 b (H / tp) (hd + 1) bytes (hd, v's head size),
a prefill into an empty cache that holds it nothing, and any other
call of more than one token 2 gathers of the written slots, (n - 1) e b
cap (r + dr) / n bytes. Where tp is 1 only the merge and the written
slots' gathers remain. A prefill and a decode step of a Mamba-2 layer
call what they call at any batch (in_proj's and the conv's outputs
gathered and out_proj's sum, where the mixer splits over "model") and,
where "data" splits the heads (dp data points dividing H), one
`all_gather` more: the gated output over "data", (dp - 1) e b S
d_inner / dp bytes. `serve_comm` sums these, with the embedding's, the
logits', the MLP's and the MoE's, for a model's serve passes.

A train step (`train.step.build_train_step(..., mesh=)`, remat on) of a
dense model of L layers whose heads, d_ff and vocabulary V split over a
model axis of size tp, with the batch split over the data axes, "pod"
and "data", of w points in all (each microbatch t tokens a point, its
loss in c chunks of t_c) and, with FSDP, the weights over "data", of
size dp, too; e the parameters' element bytes, d
the model width, W the weights' elements (wq, wk, wv, wo, w1, w2, w3) a
layer and H = d V the LM head's. Each of m microbatches, a point calls:
  * all_reduce 2 + 5 L + c times: the embedding, wo and w2 a layer (the
    forward), wo a layer again (the remat recomputation runs a block
    forward up to its last saved tensor, which comes before w2's sum),
    the q/k/v and w1/w3 copies' backward a layer, the LM head copy's
    backward a chunk, and the loss's sum and count over the data axes
    (where w > 1): (tp - 1) e d t bytes each (t_c for a chunk's), (w -
    1) 8 for the loss;
    under the sequence split (attention or MLA; the leaves no layer of
    which "model" splits need no gather) in place of a layer's wo sums
    and q/k/v copy: all_gather 2 times, its split leaves in the forward
    and the recomputation ((tp - 1) e W_s / tp bytes each), and where
    tp divides the sequence 6 more, k and v (MLA: c_kv and k_rope) and
    y in both ((tp - 1) e t (kv + d) / tp bytes a pass, kv = 2 KVH hd or
    r + dr), and all_reduce 3 + n_w times in the backward, the copies of
    h, of each of its n_w leaves and of k and v ((tp - 1) e (t d + W + t
    kv) bytes in all, W its leaves' elements); a MoE whose d_ff_expert
    tp splits (not expert parallel) in place of w2's sums: all_reduce of
    the f32 combine in the forward (and the recomputation where its
    shared experts' sum follows it), its shared experts' w2 in the
    forward, and in the backward the copies of h and of the routing
    weights (f32, top-k a token) and the shared experts' h; with the
    batch split (w > 1) its auxiliary loss's sums twice ((w - 1) 4 2E
    bytes);
  * all_gather 2 c times, the f32 logits of a chunk over "model" in the
    forward and the recomputation, (tp - 1) 4 t_c V / tp bytes; with FSDP
    also 14 L + 1 times, each weight a layer in the forward and the
    recomputation and the LM head once: (dp - 1) e (2 L W + H) / (dp tp)
    bytes in all;
  * reduce_scatter (with FSDP) 7 L + 1 times, each gathered weight's
    backward, (dp - 1) e (L W + H) / (dp tp) bytes in all.
Then once a step: all_reduce of each leaf's f32 gradient over the data
axes that do not split it, where they hold more than one point ((n - 1)
4 bytes an element the point holds, n their points: with FSDP "pod"
for the weights "data" splits, and both for the embedding, the norms
and the QKV biases; without, both for every leaf), and of the gradient
norm's sums once for each set of axes that splits some leaf ((n - 1) 4
bytes a leaf of it, n the points of its group). `train_comm` computes
it.

Counting. Inside `counting(point)` a collective meets no one: `run`
calls `fn` once, for `point` alone, on the caller's thread (under the
context stack a point's thread has), and each collective returns
shape-true tensors (the point's own repeated for the group, or its
slice for a reduce-scatter) and counts the call twice into the counts
`counting` yields, a point's: under COMM's rule (`all_reduce`, ...,
`*_bytes`: the bytes the point receives) and under the rule of the
reference's HLO accounting (`*_output_bytes`: the bytes of the
collective's result, the gathered tensor, the sum in its dtype, the
point's slice). Every point makes every call and receives the same
bytes, so the count times the mesh's size is COMM's of a real `run`.
The mesh's devices are "meta" (an abstract mesh serves), `shard_leaf`
builds the counted point's slice alone (on "meta", standing for every
point's) and `gather_leaf` a meta tensor; a tensor that reaches a
collective off "meta" raises, so a count never runs on real values.

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

import collections
import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.build import LaunchCounts
from repro_torch.launch.mesh import set_mesh
from repro_torch.models.common import abstract_params, layer_layout
from repro_torch.parallel.sharding import P
from repro_torch.parallel.sharding import batch_axes as batch_axes_of
from repro_torch.parallel.sharding import param_specs, spec_leaves
from repro_torch.train.tree import leaves

#: seconds a rendezvous (or a wait for the turn) waits before the run
#: is failed
DEFAULT_TIMEOUT = 300.0

_KINDS = ("all_reduce", "all_gather", "reduce_scatter")
COMM = LaunchCounts(*_KINDS, *(k + "_bytes" for k in _KINDS))
#: what `counting` counts, a point's: COMM's keys and each kind's bytes
#: of output
COUNTED = (*COMM, *(k + "_output_bytes" for k in _KINDS))


def reset_counts() -> None:
    COMM.reset()


_TLS = threading.local()


@dataclasses.dataclass(frozen=True)
class _Counting:
    point: int
    counts: LaunchCounts


def _counting() -> Optional[_Counting]:
    return getattr(_TLS, "counting", None)


@contextlib.contextmanager
def counting(point: int = 0):
    """`with counting(point) as counts:` every `run` in this thread runs
    mesh point `point` alone on the meta device, its collectives meeting
    no one and counted into `counts` (`COUNTED`, a point's: the module's
    note)."""
    if _counting() is not None or context() is not None:
        raise RuntimeError("spmd.counting: already counting or in a run")
    counts = LaunchCounts(*COUNTED)
    _TLS.counting = _Counting(point, counts)
    try:
        yield counts
    finally:
        _TLS.counting = None


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
    one; "meta" for every point when counting."""
    if _counting() is not None:
        return (torch.device("meta"),) * mesh.size
    if getattr(mesh, "devices", None) is None:
        raise ValueError("sharded execution needs a mesh with devices "
                         "(launch.mesh.make_test_mesh(..., devices=...))")
    devs = [torch.device(d) for d in mesh.devices]
    return tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d
                 for d in devs)


def shard_leaf(t: torch.Tensor, spec: P, mesh) -> Sharded:
    """Full tensor `t` -> its shards on the mesh's devices (each point a
    contiguous copy of its slice, whatever device `t` is on; when
    counting, the counted point's slice on "meta" for every point)."""
    devs = _devices(mesh)
    spec = P(*spec)
    mode = _counting()
    if mode is not None:
        one = _tag(t[local_slices(t.shape, spec, mesh, mode.point)].to(
            devs[0], copy=True, memory_format=torch.contiguous_format),
            spec)
        return Sharded(spec, mesh, (one,) * mesh.size, tuple(t.shape))
    shards = tuple(
        _tag(t[local_slices(t.shape, spec, mesh, i)].to(
            devs[i], copy=True, memory_format=torch.contiguous_format),
            spec)
        for i in range(mesh.size))
    return Sharded(spec, mesh, shards, tuple(t.shape))


def gather_leaf(x: Sharded, device=None) -> torch.Tensor:
    """The full tensor of `x` on `device` (default: point 0's), built
    from one point a slice; a meta tensor when counting."""
    if _counting() is not None:
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
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


def join(template, parts: Sequence[Any]):
    """The points' trees `parts` (what `run` returns, in point order) as
    one tree: a sharded leaf wherever `template` has one (its spec, mesh
    and shape, the points' tensors as its shards), point 0's value
    elsewhere."""
    def one(tmpl, *ps):
        if isinstance(tmpl, Sharded):
            return Sharded(tmpl.spec, tmpl.mesh,
                           tuple(_tag(p, tmpl.spec) for p in ps), tmpl.shape)
        return ps[0]
    return _map(one, template, *parts)


def init_state(init: Callable, params, place: Callable):
    """`init` (an optimizer's) of the sharded `params`, run on every
    point over its own shards and on its device, joined under the specs
    `place(state, param_specs, mesh)` gives (`launch.dryrun.
    opt_shardings`): a sharded state never whole on one device. Its
    shapes are `init`'s of the parameters' meta twins."""
    found = []
    _map(lambda x: found.append(x) if isinstance(x, Sharded) else x, params)
    mesh = found[0].mesh
    meta = _map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                      device="meta"), params)
    abstract = init(meta)
    specs = place(abstract, _map(lambda x: x.spec, params), mesh)
    template = _map(lambda a, s: Sharded(P(*s), mesh, (), tuple(a.shape)),
                    abstract, specs)
    return join(template, run(mesh, init, params))


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
    batch_ways groups). Counting, it has no world and counts into
    `counts`."""

    mesh: Any
    point: int
    coords: Dict[str, int]
    device: torch.device
    batch_ways: int
    world: Optional[_World]
    counts: Optional[LaunchCounts] = None
    calls: int = 0
    has_turn: bool = False

    def size(self, axes) -> int:
        return _ways(self.mesh, _axes(axes))

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The axes that split the batch ("pod", "data": the sharding
        rules' `batch_axes`), () where the batch is whole on every
        point (`batch_ways` 1)."""
        return batch_axes_of(self.mesh) if self.batch_ways > 1 else ()

    def take_turn(self) -> None:
        if not self.world.turn.acquire(timeout=self.world.timeout):
            raise RuntimeError(f"spmd: point {self.point} waited past its "
                               "timeout for its turn")
        self.has_turn = True

    def give_turn(self) -> None:
        if self.has_turn:
            self.has_turn = False
            self.world.turn.release()


def context() -> Optional[ShardContext]:
    """The calling thread's shard context inside `run`, else None."""
    return getattr(_TLS, "ctx", None)


def _need() -> ShardContext:
    ctx = context()
    if ctx is None:
        raise RuntimeError("a collective runs only inside spmd.run")
    return ctx


def _count(ctx: ShardContext, x: torch.Tensor, axes, kind: str,
           take: Optional[Callable], dtype) -> List[torch.Tensor]:
    """`_exchange` when counting: the group's tensors stand as this
    point's, and the call is counted under both rules (the module's
    note; `dtype` the result's where it is not `x`'s)."""
    if x.device.type != "meta":
        raise RuntimeError(
            f"spmd.counting: a {kind} was given a tensor on {x.device}; a "
            "counted collective meets no one and takes only meta tensors")
    n = ctx.size(axes)
    t = x if take is None else take(x)
    size = t.numel() * t.element_size()
    out = {"all_gather": n * size, "reduce_scatter": size,
           "all_reduce": t.numel() * (dtype or x.dtype).itemsize}[kind]
    ctx.counts.bump(kind)
    ctx.counts.bump(kind + "_bytes", (n - 1) * size)
    ctx.counts.bump(kind + "_output_bytes", out)
    return [t] * n


def _exchange(x: torch.Tensor, axes, kind: str,
              take: Optional[Callable] = None,
              dtype=None) -> List[torch.Tensor]:
    """Deposit `x`, meet every point, and read the group's tensors over
    `axes` in shard order, each on this point's device (this point's own
    is `x`); `take`, where given, cuts what this point reads of each
    (a reduce-scatter reads only its own slice). `dtype` is the result's
    where it is not `x`'s (counted when counting)."""
    ctx = _need()
    if ctx.world is None:
        return _count(ctx, x, axes, kind, take, dtype)
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
        if take is not None:
            t = take(t)
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


def _sum(parts: Sequence[torch.Tensor], dtype) -> torch.Tensor:
    """The parts summed in order in `dtype` (a new tensor)."""
    acc = parts[0].to(dtype, copy=True)
    for t in parts[1:]:
        acc += t.to(dtype)
    return acc


def _reduce(x: torch.Tensor, axes, op: str, dtype=None) -> torch.Tensor:
    parts = _exchange(x, axes, "all_reduce", dtype=dtype)
    if op == "max":
        acc = parts[0].clone()
        for t in parts[1:]:
            acc = torch.maximum(acc, t)
        return acc
    if dtype is not None:
        return _sum(parts, dtype)
    acc = _sum(parts, torch.promote_types(x.dtype, torch.float32))
    return acc.to(x.dtype)


def _scatter(g: torch.Tensor, axes, dim: int, size: int) -> torch.Tensor:
    """The backward of a gather over `axes` along `dim` of slices of
    `size`: this point's slice of `g`, summed over the gathered axes
    that split the batch (`ShardContext.batch_axes`: there each point's
    `g` is its own data's share, as for a weight gathered by FSDP) and
    taken as it is over the others (there every point holds the same
    `g`). A reduce-scatter where it sums: each point reads only its own
    slice of the others'."""
    ctx = _need()
    axes = _axes(axes)
    start = _flat(ctx.mesh, ctx.coords, axes) * size
    summed = tuple(a for a in axes if a in ctx.batch_axes)
    if ctx.size(summed) == 1:
        return g.narrow(dim, start, size)
    parts = _exchange(g, summed, "reduce_scatter",
                      take=lambda t: t.narrow(dim, start, size))
    return _sum(parts, torch.promote_types(g.dtype, torch.float32)) \
        .to(g.dtype)


def _on_thread(point: ShardContext) -> None:
    """Raise unless the calling thread is the one of `point`, whose
    forward recorded the node: a backward on autograd's own device
    thread has no shard context, and the points sharing that thread
    would wait for each other there."""
    if context() is not point:
        raise RuntimeError(
            f"spmd: a collective's backward ran off point {point.point}'s "
            "thread (spmd.run turns multithreaded backward off in each "
            "point's thread; run backward inside the point's function)")


class _AllReduce(torch.autograd.Function):
    """Sum of the points' partial outputs, held alike by every point of
    the group: the backward is the identity (each partial's gradient is
    the result's, which every point holds)."""

    @staticmethod
    def forward(fc, x, axes):
        fc.point = _need()
        return _reduce(x, axes, "sum")

    @staticmethod
    def backward(fc, g):
        _on_thread(fc.point)
        return g, None


class _AllGather(torch.autograd.Function):
    """Concatenation of the group's slices: the backward keeps the
    point's slice of the gradient (`_scatter`)."""

    @staticmethod
    def forward(fc, x, axes, dim):
        fc.point, fc.axes, fc.dim, fc.size = _need(), axes, dim, x.shape[dim]
        return torch.cat(_exchange(x, axes, "all_gather"), dim=dim)

    @staticmethod
    def backward(fc, g):
        _on_thread(fc.point)
        return _scatter(g, fc.axes, fc.dim, fc.size), None, None


class _Copy(torch.autograd.Function):
    """The identity, where an activation every point of the group holds
    alike enters compute split over the group: the backward sums the
    points' partial gradients (an all-reduce)."""

    @staticmethod
    def forward(fc, x, axes):
        fc.point, fc.axes = _need(), axes
        return x.view_as(x)

    @staticmethod
    def backward(fc, g):
        _on_thread(fc.point)
        return _reduce(g, fc.axes, "sum"), None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce(x: torch.Tensor, axes, op: str = "sum",
               dtype=None) -> torch.Tensor:
    """The sum (or, with `op="max"`, the largest) of `x` over the group
    of points that differ on `axes`, in shard order, a new tensor on
    every point. A sum accumulates in f32 (or `x`'s dtype if wider) and
    is cast to `x`'s dtype, or accumulates and stays in `dtype` where
    given (the int8 payloads' int32 sum). Under autograd a sum's
    backward is the identity (`_AllReduce`)."""
    if op == "sum" and dtype is None and _tracked(x):
        return _AllReduce.apply(x, _axes(axes))
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce: op must be 'sum' or 'max', got {op!r}")
    return _reduce(x, axes, op, dtype)


def all_gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """`x` of every point of the group over `axes`, concatenated along
    `dim` in shard order. Under autograd the backward keeps the point's
    slice of the gradient, summed over the batch's axes (`_scatter`)."""
    if _tracked(x):
        return _AllGather.apply(x, _axes(axes), dim)
    return torch.cat(_exchange(x, axes, "all_gather"), dim=dim)


def copy(x: torch.Tensor, axes) -> torch.Tensor:
    """`x`, which every point of the group over `axes` holds alike, as
    it enters compute split over `axes`: under autograd the backward
    all-reduces the points' partial gradients over `axes` (`_Copy`);
    otherwise `x` itself."""
    if not _axes(axes) or not _tracked(x):
        return x
    return _Copy.apply(x, _axes(axes))


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


def whole_all(ts: Dict[str, torch.Tensor], axis: str
              ) -> Dict[str, torch.Tensor]:
    """`whole(t, axis)` of every tensor of `ts`, with one rendezvous: the
    tensors split along one dim over `axis` alone (of the first such
    tensor's dtype) are flattened into one, all-gathered once and cut
    back, each whole along that dim; any other goes through `whole`. The
    bytes moved are `whole`'s; under autograd the one gather's backward
    keeps the point's slice of each gradient, as each `whole` would."""
    fused: Dict[str, int] = {}
    for name, t in ts.items():
        dims = [d for d in range(t.dim()) if split_axes(t, d)]
        if len(dims) == 1 and split_axes(t, dims[0]) == (axis,) and (
                not fused or t.dtype == ts[next(iter(fused))].dtype):
            fused[name] = dims[0]
    out = {name: whole(t, axis) for name, t in ts.items()
           if name not in fused}
    if not fused:
        return out
    flat = torch.cat([ts[name].reshape(-1) for name in fused])
    parts = all_gather(flat[None], axis, 0)        # [ways, the local sum]
    at = 0
    for name, dim in fused.items():
        t = ts[name]
        piece = parts[:, at:at + t.numel()].reshape(-1, *t.shape)
        spec = list(t._spmd_spec) + [None] * (t.dim() - len(t._spmd_spec))
        spec[dim] = None
        shape = list(t.shape)
        shape[dim] *= piece.shape[0]        # the points' slices along dim
        out[name] = _tag(piece.movedim(0, dim).reshape(shape), spec)
        at += t.numel()
    return {name: out[name] for name in ts}


def like(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """`t`, marked with the spec `src` carries as a point's tensor of a
    sharded leaf (a detached copy of a parameter, its gradient); `t` as
    it is where `src` carries none."""
    spec = getattr(src, "_spmd_spec", None)
    return t if spec is None else _tag(t, spec)


def leaf_axes(t: torch.Tensor) -> Tuple[str, ...]:
    """The mesh axes, in the mesh's order, that split any dim of the
    leaf of which `t` is a point's tensor (axes of one point left out);
    () outside `run` and for any other tensor. A sum over the leaf is
    the all-reduce of the points' sums over these axes."""
    ctx, spec = context(), getattr(t, "_spmd_spec", None)
    if ctx is None or spec is None:
        return ()
    named = {a for entry in spec for a in _axes(entry)}
    return tuple(a for a in ctx.mesh.axis_names
                 if a in named and ctx.mesh.shape[a] > 1)


def batch_axes() -> Tuple[str, ...]:
    """The axes that split the batch in this `run` (`ShardContext.
    batch_axes`); () outside `run`."""
    ctx = context()
    return () if ctx is None else ctx.batch_axes


def coordinate(axes) -> int:
    """This point's flattened coordinate over `axes` (a name or a tuple,
    the first major), the index of its range of a dim split over them;
    0 outside `run`."""
    ctx = context()
    return 0 if ctx is None else _flat(ctx.mesh, ctx.coords, _axes(axes))


def batch_offset() -> int:
    """This point's shard of the batch: its flattened coordinate over
    `batch_axes()` (0 outside `run` or where the batch is whole)."""
    ctx = context()
    return 0 if ctx is None else coordinate(ctx.batch_axes)


def data_parallel_sum(g: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """The gradient `g` of a point's tensor `leaf` of a sharded
    parameter, summed over the batch's axes the leaf is not split over,
    and marked with the leaf's spec. Over an axis that splits the leaf
    `whole`'s backward has summed it already (every such leaf is
    gathered before use); over the others each point holds its own
    data's share. `g` itself (marked) where nothing is left to sum."""
    ctx = context()
    if ctx is None:
        return g
    split = leaf_axes(leaf)
    axes = tuple(a for a in ctx.batch_axes if a not in split)
    if ctx.size(axes) > 1:
        g = all_reduce(g, axes)
    return like(g, leaf)


def index(t: torch.Tensor, r: int) -> torch.Tensor:
    """`t[r]`: a stacked leaf's layer r, keeping the spec of the other
    dims where `t` is a point's tensor of a sharded leaf. Raises where
    the stacked dim itself is split: gather it first (`whole`)."""
    if split_axes(t, 0):
        raise ValueError("spmd.index: the stacked dim is split; gather "
                         "the leaf along it first")
    out = t[r]
    spec = getattr(t, "_spmd_spec", None)
    return out if spec is None else _tag(out, tuple(spec)[1:])


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


def _enter_point(stack: contextlib.ExitStack, mesh, backend: str,
                 grad: bool) -> None:
    """What a point's function runs under: the mesh ambient, the
    caller's attention backend and grad mode, and a backward in this
    thread run in this thread, under this point's context (not on
    autograd's device thread)."""
    from repro_torch.models import layers as L
    stack.enter_context(set_mesh(mesh))
    stack.enter_context(L.attention_backend(backend))
    stack.enter_context(torch.set_grad_enabled(grad))
    stack.enter_context(torch.autograd.set_multithreading_enabled(False))


def _run_counted(mesh, fn: Callable, args, batch_ways: int, mode: _Counting,
                 backend: str, grad: bool) -> List[Any]:
    """`run` when counting: `fn` once, for the counted point alone, on
    this thread; its result stands for every point's."""
    if context() is not None:
        raise RuntimeError("spmd.run: already in a run")
    point = mode.point
    _TLS.ctx = ShardContext(mesh, point, point_coords(mesh, point),
                            torch.device("meta"), batch_ways, None,
                            mode.counts)
    try:
        with contextlib.ExitStack() as stack:
            _enter_point(stack, mesh, backend, grad)
            result = fn(*local(args, point))
    finally:
        _TLS.ctx = None
    return [result] * mesh.size


def run(mesh, fn: Callable, *args, timeout: float = DEFAULT_TIMEOUT,
        batch_ways: int = 1) -> List[Any]:
    """`fn(*args)` once a mesh point, each on its own thread, every
    sharded leaf of `args` replaced by the point's tensor; returns the
    points' results in point order. `batch_ways` is how many ways the
    batch in `args` is split over the data axes (1: every point holds
    the whole batch). Raises the first exception a point raised (within
    `timeout` of it), or RuntimeError if a rendezvous waited longer than
    `timeout`. When counting, the counted point alone (`counting`)."""
    from repro_torch.models import layers as L
    devs = _devices(mesh)
    backend = L.current_attention_backend()
    grad = torch.is_grad_enabled()
    mode = _counting()
    if mode is not None:
        return _run_counted(mesh, fn, args, batch_ways, mode, backend, grad)
    world = _World(mesh, timeout)
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
                _enter_point(stack, mesh, backend, grad)
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


def _layer_leaves(cfg, full, specs, model_split):
    """(each layer's FFN specs, None for a mixer-only block; the element
    counts of the first stacked layer's mixer leaves but its norm, and of
    those "model" splits, `model_split` saying which spec entry does) in
    the trees of `abstract_params` and `param_specs`."""
    prefix, period, _ = layer_layout(cfg)
    ffns = [(specs["prefix_layers"][i] if i < prefix else specs["layers"][
        (i - prefix) % period]).get("ffn") for i in range(cfg.n_layers)]
    mixer, lay = full["layers"][0]["mixer"], specs["layers"][0]["mixer"]
    leaves = {k: mixer[k][0].numel() for k in mixer if k != "ln"}
    split = [n for k, n in leaves.items()
             if any(model_split(x) for x in lay[k])]
    return ffns, list(leaves.values()), split


def train_comm(cfg, mesh, batch: int, seq: int, tc, fsdp: bool) -> dict:
    """`COMM` of one sharded train step (AdamW, remat; `tc` a
    `train.step.TrainConfig`), summed over the points, by the formula of
    this module's note: a model of attention or MLA layers, each
    followed by an MLP or a MoE, the batch split over the data axes
    ("pod" and "data", `sharding.batch_axes`: the global batch and its
    microbatches divide them), each point's loss chunks whole; attention
    whose heads split whole over "model", or attention and MLA under the
    sequence split (`layers.seq_split`); an MLP's d_ff and a MoE's
    d_ff_expert (its shared experts' d_ff too) split over "model" where
    tp divides them; a vocabulary tp divides; FSDP over "data" for a
    dense model whose heads split whole. Raises ValueError for what it
    does not model (a Mamba-2 mixer, a stub frontend, MLA split by heads,
    expert parallelism, FSDP over more than one point of any other
    model); `launch.collectives` counts every case."""
    a, d, n_layers, v = cfg.attn, cfg.d_model, cfg.n_layers, cfg.vocab_size
    tp, dp, m = mesh.shape["model"], mesh.shape["data"], tc.microbatches
    ways = math.prod(mesh.shape[x] for x in batch_axes_of(mesh))
    e = cfg.dtype.itemsize
    t = batch // m // ways * seq                   # a point's tokens
    nchunk = max(1, t * ways // tc.loss_chunk)
    chunk = t * ways // nchunk
    chunks = t // chunk
    full, specs = abstract_params(cfg), param_specs(cfg, mesh, fsdp)
    if cfg.mamba is not None or cfg.frontend or cfg.n_enc_layers:
        raise ValueError("train_comm: a Mamba-2 mixer or a stub frontend")
    hs = tp if a.num_heads % tp == 0 and a.num_kv_heads % tp == 0 else 1
    r, dr = a.kv_lora_rank, a.rope_head_dim
    if r and tp > 1 and hs > 1 and r % tp == 0 and dr % tp == 0:
        raise ValueError("train_comm: MLA split by heads")
    if r and (r % tp or dr % tp):
        hs = 1
    cp = tp > 1 and hs == 1          # the sequence split
    rows = cp and seq % tp == 0      # each point's query rows

    def model_split(entry):          # a spec entry that "model" splits
        return tp > 1 and "model" in (entry if isinstance(entry, tuple)
                                      else (entry,))
    ffns, ws, split = _layer_leaves(cfg, full, specs, model_split)
    dense = not cp and cfg.moe is None
    if fsdp and dp > 1 and not dense:
        raise ValueError("train_comm: FSDP of a MoE or the sequence split")
    layer = (2 * a.num_heads + 2 * a.num_kv_heads) * a.head_dim * d \
        + 3 * d * cfg.d_ff                         # the 7 weights
    loss = ways > 1                  # the loss's sum and count
    vocab = tp > 1 and v % tp == 0   # the embedding, the logits
    n = {"all_reduce": vocab + loss + vocab * chunks,
         "all_gather": 2 * chunks * vocab, "reduce_scatter": 0}
    b = {"all_reduce": vocab * (tp - 1) * e * d * (t + chunks * chunk)
         + (ways - 1) * 8,
         "all_gather": vocab * 2 * chunks * (tp - 1) * 4 * chunk * v // tp,
         "reduce_scatter": 0}

    def add(kind, calls, nbytes):
        n[kind] += calls
        b[kind] += calls * nbytes
    per = (tp - 1) * e * t * d       # an all-reduce of a point's tokens
    for ffn in ffns:
        if hs > 1:                   # wo, forward and remat; the copy
            add("all_reduce", 3, per)
        elif cp:                     # the split leaves, in one, forward
            add("all_gather", 2 * bool(split),                # and remat
                (tp - 1) * e * sum(split) // tp)
            if rows:                 # k and v (c_kv, k_rope) and y,
                kv = r + dr if r else 2 * a.num_kv_heads * a.head_dim
                n["all_gather"] += 6     # forward and remat
                b["all_gather"] += 2 * (tp - 1) * e * t * (kv + d) // tp
                # the copies' backward: h, each leaf, k and v (c_kv,
                # k_rope)
                n["all_reduce"] += 3 + len(ws)
                b["all_reduce"] += per + (tp - 1) * e * (sum(ws) + t * kv)
        if ffn is None:
            continue
        if "router" not in ffn:      # w2 forward; the copy's backward
            if model_split(ffn["w2"][-2]):
                add("all_reduce", 2, per)
            continue
        if model_split(ffn["w2"][-3]):
            raise ValueError("train_comm: expert parallelism")
        shared = "shared" in ffn and model_split(ffn["shared"]["w2"][-2])
        if model_split(ffn["w2"][-2]):   # the f32 combine, forward (and
            add("all_reduce", 1 + shared, (tp - 1) * 4 * t * d)  # remat
            add("all_reduce", 1, per)    # before the shared sum); the
            add("all_reduce", 1, (tp - 1) * 4 * t * cfg.moe.top_k)  # copies
        if shared:                   # the shared w2, forward; its copy
            add("all_reduce", 2, per)
        if ways > 1:                 # the auxiliary loss, forward, remat
            add("all_reduce", 2, (ways - 1) * 4 * 2 * cfg.moe.num_experts)
    if fsdp and dp > 1:
        n["all_gather"] += 14 * n_layers + 1
        b["all_gather"] += (dp - 1) * e * (2 * n_layers * layer + d * v) \
            // (dp * tp)
        n["reduce_scatter"] += 7 * n_layers + 1
        b["reduce_scatter"] += (dp - 1) * e * (n_layers * layer + d * v) \
            // (dp * tp)
    n = {k: x * m for k, x in n.items()}
    b = {k: x * m for k, x in b.items()}
    # once a step: the f32 gradients summed over the data axes that do
    # not split them, then the norm's sums, one all-reduce for each set
    # of axes
    groups = collections.Counter()
    for leaf, spec in zip(leaves(abstract_params(cfg)),
                          spec_leaves(param_specs(cfg, mesh, fsdp))):
        axes = tuple(x for x in mesh.axis_names if mesh.shape[x] > 1
                     and any(x in (en if isinstance(en, tuple) else (en,))
                             for en in spec if en is not None))
        local = leaf.numel() // math.prod(mesh.shape[x] for x in axes)
        rest = math.prod(mesh.shape[x] for x in batch_axes_of(mesh)
                         if x not in axes)
        if rest > 1:
            n["all_reduce"] += 1
            b["all_reduce"] += (rest - 1) * 4 * local
        if axes:
            groups[axes] += 1
    for axes, count in groups.items():
        n["all_reduce"] += 1
        b["all_reduce"] += (math.prod(mesh.shape[x] for x in axes) - 1) \
            * 4 * count
    out = {}
    for k in _KINDS:
        out[k] = n[k] * mesh.size
        out[k + "_bytes"] = b[k] * mesh.size
    return {k: out[k] for k in COMM}


def serve_comm(cfg, mesh, batch: int, prompt_len: int, gen_tokens: int,
               cap: int, passes: int = 1) -> dict:
    """`spmd.COMM` of `passes` passes of `serve.generate_sharded` (fsdp
    off), summed over the points, by the formulas of `parallel/spmd.py`'s
    note, for a model whose layers are attention, MLA or Mamba-2 mixers,
    each followed by an MLP, an expert-parallel MoE or nothing: the
    vocab-parallel embedding's all-reduce and the logits' gather (where tp
    divides the vocabulary); per layer, for attention wo's all-reduce
    where the heads split whole, and under the sequence split one gather
    of the attention leaves split over "model" each call and, where tp
    divides the call's tokens, k, v and y gathered; for MLA where its
    heads split over "model", w_kr gathered whole and wo's all-reduce,
    and the latent and rope caches gathered, or, at a batch the data axes
    do not divide (batch 1), the call's latent; under MLA's sequence
    split, as attention's, with c_kv and k_rope in place of k and v; for
    the Mamba-2 mixer where it
    splits, in_proj's and the conv's outputs gathered and out_proj's
    all-reduce, and at batch 1 its gated output gathered over "data"
    where "data" splits its heads; where a cache's slots are split over
    n points, a decode step's merge, and a prompt longer than a window
    layer's ring gathers the written slots; w2's all-reduce where its rows are
    split, the MoE's f32 combine where its experts or their d_ff are and
    its shared experts' w2 where their d_ff is, and
    once a call the stacked leaves whose layer dim is split (deepseek's
    shared experts); the splits read from `param_specs`. Raises
    ValueError for a layer this does not cover (a Mamba-2 mixer gathered
    over a model axis of more than one point). It does not model
    FSDP, whisper's encoder and cross-attention or llava's patch prefix
    (their collectives are left out); `launch.collectives` counts every
    case."""
    a, d, v = cfg.attn, cfg.d_model, cfg.vocab_size
    tp = mesh.shape.get("model", 1)
    ways_d = mesh.shape.get("data", 1)
    dp = math.prod(mesh.shape.get(x, 1) for x in ("pod", "data"))
    e = cfg.dtype.itemsize
    b_ok = batch % dp == 0
    b = batch // dp if b_ok else batch
    b1 = not b_ok and ways_d > 1     # the batch whole on every point
    full, specs = abstract_params(cfg), param_specs(cfg, mesh, fsdp=False)

    def model_split(entry):          # a spec entry that "model" splits
        return tp > 1 and "model" in (entry if isinstance(entry, tuple)
                                      else (entry,))
    stacked = []    # gathered once a call: the layer dim "model" splits
    ffns, _, gathered = _layer_leaves(cfg, full, specs, model_split)

    def walk(x, y):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k])
        elif model_split(y[0]):
            stacked.append(math.prod(x.shape))
    for x, y in zip(full["layers"], specs["layers"]):
        walk(x, y)
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    if a is not None:
        hd, kvh = a.head_dim, a.num_kv_heads
        hs = tp if a.num_heads % tp == 0 and kvh % tp == 0 else 1
        if a.kv_lora_rank:           # MLA splits its heads where tp also
            r, dr = a.kv_lora_rank, a.rope_head_dim     # divides r, dr
            hs = hs if r % tp == 0 and dr % tp == 0 else 1
        cp = tp > 1 and hs == 1      # the sequence split
        want = ([ways_d] if b1 else []) + ([tp] if cp else [])
        ring = min(cap, a.sliding_window) if a.sliding_window else cap
        n = 1
        for w in want:               # the ways the ring's slots split
            if ring % (n * w) == 0:
                n *= w
    if cfg.mamba is not None:
        mb = cfg.mamba
        d_in = mb.expand * d
        nheads, ch = d_in // mb.head_dim, d_in + 2 * mb.d_state
        if tp > 1 and (nheads % tp or ch % tp):
            raise ValueError("serve_comm: a Mamba-2 mixer gathered over "
                             "'model'")
    ar = ag = ar_b = ag_b = 0
    for s in [prompt_len] + [1] * gen_tokens:
        if tp > 1 and v % tp == 0:   # the embedding, the logits
            ar, ar_b = ar + 1, ar_b + (tp - 1) * e * b * s * d
            ag, ag_b = ag + 1, ag_b + (tp - 1) * 4 * b * v // tp
        for numel in stacked:        # the split layer dims, in one call
            ag, ag_b = ag + 1, ag_b + (tp - 1) * e * numel // tp
        for i, kind in enumerate(kinds):
            if kind == "mamba":
                if tp > 1:           # in_proj's and the conv's outputs
                    ag += 2
                    ag_b += (tp - 1) * e * b * s * (
                        d_in + ch + nheads + ch) // tp
                    ar, ar_b = ar + 1, ar_b + (tp - 1) * e * b * s * d
                if b1 and nheads % ways_d == 0:     # the gated output
                    ag += 1
                    ag_b += (ways_d - 1) * e * b * s * d_in // ways_d
            elif a.kv_lora_rank and hs > 1:
                ag += 2 if b1 else 3     # w_kr; the call's latent, or
                ag_b += (tp - 1) * e * (d * dr + (   # the cached latent
                    b * s * r if b1 else b * cap * (r + dr))) // tp
                ar, ar_b = ar + 1, ar_b + (tp - 1) * e * b * s * d
            elif hs > 1:             # wo
                ar, ar_b = ar + 1, ar_b + (tp - 1) * e * b * s * d
            elif cp:                 # the leaves "model" splits, in one
                ag += bool(gathered)
                ag_b += (tp - 1) * e * sum(gathered) // tp
                if s % tp == 0:      # k and v (MLA: c_kv, k_rope) and y
                    ag += 3
                    ag_b += (tp - 1) * e * b * s * (d + (
                        r + dr if a.kv_lora_rank else 2 * kvh * hd)) // tp
            if kind != "mamba" and s == 1 and n > 1:   # the decode merge
                ag += 1
                ag_b += (n - 1) * 4 * b * (a.num_heads // hs) * (hd + 1)
            if kind == "attn" and not a.kv_lora_rank and n > 1 \
                    and s > ring:    # a prompt that overfills the ring:
                ag += 2              # its written slots, k and v
                ag_b += 2 * (n - 1) * e * b * ring * (kvh // hs) * hd // n
            ffn = ffns[i]
            if ffn is None:
                continue
            if "router" in ffn:      # the MoE's f32 combine
                if any(model_split(x) for x in ffn["w2"][-3:-1]):
                    ar, ar_b = ar + 1, ar_b + (tp - 1) * 4 * b * s * d
                if "shared" in ffn and model_split(ffn["shared"]["w2"][-2]):
                    ar, ar_b = ar + 1, ar_b + (tp - 1) * e * b * s * d
            elif model_split(ffn["w2"][-2]):     # w2
                ar, ar_b = ar + 1, ar_b + (tp - 1) * e * b * s * d
    k = passes * mesh.size
    return {"all_reduce": ar * k, "all_gather": ag * k, "reduce_scatter": 0,
            "all_reduce_bytes": ar_b * k, "all_gather_bytes": ag_b * k,
            "reduce_scatter_bytes": 0}
