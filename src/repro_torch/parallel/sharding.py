"""Named-sharding rules for every parameter/cache in the zoo, and the
mesh-axis sizes the distributed runtime reads.

Scheme (DP = FSDP over "data", TP = "model", optional "pod" = pure DP):
  * column-parallel weights (wq/wk/wv/w1/w3/in_proj/router/unembed/...):
    inputs sharded over data (FSDP), outputs over model (Megatron TP);
  * row-parallel weights (wo/w2/out_proj): transposed;
  * MoE experts: expert-parallel over "model" when num_experts divides
    the model-axis size, else tensor-parallel inside each expert;
  * embeddings: vocab over model;
  * norms/scalars: replicated;
  * stacked (scan) leading axes: never sharded.

`fit_spec` drops any axis that does not divide the corresponding dim —
sharding decisions degrade to replication rather than failing (e.g.
whisper's odd 51865 vocab).

The reference's rules, copied. A spec is `P`, the counterpart of
`jax.sharding.PartitionSpec`: a tuple whose entries are None, an axis
name or a tuple of names (a 1-tuple is stored as the bare name). Every
function takes any mesh with `.shape` (a dict of axis sizes) and
`.axis_names`. Shapes come from `models.common.param_shapes` and from
caches built on the "meta" device, so nothing is allocated. These specs
feed the launch reports (`launch.specs`, `launch.dryrun`) and sharded
serving and training (`parallel.spmd`: `shard_tree`, `init_sharded`,
`launch.serve.serve_config(mesh=...)`, `train.step.build_train_step(
..., mesh=...)`). A point's caches follow `cache_spec`, MLA's and the
Mamba-2 mixer's at batch 1 too (the latent's slots and the SSM heads
over "data": `models.layers.cache_split`, `ssm_split`), with one
difference, on purpose: an attention cache splits its kv heads over
"model" where they split whole, and its slots where they do not (the
sequence split), not `head_dim` as `cache_spec` says (K8 takes whole
heads); the bytes a point holds are the same
(`models.layers.cache_split`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

from repro_torch.models.common import ModelConfig, param_shapes

# leaf name -> (base spec builder). fsdp = data axes tuple, tp = "model".
_COL = {"wq", "wk", "wv", "w1", "w3", "in_proj", "w_dkv", "w_uk", "w_uv",
        "w_kr", "w_qr", "unembed", "frame_proj", "patch_proj"}
_ROW = {"wo", "w2", "out_proj"}
_BIAS_TP = {"bq", "bk", "bv"}
_REPL = {"ln", "ln_f", "ln_x", "enc_ln_f", "a_log", "dt_bias", "d_skip"}


class P(tuple):
    """A partition spec: one entry a dim (None, an axis name or a tuple
    of names; a 1-tuple becomes the bare name)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (torch has no such record)."""

    mesh: Any
    spec: P


def axis_size(mesh, name: str) -> int:
    """Size of mesh axis `name` (1 when the mesh has no such axis)."""
    return mesh.shape[name] if name in mesh.shape else 1


def fit_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Replicate any dim the assigned axes don't divide."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = math.prod(axis_size(mesh, a) for a in axes)
        out.append(ax if size > 0 and dim % size == 0 else None)
    return P(*out)


def _base_spec(name: str, ndim: int, cfg: ModelConfig, mesh,
               fsdp, in_moe: bool) -> P:
    tp = "model"
    if in_moe and name in ("w1", "w2", "w3"):
        ep_ok = (cfg.moe is not None
                 and cfg.moe.num_experts % axis_size(mesh, tp) == 0)
        if name in ("w1", "w3"):
            spec = (tp, fsdp, None) if ep_ok else (None, fsdp, tp)
        else:  # w2 [E, f, d]
            spec = (tp, None, fsdp) if ep_ok else (None, tp, fsdp)
    elif name == "embed":
        # vocab-parallel embedding: each TP shard gathers its vocab range
        spec = (tp, None)
    elif name == "router":
        spec = (fsdp, None)
    elif name == "conv_w":
        spec = (None, tp)
    elif name in _COL:
        spec = (fsdp, tp)
    elif name in _ROW:
        spec = (tp, fsdp)
    elif name in _BIAS_TP:
        spec = (tp,)
    else:  # norms, scalars, unknown -> replicate
        spec = ()
    # left-pad with None for stacked (scan) leading axes
    pad = ndim - len(spec)
    assert pad >= 0, (name, ndim, spec)
    return P(*((None,) * pad + tuple(spec)))


def _map_with_path(fn, tree, path=()):
    """`fn(path of dict keys, leaf)` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path) for v in tree]
    return fn(path, tree)


def param_specs(cfg: ModelConfig, mesh, fsdp: bool = True) -> Any:
    """Spec tree matching `init_params(cfg)`'s structure.

    fsdp=True  : weights sharded over `data` too (ZeRO-3) — required when
                 params don't fit replicated;
    fsdp=False : weights sharded over `model` only, replicated across
                 `data` (ZeRO-1) — no per-microbatch weight all-gather;
                 the right choice for small models and for serving.
    """
    if fsdp:
        ax = tuple(a for a in ("data",) if a in mesh.shape)
        fsdp_ax = ax[0] if len(ax) == 1 else (ax or None)
    else:
        fsdp_ax = None

    def spec_for(path, shape):
        name = path[-1] if path else ""
        ndim = len(shape)
        in_moe = "ffn" in path and ndim >= 3 and name in ("w1", "w2", "w3")
        spec = _base_spec(name, ndim, cfg, mesh, fsdp_ax, in_moe)
        return fit_spec(spec, shape, mesh)

    return _map_with_path(spec_for, param_shapes(cfg))


def map_specs(fn, tree):
    """`fn` over the specs of a spec tree (dicts, lists and cache
    records), rebuilt in its structure."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, v) for v in tree]
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_specs(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        return type(tree)(*(map_specs(fn, v) for v in tree)) \
            if hasattr(tree, "_fields") else tuple(map_specs(fn, v)
                                                   for v in tree)
    return tree


def spec_leaves(specs) -> list:
    """The specs of a spec tree in `train.tree.leaves` order (a spec is a
    tuple, so `leaves` would walk into it)."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    return [x for v in specs for x in spec_leaves(v)]


def param_shardings(cfg: ModelConfig, mesh, fsdp: bool = True) -> Any:
    return map_specs(lambda s: NamedSharding(mesh, s),
                     param_specs(cfg, mesh, fsdp=fsdp))


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> P:
    """[B, ...] sharded over (pod, data) when divisible, else replicated."""
    axes = batch_axes(mesh)
    size = math.prod(axis_size(mesh, a) for a in axes)
    first = axes if (axes and batch % size == 0) else None
    return P(first, *([None] * extra_dims))


def cache_spec(cfg: ModelConfig, mesh, batch: int,
               shard_seq_when_b1: bool = True) -> Any:
    """Spec tree for `Model.init_cache`'s output (the same records, a
    spec in each tensor's field; a ring cursor's spec is the reference's
    for its stacked int32 cursor array). Batch-sharded when the batch
    divides the DP axes; for global_batch==1 long-context decode the KV
    *length* (and mamba heads) shard over "data" instead — KV sequence
    parallelism."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model

    axes = batch_axes(mesh)
    size = math.prod(axis_size(mesh, a) for a in axes)
    b_ok = axes and batch % size == 0

    def kv_spec(leaf_ndim: int, kind: str) -> P:
        if b_ok:
            # batch over DP axes AND the head/feature dim over model:
            # decode caches are the dominant serve-memory term, so they
            # must split over the full mesh
            if kind == "kv":
                if leaf_ndim == 4:          # [B, cap, kvh, hd]
                    return P(axes, None, None, "model")
                return P(axes, None, "model")   # MLA [B, cap, r]
            if kind == "conv":              # [B, k, ch]
                return P(axes, None, "model")
            if kind == "ssm":               # [B, H, P, N]
                return P(axes, "model", None, None)
            return P(axes, *([None] * (leaf_ndim - 1)))
        if not shard_seq_when_b1:
            return P(*([None] * leaf_ndim))
        if kind == "kv":     # [B, cap, (kvh, hd) | (r,) | (dr,)]
            rest = [None] * (leaf_ndim - 2)
            if leaf_ndim == 4:
                rest = [None, "model"]      # head_dim over model
            return P(None, "data", *rest)
        if kind == "conv":   # [B, k, ch]
            return P(None, None, "model")
        if kind == "ssm":    # [B, H, P, N]
            return P(None, "data", None, None)
        return P(*([None] * leaf_ndim))

    def leaf(t, kind: str, stacked: bool) -> P:
        base = kv_spec(t.ndim - (1 if stacked else 0), kind)
        spec = P(*((None,) * (t.ndim - len(base)) + tuple(base)))
        return fit_spec(spec, tuple(t.shape), mesh)

    def one(c, stacked: bool):
        if isinstance(c, L.MambaCache):
            return L.MambaCache(leaf(c.conv, "conv", stacked),
                                leaf(c.ssm, "ssm", stacked))
        return L.KVCache(leaf(c.k, "kv", stacked), leaf(c.v, "kv", stacked),
                         P(None) if stacked else P())

    caches = Model(cfg).init_cache(batch, 128, "meta")
    return {"prefix": [one(c, False) for c in caches["prefix"]],
            "slots": [one(c, True) for c in caches["slots"]]}
