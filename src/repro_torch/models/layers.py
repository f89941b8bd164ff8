"""Forward passes of the blocks the port runs: pre-norm residual
attention (GQA, optionally biased QKV — qwen; sliding-window — mixtral;
RoPE; a static-capacity ring KV cache for serving), MLA's latent
attention (deepseek-v2), the Mamba-2 mixer (the chunked SSD for a whole
sequence, the recurrent step for decode, a conv window and SSM state
cache), whisper's cross-attention, the swiglu / relu2 / gelu MLPs and
the top-k routed MoE with shared experts.

Two execution modes, as the reference's:
  * prefill: full-sequence forward, writing the cache if one is given;
  * decode: q_len == 1 step against the cache.

Numerics: matmuls in the param dtype (bf16), softmax/logits in fp32,
norms in fp32 (their weights are f32), RoPE tables in f32 cast to the
activations' dtype before the rotation. Mamba-2's conv runs in the
model dtype, its SSD and SSM state in f32 (the output cast back), its
dt as softplus(dt_raw in f32 + dt_bias).

Differences from the reference, on purpose:
  * the caches are updated in place (the reference copies them
    functionally: at qwen1.5-4b's full width a copy is 3.42 GB per
    decode step), and a KV cursor is a host int, so no step syncs the
    device to read it;
  * the attention backend defaults to "flash", the hand-written kernel
    (K8): the reference defaults to "auto" only because Pallas runs in
    interpret mode off a TPU (ROADMAP Queue 3);
  * MLA hands K8 its v at head_dim 128 against q/k's 192, where the
    reference pads v with zeros to 192 and slices the output back: the
    same numbers without the padded columns;
  * the MoE gathers each expert's kept tokens into [E, C, d] and adds
    the experts' outputs back per token, where the reference multiplies
    by one-hot [T, E, C] dispatch and combine tensors: the same sums
    without the products by zero (at deepseek-v2-lite's prefill each
    such tensor has 503 M entries);
  * the SSD's three- and four-operand einsums run as pairs of products
    (the same f32 sums, in another order).
The reference's sharding hints (`parallel.hints`) are called where the
reference calls them; each returns its tensor as it is (one controller,
no partitioner). The MoE splits its tokens into `hints.dp_size()` groups
as the reference does: one group without a mesh, one a data-parallel
shard under `launch.mesh.set_mesh`, each with its own capacity and queue
positions.

Sharded (inside `parallel.spmd.run`, one thread a mesh point, each
holding its local parameters and batch rows; with no shard context every
function runs unsharded). Which dims of a leaf are split, and over which
axes, is read from the leaf's spec (`spmd.split_axes`, `spmd.whole`),
never from its shape. The collectives sit at the reference's hint sites:
  * attention, where tp (the "model" axis) divides both the query and
    the kv heads (`heads_split`): wq/wk/wv and the QKV biases are the
    point's columns, K8 runs on its H/tp query and KVH/tp kv heads
    (whole heads, as K8 takes them; its ring cache holds those kv
    heads), and wo's partial product is all-reduced over "model". Where
    the heads do not split whole (minitron's 6/2 smoke heads or
    mixtral's 2 smoke kv heads on a model axis of 4, qwen1.5-4b's 20 on
    8: `fit_spec` cuts `wk` mid-head), attention splits by sequence
    (`seq_split`, the reference's "seq" layout, context parallelism):
    every attention leaf is gathered over "model", a point takes its
    S/tp query rows (every row where tp does not divide S) against the
    gathered k and v, and its rows of y are all-gathered; its cache
    holds cap/tp of the ring's slots (`cache_split`);
  * a batch the data axes do not divide (batch 1, `whole_batch`) is
    whole on every point, and its attention and MLA caches hold a range
    of the slots over "data", where `cache_spec` splits the KV length.
    Under a split of the slots (either axis, or both, "data" first) a
    point writes only the slots it holds, and a decode step runs K8 on
    them with their log-sum-exp and merges the points' outputs
    (`_cache_keys`, `_sdpa_merged`);
  * MLA (`_mla_attention`), where tp divides its heads, r and dr
    (`mla_split`): the point's heads of wq, w_qr, w_uk, w_uv and wo, its
    r/tp columns of w_dkv, and w_kr gathered whole (RoPE pairs columns
    across the split); K8 runs on the point's heads and wo's partial
    product is all-reduced. Its cache holds `cache_spec`'s share: at a
    batch the data axes divide, the r/tp columns of the latent cache and
    dr/tp of the rope cache, both all-gathered over "model" before the
    per-head expansion; at batch 1, its slots over "data" at every
    column, the call's latent all-gathered over "model" before it is
    written, so no cache is gathered. Where tp divides none of them
    (`seq_split`), MLA splits by sequence as attention does: its leaves
    gathered over "model", a point's S/tp query rows against every row's
    gathered c_kv and k_rope (every row where tp does not divide S), its
    rows of y all-gathered; its cache holds cap/tp of the slots at every
    column (`cache_split`), a decode step's outputs merged;
  * the MLP: w1/w3 are the point's columns of d_ff and w2's partial
    product is all-reduced;
  * the MoE: the router is replicated and the routing is the global one
    (capacity from the global E; a data shard's tokens are exactly its
    group); under expert parallelism a point holds E/tp experts and runs
    only the (token, slot) pairs routed to them, at local expert indices
    (the rest into a spare row with weight 0); otherwise d_ff is split
    inside each expert; the f32 combine is all-reduced over "model";
  * the Mamba-2 mixer, where tp divides its heads and conv channels
    (`mamba_split`): in_proj's columns are the point's
    and its output is all-gathered over "model", the depthwise conv runs
    on the point's channels (its conv cache holds those) and its output
    is all-gathered, the SSD or recurrent step runs on the point's heads
    (its SSM cache holds those) with B and C whole, and out_proj's
    partial product is all-reduced. Otherwise the mixer runs gathered.
    At batch 1 the SSM state's heads split over "data" instead
    (`ssm_split`, as `cache_spec`): a point runs its data coordinate's
    heads and all-gathers their gated output over "data" before its rows
    of out_proj;
  * whisper's cross-attention as attention (`_attn_weights`): K and V
    projected from the whole encoder output on the point's heads;
  * the embedding is a vocab-parallel lookup (`embed`), then an
    all-reduce (a vocabulary tp does not divide, whisper's 51,865, stays
    whole: a plain lookup);
  * with FSDP a leaf split over "data" is all-gathered just before use
    and dropped after the layer.
Partial products are summed in f32 and cast once (`spmd.all_reduce`).
Where an activation every point of the model axis holds alike enters
compute split over that axis (q/k/v over the local heads, or over the
local rows with the gathered weights, k and v after, w1/w3 over
the local hidden units, the MoE's tokens and routing weights into the
local experts or hidden units, the LM head's local vocabulary, the
encoder output into cross-attention's local heads, the Mamba-2 mixer's
gathered projections and its per-head scalars into its local heads and
channels), it passes through `spmd.copy`, whose backward all-reduces
the points' partial gradients: with the collectives' own backwards (a
sum's is the identity, a gather's keeps the point's slice) every
point's gradient of a local tensor is its slice of the unsharded
gradient, the same bits on every replica. The MoE's auxiliary loss is
the global batch's (its sums all-reduced over the batch's axes).

Training differentiates these functions with torch's autograd. K8 has
no backward (nor has the reference's Pallas kernel), so the training
step runs attention on "auto" inside `attention_backend("auto")`, a
per-thread override that leaves the process-wide backend — and a server
in the same process — on "flash".
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flashattn import flash_attention
from repro_torch.kernels.flashattn.ops import merge_partials
from repro_torch.kernels.flashattn.ref import NEG, masked_logits, sdpa_ref
from repro_torch.models.common import (
    AttnConfig, MambaConfig, ModelConfig, MoEConfig,
)
from repro_torch.parallel import hints as HT
from repro_torch.parallel import spmd as SP
from repro_torch.parallel.sharding import batch_axes as batch_axes_of

# --------------------------------------------------------------------------
# norms & basics
# --------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    nrm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (nrm * w).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return (((xf - mu) * torch.rsqrt(var + eps)) * w).to(x.dtype)


def norm(x, w, kind: str):
    return rmsnorm(x, w) if kind == "rmsnorm" else layernorm(x, w)


def silu(x):
    return x * torch.sigmoid(x)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """positions [B, S] -> (cos, sin) [B, S, dim/2] fp32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv[None, None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, S, H, D] with D even; rotate half (GPT-NeoX style)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# --------------------------------------------------------------------------
# softmax attention core
# --------------------------------------------------------------------------


# score-matrix entries above this trigger the chunked (flash-style) path
_SDPA_CHUNK_THRESHOLD = 4096 * 4096
_Q_CHUNK = 512
_KV_CHUNK = 1024


# the reference's dense path is the kernel's oracle, over expanded heads
_sdpa_dense = sdpa_ref


def _sdpa_chunked(q, k, v, q_pos, kv_pos, kv_valid, *, causal, window):
    """Online-softmax attention over Q and KV chunks: the peak score
    buffer is [B,H,Qc,Kc] regardless of sequence length (the reference's
    pure-JAX flash formulation, as loops)."""
    b, sq, h, _ = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    qc, kc = min(_Q_CHUNK, sq), min(_KV_CHUNK, skv)
    pad_q, pad_k = (-sq) % qc, (-skv) % kc
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = F.pad(q_pos, (0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        kv_pos = F.pad(kv_pos, (0, pad_k))
        kv_valid = F.pad(kv_valid, (0, pad_k))
    outs = []
    for i in range(0, q.shape[1], qc):
        qi, qpi = q[:, i:i + qc], q_pos[:, i:i + qc]
        acc = torch.zeros((b, h, qc, dv), dtype=torch.float32,
                          device=q.device)
        mx = torch.full((b, h, qc), -math.inf, dtype=torch.float32,
                        device=q.device)
        lse = torch.zeros_like(mx)
        for j in range(0, k.shape[1], kc):
            s = masked_logits(qi, k[:, j:j + kc], qpi, kv_pos[:, j:j + kc],
                              kv_valid[:, j:j + kc], causal=causal,
                              window=window)
            new_mx = torch.maximum(mx, s.amax(dim=-1))
            alpha = torch.exp(mx - new_mx)
            p = torch.exp(s - new_mx[..., None])
            pv = torch.einsum("bhqk,bkhd->bhqd", p.to(qi.dtype).float(),
                              v[:, j:j + kc].float()).to(qi.dtype)
            acc = acc * alpha[..., None] + pv.float()
            lse = lse * alpha + p.sum(dim=-1)
            mx = new_mx
        out = acc / torch.clamp(lse, min=1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3).to(qi.dtype))
    return torch.cat(outs, dim=1)[:, :sq]


# attention backend: "flash" (the hand-written kernel K8; its plain torch
# version on CPU tensors) or "auto" (the reference's dense path, chunked
# for long sequences, in plain torch)
_SDPA_BACKEND = "flash"
# a per-thread override of it (`attention_backend`)
_BACKEND_TLS = threading.local()


def _check_backend(name: str) -> None:
    if name not in ("auto", "flash"):
        raise ValueError(f"attention backend must be 'auto' or 'flash', "
                         f"got {name!r}")


def set_attention_backend(name: str) -> None:
    global _SDPA_BACKEND
    _check_backend(name)
    _SDPA_BACKEND = name


@contextlib.contextmanager
def attention_backend(name: str):
    """Run attention on `name` in this thread for the block's duration
    (nestable); other threads keep theirs."""
    _check_backend(name)
    prev = getattr(_BACKEND_TLS, "name", None)
    _BACKEND_TLS.name = name
    try:
        yield
    finally:
        _BACKEND_TLS.name = prev


def current_attention_backend() -> str:
    return getattr(_BACKEND_TLS, "name", None) or _SDPA_BACKEND


def _sdpa(q, k, v, q_pos, kv_pos, kv_valid, *, causal: bool,
          window: Optional[int], return_lse: bool = False):
    """q [B,Sq,H,D], k [B,Skv,KVH,D], v [B,Skv,KVH,Dv] (KVH divides H,
    Dv <= D). fp32 softmax, scores scaled by 1/sqrt(D). With
    `return_lse` (a decode step, Sq 1) also each row's log-sum-exp [B, H]
    f32, -inf where the row may see no key (K8's `return_lse`)."""
    if current_attention_backend() == "flash":
        return flash_attention(q, k, v, q_pos, kv_pos, kv_valid,
                               causal=causal, window=window,
                               return_lse=return_lse)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if return_lse:
        s = masked_logits(q, k, q_pos, kv_pos, kv_valid, causal=causal,
                          window=window)[..., 0, :]          # [B,H,Skv]
        lse = torch.where(s.amax(-1) > NEG, torch.logsumexp(s, -1),
                          -math.inf)
        return _sdpa_dense(q, k, v, q_pos, kv_pos, kv_valid, causal=causal,
                           window=window), lse
    if q.shape[1] * k.shape[1] > _SDPA_CHUNK_THRESHOLD:
        return _sdpa_chunked(q, k, v, q_pos, kv_pos, kv_valid,
                             causal=causal, window=window)
    return _sdpa_dense(q, k, v, q_pos, kv_pos, kv_valid,
                       causal=causal, window=window)


@dataclasses.dataclass
class KVCache:
    """Static-capacity *ring* cache. `index` counts tokens ever written
    (a host int); token at position p lives in slot p % cap. For
    full-attention layers cap >= tokens, so the ring never wraps.

    In `spmd.run` a point may hold a range of the ring's slots
    (`cache_split`): its tensors hold the global slots [start, start +
    their length) of a ring of `slots` (0: the tensors' own length), the
    range at its coordinate over `axes`, the mesh axes the slots are
    split over (() where it holds them all)."""
    k: torch.Tensor          # [B, cap, KVH, D] ([n_reps, ...] when stacked)
    v: torch.Tensor
    index: int = 0
    start: int = 0
    slots: int = 0
    axes: Tuple[str, ...] = ()


def _cache_update(cache: KVCache, k_new, v_new) -> KVCache:
    """Ring write of S_new entries at the cursor, in place: token t to
    global slot (index + t) % slots, only the last `slots` tokens where
    S_new is more; a point holding a range of the slots writes the
    tokens that fall in it (a decode step's slot is written by its owner
    alone). Returns the cache with the cursor moved on."""
    n, s = cache.k.shape[1], k_new.shape[1]
    cap, lo0, idx = cache.slots or n, cache.start, cache.index
    t = max(0, s - cap)
    while t < s:                        # runs of consecutive slots
        slot = (idx + t) % cap
        run = min(s - t, cap - slot)
        lo, hi = max(slot, lo0), min(slot + run, lo0 + n)
        if lo < hi:
            src = slice(t + lo - slot, t + hi - slot)
            cache.k[:, lo - lo0:hi - lo0] = k_new[:, src]
            cache.v[:, lo - lo0:hi - lo0] = v_new[:, src]
        t += run
    return dataclasses.replace(cache, index=idx + s)


def _ring_positions(index: int, cap: int, batch: int, device,
                    start: int = 0, n: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kv_pos, kv_valid) [batch, n] for the global slots [start, start +
    n) (default: all `cap`) of a ring cache whose cursor is `index`: slot
    j holds position index-1-((index-1-j) % cap), invalid if < 0.
    Contiguous int32 and bool, as K8 reads them."""
    n = cap - start if n is None else n
    j = torch.arange(start, start + n, device=device)
    kv_pos = index - 1 - ((index - 1 - j) % cap)
    return (kv_pos.to(torch.int32)[None, :].repeat(batch, 1),
            (kv_pos >= 0)[None, :].repeat(batch, 1))


def cache_positions(cache: KVCache, index: int, batch: int, device,
                    slot_dim: int = 1):
    """`_ring_positions` at cursor `index` of the slots `cache` holds (a
    point's range of the global ring), along its tensors' `slot_dim` (2
    for a stacked cache)."""
    n = cache.k.shape[slot_dim]
    return _ring_positions(index, cache.slots or n, batch, device,
                           cache.start, n)


def _cache_keys(cache: KVCache, k, v, positions, ring):
    """Write a call's `k` and `v` [B, S, ...] into `cache` and return (the
    cache, the keys and values the call attends to, their positions and
    validity, the axes a decode step's partial outputs are merged over).
    A cache that holds every slot, or a decode step's, is read as it
    stands (at `ring`, its `cache_positions` after the write, where the
    caller has them); under a split of the slots (`KVCache.axes`) a
    decode step's output over the point's slots is a partial merged over
    those axes (`_sdpa_merged`), a prefill into an empty cache that it
    does not overfill attends to the call's own k and v, which is what
    the written slots hold, and any other call all-gathers the written
    slots."""
    b, s = k.shape[:2]
    new = _cache_update(cache, k, v)
    split, cap = cache.axes, cache.slots or cache.k.shape[1]
    if not split or s == 1:             # the slots this point holds
        kv_pos, kv_valid = ring or cache_positions(new, new.index, b,
                                                   k.device)
        return new, new.k, new.v, kv_pos, kv_valid, split
    if cache.index == 0 and s <= cap:   # the slots hold this call
        return new, k, v, positions, torch.ones(
            (b, s), dtype=torch.bool, device=k.device), ()
    kv_pos, kv_valid = _ring_positions(new.index, cap, b, k.device)
    return (new, SP.all_gather(new.k, split, 1),
            SP.all_gather(new.v, split, 1), kv_pos, kv_valid, ())


def _sdpa_merged(q, k, v, q_pos, kv_pos, kv_valid, merge, **kw):
    """`_sdpa` of a call; where `merge` names axes (a decode step over a
    point's range of the slots) K8 also returns its log-sum-exp, and the
    points' f32 (output, lse) are all-gathered over `merge` in one
    gather and combined (`merge_partials`)."""
    out = _sdpa(q, k, v, q_pos, kv_pos, kv_valid, return_lse=bool(merge),
                **kw)
    if not merge:
        return out
    part = torch.cat([out[0][:, 0].float(), out[1][..., None]], dim=-1)
    parts = SP.all_gather(part[None], merge, 0)
    return merge_partials(parts[..., :-1], parts[..., -1]) \
        .to(q.dtype)[:, None]


def attention(p: Dict[str, torch.Tensor], x: torch.Tensor, a: AttnConfig,
              positions: torch.Tensor, cache: Optional[KVCache] = None,
              norm_kind: str = "rmsnorm",
              ring: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Pre-norm residual attention block. If `cache` is given, new KV are
    written to it and attention runs against the whole cache (decode /
    prefill into the cache); otherwise self-attention over x. `ring` is
    the cache's `cache_positions` after this write, when the caller has
    them (every layer of a step shares them).

    Sharded where the heads do not split whole (`seq_split` tp > 1, the
    reference's "seq" layout): the weights are gathered whole over
    "model"; where tp divides the call's S a point takes its S/tp query
    rows, projects and rotates them, all-gathers k and v along the
    sequence, attends with its rows' positions and all-gathers its rows
    of y, so the residual is whole on every point (otherwise every point
    takes every row). Under autograd h, the gathered weights and the
    gathered k and v enter the row split through `spmd.copy`: each
    point's gradient of them is its rows' share. A cache whose slots are
    split (`KVCache.axes`) is written by each point at its slots; a
    decode step runs K8 on the point's slots with their log-sum-exp and
    merges the points' outputs (one all-gather of (o, lse) over those
    axes, `merge_partials`); a prefill into an empty cache that it does
    not overfill attends against the call's own (gathered) k and v,
    which is what the written slots hold; any other call all-gathers the
    written slots."""
    b, s, d = x.shape
    h = norm(x, p["ln"], norm_kind)
    if a.kv_lora_rank:
        return _mla_attention(p, x, h, a, positions, cache, ring)

    w, tp = _attn_weights(p, a)
    nh, nkv = a.num_heads // tp, a.num_kv_heads // tp
    rows = _query_rows(a, s)
    q_pos = positions
    if tp > 1:                  # h enters the point's heads
        h = SP.copy(h, "model")
    elif rows is not None:      # h and the weights enter the point's rows
        h = SP.copy(h, "model")[:, rows]
        w = {n: SP.copy(t, "model") for n, t in w.items()}
        q_pos = positions[:, rows]
    sq = h.shape[1]
    q = h @ w["wq"]
    k = h @ w["wk"]
    v = h @ w["wv"]
    if a.qkv_bias:
        q = q + w["bq"]
        k = k + w["bk"]
        v = v + w["bv"]
    q = q.reshape(b, sq, nh, a.head_dim)
    k = k.reshape(b, sq, nkv, a.head_dim)
    v = v.reshape(b, sq, nkv, a.head_dim)
    cos, sin = rope_tables(q_pos, a.head_dim, a.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if rows is not None:        # every row's keys and values
        k = SP.copy(SP.all_gather(k, "model", 1), "model")
        v = SP.copy(SP.all_gather(v, "model", 1), "model")
    layout = HT.attn_layout(a.num_heads, s)
    q, k, v = HT.hint_qkv(q, k, v, layout)

    kw = dict(causal=a.causal, window=a.sliding_window)
    if cache is None:
        kv_valid = torch.ones(k.shape[:2], dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, q_pos, positions, kv_valid, **kw)
        new_cache = None
    else:
        new_cache, k, v, kv_pos, kv_valid, merge = _cache_keys(
            cache, k, v, positions, ring)
        out = _sdpa_merged(q, k.to(q.dtype), v.to(q.dtype), q_pos, kv_pos,
                           kv_valid, merge, **kw)
    out = HT.hint_attn_out(out, layout)
    y = out.reshape(b, sq, nh * a.head_dim) @ w["wo"]
    if tp > 1:
        y = SP.all_reduce(y, "model")
    elif rows is not None:      # every point's rows
        y = SP.all_gather(y, "model", 1)
    return x + y, new_cache


def heads_split(a: AttnConfig) -> int:
    """The ways attention's heads split over "model" in `spmd.run`: tp
    where it divides both the query and the kv heads, else 1 (also with
    no shard context)."""
    ctx = SP.context()
    tp = ctx.size("model") if ctx is not None else 1
    return tp if a.num_heads % tp == 0 and a.num_kv_heads % tp == 0 else 1


def seq_split(a: AttnConfig) -> int:
    """The ways attention or MLA splits by sequence over "model" in
    `spmd.run` (context parallelism): tp where tp > 1 and the heads do
    not split (`heads_split` 1; for MLA `mla_split` 1), else 1."""
    ctx = SP.context()
    tp = ctx.size("model") if ctx is not None else 1
    whole = mla_split(a) if a.kv_lora_rank else heads_split(a)
    return tp if tp > 1 and whole == 1 else 1


def _query_rows(a: AttnConfig, s: int) -> Optional[slice]:
    """This point's query rows [r S/tp, (r + 1) S/tp) of a call of S
    tokens under the sequence split (`seq_split` tp, r its coordinate on
    "model"); None, every row, where there is none or tp does not divide
    S (the reference's "none" layout)."""
    tp = seq_split(a)
    if tp == 1 or s % tp:
        return None
    r = SP.coordinate("model")
    return slice(r * s // tp, (r + 1) * s // tp)


def whole_batch(batch: int) -> bool:
    """Whether, in `spmd.run`, a batch of `batch` local rows is whole on
    every point of a data axis of more than one point: the global batch
    (`batch` times the run's `batch_ways`) does not divide the data axes
    (batch 1). There `cache_spec` splits a cache's length and the Mamba
    heads over "data" (`cache_split`, `ssm_split`). False with no shard
    context."""
    ctx = SP.context()
    if ctx is None:
        return False
    dp = ctx.size(batch_axes_of(ctx.mesh))
    return ctx.size("data") > 1 and (batch * ctx.batch_ways) % dp != 0


def cache_split(a: AttnConfig, batch: int, cap: int
                ) -> Tuple[Tuple[str, ...], int]:
    """(the mesh axes a point's attention or MLA cache of `cap` ring
    slots, for `batch` local rows, is split over along its slots, the
    global slot its range starts at) in `spmd.run`; ((), 0) with no shard
    context. "data" at a batch whole on every point (`whole_batch`),
    where `cache_spec` splits the KV length; then "model" under the
    sequence split (`seq_split`), where `cache_spec` splits attention's
    head_dim (MLA's latent r) and the port, whose K8 takes whole heads,
    splits the slots. An axis is kept only where `cap` divides over it
    and the axes kept before it, as `fit_spec` leaves a dim whole: never
    an uneven split."""
    ctx = SP.context()
    if ctx is None:
        return (), 0
    want = []
    if whole_batch(batch):
        want.append("data")
    if seq_split(a) > 1:
        want.append("model")
    axes, ways = [], 1
    for ax in want:
        if cap % (ways * ctx.size(ax)) == 0:
            axes.append(ax)
            ways *= ctx.size(ax)
    return tuple(axes), SP.coordinate(tuple(axes)) * (cap // ways)


def _attn_weights(p, a: AttnConfig):
    """(attention's weights as this point uses them, the ways its heads
    split): `p` and 1 with no shard context; in `spmd.run` the leaves
    split over "data" (FSDP) gathered, and where the heads do not split
    whole over "model" every leaf gathered whole over "model" too, in
    one all-gather (`spmd.whole_all`). Where
    they do, each leaf must be split over "model" along its heads."""
    if SP.context() is None:
        return p, 1
    tp = heads_split(a)
    w = {n: SP.whole(p[n], "data")
         for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv") if n in p}
    if tp == 1:                 # one gather for them all
        return SP.whole_all(w, "model"), 1
    for n, t in w.items():
        if SP.split_axes(t, 0 if n == "wo" else -1) != ("model",):
            raise ValueError(f"attention's heads split over 'model' but "
                             f"{n}'s spec does not split them")
    return w, tp


def mla_split(a: AttnConfig) -> int:
    """The ways MLA splits over "model" in `spmd.run`: `heads_split`'s tp
    where tp also divides the latent rank r and the rope dims dr (the
    cache's columns a point holds, as `cache_spec` splits them), else 1."""
    tp = heads_split(a)
    return tp if a.kv_lora_rank % tp == 0 and a.rope_head_dim % tp == 0 \
        else 1


_MLA_LEAVES = ("wq", "w_qr", "w_dkv", "w_kr", "w_uk", "w_uv", "wo")


def _mla_weights(p, a: AttnConfig):
    """(MLA's weights as this point uses them, the ways it splits, where
    this point's rope columns start): `p`, 1 and 0 with no shard context.
    In `spmd.run` the leaves split over "data" (FSDP) are gathered; where
    MLA does not split (`mla_split` 1) every leaf is gathered whole over
    "model" too, in one all-gather (`spmd.whole_all`: the sequence
    split). Where it does, each leaf must be split over "model":
    wq, w_qr, w_uk and w_uv by whole heads (their columns), wo by its rows,
    w_dkv along r; w_kr along dr, which is gathered whole, since RoPE
    pairs rope column i with i + dr/2, which may lie on another point.
    The third value is where this point's dr/tp rope columns start."""
    if SP.context() is None:
        return p, 1, 0
    tp = mla_split(a)
    w = {n: SP.whole(p[n], "data") for n in _MLA_LEAVES}
    if tp == 1:                 # one gather for them all
        return SP.whole_all(w, "model"), 1, 0
    for n, t in w.items():
        if SP.split_axes(t, 0 if n == "wo" else -1) != ("model",):
            raise ValueError(f"MLA splits over 'model' but {n}'s spec does "
                             f"not split it")
    off = SP.offset(w["w_kr"], -1)
    # every point rotates the whole k_rope, and the rotation's backward
    # moves a point's gradient into the pair columns of other points:
    # the whole w_kr's gradient is summed over "model" before the
    # gather's backward keeps the point's slice
    w["w_kr"] = SP.copy(SP.whole(w["w_kr"], "model"), "model")
    return w, tp, off


def _mla_attention(p, x, h, a: AttnConfig, positions, cache, ring):
    """DeepSeek-V2 multi-head latent attention. The cache holds only the
    compressed c_kv [B, cap, r] (in `KVCache.k`) and the shared, rotated
    k_rope [B, cap, dr] (in `KVCache.v`); k_nope and v are expanded from
    the cache's slots at each call, as the reference does.

    Sharded by heads (`mla_split` tp > 1): a point computes its r/tp
    columns of c_kv and the whole k_rope (from the gathered w_kr), expands
    k_nope and v for its nh/tp heads only (w_uk's and w_uv's local
    columns), runs K8 on those heads and all-reduces wo's partial product.
    Its cache holds `cache_spec`'s share. At a batch the data axes divide,
    that is c_kv's columns and its dr/tp columns of k_rope for every slot;
    both are all-gathered over "model" along their last dim before the
    expansion (without a cache, only c_kv: the whole k_rope is at hand).
    At a batch whole on every point (`whole_batch`, batch 1) it is a
    range of the slots over "data" at every column (`cache_split`): the
    call's c_kv is all-gathered over "model" before it is written, the
    point expands its slots alone, and a decode step's partial outputs
    are merged over "data" (`_cache_keys`, `_sdpa_merged`, as attention's
    are); the latent is never gathered over "model". Under autograd the
    gathered latent enters the local heads through `spmd.copy`, so its
    gather's backward keeps the point's slice of a gradient summed over
    "model"; the whole k_rope's reaches h and w_kr through their own
    copies.

    Sharded by sequence (`seq_split` tp > 1, where tp does not divide the
    heads, r and dr: the reference's "seq" layout), as attention is: the
    leaves are gathered whole over "model" in one gather; where tp
    divides the call's S a point projects and rotates its S/tp query rows
    (q, q_rope, and its rows' c_kv and k_rope), all-gathers c_kv and
    k_rope along the sequence (narrower than h), expands every head, runs
    K8 on its rows against every key and all-gathers its rows of y
    (otherwise every point takes every row). Its cache holds cap/tp of
    the slots at every column (`cache_split`), written, attended and
    merged as attention's (`_cache_keys`, `_sdpa_merged`). Under autograd
    h, the gathered leaves and the gathered c_kv and k_rope enter the row
    split through `spmd.copy`."""
    b, s, _ = x.shape
    w, tp, off = _mla_weights(p, a)
    nh, hd, dr = a.num_heads // tp, a.head_dim, a.rope_head_dim
    # the cache's every column: at batch 1, or where MLA's heads do not
    # split
    wide = cache is not None and (tp == 1 or whole_batch(b))
    rows = _query_rows(a, s)
    q_pos = positions
    if tp > 1:                  # h enters the point's heads and columns
        h = SP.copy(h, "model")
    elif rows is not None:      # h and the leaves enter the point's rows
        h = SP.copy(h, "model")[:, rows]
        w = {n: SP.copy(t, "model") for n, t in w.items()}
        q_pos = positions[:, rows]
    sq = h.shape[1]
    c_kv = h @ w["w_dkv"]                                  # [B,Sq,r/tp]
    cos, sin = rope_tables(q_pos, dr, a.rope_theta)
    k_rope = apply_rope((h @ w["w_kr"]).reshape(b, sq, 1, dr), cos,
                        sin)[:, :, 0]                       # [B,Sq,dr]
    q = (h @ w["wq"]).reshape(b, sq, nh, hd)
    q_rope = apply_rope((h @ w["w_qr"]).reshape(b, sq, nh, dr), cos, sin)
    if rows is not None:        # every row's latent and rope keys
        c_kv = SP.copy(SP.all_gather(c_kv, "model", 1), "model")
        k_rope = SP.copy(SP.all_gather(k_rope, "model", 1), "model")

    merge = ()
    if wide:                    # the point's slots, every column
        if tp > 1:              # the call's whole latent
            c_kv = SP.copy(SP.all_gather(c_kv, "model", -1), "model")
        cache, c_all, kr_all, kv_pos, kv_valid, merge = _cache_keys(
            cache, c_kv, k_rope, positions, ring)
        c_all, kr_all = c_all.to(x.dtype), kr_all.to(x.dtype)
    elif cache is not None:     # the point's dr/tp rope columns
        cache = _cache_update(cache, c_kv, k_rope[..., off:off + dr // tp])
        kv_pos, kv_valid = ring or cache_positions(cache, cache.index, b,
                                                   x.device)
        kr_all = SP.copy(SP.all_gather(cache.v.to(x.dtype), "model", -1),
                         "model")                           # [B,cap,dr]
        c_all = SP.copy(SP.all_gather(cache.k.to(x.dtype), "model", -1),
                        "model")                            # [B,cap,r]
    else:
        c_all, kr_all = c_kv, k_rope
        kv_pos = positions
        kv_valid = torch.ones((b, s), dtype=torch.bool, device=x.device)
        if tp > 1:              # the whole latent
            c_all = SP.copy(SP.all_gather(c_all, "model", -1), "model")

    skv = c_all.shape[1]
    k_nope = (c_all @ w["w_uk"]).reshape(b, skv, nh, hd)
    vv = (c_all @ w["w_uv"]).reshape(b, skv, nh, hd)
    # [q_nope; q_rope] . [k_nope; k_rope] is the two-term MLA logit, and
    # the scale 1/sqrt(hd + dr) is the reference's (its v padded to
    # hd + dr, sliced back after)
    qq = torch.cat([q, q_rope], dim=-1)
    kk = torch.cat([k_nope, kr_all[:, :, None].expand(b, skv, nh, dr)],
                   dim=-1)
    layout = HT.attn_layout(a.num_heads, s)
    qq, kk, vv = HT.hint_qkv(qq, kk, vv, layout)
    out = _sdpa_merged(qq, kk, vv, q_pos, kv_pos, kv_valid, merge,
                       causal=a.causal, window=None)
    out = HT.hint_attn_out(out, layout)
    y = out.reshape(b, sq, nh * hd) @ w["wo"]
    if tp > 1:
        y = SP.all_reduce(y, "model")
    elif rows is not None:      # every point's rows
        y = SP.all_gather(y, "model", 1)
    return x + y, cache


def cross_attention(p, x, enc_out, a: AttnConfig, norm_kind="rmsnorm"):
    """Decoder cross-attention (whisper), the reference's: queries from
    norm(x, ln_x), K and V projected from the encoder output, no RoPE,
    every position 0 and every key valid, non-causal, through `_sdpa`
    (on "flash" K8: its decode variant at a decode step's Sq of 1); the
    QKV biases are not applied, as the reference applies none here.
    Returns x + y @ wo. Sharded as `attention` (`_attn_weights`): the
    point's heads of wq, wk and wv, K and V projected from its rows of the
    whole `enc_out`, wo's partial product all-reduced over "model"."""
    b, s, _ = x.shape
    w, tp = _attn_weights(p, a)
    nh, nkv = a.num_heads // tp, a.num_kv_heads // tp
    h = norm(x, p["ln_x"], norm_kind)
    if tp > 1:                  # h and enc_out enter the point's heads
        h, enc_out = SP.copy(h, "model"), SP.copy(enc_out, "model")
    q = (h @ w["wq"]).reshape(b, s, nh, a.head_dim)
    se = enc_out.shape[1]
    k = (enc_out @ w["wk"]).reshape(b, se, nkv, a.head_dim)
    v = (enc_out @ w["wv"]).reshape(b, se, nkv, a.head_dim)
    pos = dict(dtype=torch.int32, device=x.device)
    out = _sdpa(q, k, v, torch.zeros((b, s), **pos),
                torch.zeros((b, se), **pos),
                torch.ones((b, se), dtype=torch.bool, device=x.device),
                causal=False, window=None)
    y = out.reshape(b, s, nh * a.head_dim) @ w["wo"]
    if tp > 1:
        y = SP.all_reduce(y, "model")
    return x + y


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def _ffn(p, h, act: str):
    """An MLP's output for the normed input `h`. In `spmd.run` its leaves
    split over "data" are gathered, and where its hidden units are split
    (w2's rows) w2's partial product is all-reduced over their axes."""
    w1, w2 = SP.whole(p["w1"], "data"), SP.whole(p["w2"], "data")
    w3 = SP.whole(p["w3"], "data") if "w3" in p else None
    split = SP.split_axes(w2, 0)
    h = SP.copy(h, split)           # h enters the point's hidden units
    if act == "swiglu":
        y = (silu(h @ w1) * (h @ w3)) @ w2
    elif act == "relu2":                      # squared ReLU (nemotron)
        y = torch.square(torch.relu(h @ w1)) @ w2
    else:                                     # jax.nn.gelu's tanh form
        y = F.gelu(h @ w1, approximate="tanh") @ w2
    return SP.all_reduce(y, split) if split else y


def mlp(p, x, act: str, norm_kind: str = "rmsnorm"):
    """Pre-norm residual MLP."""
    return x + _ffn(p, norm(x, p["ln"], norm_kind), act)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """`table[tokens]`; in `spmd.run`, with the vocabulary split, each
    point looks up the tokens of its range (0 for the others) and the
    points' rows are all-reduced over the vocabulary's axes."""
    table = SP.whole(table, "data")
    split = SP.split_axes(table, 0)
    if not split:
        return table[tokens]
    n = table.shape[0]
    ids = tokens - SP.offset(table, 0)
    hit = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, n - 1)]
    return SP.all_reduce(torch.where(hit[..., None], rows, 0), split)


class Route(NamedTuple):
    """A MoE layer's routing of T tokens in `groups` equal groups of
    consecutive tokens: each token's top-k experts (`top_e`, by
    descending weight) and weights renormalised over them (`top_w`,
    f32), each (token, slot)'s place in its expert's queue in its group
    (`pos`, counted over the group's tokens and slots in order), whether
    it fits the expert's `capacity` in that group (`keep`)."""
    top_w: torch.Tensor     # [T, k] f32
    top_e: torch.Tensor     # [T, k] int64
    pos: torch.Tensor       # [T, k] int64
    keep: torch.Tensor      # [T, k] bool
    capacity: int
    groups: int


def moe_route(router: torch.Tensor, h: torch.Tensor, m: MoEConfig,
              s: int, groups: Optional[int] = None) -> Route:
    """The reference's routing: the T tokens split into G = dp_size()
    groups (1 when G does not divide T; G is the ambient mesh's
    data-parallel ways; a sharded MoE passes as `groups` the count of
    groups its local tokens hold), f32 router logits, softmax, top-k
    renormalised, each group's capacity int(cf * Tg * k / E) (at least
    1), or Tg at
    decode (s == 1: dropless), queue positions counted within the
    group. `h` is [T, d]."""
    t = h.shape[0]
    g = HT.dp_size() if groups is None else groups
    if t % g:
        g = 1
    tg = t // g
    probs = torch.softmax(h.float() @ router, dim=-1)
    top_w, top_e = torch.topk(probs, m.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    cap = tg if s == 1 else int(max(1, m.capacity_factor * tg * m.top_k
                                    / m.num_experts))
    # each expert's row of (token, slot) picks in each group, scanned
    # along the row: a scan down [T*k, E] would run E-wide (336 ms of
    # deepseek-v2-lite's 0.53 s prefill on an H100)
    flat = F.one_hot(top_e.reshape(-1), m.num_experts).t().contiguous() \
        .reshape(m.num_experts, g, tg * m.top_k)
    pos = ((torch.cumsum(flat, dim=2) - flat) * flat).sum(0)
    pos = pos.reshape(t, m.top_k)
    return Route(top_w, top_e, pos, pos < cap, cap, g)


def moe(p, x, cfg: ModelConfig, norm_kind: str = "rmsnorm"):
    """Top-k routed experts with a capacity per token group (overflow
    tokens take only the residual path), plus the shared experts run
    densely (deepseek). Each expert's kept tokens are gathered into its
    rows of [E, G * (C + 1), d], group g's at rows g * (C + 1) onward (a
    dropped (token, slot) into its group's spare row C, whose output no
    token takes), the experts run as batched products, and each (token,
    slot) adds its expert's output times its weight (rounded to the model
    dtype, as the reference's combine; 0 where dropped) back to the
    token, summed in f32 by a reduction over the slots (the same bits on
    every point that runs it). Nothing waits on the device: no count of
    kept slots is read."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    # FSDP gathers; in spmd.run the groups the local tokens hold
    router, w1, w2, w3 = (SP.whole(p[n], "data")
                          for n in ("router", "w1", "w2", "w3"))
    ctx = SP.context()
    groups = None if ctx is None else HT.dp_size() // ctx.batch_ways
    h = norm(x, p["ln"], norm_kind).reshape(t, d)
    r = moe_route(router, h, m, s, groups)
    h = HT.hint(h.reshape(r.groups, t // r.groups, d), "batch", None,
                None).reshape(t, d)
    # experts, or d_ff inside them, split over `split`: the tokens and
    # their weights enter the point's share of the experts' work
    split = SP.split_axes(w1, 0) or SP.split_axes(w2, 1)
    h, top_w = SP.copy(h, split), SP.copy(r.top_w, split)
    tok = torch.arange(t, device=x.device).repeat_interleave(m.top_k)
    e = r.top_e.reshape(-1)
    rows = r.capacity + 1
    c = r.pos.reshape(-1).clamp(max=r.capacity)
    w = (top_w * r.keep).reshape(-1)
    n_local = w1.shape[0]
    if SP.split_axes(w1, 0):        # expert-parallel: this point's experts
        lo = SP.offset(w1, 0)
        mine = (e >= lo) & (e < lo + n_local)
        e = (e - lo).clamp(0, n_local - 1)
        c = torch.where(mine, c, r.capacity)
        w = w * mine
    if r.groups > 1:                # group g's rows start at g * (C + 1)
        c = c + tok // (t // r.groups) * rows
    xin = h.new_zeros((n_local, r.groups * rows, d))
    xin[e, c] = h[tok]
    xin = HT.hint(xin, "model", None, None)
    hmid = silu(torch.bmm(xin, w1)) * torch.bmm(xin, w3)
    hmid = HT.hint(hmid, "model", None, None)
    xout = torch.bmm(hmid, w2)                            # [E,G(C+1),d]
    w = w.to(x.dtype).float()
    # a token's k slots summed by a reduction, not scattered: CUDA's
    # `index_add_` adds in the order its atomics land, so the points that
    # each run a MoE no mesh axis splits would hold other bits
    y = (xout[e, c].float() * w[:, None]).reshape(t, m.top_k, d).sum(1)
    if split:                       # experts, or d_ff inside them
        y = SP.all_reduce(y, split)
    y = y.to(x.dtype)
    if m.num_shared:
        sp = p["shared"]
        hs = norm(x, sp["ln"], norm_kind).reshape(t, d)
        y = y + _ffn(sp, hs, "swiglu")
    return x + y.reshape(b, s, d)


def moe_aux_loss(p, x, cfg: ModelConfig, norm_kind: str = "rmsnorm"):
    """Load-balancing auxiliary loss (Switch/GShard): E times the dot of
    each expert's share of top-1 choices and its mean router
    probability, in f32. In `spmd.run` with the batch split, the shares
    are the global batch's: each point's counts and probability sums
    all-reduced over the batch's axes (one call)."""
    m = cfg.moe
    h = norm(x, p["ln"], norm_kind)
    router = SP.whole(p["router"], "data")
    probs = torch.softmax(h.reshape(-1, h.shape[-1]).float() @ router,
                          dim=-1)
    top_e = torch.argmax(probs, dim=-1)
    chosen = F.one_hot(top_e, m.num_experts).float()
    axes = SP.batch_axes()
    if not axes:
        return m.num_experts * torch.sum(chosen.mean(dim=0)
                                         * probs.mean(dim=0))
    sums = SP.all_reduce(torch.cat([chosen.sum(0), probs.sum(0)]), axes)
    n = probs.shape[0] * SP.context().size(axes)
    return m.num_experts * torch.sum((sums[:m.num_experts] / n)
                                     * (sums[m.num_experts:] / n))


# --------------------------------------------------------------------------
# Mamba-2 (SSD)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class MambaCache:
    """A Mamba-2 layer's decode state, written in place: the last
    d_conv - 1 inputs of the causal conv (the xBC stream, before the
    conv, in the model dtype) and the SSM state (f32)."""
    conv: torch.Tensor       # [B, d_conv-1, d_inner + 2N] ([n_reps, ...])
    ssm: torch.Tensor        # [B, H, P, N]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., T] -> [..., T, T]; out[i,j] = sum_{l=j+1..i} x[l] (tril),
    -inf above the diagonal."""
    t = x.shape[-1]
    xe = x[..., :, None].expand(*x.shape, t)
    m1 = torch.ones((t, t), dtype=torch.bool, device=x.device).tril(-1)
    s = torch.cumsum(torch.where(m1, xe, 0.0), dim=-2)
    m2 = torch.ones((t, t), dtype=torch.bool, device=x.device).tril(0)
    return torch.where(m2, s, -math.inf)


def _ssd_chunked(xh, dt, a_log, B, C, chunk: int):
    """SSD block-decomposition scan (Mamba-2 §6, ngroups=1), in f32.

    xh [b,s,h,p], dt [b,s,h] (post-softplus, f32), a_log [h], B/C [b,s,n]
    with s a multiple of `chunk`. Returns y [b,s,h,p] in xh's dtype and
    the final state [b,h,p,n] (f32). The reference's three- and
    four-operand einsums run as pairs of products."""
    b, s, hh, pp = xh.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    c = s // chunk
    A = -torch.exp(a_log.float())                            # [h]
    dA = dt * A[None, None, :]                               # [b,s,h]
    xd = xh * dt[..., None].to(xh.dtype)                     # dt-weighted x

    def r(t):
        return t.reshape(b, c, chunk, *t.shape[2:])
    Xc, Ac, Bc, Cc = r(xd).float(), r(dA), r(B).float(), r(C).float()
    Ac = Ac.movedim(-1, 1)                                   # [b,h,c,l]
    A_cum = torch.cumsum(Ac, dim=-1)

    L = torch.exp(_segsum(Ac))                               # [b,h,c,l,l]
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", L * CB[:, None], Xc)

    decay_states = torch.exp(A_cum[..., -1:] - A_cum)        # [b,h,c,l]
    states = torch.einsum("bcln,bclhp->bchpn", Bc,
                          Xc * decay_states.permute(0, 2, 3, 1)[..., None])

    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    pad_cum = F.pad(A_cum[..., -1], (1, 0))                  # [b,h,c+1]
    decay_chunk = torch.exp(_segsum(pad_cum))                # [b,h,c+1,c+1]
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states, final = new_states[:, :-1], new_states[:, -1]

    state_decay = torch.exp(A_cum)                           # [b,h,c,l]
    Y_off = torch.einsum("bcln,bchpn->bclhp", Cc, states) \
        * state_decay.permute(0, 2, 3, 1)[..., None]
    y = (Y_diag + Y_off).reshape(b, s, hh, pp)
    return y.to(xh.dtype), final


def mamba_split(mb: MambaConfig, d: int) -> int:
    """The ways the Mamba-2 mixer of width `d` splits over "model" in
    `spmd.run`: tp where it divides the heads and the conv's d_inner + 2N
    channels (and so in_proj's d_inner + channels + heads columns: the
    dims `param_specs` and `cache_spec` split), else 1 (also with no
    shard context)."""
    ctx = SP.context()
    tp = ctx.size("model") if ctx is not None else 1
    d_inner = mb.expand * d
    nheads, ch = d_inner // mb.head_dim, d_inner + 2 * mb.d_state
    return tp if nheads % tp == 0 and ch % tp == 0 else 1


_MAMBA_LEAVES = ("in_proj", "conv_w", "out_proj", "a_log", "dt_bias",
                 "d_skip")


def _mamba_weights(p, mb: MambaConfig, d: int):
    """(the mixer's weights as this point uses them, the ways it splits,
    this point's first head, its first conv channel): `p`, 1, 0 and 0
    with no shard context. In `spmd.run` the leaves split over "data"
    (FSDP) are gathered; where the mixer does not split (`mamba_split`
    1) every leaf is gathered whole over "model" too. Where it does,
    in_proj must be split over "model" by its columns, conv_w by its
    channels and out_proj by its rows (whole heads, as d_inner / tp is);
    the per-head a_log, dt_bias and d_skip enter the point's heads
    through `spmd.copy` (their gradient is summed over "model"). The
    third value is the first head of the point's rows of out_proj."""
    if SP.context() is None:
        return p, 1, 0, 0
    tp = mamba_split(mb, d)
    w = {n: SP.whole(p[n], "data") for n in _MAMBA_LEAVES}
    if tp == 1:
        return {n: SP.whole(t, "model") for n, t in w.items()}, 1, 0, 0
    for n, dim in (("in_proj", -1), ("conv_w", -1), ("out_proj", 0)):
        if SP.split_axes(w[n], dim) != ("model",):
            raise ValueError(f"the Mamba-2 mixer splits over 'model' but "
                             f"{n}'s spec does not split it")
    for n in ("a_log", "dt_bias", "d_skip"):
        w[n] = SP.copy(SP.whole(w[n], "model"), "model")
    return (w, tp, SP.offset(w["out_proj"], 0) // mb.head_dim,
            SP.offset(w["conv_w"], -1))


def ssm_split(mb: MambaConfig, d: int, data: bool
              ) -> Tuple[Tuple[str, ...], int, int]:
    """(the mesh axes a Mamba-2 mixer of width `d` splits the heads of its
    SSM state and step over, its first head, its number of heads) in
    `spmd.run`; ((), 0, H) with no shard context. Where `data` (a cache at
    a batch whole on every point: `whole_batch`), "data", as `cache_spec`
    splits the heads at batch 1, or no axis where the data axis does not
    divide them (`fit_spec`); otherwise "model" where the mixer splits
    (`mamba_split`)."""
    nheads = mb.expand * d // mb.head_dim
    ctx = SP.context()
    if ctx is None:
        return (), 0, nheads
    if data:
        axes = ("data",) if nheads % ctx.size("data") == 0 else ()
    else:
        axes = ("model",) if mamba_split(mb, d) > 1 else ()
    n = nheads // ctx.size(axes)
    return axes, SP.coordinate(axes) * n, n


def mamba2(p, x: torch.Tensor, mb: MambaConfig,
           cache: Optional[MambaCache] = None, norm_kind: str = "rmsnorm"
           ) -> Tuple[torch.Tensor, Optional[MambaCache]]:
    """Mamba-2 mixer block (pre-norm residual). With no cache, or s > 1,
    the full-sequence path (train, whole-prompt prefill): the causal
    depthwise conv as d_conv shifted multiply-adds in the model dtype,
    SSD in f32 over the sequence zero-padded to a multiple of `chunk`,
    starting from the zero state whatever the cache holds; a given cache
    takes the conv window and the final state. s == 1 with a cache is
    the recurrent decode step. The cache is written in place.

    Sharded (`mamba_split` tp > 1; in_proj's contiguous column split
    does not follow the heads: on tp 2 at mamba2-370m a point holds all
    of z and the first 144 columns of xBC): a point projects with its
    columns of in_proj and all-gathers the result over "model", runs the
    conv on its ch/tp channels (its conv cache holds those), all-gathers
    the conv's output, takes its H/tp heads of x, z and dt with B and C
    whole (one group), runs the SSD or the recurrent step on those heads
    (its SSM cache holds them), gates, multiplies by its rows of out_proj
    and all-reduces over "model". Under autograd both gathered tensors
    enter the point's share through `spmd.copy`: each point reads other
    points' columns, so a gather's backward keeps the point's slice of
    a gradient summed over "model".

    With a cache at a batch whole on every point (`whole_batch`, batch
    1) the SSM state's heads split over "data" instead (`ssm_split`,
    whole over "model", as `cache_spec` splits them), and those are
    generally not the heads of the point's rows of out_proj: the point
    runs the SSD or the step on its data coordinate's H/dp heads (their
    z, dt and per-head scalars), all-gathers the gated output over
    "data", and multiplies its rows' heads of it by its rows of out_proj
    (then the sum over "model" as above). The conv keeps its ch/tp
    channels over "model"."""
    b, s, d = x.shape
    d_inner = mb.expand * d
    nheads = d_inner // mb.head_dim
    n, hp = mb.d_state, mb.head_dim
    ch = d_inner + 2 * n
    w, tp, h0, c0 = _mamba_weights(p, mb, d)
    nh, cl = nheads // tp, ch // tp
    # the SSM's heads [s0, s0 + sn), split over `over`
    over, s0, sn = ssm_split(mb, d, cache is not None and whole_batch(b))
    heads = slice(s0 * hp, (s0 + sn) * hp)
    h = norm(x, p["ln"], norm_kind)
    if tp > 1:                  # h enters the point's columns
        h = SP.copy(h, "model")
    zxbcdt = h @ w["in_proj"]
    if tp > 1:
        zxbcdt = SP.copy(SP.all_gather(zxbcdt, "model", -1), "model")
    z = zxbcdt[..., :d_inner][..., heads]
    xbc = zxbcdt[..., d_inner:d_inner + ch][..., c0:c0 + cl]
    dt_raw = zxbcdt[..., -nheads:][..., s0:s0 + sn]
    a_log, dt_bias, d_skip = (w[k][s0:s0 + sn]
                              for k in ("a_log", "dt_bias", "d_skip"))

    def whole_channels(t):      # the conv's output over every channel
        t = silu(t)
        if tp > 1:
            t = SP.copy(SP.all_gather(t, "model", -1), "model")
        return t

    if cache is None or s > 1:
        xbc_pad = F.pad(xbc, (0, 0, mb.d_conv - 1, 0))
        cw = w["conv_w"].to(xbc.dtype)
        acc = torch.zeros_like(xbc)
        for kk in range(mb.d_conv):
            acc = acc + xbc_pad[:, kk:kk + s] * cw[kk]
        xbc = whole_channels(acc)
        xh = xbc[..., :d_inner][..., heads].reshape(b, s, sn, hp)
        B = xbc[..., d_inner:d_inner + n]
        C = xbc[..., d_inner + n:]
        xh = HT.hint(xh, "batch", None, "model", None)
        dt = F.softplus(dt_raw.float() + dt_bias)
        dt = HT.hint(dt, "batch", None, "model")
        pad_len = (-s) % mb.chunk

        def zpad(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad_len))
        y, final = _ssd_chunked(zpad(xh), zpad(dt), a_log, zpad(B),
                                zpad(C), mb.chunk)
        y = y[:, :s]
        if cache is not None:           # prefill -> decode handoff
            cache.conv.copy_(xbc_pad[:, s:])      # the last d_conv - 1
            cache.ssm.copy_(final)
    else:
        # single-token recurrent step
        xbc_win = torch.cat([cache.conv, xbc], dim=1)        # [b,k,ch]
        xbc1 = whole_channels(torch.einsum("bkc,kc->bc", xbc_win,
                                           w["conv_w"].to(xbc.dtype)))
        xh = xbc1[:, :d_inner][:, heads].reshape(b, sn, hp)
        B = xbc1[:, d_inner:d_inner + n]
        C = xbc1[:, d_inner + n:]
        dt = F.softplus(dt_raw[:, 0].float() + dt_bias)   # [b,h]
        dA = torch.exp(dt * -torch.exp(a_log.float()))
        hstate = cache.ssm * dA[..., None, None] \
            + (dt[..., None, None] * xh.float()[..., None]
               * B.float()[:, None, None, :])
        hstate = HT.hint(hstate, "batch", "model", None, None)
        y = torch.einsum("bhpn,bn->bhp", hstate, C.float())
        y = y.to(x.dtype).reshape(b, 1, sn, hp)
        cache.conv.copy_(xbc_win[:, 1:])
        cache.ssm.copy_(hstate)

    y = y.reshape(b, s, sn * hp) + (
        d_skip.to(x.dtype)[None, None, :, None]
        * xh.reshape(b, s, sn, hp)).reshape(b, s, sn * hp)
    y = y * silu(z)
    if "data" in over:          # every head, then the out_proj rows' own
        y, s0 = SP.all_gather(y, "data", -1), 0
    y = y[..., (h0 - s0) * hp:(h0 - s0 + nh) * hp] @ w["out_proj"]
    if tp > 1:
        y = SP.all_reduce(y, "model")
    return x + y, cache
