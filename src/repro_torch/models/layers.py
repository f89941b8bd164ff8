"""Forward passes of the blocks the port runs: pre-norm residual
attention (GQA, optionally biased QKV — qwen; RoPE; a static-capacity
ring KV cache for serving) and the swiglu / relu2 / gelu MLPs.

Two execution modes, as the reference's:
  * prefill: full-sequence forward, writing the KV cache if one is given;
  * decode: q_len == 1 step against the cache.

Numerics: matmuls in the param dtype (bf16), softmax/logits in fp32,
norms in fp32 (their weights are f32), RoPE tables in f32 cast to the
activations' dtype before the rotation.

Differences from the reference, on purpose:
  * the cache is updated in place (the reference copies it functionally:
    at qwen1.5-4b's full width a copy is 3.42 GB per decode step), and
    its cursor is a host int, so no step syncs the device to read it;
  * the attention backend defaults to "flash", the hand-written kernel
    (K8): the reference defaults to "auto" only because Pallas runs in
    interpret mode off a TPU (ROADMAP Queue 3).
The reference's sharding hints (`parallel/hints.py`) are identities
without a mesh and are left out (they return with the distributed
runtime). MLA, cross-attention, MoE and Mamba-2 raise
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flashattn import flash_attention
from repro_torch.kernels.flashattn.ref import masked_logits, sdpa_ref
from repro_torch.models.common import TODO, AttnConfig

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
    b, sq, h, d = q.shape
    skv = k.shape[1]
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
        acc = torch.zeros((b, h, qc, d), dtype=torch.float32,
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


def set_attention_backend(name: str) -> None:
    global _SDPA_BACKEND
    if name not in ("auto", "flash"):
        raise ValueError(f"attention backend must be 'auto' or 'flash', "
                         f"got {name!r}")
    _SDPA_BACKEND = name


def _sdpa(q, k, v, q_pos, kv_pos, kv_valid, *, causal: bool,
          window: Optional[int]):
    """q [B,Sq,H,D], k/v [B,Skv,KVH,D] (KVH divides H). fp32 softmax."""
    if _SDPA_BACKEND == "flash":
        return flash_attention(q, k, v, q_pos, kv_pos, kv_valid,
                               causal=causal, window=window)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if q.shape[1] * k.shape[1] > _SDPA_CHUNK_THRESHOLD:
        return _sdpa_chunked(q, k, v, q_pos, kv_pos, kv_valid,
                             causal=causal, window=window)
    return _sdpa_dense(q, k, v, q_pos, kv_pos, kv_valid,
                       causal=causal, window=window)


@dataclasses.dataclass
class KVCache:
    """Static-capacity *ring* cache. `index` counts tokens ever written
    (a host int); token at position p lives in slot p % cap. For
    full-attention layers cap >= tokens, so the ring never wraps."""
    k: torch.Tensor          # [B, cap, KVH, D] ([n_reps, ...] when stacked)
    v: torch.Tensor
    index: int = 0


def _cache_update(cache: KVCache, k_new, v_new) -> KVCache:
    """Ring write of S_new entries at the cursor, in place; returns the
    cache with the cursor moved on."""
    cap = cache.k.shape[1]
    idx = cache.index
    s = k_new.shape[1]
    if s >= cap:
        # keep only the last `cap` tokens, placed at slot pos % cap
        p0 = idx + s - cap
        cache.k.copy_(torch.roll(k_new[:, -cap:], p0 % cap, dims=1))
        cache.v.copy_(torch.roll(v_new[:, -cap:], p0 % cap, dims=1))
    elif idx % cap + s <= cap:          # one run of slots (decode: s == 1)
        slot = idx % cap
        cache.k[:, slot:slot + s] = k_new
        cache.v[:, slot:slot + s] = v_new
    else:                               # the run wraps round the ring
        slots = (idx + torch.arange(s, device=k_new.device)) % cap
        cache.k[:, slots] = k_new.to(cache.k.dtype)
        cache.v[:, slots] = v_new.to(cache.v.dtype)
    return KVCache(cache.k, cache.v, idx + s)


def _ring_positions(index: int, cap: int, batch: int,
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kv_pos, kv_valid) [batch, cap] for a ring cache whose cursor is
    `index`: slot j holds position index-1-((index-1-j) % cap), invalid
    if < 0. Contiguous int32 and bool, as K8 reads them."""
    j = torch.arange(cap, device=device)
    kv_pos = index - 1 - ((index - 1 - j) % cap)
    return (kv_pos.to(torch.int32)[None, :].repeat(batch, 1),
            (kv_pos >= 0)[None, :].repeat(batch, 1))


def attention(p: Dict[str, torch.Tensor], x: torch.Tensor, a: AttnConfig,
              positions: torch.Tensor, cache: Optional[KVCache] = None,
              norm_kind: str = "rmsnorm",
              ring: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Pre-norm residual attention block. If `cache` is given, new KV are
    written to it and attention runs against the whole cache (decode /
    prefill into the cache); otherwise self-attention over x. `ring` is
    the cache's `_ring_positions` after this write, when the caller has
    them (every layer of a step shares them)."""
    b, s, d = x.shape
    h = norm(x, p["ln"], norm_kind)
    if a.kv_lora_rank:
        return _mla_attention(p, x, h, a, positions, cache, norm_kind)

    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if a.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, a.num_heads, a.head_dim)
    k = k.reshape(b, s, a.num_kv_heads, a.head_dim)
    v = v.reshape(b, s, a.num_kv_heads, a.head_dim)
    cos, sin = rope_tables(positions, a.head_dim, a.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        kv_valid = torch.ones(k.shape[:2], dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, positions, positions, kv_valid,
                    causal=a.causal, window=a.sliding_window)
        new_cache = None
    else:
        new_cache = _cache_update(cache, k, v)
        kv_pos, kv_valid = ring or _ring_positions(
            new_cache.index, cache.k.shape[1], b, x.device)
        out = _sdpa(q, new_cache.k.to(q.dtype), new_cache.v.to(q.dtype),
                    positions, kv_pos, kv_valid, causal=a.causal,
                    window=a.sliding_window)
    y = out.reshape(b, s, a.num_heads * a.head_dim) @ p["wo"]
    return x + y, new_cache


def _mla_attention(p, x, h, a: AttnConfig, positions, cache, norm_kind):
    raise NotImplementedError(f"MLA attention {TODO}")


def cross_attention(p, x, enc_out, a: AttnConfig, norm_kind="rmsnorm"):
    raise NotImplementedError(f"cross-attention {TODO}")


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def mlp(p, x, act: str, norm_kind: str = "rmsnorm"):
    h = norm(x, p["ln"], norm_kind)
    if act == "swiglu":
        y = (silu(h @ p["w1"]) * (h @ p["w3"])) @ p["w2"]
    elif act == "relu2":                      # squared ReLU (nemotron)
        y = torch.square(torch.relu(h @ p["w1"])) @ p["w2"]
    else:                                     # jax.nn.gelu's tanh form
        y = F.gelu(h @ p["w1"], approximate="tanh") @ p["w2"]
    return x + y


def moe(p, x, cfg, norm_kind: str = "rmsnorm"):
    raise NotImplementedError(f"MoE layers {TODO}")


def moe_aux_loss(p, x, cfg, norm_kind: str = "rmsnorm"):
    raise NotImplementedError(f"MoE layers {TODO}")


def mamba2(p, x, mb, cache=None, norm_kind: str = "rmsnorm"):
    raise NotImplementedError(f"Mamba-2 layers {TODO}")
