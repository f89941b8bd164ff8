"""Model configuration + parameter-initialization helpers.

One `ModelConfig` covers the whole zoo; per-architecture files in
`repro_torch.configs` instantiate it (copied from the reference). Blocks
are described by a repeating `block_pattern`; parameters keep the
reference's layout: `embed`, `ln_f`, `unembed`, `prefix_layers`, and
`layers` as one dict per pattern slot whose tensors are stacked on a
leading `[n_reps]` axis.

`param_shapes` walks every architecture's layout from its shapes alone,
so `param_count` needs no initialisation. `init_params` draws from a
`torch.Generator` at the reference's distributions for every
architecture of the zoo: full and sliding-window attention (with QKV
bias), MLA's latent attention, the Mamba-2 mixer, the swiglu, relu2 and
gelu MLPs and the routed MoE (with shared experts and deepseek's leading
dense layers as `prefix_layers`); a pattern slot's mixer follows
`cfg.layer_kind`, so a hybrid stack (jamba's 1 attention : 7 Mamba)
mixes them. Whisper's encoder (`encoder`, stacked on `[n_enc_layers]`,
and `enc_ln_f`) and decoder cross-attention (`cross`, stacked on
`[n_layers]`), and the stub frontends' projections (`frame_proj`,
`patch_proj`), are drawn as the reference draws them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int              # per-expert hidden dim
    num_shared: int = 0           # always-on shared experts
    capacity_factor: float = 1.25
    every_n_layers: int = 1       # MoE on layers where (i % n == n-1)
    first_dense: int = 0          # leading dense layers (deepseek style)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # SWA (mixtral/mistral)
    # MLA (deepseek): latent KV compression
    kv_lora_rank: Optional[int] = None
    rope_head_dim: int = 64                # decoupled RoPE dim under MLA
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    vocab_size: int
    d_ff: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    # repeating layer pattern: tuple of "attn" | "mamba"; cycled over depth
    block_pattern: Tuple[str, ...] = ("attn",)
    act: str = "swiglu"                 # swiglu | relu2 | gelu
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    tie_embeddings: bool = False
    # encoder-decoder (whisper): n_enc_layers>0 adds an encoder + cross-attn
    n_enc_layers: int = 0
    enc_seq_len: int = 0                # encoder positions (frames)
    # multimodal stub frontends provide pre-computed continuous embeddings
    frontend: Optional[str] = None      # None | "audio_stub" | "vision_stub"
    num_patches: int = 0                # vision stub: patches per sample
    max_seq_len: int = 131_072
    dtype: Any = torch.bfloat16
    # long-context serving support class (DESIGN.md §5):
    #   "full" = unbounded KV, "window" = SWA-bounded, "state" = SSM state
    context_class: str = "full"

    @property
    def block_period(self) -> int:
        return len(self.block_pattern)

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % self.block_period]

    def param_count(self) -> int:
        """Total parameters (exact, from the layout's shapes)."""
        return sum(math.prod(s) for s in _leaves(param_shapes(self)))

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: top_k + shared experts only)."""
        total = self.param_count()
        if self.moe is None:
            return total
        m = self.moe
        # count routed expert params then scale by top_k/num_experts
        per_expert = 3 * self.d_model * m.d_ff_expert
        n_moe = len(moe_layer_indices(self))
        routed = n_moe * m.num_experts * per_expert
        active_routed = n_moe * m.top_k * per_expert
        return total - routed + active_routed


def moe_layer_indices(cfg: ModelConfig) -> Sequence[int]:
    if cfg.moe is None:
        return []
    m = cfg.moe
    out = []
    for i in range(cfg.n_layers):
        if i < m.first_dense:
            continue
        if (i % m.every_n_layers) == (m.every_n_layers - 1):
            out.append(i)
    return out


def layer_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(prefix layers, full pattern period, repetitions of the period):
    the true repeat period is lcm(pattern, moe period), after a
    non-repeating prefix of `first_dense` layers."""
    moe_period = cfg.moe.every_n_layers if cfg.moe else 1
    prefix = cfg.moe.first_dense if cfg.moe else 0
    full_period = int(np.lcm(cfg.block_period, moe_period))
    body = cfg.n_layers - prefix
    if body % full_period:
        raise ValueError(f"{cfg.name}: layers {cfg.n_layers} minus prefix "
                         f"{prefix} must be divisible by pattern period "
                         f"{full_period}")
    return prefix, full_period, body // full_period


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------
# shapes of every architecture's parameters
# --------------------------------------------------------------------------


def _attn_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    a, d = cfg.attn, cfg.d_model
    if a.kv_lora_rank:
        r = a.kv_lora_rank
        p = {"wq": (d, a.num_heads * a.head_dim), "w_dkv": (d, r),
             "w_uk": (r, a.num_heads * a.head_dim),
             "w_uv": (r, a.num_heads * a.head_dim),
             "w_kr": (d, a.rope_head_dim),
             "w_qr": (d, a.num_heads * a.rope_head_dim),
             "wo": (a.num_heads * a.head_dim, d)}
    else:
        p = {"wq": (d, a.num_heads * a.head_dim),
             "wk": (d, a.num_kv_heads * a.head_dim),
             "wv": (d, a.num_kv_heads * a.head_dim),
             "wo": (a.num_heads * a.head_dim, d)}
        if a.qkv_bias:
            p.update(bq=(a.num_heads * a.head_dim,),
                     bk=(a.num_kv_heads * a.head_dim,),
                     bv=(a.num_kv_heads * a.head_dim,))
    p["ln"] = (d,)
    return p


def _mlp_shapes(cfg: ModelConfig, d_ff: Optional[int] = None
                ) -> Dict[str, tuple]:
    d_ff, d = d_ff or cfg.d_ff, cfg.d_model
    p = {"w1": (d, d_ff), "w2": (d_ff, d), "ln": (d,)}
    if cfg.act == "swiglu":
        p["w3"] = (d, d_ff)
    return p


def _moe_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    m, d = cfg.moe, cfg.d_model
    e, f = m.num_experts, m.d_ff_expert
    p = {"router": (d, e), "w1": (e, d, f), "w2": (e, f, d),
         "w3": (e, d, f), "ln": (d,)}
    if m.num_shared:
        p["shared"] = _mlp_shapes(cfg, d_ff=f * m.num_shared)
    return p


def _mamba_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    mb, d = cfg.mamba, cfg.d_model
    d_inner = mb.expand * d
    n_heads = d_inner // mb.head_dim
    return {"in_proj": (d, 2 * d_inner + 2 * mb.d_state + n_heads),
            "conv_w": (mb.d_conv, d_inner + 2 * mb.d_state),
            "a_log": (n_heads,), "dt_bias": (n_heads,), "d_skip": (n_heads,),
            "out_proj": (d_inner, d), "ln": (d,)}


def _block_shapes(cfg: ModelConfig, i: int) -> Dict[str, Any]:
    kind = cfg.layer_kind(i)
    block = {"mixer": _mamba_shapes(cfg) if kind == "mamba"
             else _attn_shapes(cfg)}
    if i in set(moe_layer_indices(cfg)):
        block["ffn"] = _moe_shapes(cfg)
    elif cfg.d_ff > 0:
        block["ffn"] = _mlp_shapes(cfg)
    return block


def _stacked(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stacked(v, n) for k, v in tree.items()}
    return (n,) + tuple(tree)


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter pytree of `init_params`, with shape tuples as
    leaves, for every architecture of the zoo."""
    d, v = cfg.d_model, cfg.vocab_size
    out: Dict[str, Any] = {"embed": (v, d), "ln_f": (d,)}
    if not cfg.tie_embeddings:
        out["unembed"] = (d, v)
    if cfg.frontend == "vision_stub":
        out["patch_proj"] = (d, d)
    if cfg.frontend == "audio_stub":
        out["frame_proj"] = (d, d)
    prefix, period, n_reps = layer_layout(cfg)
    out["prefix_layers"] = [_block_shapes(cfg, i) for i in range(prefix)]
    out["layers"] = [_stacked(_block_shapes(cfg, prefix + s), n_reps)
                     for s in range(period)]
    if cfg.n_enc_layers:
        out["encoder"] = _stacked({"mixer": _attn_shapes(cfg),
                                   "ffn": _mlp_shapes(cfg)},
                                  cfg.n_enc_layers)
        out["enc_ln_f"] = (d,)
        out["cross"] = _stacked({**_attn_shapes(cfg), "ln_x": (d,)},
                                cfg.n_layers)
    return out


#: the leaves `init_params` keeps in f32 whatever `cfg.dtype` is: norms'
#: weights, the MoE router, Mamba-2's per-head scalars
F32_LEAVES = frozenset({"ln", "ln_f", "ln_x", "enc_ln_f", "router",
                        "a_log", "dt_bias", "d_skip"})


def _with_names(tree, fn, name: str = ""):
    """`fn(leaf name, shape)` over a tree of shape tuples (a leaf's name
    is its dict key; a list entry keeps its parent's)."""
    if isinstance(tree, dict):
        return {k: _with_names(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_names(v, fn, name) for v in tree]
    return fn(name, tree)


def abstract_params(cfg: ModelConfig, device="meta") -> Dict[str, Any]:
    """`init_params`' tree as empty tensors of its shapes and dtypes on
    `device` (default "meta": no storage), drawing nothing."""
    return _with_names(param_shapes(cfg), lambda name, shape: torch.empty(
        shape, device=device,
        dtype=torch.float32 if name in F32_LEAVES else cfg.dtype))


# --------------------------------------------------------------------------
# initialization
# --------------------------------------------------------------------------


_PLACE = threading.local()


@contextlib.contextmanager
def placing(place):
    """Inside the block, each leaf `init_params` would draw in this
    thread is `place(shape, dtype, draw)` instead, where `draw()` draws
    it as it would have been (`parallel.spmd.init_sharded` shards each
    leaf as it is drawn, or draws nothing at all)."""
    prev = getattr(_PLACE, "fn", None)
    _PLACE.fn = place
    try:
        yield
    finally:
        _PLACE.fn = prev


def _normal(gen: torch.Generator, shape, scale: float, dtype,
            by_lead: bool = False):
    """N(0, 1) * scale drawn in f32, cast to `dtype`. `by_lead` draws one
    leading index at a time into the result, so the f32 temporary is a
    slice of it (the stacked experts of a full MoE are 9.6 GB in bf16).
    Under `placing`, the leaf goes through its hook."""
    place = getattr(_PLACE, "fn", None)
    if place is not None:
        _PLACE.fn = None
        try:
            return place(tuple(shape), dtype, lambda: _normal(
                gen, shape, scale, dtype, by_lead))
        finally:
            _PLACE.fn = place
    if by_lead and len(shape) > 1:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        for i in range(shape[0]):
            out[i] = _normal(gen, shape[1:], scale, dtype)
        return out
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


def _dense(gen, lead, d_in, d_out, dtype, scale: Optional[float] = None,
           by_lead: bool = False):
    """The reference's `_dense`: N(0, 1) * scale (1/sqrt(d_in) unless
    given) in f32, cast to `dtype`; `lead` is the stacking prefix."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _normal(gen, (*lead, d_in, d_out), scale, dtype, by_lead)


def init_attn_layer(gen, cfg: ModelConfig, lead=()) -> Dict[str, Any]:
    a, d, dt = cfg.attn, cfg.d_model, cfg.dtype
    ones = torch.ones((*lead, d), dtype=torch.float32, device=gen.device)
    if a.kv_lora_rank:                    # MLA: latent KV + decoupled RoPE
        r, hd, dr = a.kv_lora_rank, a.num_heads * a.head_dim, a.rope_head_dim
        return {"wq": _dense(gen, lead, d, hd, dt),
                "w_dkv": _dense(gen, lead, d, r, dt),
                "w_uk": _dense(gen, lead, r, hd, dt),
                "w_uv": _dense(gen, lead, r, hd, dt),
                "w_kr": _dense(gen, lead, d, dr, dt),
                "w_qr": _dense(gen, lead, d, a.num_heads * dr, dt),
                "wo": _dense(gen, lead, hd, d, dt), "ln": ones}
    zeros = dict(dtype=dt, device=gen.device)
    p = {"wq": _dense(gen, lead, d, a.num_heads * a.head_dim, dt),
         "wk": _dense(gen, lead, d, a.num_kv_heads * a.head_dim, dt),
         "wv": _dense(gen, lead, d, a.num_kv_heads * a.head_dim, dt),
         "wo": _dense(gen, lead, a.num_heads * a.head_dim, d, dt)}
    if a.qkv_bias:
        p["bq"] = torch.zeros((*lead, a.num_heads * a.head_dim), **zeros)
        p["bk"] = torch.zeros((*lead, a.num_kv_heads * a.head_dim), **zeros)
        p["bv"] = torch.zeros((*lead, a.num_kv_heads * a.head_dim), **zeros)
    p["ln"] = ones
    return p


def init_mlp_layer(gen, cfg: ModelConfig, lead=(),
                   d_ff: Optional[int] = None) -> Dict[str, Any]:
    d_ff, d, dt = d_ff or cfg.d_ff, cfg.d_model, cfg.dtype
    p = {"w1": _dense(gen, lead, d, d_ff, dt),
         "w2": _dense(gen, lead, d_ff, d, dt),
         "ln": torch.ones((*lead, d), dtype=torch.float32,
                          device=gen.device)}
    if cfg.act == "swiglu":
        p["w3"] = _dense(gen, lead, d, d_ff, dt)    # gate
    return p


def init_moe_layer(gen, cfg: ModelConfig, lead=()) -> Dict[str, Any]:
    """The reference's `init_moe_layer`: an f32 router, the experts'
    weights stacked on an [E] axis (after `lead`), and the shared experts
    as one MLP of `d_ff_expert * num_shared`."""
    m, d, dt = cfg.moe, cfg.d_model, cfg.dtype
    e, f = m.num_experts, m.d_ff_expert
    p = {"router": _dense(gen, lead, d, e, torch.float32),
         "w1": _dense(gen, (*lead, e), d, f, dt, by_lead=True),
         "w2": _dense(gen, (*lead, e), f, d, dt, by_lead=True),
         "w3": _dense(gen, (*lead, e), d, f, dt, by_lead=True),
         "ln": torch.ones((*lead, d), dtype=torch.float32,
                          device=gen.device)}
    if m.num_shared:
        p["shared"] = init_mlp_layer(gen, cfg, lead, d_ff=f * m.num_shared)
    return p


def init_mamba_layer(gen, cfg: ModelConfig, lead=()) -> Dict[str, Any]:
    """The reference's `init_mamba_layer`: `in_proj` (emitting z, x, B,
    C and dt) and `out_proj` as `_dense`, the depthwise conv's taps
    N(0, 1) * 0.1 in the model dtype, `a_log` and `dt_bias` zeros and
    `d_skip` ones in f32."""
    mb, d, dt = cfg.mamba, cfg.d_model, cfg.dtype
    d_inner = mb.expand * d
    n_heads = d_inner // mb.head_dim
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {"in_proj": _dense(gen, lead, d,
                              2 * d_inner + 2 * mb.d_state + n_heads, dt),
            "conv_w": _normal(gen, (*lead, mb.d_conv,
                                    d_inner + 2 * mb.d_state), 0.1, dt),
            "a_log": torch.zeros((*lead, n_heads), **f32),   # A = -exp(a_log)
            "dt_bias": torch.zeros((*lead, n_heads), **f32),
            "d_skip": torch.ones((*lead, n_heads), **f32),
            "out_proj": _dense(gen, lead, d_inner, d, dt),
            "ln": torch.ones((*lead, d), **f32)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Full parameter pytree on `gen.device`. Repeated layers are drawn
    stacked on a leading axis per pattern slot, as the reference's; the
    leading dense layers of a MoE config (`first_dense`) unstacked in
    `prefix_layers`; whisper's encoder layers stacked on `[n_enc_layers]`
    and its cross-attention layers (an attention layer with `ln_x`, the
    norm of its queries) on `[n_layers]`."""
    d, dt = cfg.d_model, cfg.dtype
    params: Dict[str, Any] = {
        "embed": _normal(gen, (cfg.vocab_size, d), 0.02, dt),
        "ln_f": torch.ones(d, dtype=torch.float32, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _dense(gen, (), d, cfg.vocab_size, dt,
                                   scale=0.02)
    if cfg.frontend == "vision_stub":
        params["patch_proj"] = _dense(gen, (), d, d, dt)
    if cfg.frontend == "audio_stub":
        params["frame_proj"] = _dense(gen, (), d, d, dt)
    prefix, period, n_reps = layer_layout(cfg)
    moe_idx = set(moe_layer_indices(cfg))

    def block(i: int, lead) -> Dict[str, Any]:
        mixer = init_mamba_layer if cfg.layer_kind(i) == "mamba" \
            else init_attn_layer
        out = {"mixer": mixer(gen, cfg, lead)}
        if i in moe_idx:
            out["ffn"] = init_moe_layer(gen, cfg, lead)
        elif cfg.d_ff > 0:                # d_ff == 0: mixer-only block
            out["ffn"] = init_mlp_layer(gen, cfg, lead)
        return out

    params["prefix_layers"] = [block(i, ()) for i in range(prefix)]
    params["layers"] = [block(prefix + s, (n_reps,)) for s in range(period)]
    if cfg.n_enc_layers:
        ne, f32 = cfg.n_enc_layers, dict(dtype=torch.float32,
                                         device=gen.device)
        params["encoder"] = {"mixer": init_attn_layer(gen, cfg, (ne,)),
                             "ffn": init_mlp_layer(gen, cfg, (ne,))}
        params["enc_ln_f"] = torch.ones(d, **f32)
        params["cross"] = {**init_attn_layer(gen, cfg, (cfg.n_layers,)),
                           "ln_x": torch.ones((cfg.n_layers, d), **f32)}
    return params
