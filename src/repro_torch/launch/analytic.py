"""Analytic per-device cost model for the roofline, on NVIDIA H100s.

XLA's `cost_analysis()` counts each while-loop body once (scan over
layers / microbatches / loss chunks), so the reference's roofline uses
this explicit model — every formula is written out below — rather than
raw compiler numbers. The formulas are the reference's
(`launch/analytic.py`), unchanged; the hardware constants are the H100
SXM's (datasheet), each with its source beside it.

Conventions:
  * FLOPs: 2·m·n·k per matmul; causal attention scores+AV at half cost.
  * Training executes fwd (2·N·D) + bwd (4·N·D) + remat re-fwd (2·N·D):
    8·N·D matmul FLOPs against the 6·N·D "useful" MODEL_FLOPS.
  * Bytes: weight traffic per pass + optimizer state traffic + an
    activation-traffic term (reads+writes of layer activations).
  * Collectives: FSDP weight all-gather + gradient reduce-scatter over
    `data`, TP activation all-reduces over `model`, MoE all-to-all —
    one collective term at one link rate, as the reference has one.
  * Serving placement: weights stay resident, sharded over `model`
    only, when that slice fits `SERVE_FIT_BYTES` of a device's memory;
    else they stay ZeRO-3 sharded and are re-gathered.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import SHAPES, ShapeSpec
from repro_torch.models.common import ModelConfig, moe_layer_indices

# NVIDIA H100 SXM5 80GB datasheet: 989 TFLOP/s dense bf16 Tensor Core
PEAK_FLOPS = 989e12          # bf16 / device
# H100 SXM5 datasheet: 3.35 TB/s HBM3
HBM_BW = 3.35e12             # B/s / device
# H100 SXM5 datasheet: 80 GB HBM3
HBM_BYTES = 80e9             # B / device
# one ConnectX-7 InfiniBand NDR port a GPU, 400 Gb/s = 50 GB/s: the data
# and pod collectives of the (32, 8) production mesh cross nodes over
# it. The model axis (8 GPUs, one HGX node) rides NVLink 4 at 450 GB/s a
# direction; the model keeps the reference's single collective term, at
# the slower rate.
LINK_BW = 50e9               # B/s / device
# the serving rule "weights fit when sharded over model only": 75% of a
# device's memory (the reference hard-codes 12e9, 75% of a 16 GB v5e)
SERVE_FIT_BYTES = 0.75 * HBM_BYTES


@dataclasses.dataclass
class Cost:
    flops: float             # per device
    hbm_bytes: float         # per device
    coll_bytes: float        # per device
    model_flops: float       # global "useful" 6·N_act·D
    notes: str = ""

    def terms(self) -> Dict[str, float]:
        return {
            "compute_s": self.flops / PEAK_FLOPS,
            "memory_s": self.hbm_bytes / HBM_BW,
            "collective_s": self.coll_bytes / LINK_BW,
        }

    def bottleneck(self) -> str:
        t = self.terms()
        return max(t, key=t.get).replace("_s", "")


def _mesh_sizes(mesh_shape: Dict[str, int]):
    dp = mesh_shape.get("pod", 1) * mesh_shape.get("data", 1)
    tp = mesh_shape.get("model", 1)
    return dp, tp, dp * tp


def _attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for i in range(cfg.n_layers)
               if cfg.layer_kind(i) == "attn")


def _mamba_layers(cfg: ModelConfig) -> int:
    return cfg.n_layers - _attn_layers(cfg)


def _attn_flops_fwd(cfg: ModelConfig, tokens_total: float,
                    kv_len: float, causal: bool) -> float:
    """Scores + AV for all attention layers (global FLOPs, fwd only)."""
    if cfg.attn is None:
        return 0.0
    a = cfg.attn
    eff = kv_len / 2 if causal else kv_len
    if a.sliding_window:
        eff = min(eff, a.sliding_window)
    per_tok = 2 * 2 * a.num_heads * a.head_dim * eff
    return per_tok * tokens_total * _attn_layers(cfg)


def _ssd_flops_fwd(cfg: ModelConfig, tokens_total: float) -> float:
    if cfg.mamba is None:
        return 0.0
    mb = cfg.mamba
    d_inner = mb.expand * cfg.d_model
    # intra-chunk "attention" (chunk-causal) + state path (d_state)
    per_tok = 2 * d_inner * (mb.chunk / 2 + 2 * mb.d_state)
    return per_tok * tokens_total * _mamba_layers(cfg)


def param_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * 2.0          # bf16


def active_param_bytes(cfg: ModelConfig) -> float:
    return cfg.active_param_count() * 2.0


def train_cost(cfg: ModelConfig, spec: ShapeSpec, mesh_shape: Dict[str, int],
               microbatches: int, optimizer: str,
               opt_state_bytes_per_param: float,
               fsdp: bool = True,
               accum_bytes: float = 4.0) -> Cost:
    dp, tp, n_dev = _mesh_sizes(mesh_shape)
    D = spec.global_batch * spec.seq_len            # tokens
    n_act = cfg.active_param_count()
    n_tot = cfg.param_count()

    model_flops = 6.0 * n_act * D
    # executed: fwd + bwd + remat refwd = 8·N·D, plus attention/ssd terms
    # (x4: fwd + refwd + 2x bwd)
    mm = 8.0 * n_act * D
    attn = 4.0 * _attn_flops_fwd(cfg, D, spec.seq_len, causal=True)
    ssd = 4.0 * _ssd_flops_fwd(cfg, D)
    flops_dev = (mm + attn + ssd) / n_dev

    # HBM bytes / device
    p_shards = n_dev if fsdp else tp
    p_local = param_bytes(cfg) / p_shards
    opt_local = n_tot * opt_state_bytes_per_param / p_shards
    grad_local = n_tot * accum_bytes / p_shards
    weight_traffic = 3.0 * p_local * microbatches   # fwd+bwd+remat reads
    opt_traffic = 2.0 * (opt_local + grad_local) + 4.0 * p_local
    d_tok_local = D / dp                            # tokens per DP shard
    act_traffic = 12.0 * d_tok_local * cfg.d_model * 2.0 \
        * cfg.n_layers / tp
    logits_traffic = 4.0 * d_tok_local * cfg.vocab_size * 2.0 / tp
    hbm = weight_traffic + opt_traffic + act_traffic + logits_traffic

    # collectives / device
    if fsdp:
        # ZeRO-3: all-gather weights (per microbatch, fwd+remat+bwd) over
        # data, then reduce-scatter grads once
        w_coll = 3.0 * microbatches * (param_bytes(cfg) / tp) \
            * (dp - 1) / dp
        g_coll = (n_tot * accum_bytes / tp) * (dp - 1) / dp
    else:
        # ZeRO-1: weights resident; one gradient all-reduce (ring: 2x)
        w_coll = 0.0
        g_coll = 2.0 * (n_tot * accum_bytes / tp) * (dp - 1) / dp
    # TP: 2 all-reduces per layer fwd (+2x bwd) on activations
    tp_ar = 0.0 if tp == 1 else \
        4.0 * 2.0 * d_tok_local * cfg.d_model * 2.0 * cfg.n_layers \
        * (tp - 1) / tp
    # MoE all-to-all: dispatch+return of expert inputs/outputs (fwd+bwd)
    a2a = 0.0
    n_moe = len(moe_layer_indices(cfg))
    if n_moe and tp > 1:
        a2a = 4.0 * d_tok_local * cfg.moe.top_k * cfg.d_model * 2.0 \
            * n_moe * (tp - 1) / tp
    coll = w_coll + g_coll + tp_ar + a2a

    return Cost(flops_dev, hbm, coll, model_flops,
                notes=f"m={microbatches} opt={optimizer} "
                      f"{'zero3' if fsdp else 'zero1'}")


def prefill_cost(cfg: ModelConfig, spec: ShapeSpec,
                 mesh_shape: Dict[str, int]) -> Cost:
    dp, tp, n_dev = _mesh_sizes(mesh_shape)
    D = spec.global_batch * spec.seq_len
    n_act = cfg.active_param_count()
    model_flops = 2.0 * n_act * D
    mm = 2.0 * n_act * D
    attn = _attn_flops_fwd(cfg, D, spec.seq_len, causal=True)
    ssd = _ssd_flops_fwd(cfg, D)
    flops_dev = (mm + attn + ssd) / n_dev

    d_tok_local = D / dp
    # serving placement: weights sharded over model only (resident) when
    # they fit; 398B-class models stay ZeRO-3 sharded and re-gather
    fits = param_bytes(cfg) / tp <= SERVE_FIT_BYTES
    p_local = param_bytes(cfg) / (tp if fits else n_dev)
    act = 8.0 * d_tok_local * cfg.d_model * 2.0 * cfg.n_layers / tp
    kv_write = _kv_cache_bytes(cfg, spec.global_batch, spec.seq_len) / n_dev
    hbm = p_local + act + kv_write

    tp_ar = 0.0 if tp == 1 else \
        2.0 * d_tok_local * cfg.d_model * 2.0 * cfg.n_layers * (tp - 1) / tp
    w_ag = 0.0 if fits else (param_bytes(cfg) / tp) * (dp - 1) / dp
    return Cost(flops_dev, hbm, tp_ar + w_ag, model_flops)


def _kv_cache_bytes(cfg: ModelConfig, batch: int, cap: int) -> float:
    if cfg.attn is None:
        a_bytes = 0.0
    elif cfg.attn.kv_lora_rank:
        a_bytes = batch * cap * (cfg.attn.kv_lora_rank
                                 + cfg.attn.rope_head_dim) * 2.0
    else:
        eff = min(cap, cfg.attn.sliding_window or cap)
        a_bytes = batch * eff * 2 * cfg.attn.num_kv_heads \
            * cfg.attn.head_dim * 2.0
    total = a_bytes * _attn_layers(cfg)
    if cfg.mamba is not None:
        mb = cfg.mamba
        d_inner = mb.expand * cfg.d_model
        nheads = d_inner // mb.head_dim
        total += (batch * nheads * mb.head_dim * mb.d_state * 4.0
                  + batch * (mb.d_conv - 1) * (d_inner + 2 * mb.d_state)
                  * 2.0) * _mamba_layers(cfg)
    return total


def decode_cost(cfg: ModelConfig, spec: ShapeSpec,
                mesh_shape: Dict[str, int]) -> Cost:
    dp, tp, n_dev = _mesh_sizes(mesh_shape)
    B = spec.global_batch                       # one token per sequence
    n_act = cfg.active_param_count()
    model_flops = 2.0 * n_act * B
    attn = _attn_flops_fwd(cfg, B, spec.seq_len, causal=False)
    ssd = _ssd_flops_fwd(cfg, B) if cfg.mamba else 0.0
    flops_dev = (2.0 * n_act * B + attn + ssd) / n_dev

    # decode is memory-bound: every step reads all (active) weights and
    # the whole KV cache; serving placement keeps weights resident
    # (sharded over model only) when they fit, else ZeRO-3 + re-gather
    fits = param_bytes(cfg) / tp <= SERVE_FIT_BYTES
    p_read = active_param_bytes(cfg) / (tp if fits else n_dev)
    kv_read = _kv_cache_bytes(cfg, B, spec.seq_len) / n_dev
    hbm = p_read + kv_read

    tp_ar = 0.0 if tp == 1 else \
        2.0 * B * cfg.d_model * 2.0 * cfg.n_layers * (tp - 1) / tp
    w_ag = 0.0 if fits else (param_bytes(cfg) / tp) * (dp - 1) / dp
    return Cost(flops_dev, hbm, tp_ar + w_ag, model_flops)


def cell_cost(cfg: ModelConfig, shape: str, mesh_shape: Dict[str, int],
              microbatches: int = 1, optimizer: str = "adamw",
              opt_bytes_per_param: float = 8.0, fsdp: bool = True,
              accum_bytes: float = 4.0) -> Cost:
    spec = SHAPES[shape]
    if spec.kind == "train":
        return train_cost(cfg, spec, mesh_shape, microbatches, optimizer,
                          opt_bytes_per_param, fsdp=fsdp,
                          accum_bytes=accum_bytes)
    if spec.kind == "prefill":
        return prefill_cost(cfg, spec, mesh_shape)
    return decode_cost(cfg, spec, mesh_shape)
