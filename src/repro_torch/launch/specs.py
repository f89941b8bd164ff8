"""Stand-in inputs + shardings for every (arch x shape) cell.

`input_specs(arch, shape, mesh)` builds the inputs of the cell's step
as tensors on the "meta" device (shapes and dtypes, no storage: the
counterpart of the reference's `jax.ShapeDtypeStruct`s) and the
matching partition specs. Per-arch training knobs (microbatching,
optimizer, state and accumulation dtypes, ZeRO-1 or ZeRO-3) are the
reference's (`TRAIN_SETTINGS`), chosen there for a 16 GB TPU v5e; the
launch reports (`launch.dryrun`, `launch.roofline`) read them as the
reference's do, so both tables describe the same steps.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import Batch, Model
from repro_torch.parallel import sharding as S
from repro_torch.parallel.sharding import P


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    samples_per_microbatch: int = 8     # grad-accum granularity
    optimizer: str = "adamw"
    opt_state_dtype: Any = torch.float32
    loss_chunk: int = 2048
    accum_dtype: Any = torch.float32
    # ZeRO-3 weight sharding over data; False (ZeRO-1) for models whose
    # params+opt fit per device when sharded over model only — no
    # per-microbatch weight all-gather
    fsdp: bool = True


# per-arch memory-budget knobs, the reference's
TRAIN_SETTINGS: Dict[str, TrainSettings] = {
    "qwen1.5-4b": TrainSettings(4, fsdp=False),
    "starcoder2-7b": TrainSettings(2, fsdp=False),
    "command-r-35b": TrainSettings(2),
    "minitron-4b": TrainSettings(8, fsdp=False),
    "mamba2-370m": TrainSettings(1, fsdp=False),
    "deepseek-v2-lite-16b": TrainSettings(1),   # bounds MoE dispatch
    "mixtral-8x7b": TrainSettings(2),
    "jamba-1.5-large-398b": TrainSettings(
        4, optimizer="adafactor", opt_state_dtype=torch.bfloat16,
        accum_dtype=torch.bfloat16),
    "llava-next-mistral-7b": TrainSettings(4, fsdp=False),
    "whisper-base": TrainSettings(16, fsdp=False),
}


def microbatches_for(arch: str, cfg: ModelConfig, mesh,
                     spec: ShapeSpec) -> int:
    ts = TRAIN_SETTINGS[arch]
    dp = math.prod(S.axis_size(mesh, a) for a in S.batch_axes(mesh))
    b_local = max(spec.global_batch // dp, 1)
    m = max(1, b_local // ts.samples_per_microbatch)
    while b_local % m:
        m -= 1
    return m


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_specs(cfg: ModelConfig, spec: ShapeSpec, mesh):
    """(meta batch, spec batch) for a train/prefill sequence batch. VLM
    reserves patch positions inside seq_len; whisper extra = encoder
    frames."""
    b = spec.global_batch
    s = spec.seq_len
    extra = extra_spec = None
    if cfg.frontend == "vision_stub":
        s = s - cfg.num_patches
        extra = _meta((b, cfg.num_patches, cfg.d_model), torch.float32)
        extra_spec = S.batch_spec(mesh, b, extra_dims=2)
    if cfg.frontend == "audio_stub":
        extra = _meta((b, cfg.enc_seq_len, cfg.d_model), torch.float32)
        extra_spec = S.batch_spec(mesh, b, extra_dims=2)
    tok_spec = S.batch_spec(mesh, b, extra_dims=1)
    return (Batch(_meta((b, s), torch.int32), _meta((b, s), torch.int32),
                  extra),
            Batch(tok_spec, tok_spec, extra_spec))


def input_specs(arch: str, shape: Union[str, ShapeSpec], mesh,
                cfg: Optional[ModelConfig] = None):
    """Returns (kind, args, args_specs) for the cell's step fn; `shape`
    is a name of `SHAPES` or a `ShapeSpec`.

    train:   (batch,)                         -> train_step
    prefill: (batch,)                         -> prefill
    decode:  (tokens, caches, position[, enc]) -> decode_step
    (the parameters, and the optimizer state, come apart: `dryrun`).
    The decode position stands as an int32 scalar, the reference's; the
    port's step takes it as a host int, as it keeps its ring cursors.
    """
    cfg = cfg or get_config(arch)
    spec = SHAPES[shape] if isinstance(shape, str) else shape

    if spec.kind in ("train", "prefill"):
        batch, batch_sh = _token_specs(cfg, spec, mesh)
        return spec.kind, (batch,), (batch_sh,)

    # decode: one new token against a seq_len-deep cache
    b = spec.global_batch
    cap = spec.seq_len
    caches = Model(cfg).init_cache(b, cap, "meta")
    cache_spec = S.cache_spec(cfg, mesh, b)
    tok = _meta((b, 1), torch.int32)
    tok_spec = S.batch_spec(mesh, b, extra_dims=1)
    pos = _meta((), torch.int32)
    args = (tok, caches, pos)
    shs = (tok_spec, cache_spec, P())
    if cfg.n_enc_layers:
        enc = _meta((b, cfg.enc_seq_len, cfg.d_model), cfg.dtype)
        args = args + (enc,)
        shs = shs + (S.batch_spec(mesh, b, extra_dims=2),)
    return "decode", args, shs


def named(mesh, tree):
    return S.map_specs(lambda s: S.NamedSharding(mesh, s), tree)
