"""Architecture registry: `--arch <id>` resolution + input-shape sets.

Every assigned architecture is a selectable config; each pairs with the
LM shape set (train_4k / prefill_32k / decode_32k / long_500k). Shape
applicability follows DESIGN.md §5: `long_500k` needs sub-quadratic
serving (context_class "state" or "window"); pure full-attention archs
skip it with an explicit reason recorded in the roofline table.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from repro_torch.models.common import ModelConfig

_MODULES = {
    "qwen1.5-4b": "qwen1_5_4b",
    "starcoder2-7b": "starcoder2_7b",
    "command-r-35b": "command_r_35b",
    "minitron-4b": "minitron_4b",
    "mamba2-370m": "mamba2_370m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "mixtral-8x7b": "mixtral_8x7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-base": "whisper_base",
}

ARCHS: List[str] = list(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}").CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}").SMOKE


def shape_skip_reason(cfg: ModelConfig, shape: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the reason it is skipped
    (recorded as a SKIP row in the roofline table)."""
    spec = SHAPES[shape]
    if spec.kind == "decode" and spec.seq_len > 131_072 \
            and cfg.context_class == "full":
        return ("full-attention decode at 524k KV is not sub-quadratic; "
                "skipped per assignment (DESIGN.md §5)")
    return None


def applicable_cells() -> List[Tuple[str, str, Optional[str]]]:
    """All 40 (arch, shape) cells with their skip reason (None = runs)."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            out.append((arch, shape, shape_skip_reason(cfg, shape)))
    return out
