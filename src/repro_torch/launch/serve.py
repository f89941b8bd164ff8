"""Serving launcher: batched prefill + ring-cache greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        [--config full|smoke] [--batch 4] [--prompt-len 128] \\
        [--gen-tokens 64] [--device cuda]

The flags of the reference's `examples/serve_lm.py`, plus `--config`
(the registry's published config, or its reduced smoke config) and
`--device` (default `cuda`; asking for CUDA where there is none raises,
it never runs on the CPU instead). Weights are random, drawn from a
`torch.Generator` seeded 0 on the device; the prompt is random tokens
from one seeded 1. The run is one warm-up pass, then one timed pass:
prefill, then `--gen-tokens` greedy decode steps; it prints prefill
tok/s and decode ms/token as `serve_lm.py` does. The cache holds
prompt + gen + 8 slots (a sliding-window layer's ring at most its
window, a Mamba layer its fixed-size state: `Model.init_cache`).
`serve_config` runs the same on a config the caller builds, such as a
published one cut in depth.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.models.model import Batch, Model


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device cpu to "
                           "run on the CPU")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model: Model, params, prompt: torch.Tensor, gen_tokens: int,
             cap: int, forced: Optional[torch.Tensor] = None
             ) -> Dict[str, Any]:
    """Prefill `prompt` [B, S] into a `cap`-slot cache, then decode
    `gen_tokens` steps greedily — or, given `forced` [B, gen_tokens + 1]
    (a greedy run's tokens), feed those instead (teacher forcing).
    Returns the tokens fed [B, gen_tokens + 1] (the first from the
    prefill), the logits of the prefill and of every step ([B, V] f32
    each), and the prefill and decode seconds (host clock, synchronised)."""
    dev = prompt.device
    s = prompt.shape[1]
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, Batch(prompt, prompt), cap=cap)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    def pick(i: int, lg: torch.Tensor) -> torch.Tensor:
        if forced is not None:
            return forced[:, i:i + 1]
        return lg[:, -1].argmax(-1)[:, None]

    all_logits: List[torch.Tensor] = [logits[:, -1]]
    tok = pick(0, logits)
    fed = [tok]
    t0 = time.perf_counter()
    for i in range(gen_tokens):
        logits, caches = model.decode_step(params, tok, caches, s + i)
        all_logits.append(logits[:, -1])
        tok = pick(i + 1, logits)
        fed.append(tok)
    _sync(dev)
    return {"tokens": torch.cat(fed, dim=1), "logits": all_logits,
            "prefill_seconds": t_prefill,
            "decode_seconds": time.perf_counter() - t0}


def serve(arch: str, config: str, batch: int, prompt_len: int,
          gen_tokens: int, device: str) -> Dict[str, Any]:
    """`serve_config` of the registry's config of `arch`: its published
    one (`config="full"`) or its reduced smoke config."""
    dev = resolve_device(device)
    if arch not in ARCHS:
        raise ValueError(f"--arch must be one of {ARCHS}")
    if config not in ("full", "smoke"):
        raise ValueError("--config must be 'full' or 'smoke'")
    cfg = get_config(arch) if config == "full" else get_smoke_config(arch)
    return serve_config(cfg, batch, prompt_len, gen_tokens, dev)


def serve_config(cfg, batch: int, prompt_len: int, gen_tokens: int,
                 dev: torch.device) -> Dict[str, Any]:
    """Build the model of `cfg` (random weights drawn on `dev` from seed
    0, a random prompt from seed 1), then two passes of `generate`: a
    warm-up and the timed one; returns the timed pass's result with the
    model, its parameters, the prompt, the cache size and both passes'
    seconds."""
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)
    cap = prompt_len + gen_tokens + 8           # serve_lm.py's rule
    passes = [generate(model, params, prompt, gen_tokens, cap)
              for _ in range(2)]        # the warm-up, then the timed pass
    return {**passes[1], "cfg": cfg, "model": model, "params": params,
            "prompt": prompt, "cap": cap,
            "passes": [(p["prefill_seconds"], p["decode_seconds"])
                       for p in passes]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--config", default="full", choices=("full", "smoke"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen-tokens", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = serve(args.arch, args.config, args.batch, args.prompt_len,
                args.gen_tokens, args.device)
    b, s, g = args.batch, args.prompt_len, args.gen_tokens
    t_pre, t_dec = res["prefill_seconds"], res["decode_seconds"]
    print(f"{res['cfg'].name}: serving B={b} prompt={s} gen={g} "
          f"on {args.device}")
    print(f"prefill: {t_pre * 1e3:.1f} ms ({b * s / t_pre:,.0f} tok/s)")
    if g:
        print(f"decode: {t_dec / g * 1e3:.2f} ms/token "
              f"({b * g / t_dec:,.0f} tok/s aggregate)")
    out = res["tokens"].cpu()
    print(f"generated shape {tuple(out.shape)}; sample: "
          f"{out[0][:12].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
