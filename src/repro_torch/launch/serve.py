"""Serving launcher: batched prefill + ring-cache greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        [--config full|smoke] [--batch 4] [--prompt-len 128] \\
        [--gen-tokens 64] [--device cuda] [--mesh DxM | PxDxM]

The flags of the reference's `examples/serve_lm.py`, plus `--config`
(the registry's published config, or its reduced smoke config) and
`--device` (default `cuda`; asking for CUDA where there is none raises,
it never runs on the CPU instead). Weights are random, drawn from a
`torch.Generator` seeded 0 on the device; the prompt is random tokens
from one seeded 1, and the stub frontends' embeddings (whisper's
`enc_seq_len` frames, llava's `num_patches` patches, f32 N(0, 1)) from
one seeded 2. The run is one warm-up pass, then one timed pass:
prefill, then `--gen-tokens` greedy decode steps; it prints prefill
tok/s and decode ms/token as `serve_lm.py` does. Whisper's prefill
encodes the frames inside, and `generate` encodes them once more after
it, within the prefill's seconds, for the decode steps, as
`serve_lm.py` does. Llava's decode positions start past the patches.
The cache holds every position the prefill writes, the patches
included, plus gen + 8 slots (a sliding-window layer's ring at most its
window, a Mamba layer its fixed-size state: `Model.init_cache`);
`serve_lm.py` leaves the patches out of its cap, so at full width its
ring drops them (ROADMAP Queue 3).
`serve_config` runs the same on a config the caller builds, such as a
published one cut in depth.

Sharded (`--mesh 1x4`, ("data", "model"), or `2x1x2`, ("pod", "data",
"model"); `serve_config(..., mesh=...)`): the parameters are drawn a
leaf at a time straight into their shards under `param_specs` (the
values of the unsharded run: `spmd.init_sharded`), `fsdp=None` takes
`launch.dryrun.serve_fsdp`'s rule, the prompt is split over the data
axes by `batch_spec`, and every mesh point runs `generate` on its rows
(`generate_sharded`: `spmd.run`, one thread a point), its logits
gathered over the data axes at the end. `--mesh` puts point i on
`cuda:i` (or every point on the CPU with `--device cpu`); the printed
lines add each device's parameter and cache bytes beside its peak.
Every block kind of the zoo runs sharded: attention (MLA included:
deepseek's latent cache holds the point's columns) with an MLP or a MoE,
the Mamba-2 mixer (its caches the point's conv channels and SSM heads),
llava's patch prefix and whisper's frames (each split with the prompt;
whisper's `enc_out` is then the point's rows) with its encoder and
cross-attention.
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import layers as L
from repro_torch.models.model import Batch, Model
from repro_torch.parallel import sharding as S
from repro_torch.parallel import spmd as SP


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device cpu to "
                           "run on the CPU")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prefix_len(cfg, extra: Optional[torch.Tensor]) -> int:
    """Positions the prefill writes before the prompt: the patches under
    the vision stub, else none."""
    if cfg.frontend == "vision_stub" and extra is not None:
        return extra.shape[1]
    return 0


def stub_len(cfg) -> Optional[int]:
    """Embeddings a sample of the stub frontend carries: `num_patches`
    under the vision stub, `enc_seq_len` frames under the audio stub,
    None without a frontend."""
    return {"vision_stub": cfg.num_patches,
            "audio_stub": cfg.enc_seq_len}.get(cfg.frontend)


def stub_inputs(cfg, batch: int, dev: torch.device,
                seed: int = 2) -> Optional[torch.Tensor]:
    """The stub frontend's embeddings [batch, `stub_len`, d], f32 N(0, 1)
    from a `torch.Generator` on `dev` seeded `seed`; None without a
    frontend."""
    n = stub_len(cfg)
    if n is None:
        return None
    return torch.randn((batch, n, cfg.d_model),
                       generator=torch.Generator(device=dev).manual_seed(
                           seed), dtype=torch.float32, device=dev)


def generate(model: Model, params, prompt: torch.Tensor, gen_tokens: int,
             cap: int, forced: Optional[torch.Tensor] = None,
             extra: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Prefill `prompt` [B, S] (with the stub frontend's `extra`) into a
    `cap`-slot cache, then decode `gen_tokens` steps greedily — or, given
    `forced` [B, gen_tokens + 1] (a greedy run's tokens), feed those
    instead (teacher forcing). Whisper's `enc_out` is encoded once after
    the prefill, inside its seconds, and given to every step; decode
    positions start past the patches. Returns the tokens fed [B,
    gen_tokens + 1] (the first from the prefill), the logits of the
    prefill and of every step ([B, V] f32 each), and the prefill and
    decode seconds (host clock, synchronised)."""
    dev = prompt.device
    s = prefix_len(model.cfg, extra) + prompt.shape[1]
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, Batch(prompt, prompt, extra),
                                   cap=cap)
    enc_out = model.encode(params, extra) if model.cfg.n_enc_layers \
        else None
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
        logits, caches = model.decode_step(params, tok, caches, s + i,
                                           enc_out)
        all_logits.append(logits[:, -1])
        tok = pick(i + 1, logits)
        fed.append(tok)
    _sync(dev)
    return {"tokens": torch.cat(fed, dim=1), "logits": all_logits,
            "prefill_seconds": t_prefill,
            "decode_seconds": time.perf_counter() - t0}


def batch_ways(mesh, batch: int) -> int:
    """The ways `batch_spec` splits a batch of `batch` rows over the data
    axes (1 where they do not divide it: whole on every point)."""
    if S.batch_spec(mesh, batch)[0] is None:
        return 1
    return math.prod(S.axis_size(mesh, a) for a in S.batch_axes(mesh))


def split_rows(mesh, t: Optional[torch.Tensor]):
    """`t` [B, ...] as a sharded leaf, its rows split by `batch_spec`
    (None stays None)."""
    return None if t is None else SP.shard_leaf(
        t, S.batch_spec(mesh, t.shape[0], t.dim() - 1), mesh)


def generate_sharded(model: Model, params, prompt: torch.Tensor,
                     gen_tokens: int, cap: int, mesh,
                     forced: Optional[torch.Tensor] = None,
                     extra: Optional[torch.Tensor] = None
                     ) -> Dict[str, Any]:
    """`generate` on every point of `mesh` over sharded `params`: the
    prompt, `forced` and `extra` split over the data axes by
    `batch_spec` (whole on every point where the batch does not divide
    them), the tokens and logits gathered over them; the seconds are the
    slowest point's."""
    spec = S.batch_spec(mesh, prompt.shape[0])
    outs = SP.run(mesh, generate, model, params, split_rows(mesh, prompt),
                  gen_tokens, cap, split_rows(mesh, forced),
                  split_rows(mesh, extra),
                  batch_ways=batch_ways(mesh, prompt.shape[0]))
    return {"tokens": SP.gather_results(mesh, spec,
                                        [o["tokens"] for o in outs]),
            "logits": [SP.gather_results(mesh, spec,
                                         [o["logits"][i] for o in outs])
                       for i in range(gen_tokens + 1)],
            "prefill_seconds": max(o["prefill_seconds"] for o in outs),
            "decode_seconds": max(o["decode_seconds"] for o in outs)}


def serve(arch: str, config: str, batch: int, prompt_len: int,
          gen_tokens: int, device: str, mesh=None) -> Dict[str, Any]:
    """`serve_config` of the registry's config of `arch`: its published
    one (`config="full"`) or its reduced smoke config."""
    dev = resolve_device(device)
    if arch not in ARCHS:
        raise ValueError(f"--arch must be one of {ARCHS}")
    if config not in ("full", "smoke"):
        raise ValueError("--config must be 'full' or 'smoke'")
    cfg = get_config(arch) if config == "full" else get_smoke_config(arch)
    return serve_config(cfg, batch, prompt_len, gen_tokens, dev, mesh=mesh)


def cache_bytes(caches: dict) -> int:
    """Bytes of a model's caches (`Model.init_cache`)."""
    return sum(t.numel() * t.element_size()
               for c in caches["prefix"] + caches["slots"]
               for t in ((c.conv, c.ssm) if isinstance(c, L.MambaCache)
                         else (c.k, c.v)))


def device_bytes(model: Model, params, mesh, batch: int,
                 cap: int) -> Dict[str, Dict[str, Any]]:
    """Per device of `mesh`: the parameter bytes its points hold, the
    bytes of their caches (each point's `init_cache` of its batch rows
    and kv heads, built on the "meta" device) and, on CUDA, the peak
    memory allocated since the last reset."""
    ways = batch_ways(mesh, batch)
    caches = SP.run(mesh, lambda: cache_bytes(
        model.init_cache(batch // ways, cap, "meta")), batch_ways=ways)
    out: Dict[str, Dict[str, Any]] = {}
    for point, dev in enumerate(mesh.devices):
        row = out.setdefault(str(dev), {"points": 0, "params": 0,
                                        "caches": 0, "peak": None})
        row["points"] += 1
        row["params"] += SP.tree_local_bytes(params, point)
        row["caches"] += caches[point]
        if dev.type == "cuda":
            row["peak"] = torch.cuda.max_memory_allocated(dev)
    return out


def serve_config(cfg, batch: int, prompt_len: int, gen_tokens: int,
                 device, mesh=None, fsdp: Optional[bool] = None
                 ) -> Dict[str, Any]:
    """Build the model of `cfg` (random weights drawn on `device` from
    seed 0, a random prompt from seed 1, the stub frontend's embeddings
    from seed 2), then two passes of `generate`: a warm-up and the timed
    one; returns the timed pass's result with the model, its parameters,
    the prompt, the stub embeddings (`extra`), the cache size and both
    passes' seconds. With a `mesh` (one device a point) the parameters
    are drawn on `device` straight into their shards under
    `param_specs(cfg, mesh, fsdp)` (`fsdp=None`: `dryrun.serve_fsdp`'s
    rule) and each pass is `generate_sharded`; the result adds the mesh,
    `fsdp` and `device_bytes`."""
    dev = resolve_device(device)
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)
    extra = stub_inputs(cfg, batch, dev)
    # serve_lm.py's rule, with the patches the prefill writes counted
    cap = prefix_len(cfg, extra) + prompt_len + gen_tokens + 8
    layout: Dict[str, Any] = {}
    if mesh is None:
        params = model.init(gen)
        passes = [generate(model, params, prompt, gen_tokens, cap,
                           extra=extra) for _ in range(2)]
    else:
        from repro_torch.launch.dryrun import serve_fsdp
        fsdp = serve_fsdp(cfg, mesh) if fsdp is None else fsdp
        params = SP.init_sharded(lambda: model.init(gen),
                                 S.param_specs(cfg, mesh, fsdp), mesh)
        passes = [generate_sharded(model, params, prompt, gen_tokens, cap,
                                   mesh, extra=extra) for _ in range(2)]
        layout = {"mesh": mesh, "fsdp": fsdp,
                  "device_bytes": device_bytes(model, params, mesh, batch,
                                               cap)}
    # the warm-up, then the timed pass
    return {**passes[1], "cfg": cfg, "model": model, "params": params,
            "prompt": prompt, "extra": extra, "cap": cap,
            "passes": [(p["prefill_seconds"], p["decode_seconds"])
                       for p in passes], **layout}


def parse_mesh(text: str, device: str):
    """`--mesh DxM` over ("data", "model") or `PxDxM` over ("pod",
    "data", "model"): point i on `cuda:i` (raises if fewer CUDA devices
    are visible), or every point on the CPU for `--device cpu`."""
    shape = tuple(int(n) for n in text.lower().split("x"))
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"--mesh takes DxM or PxDxM, got {text!r}")
    axes = ("data", "model") if len(shape) == 2 \
        else ("pod", "data", "model")
    n = math.prod(shape)
    if resolve_device(device).type == "cpu":
        devices = ["cpu"] * n
    else:
        visible = torch.cuda.device_count()
        if visible < n:
            raise ValueError(f"--mesh {text} puts a point on each of {n} "
                             f"CUDA devices; {visible} are visible")
        devices = [f"cuda:{i}" for i in range(n)]
    return make_test_mesh(shape, axes, devices=devices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--config", default="full", choices=("full", "smoke"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen-tokens", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="DxM or PxDxM: serve sharded over that mesh")
    args = ap.parse_args(argv)
    mesh = parse_mesh(args.mesh, args.device) if args.mesh else None
    res = serve(args.arch, args.config, args.batch, args.prompt_len,
                args.gen_tokens, args.device, mesh=mesh)
    b, s, g = args.batch, args.prompt_len, args.gen_tokens
    t_pre, t_dec = res["prefill_seconds"], res["decode_seconds"]
    where = args.device if mesh is None else \
        f"mesh {args.mesh} {mesh.axis_names} (fsdp {res['fsdp']})"
    print(f"{res['cfg'].name}: serving B={b} prompt={s} gen={g} "
          f"on {where}")
    for dev, row in res.get("device_bytes", {}).items():
        peak = "not measured" if row["peak"] is None \
            else f"{row['peak']:,} B"
        print(f"{dev}: {row['points']} point(s), params "
              f"{row['params']:,} B, caches {row['caches']:,} B, "
              f"peak {peak}")
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
