#!/usr/bin/env python3
"""Sharded serving of a model too large for one card: mixtral-8x7b
uncut (32 layers, 46.70 B parameters, 93.4 GB of bf16) on a (1, 4)
("data", "model") mesh of four GPUs, point i on `cuda:i`, through
`repro_torch.launch.serve.serve_config(..., mesh=...)`.

    python3 tools/serve_sharded.py [--arch mixtral-8x7b] [--mesh 1x4] \\
        [--batch 2] [--prompt-len 4080] [--gen-tokens 32]
    python3 tools/serve_sharded.py --arch jamba-1.5-large-398b \\
        --layers 8 --batch 4 --prompt-len 2048
    python3 tools/serve_sharded.py --arch qwen1.5-4b --mesh 1x8 \\
        --batch 4 --prompt-len 2048 --gen-tokens 16 --one-card
    python3 tools/serve_sharded.py --arch qwen1.5-4b --mesh 2x2 \\
        --batch 1 --prompt-len 32744 --gen-tokens 16 --one-card

`--layers` cuts the published config's depth, and only jamba-1.5-large-
398b's: its 72 layers (398 B parameters, 796 GB of bf16) fit on no four
cards, and one 8-layer period of its pattern (one attention layer, seven
Mamba-2 layers, the MoE on every second) at published widths is 90.3
GB, about 22.6 GB a card on (1, 4), the smallest cut that keeps every
block kind. Every other arch runs uncut.

The parameters are drawn on cuda:0 a leaf at a time straight into their
shards (`spmd.init_sharded`), so the whole model never exists on one
card; then the launcher's two passes (a warm-up, then the timed one) of
prefill and greedy decode, every point on its own thread. Prints the
cards' names and power limits (nvidia-smi), then one JSON line: prefill
seconds and tok/s, decode ms/token, K8's launches against attention
layers x points a prefill call and a decode step, the collective counts
(`spmd.COMM`) and, per card, the parameter bytes it holds beside
`dryrun.local_bytes` of `param_specs` (reckoned), its cache bytes
beside `cache_spec`'s share, and its peak memory (since the start: the
draws' one full leaf on cuda:0 included); with fsdp off and no stub
frontend, also `spmd.serve_comm`, the collectives' formula,
beside them (null for a layer it does not cover). Needs as many
visible CUDA devices as mesh points, or, with `--one-card`, puts every
point on cuda:0 (`chip_smoke.py`'s sharded paths run so: the two
commands above repeat `serve-sharded-cp`'s run uncut (the smoke cuts
it to 16 layers), qwen1.5-4b's 20 heads split by sequence over 8
points, and `serve-sharded-b1`'s, batch 1 with the cache's length split
over "data", without their checks).
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


#: the one arch whose depth `--layers` may cut (the module's note)
CUT_ARCH = "jamba-1.5-large-398b"


def run(arch: str, mesh_text: str, batch: int, prompt_len: int,
        gen_tokens: int, layers=None, one_card: bool = False) -> dict:
    """One sharded serve of `arch`'s published config (cut to `layers`
    layers where given) on `mesh_text`'s mesh of CUDA devices (every
    point on cuda:0 with `one_card`); the record the module's note
    describes."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flashattn import ops as fa
    from repro_torch.launch import serve
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.models.common import abstract_params
    from repro_torch.models.model import Model
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import spmd as SP
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if one_card:
        from repro_torch.launch.mesh import make_test_mesh
        shape = tuple(int(n) for n in mesh_text.lower().split("x"))
        axes = ("data", "model") if len(shape) == 2 \
            else ("pod", "data", "model")
        mesh = make_test_mesh(shape, axes,
                              devices=["cuda:0"] * math.prod(shape))
    else:
        mesh = serve.parse_mesh(mesh_text, "cuda")
    fa.reset_launches()
    SP.reset_counts()
    res = serve.serve_config(cfg, batch, prompt_len, gen_tokens, "cuda:0",
                             mesh=mesh)
    launches, comm = dict(fa.LAUNCHES), dict(SP.COMM)
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    want = {"flash_prefill": 2 * n_attn * mesh.size,
            "flash_decode": 2 * n_attn * mesh.size * gen_tokens}
    specs = S.param_specs(cfg, mesh, fsdp=res["fsdp"])
    reckoned = local_bytes(abstract_params(cfg), specs, mesh)
    cache = local_bytes(Model(cfg).init_cache(batch, res["cap"], "meta"),
                        S.cache_spec(cfg, mesh, batch), mesh)
    devices = {}
    for dev, row in res["device_bytes"].items():
        devices[dev] = {**row, "params_reckoned": reckoned * row["points"],
                        "caches_cache_spec": cache * row["points"]}
    bytes_ok = all(r["params"] == r["params_reckoned"]
                   and r["caches"] == r["caches_cache_spec"]
                   for r in devices.values())
    t_pre, t_dec = res["prefill_seconds"], res["decode_seconds"]
    formula = None
    if not cfg.n_enc_layers and cfg.frontend is None and not res["fsdp"]:
        try:                        # the formula, where it covers the model
            formula = SP.serve_comm(
                cfg, mesh, batch, prompt_len, gen_tokens, res["cap"],
                len(res["passes"]))
        except ValueError:
            pass
    return {"arch": arch, "config": cfg.name, "layers": cfg.n_layers,
            "params": cfg.param_count(), "mesh": mesh_text,
            "axes": list(mesh.axis_names), "fsdp": res["fsdp"],
            "batch": batch, "prompt_len": prompt_len,
            "gen_tokens": gen_tokens, "cap": res["cap"],
            "passes_seconds": res["passes"], "prefill_seconds": t_pre,
            "prefill_tok_s": batch * prompt_len / t_pre,
            "decode_ms_per_token": t_dec / max(gen_tokens, 1) * 1e3,
            "launches": launches, "launches_expected": want,
            "launches_ok": launches == want, "bytes_ok": bytes_ok,
            "collectives": comm, "collectives_formula": formula,
            "finite": all(bool(torch.isfinite(x).all())
                          for x in res["logits"]),
            "sample": res["tokens"][0, :12].tolist(), "devices": devices}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--mesh", default="1x4")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=4080)
    ap.add_argument("--gen-tokens", type=int, default=32)
    ap.add_argument("--layers", type=int, default=None,
                    help=f"cut the depth ({CUT_ARCH} only)")
    ap.add_argument("--one-card", action="store_true",
                    help="put every mesh point on cuda:0")
    args = ap.parse_args()
    if args.layers is not None and args.arch != CUT_ARCH:
        ap.error(f"--layers cuts {CUT_ARCH} only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out = run(args.arch, args.mesh, args.batch, args.prompt_len,
              args.gen_tokens, args.layers, args.one_card)
    print(json.dumps({"nvidia_smi": smi.splitlines(), **out}), flush=True)
    return 0 if out["finite"] and out["launches_ok"] and out["bytes_ok"] \
        else 1


if __name__ == "__main__":
    sys.exit(main())
