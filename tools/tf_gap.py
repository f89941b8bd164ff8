#!/usr/bin/env python3
"""The teacher-forced gap of the serving path at full width and cut
depth, on any device: how far the flash backend's logits (K8, or its
plain version `flash_plain` on the CPU) lie from dense attention's
("auto") when both are fed the same tokens, and, for a MoE model, the
share of (token, layer) routing choices that differ. For a model with no
attention (mamba2-370m) the gap is instead the one between its decode
and its full forward over the same tokens (`chip_smoke.full_forward_gap`).

    PYTHONPATH=src python3 tools/tf_gap.py --arch deepseek-v2-lite-16b \\
        --layers 3 6 --batch 2 --prompt-len 256 --gen-tokens 6 --device cpu

For each depth: the model's published config with `n_layers` cut to
that depth (random weights from seed 0, a random prompt from seed 1, the
stub frontend's embeddings from seed 2 — whisper's frames, llava's
patches, whose positions the cache holds too — as
`repro_torch.launch.serve`), one greedy pass on the flash backend, then
one JSON line of `chip_smoke.teacher_forced_gap` (max and mean |d| over
the prefill's and every step's logits, argmax agreement) and, for a MoE
model, a second with the dense run taking the flash run's routing
choices (`routes_replayed`; the first reports the share of routing
choices that differ). `chip_smoke.py`'s teacher-forced bounds are set
from these readings.

With `--mesh DxM` (point i on `cuda:i`, or every point on the CPU with
`--device cpu`) the gap is instead the sharded model's from the
unsharded one, both on the flash backend: one greedy pass of the
unsharded model under the mesh's abstract twin (so both have the same
MoE token groups), then the model drawn straight into shards
(`spmd.init_sharded`, `fsdp` by `dryrun.serve_fsdp`'s rule) and fed the
same tokens and stub embeddings (`chip_smoke.sharded_gap`): once routing
on its own, and, for a MoE model, once taking the unsharded run's
routing choices.

    PYTHONPATH=src python3 tools/tf_gap.py --arch mixtral-8x7b \\
        --layers 1 2 --mesh 2x2 --device cpu

A batch the data axes do not divide runs whole on every point, its
cache's slots split over "data" (`chip_smoke.py`'s `serve-sharded-b1`),
and a model axis of 8 splits qwen1.5-4b's 20 heads by sequence
(`serve-sharded-cp`; the cap, prompt + tokens + 8, should divide by 8):

    PYTHONPATH=src python3 tools/tf_gap.py --arch qwen1.5-4b \\
        --layers 1 2 4 --mesh 1x8 --batch 2 --prompt-len 256 \\
        --gen-tokens 8 --device cpu
    PYTHONPATH=src python3 tools/tf_gap.py --arch qwen1.5-4b \\
        --layers 1 2 4 --mesh 2x2 --batch 1 --prompt-len 256 \\
        --gen-tokens 6 --device cpu

`--config smoke` takes the registry's smoke config instead (its depth
cut the same way), for a quick run of the tool itself.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--layers", type=int, nargs="+", default=[3])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--gen-tokens", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="DxM: the gap of the model sharded over this mesh")
    ap.add_argument("--config", default="full", choices=("full", "smoke"))
    args = ap.parse_args(argv)

    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.flashattn import ops as fa
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    dev = serve.resolve_device(args.device)
    for n in args.layers:
        base = get_config if args.config == "full" else get_smoke_config
        cfg = dataclasses.replace(base(args.arch), n_layers=n)
        if args.mesh:
            sharded(torch, args, cfg, dev)
            continue
        model = Model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        prompt = torch.randint(0, cfg.vocab_size,
                               (args.batch, args.prompt_len),
                               generator=torch.Generator(device=dev)
                               .manual_seed(1), device=dev)
        extra = serve.stub_inputs(cfg, args.batch, dev)
        cap = serve.prefix_len(cfg, extra) + args.prompt_len \
            + args.gen_tokens + 8
        routes, restore = chip_smoke.record_routes(L) if cfg.moe else \
            (None, None)
        try:
            res = serve.generate(model, params, prompt, args.gen_tokens, cap,
                                 extra=extra)
        finally:
            if restore:
                restore()
        res.update(model=model, params=params, prompt=prompt, extra=extra,
                   cap=cap)
        head = {"arch": args.arch, "layers": n, "device": str(dev),
                "batch": args.batch, "prompt_len": args.prompt_len,
                "gen_tokens": args.gen_tokens}
        if cfg.attn is None:
            gaps = [{"check": "decode vs full forward",
                     **chip_smoke.full_forward_gap(torch, L, res)}]
        else:
            gaps = [chip_smoke.teacher_forced_gap(torch, L, fa, serve, res,
                                                  routes, replay=replay)
                    for replay in ((False, True) if cfg.moe else (False,))]
        for gap in gaps:
            gap.pop("steps")
            print(json.dumps({**head, **gap}), flush=True)
        del model, params, res
    return 0


def sharded(torch, args, cfg, dev) -> None:
    """`--mesh`'s readings at one depth (the module's note)."""
    from repro_torch.launch.dryrun import serve_fsdp
    from repro_torch.launch.mesh import make_test_mesh, set_mesh
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import spmd as SP
    mesh = serve.parse_mesh(args.mesh, args.device)
    model = Model(cfg)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)
    extra = serve.stub_inputs(cfg, args.batch, dev)
    cap = serve.prefix_len(cfg, extra) + args.prompt_len \
        + args.gen_tokens + 8
    with set_mesh(make_test_mesh(mesh.axis_sizes, mesh.axis_names)):
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        routes, restore = chip_smoke.record_routes(L) if cfg.moe else \
            (None, None)
        try:
            ref = serve.generate(model, params, prompt, args.gen_tokens, cap,
                                 extra=extra)
        finally:
            if restore:
                restore()
    del params
    ref.update(prompt=prompt, cap=cap, extra=extra)
    fsdp = serve_fsdp(cfg, mesh)
    shards = SP.init_sharded(
        lambda: model.init(torch.Generator(device=dev).manual_seed(0)),
        S.param_specs(cfg, mesh, fsdp), mesh)
    head = {"arch": args.arch, "layers": cfg.n_layers, "mesh": args.mesh,
            "fsdp": fsdp, "device": str(dev), "batch": args.batch,
            "prompt_len": args.prompt_len, "gen_tokens": args.gen_tokens,
            "check": "sharded vs unsharded, teacher-forced"}
    for replay in (False, True) if cfg.moe else (False,):
        gap = chip_smoke.sharded_gap(torch, L, SP, serve, ref, model, shards,
                                     mesh, routes, replay)
        gap.pop("steps")
        print(json.dumps({**head, **gap}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
