"""Roofline assembly over the port's dry-run reports.

Reads the dry-run reports (reports/torch/dryrun/*.json, written by
`launch.dryrun`), combines them with the analytic cost model
(`launch.analytic`, H100 constants), and emits the full baseline table:
three roofline terms per (arch x shape x mesh), dominant bottleneck,
MODEL_FLOPS / executed-FLOPs ratio, and what would move the dominant
term — written to reports/torch/roofline_<mesh>.md and .json. The terms
are arithmetic over configs, not measurements on a card. Beside the
collective term's analytic bytes a device (`coll_bytes_per_dev_analytic`)
stand the dry run's counted ones (`launch.collectives`: one mesh point's
step on the meta device): `coll_bytes_per_dev_counted` by the
reference's rule (each collective's output) and
`coll_received_bytes_per_dev_counted` by the bytes a point receives,
the wire term the analytic bytes estimate (`coll_received_over_analytic`
their ratio).

    python -m repro_torch.launch.roofline [--mesh single|multi]
        [--reports DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_skip_reason
from repro_torch.launch.analytic import PEAK_FLOPS, cell_cost
from repro_torch.launch.specs import TRAIN_SETTINGS

REPORT_DIR = os.path.join(os.path.dirname(__file__),
                          "..", "..", "..", "reports", "torch")


_IMPROVE = {
    "compute": ("increase per-device arithmetic intensity: larger "
                "microbatch / fuse attention (the hand-written flash "
                "kernel K8; it has no backward yet) / bf16-accumulate "
                "matmuls"),
    "memory": ("cut HBM traffic: KV-cache quantization, weight "
               "prefetch across layer scan, fewer remat passes, "
               "MLA-style cache compression"),
    "collective": ("overlap or shrink comm: int8 gradient compression, "
                   "all-gather/compute overlap across the layer scan, "
                   "2D-sharded weights to halve all-gather hops"),
}


def load_cells(mesh_tag: str, report_dir: str = REPORT_DIR) -> List[dict]:
    out = []
    pat = os.path.join(report_dir, "dryrun", f"*__{mesh_tag}.json")
    for path in sorted(glob.glob(pat)):
        with open(path) as f:
            out.append(json.load(f))
    return out


def build_table(mesh_tag: str = "single",
                report_dir: str = REPORT_DIR) -> List[dict]:
    rows = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            skip = shape_skip_reason(cfg, shape)
            path = os.path.join(report_dir, "dryrun",
                                f"{arch}__{shape}__{mesh_tag}.json")
            meas = None
            if os.path.exists(path):
                with open(path) as f:
                    meas = json.load(f)
            if skip:
                rows.append({"arch": arch, "shape": shape,
                             "skip": skip})
                continue
            if meas is None or "skip" in meas:
                rows.append({"arch": arch, "shape": shape,
                             "skip": "dry-run report missing"})
                continue
            mesh_shape = meas["mesh"]
            opt = meas.get("optimizer", "adamw")
            ts = TRAIN_SETTINGS[arch]
            opt_bpp = {"adamw": 8.0 if ts.opt_state_dtype == torch.float32
                       else 4.0,
                       "adafactor": 0.1}[opt]
            accum_b = 4.0 if ts.accum_dtype == torch.float32 else 2.0
            cost = cell_cost(cfg, shape, mesh_shape,
                             microbatches=meas.get("microbatches", 1),
                             optimizer=opt,
                             opt_bytes_per_param=opt_bpp,
                             fsdp=meas.get("fsdp", True),
                             accum_bytes=accum_b)
            terms = cost.terms()
            dominant = cost.bottleneck()
            step_s = max(terms.values())
            useful_s = (cost.model_flops / meas["devices"]) / PEAK_FLOPS
            received = meas.get("collective_received_bytes_per_device")
            rows.append({
                "arch": arch, "shape": shape, "mesh": mesh_tag,
                "devices": meas["devices"],
                "compute_s": terms["compute_s"],
                "memory_s": terms["memory_s"],
                "collective_s": terms["collective_s"],
                "bottleneck": dominant,
                "model_flops": cost.model_flops,
                "executed_flops_per_dev": cost.flops,
                "useful_ratio": cost.model_flops
                / (cost.flops * meas["devices"]),
                "roofline_fraction": useful_s / step_s,
                "traced_flops_per_dev": meas["flops_per_device"],
                "traced_over_executed": meas["flops_per_device"]
                / cost.flops,
                "coll_bytes_per_dev_analytic": cost.coll_bytes,
                "coll_bytes_per_dev_counted":
                    meas["collective_bytes_per_device"],
                "coll_received_bytes_per_dev_counted": received,
                "coll_received_over_analytic": None
                if received is None or not cost.coll_bytes
                else received / cost.coll_bytes,
                "memory_report": meas["memory"],
                "improve": _IMPROVE[dominant],
            })
    return rows


def render_md(rows: List[dict]) -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | "
        "coll B/dev analytic | coll B/dev counted | "
        "bottleneck | MODEL/executed flops | traced/executed flops | "
        "roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if "skip" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                         f"— | SKIP | — | — | {r['skip'][:60]}… |")
            continue
        counted = r["coll_bytes_per_dev_counted"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"{r['coll_bytes_per_dev_analytic']:.3e} | "
            f"{'—' if counted is None else format(counted, '.3e')} | "
            f"{r['bottleneck']} | {r['useful_ratio']:.2f} | "
            f"{r['traced_over_executed']:.2f} | "
            f"{r['roofline_fraction']:.2f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi"])
    ap.add_argument("--reports", default=REPORT_DIR,
                    help="report root (reads <root>/dryrun)")
    args = ap.parse_args(argv)
    rows = build_table(args.mesh, args.reports)
    os.makedirs(args.reports, exist_ok=True)
    out_json = os.path.join(args.reports, f"roofline_{args.mesh}.json")
    with open(out_json, "w") as f:
        json.dump(rows, f, indent=1)
    md = render_md(rows)
    with open(os.path.join(args.reports, f"roofline_{args.mesh}.md"),
              "w") as f:
        f.write(md + "\n")
    print(md)
    done = [r for r in rows if "skip" not in r]
    print(f"\n{len(done)} cells analysed, "
          f"{len(rows) - len(done)} skipped; reports in {out_json}")
    worst = min(done, key=lambda r: r["roofline_fraction"], default=None)
    collb = max(done, key=lambda r: r["collective_s"]
                / max(r["compute_s"], 1e-12), default=None)
    if worst:
        print(f"worst roofline fraction: {worst['arch']} x "
              f"{worst['shape']} ({worst['roofline_fraction']:.2f})")
    if collb:
        print(f"most collective-bound: {collb['arch']} x "
              f"{collb['shape']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
