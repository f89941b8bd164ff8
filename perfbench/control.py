"""The controls of the comparison that decides `correct`: the plain
reference put in the program's place, computed in float32, the precision
below the configurations' float64, once summed one row after the other
and once summed pairwise.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, makes the cell's data at its own scale, works out every
template's answer at float64 and in each float32 control, and compares
each control with the float64 answer exactly as a run compares the
program's answers. Prints one JSON line a seed and control with each
number compared, its limit, and whether the control came out correct
(it must not). Runs on the host alone; the benchmark's own runs never
run it.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def controls():
    """The float32 controls by name: (name, the reference's `acc`)."""
    import numpy as np

    from perfbench import reflib
    return (("serial", np.float32), ("pairwise", reflib.PAIRWISE32))


def control(cell, seed: int, scale=None) -> list:
    """One result a control, on the data of `seed`."""
    import numpy as np

    from perfbench import compare
    sf = float(scale if scale is not None
               else cell.config["generator"]["scale_factor"])
    db = cell.generator().generate(sf, seed)
    names = list(cell.workload["traffic"]["templates"])
    want = {n: cell.template(n).reference(db, np.float64) for n in names}
    out = []
    for control_name, acc in controls():
        t = time.perf_counter()
        bad, err = 0, 0.0
        by_template = {}
        for name in names:
            tpl = cell.template(name)
            b, e = compare.compare(tpl.reference(db, acc), want[name],
                                   tpl.ORDER_BY)
            by_template[name] = [b, e]
            bad, err = bad + b, max(err, e)
        numbers = {"bad_cells": bad, "float_rel_err": err}
        checks = {k: {"value": numbers[k], "limit": v}
                  for k, v in cell.workload["limits"].items()}
        out.append({
            "workload": cell.name, "seed": seed, "scale": sf,
            "control": control_name,
            "correct": all(c["value"] <= c["limit"]
                           for c in checks.values()),
            "checks": checks, "by_template": by_template,
            "seconds": time.perf_counter() - t})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import harness
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        for res in control(cell, seed):
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
