"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Makes the cell's data from the seed, serves the cell's traffic through
`repro_torch`'s `QueryServer` on the card for `--seconds`, compares
every answer with the plain reference, and prints, last on standard
output, one JSON line: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer ones, read
under torch.profiler), `device`, with `--trace 1` `breakdown`, and last
`checks` (each number compared, with its limit, also the last lines on
standard error). Needs a CUDA device; exits 1 without one, and 3 if JAX
or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench import harness
    chips = harness.load_cell(args.workload).config["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    line = harness.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), T_START)
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & set(harness.FORBIDDEN))
    if found:
        print(f"perfbench: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    emit(line)
    return 0


def emit(line: dict) -> None:
    """The server's counts and errors and the run's stage times on an
    earlier line, then the
    checks on standard error, then the result line."""
    print(json.dumps({k: line.pop(k) for k in (
        "server", "errors", "stages", "per_template")}), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.exit(main())
