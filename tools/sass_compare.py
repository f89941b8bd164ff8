#!/usr/bin/env python3
"""Compare the machine code (SASS) of the kernels of two CUDA sources,
as the package builds them for the H100 (sm_90a): whether a change to a
source left a kernel's code as it was, and each kernel's registers.

    python3 tools/sass_compare.py A.cu B.cu [--pair NAME_A=NAME_B ...]

Each source is compiled to a cubin with the package's flags
(`build.NVCC_FLAGS`, a cubin instead of a shared library; one nvcc each,
started together; the headers of the source's own tree,
`kernels/csrc`) and disassembled with `cuobjdump -sass`. A kernel is
named as its demangled name reads without namespace and parameters
(`slice_scatter_kernel<false>`, `transfer_kernel`). Every kernel named
alike in both sources is compared, and each `--pair` names one more pair
(a kernel renamed or re-templated). Needs the CUDA toolkit (nvcc,
cuobjdump, cu++filt), no GPU.

One JSON line: per pair, the registers (ptxas) and instructions of
each, `identical` (every instruction the same, operands included) and
`same_but_params` (the same once the constant-bank offsets, where a
kernel reads its parameters, are set aside), and the first lines of the
difference where there is one.
"""
from __future__ import annotations

import argparse
import difflib
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: one SASS instruction: `/*0040*/  IMAD R1, ... ;  /* 0x... */`
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
#: a parameter's place in the constant bank
PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def tool(name: str) -> str:
    from repro_torch.kernels import build
    path = shutil.which(name)
    if path is None:
        path = str(pathlib.Path(build.nvcc_path()).parent / name)
    return path


def short(demangled: str) -> str:
    """`(anonymous namespace)::f<1, false>(int, ...)` -> `f<1, false>`
    (template values as C++ writes them: `(bool)0` -> `false`)."""
    name = re.sub(r"^.*?(\(anonymous namespace\)|<unnamed>)::", "",
                  demangled.strip())
    name = re.sub(r"\(bool\)0", "false", name)
    name = re.sub(r"\(bool\)1", "true", name)
    name = re.sub(r"\((?:int|unsigned int)\)(-?\d+)", r"\1", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def compile_all(sources: list, out: pathlib.Path) -> list:
    """Start one nvcc a source; returns (cubin, ptxas log) each."""
    from repro_torch.kernels import build
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = []
    for i, src in enumerate(sources):
        cubin = out / f"{i}.cubin"
        # the shared headers of the source's own tree (kernels/csrc)
        include = pathlib.Path(src).resolve().parents[2] / "csrc"
        if not include.is_dir():
            include = build.INCLUDE_DIR
        procs.append((cubin, subprocess.Popen(
            [build.nvcc_path(), *flags, "-cubin", "-I", str(include), "-o",
             str(cubin), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    done = []
    for (cubin, proc), src in zip(procs, sources):
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"sass_compare: nvcc {src}:\n{log}")
        done.append((cubin, log))
    return done


def kernels(cubin: pathlib.Path, log: str) -> dict:
    """name -> (registers, instructions) of each kernel in the cubin."""
    sass = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    bodies, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            bodies[name] = []
        elif name is not None:
            m = INSTR.search(line)
            if m:
                bodies[name].append(" ".join(m.group(1).split()))
    regs, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            regs[entry] = int(m.group(1))
            entry = None
    mangled = list(bodies)
    demangled = subprocess.run([tool("cu++filt")], input="\n".join(mangled),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    return {short(d): (regs.get(m), bodies[m])
            for m, d in zip(mangled, demangled)}


def compare(a, b) -> dict:
    (ra, ia), (rb, ib) = a, b
    rec = {"registers": [ra, rb], "instructions": [len(ia), len(ib)],
           "identical": ia == ib,
           "same_but_params": ([PARAM.sub("c[0x0][.]", x) for x in ia]
                               == [PARAM.sub("c[0x0][.]", x) for x in ib])}
    if not rec["identical"]:
        rec["diff"] = list(difflib.unified_diff(ia, ib, lineterm="", n=1))[
            2:22]
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--pair", action="append", default=[],
                    help="NAME_A=NAME_B: a kernel of A against one of B")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        (ca, la), (cb, lb) = compile_all([args.a, args.b],
                                         pathlib.Path(tmp))
        ka, kb = kernels(ca, la), kernels(cb, lb)
    pairs = [(n, n) for n in sorted(set(ka) & set(kb))]
    pairs += [tuple(p.split("=", 1)) for p in args.pair]
    rec = {"tool": "sass_compare", "a": args.a, "b": args.b,
           "only_a": sorted(set(ka) - set(kb)),
           "only_b": sorted(set(kb) - set(ka)), "pairs": {}}
    for na, nb in pairs:
        if na not in ka or nb not in kb:
            raise SystemExit(f"sass_compare: no kernel {na!r} in A "
                             f"({sorted(ka)}) or {nb!r} in B ({sorted(kb)})")
        rec["pairs"][na if na == nb else f"{na}={nb}"] = compare(ka[na],
                                                                 kb[nb])
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
