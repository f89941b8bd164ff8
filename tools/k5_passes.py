#!/usr/bin/env python3
"""K5 (the hash-map lookup) at its `chip_smoke.py` cases, and a pass
route for K5 and K6b that walks the table an L2-sized range of slots at a
time, on one NVIDIA GPU.

    python3 tools/k5_passes.py [--src DIR] [--no-sweep]

`--src` is the `src/` directory whose `repro_torch` is measured (default:
this checkout's), so another checkout's K5 can be read with this
checkout's inputs. The pass route is built from a copy of that
`semijoin.cu` with K5's and K6b's launcher (`launch_probe`) replaced
(`PASS_CODE`, one nvcc beside the package's own library) and called
through the package's wrappers (`lookup`, `set_probe`, the library
swapped in): P contiguous ranges of at most 32 MB of table each; pass p
reads every probe key (evict-first) and walks only the probes whose home
slot lies in range p, on past the range's end (the last range's into
slot 0), so the range's sectors come from HBM once and then from L2;
pass 0 writes every row, later passes only their hits; a lane walks
`chunk` probes in turn (lane l of warp w its i-th at
w * 32 * chunk + 32 i + l), the next one's keys loaded during the walk;
the table is read at normal L2 priority or under an evict-last policy;
chunk 0 takes `together_kernel` instead, 4 adjacent probes a thread
whose walks are in flight together (a round loads the next slot of each
open walk). `joinmap_lookup_force(passes, chunk, policy)` sets the
three (passes 0: the rule, ceil(table bytes / 32 MB), at most 4). One
JSON line:

- `cases`: "SF 1 lineitem" (6,001,215 random probe keys into the 2^22
  slots of SF 1 orders' 1.5 M keys: `chip_smoke.sf1_lookup_probe`), the
  same keys sorted ("SF 1 sorted": lineitem's real order, each key's
  probes together) and the plane-off path's most frequent lookup shape
  (`chip_smoke.K5_PATH_CASE`): K5 as it is (`k5`) and through the pass
  route by its rule (`rule`, chunks of 8), forced to 1-3 passes (`p1`
  ... `p3`), at one pass with chunks of 1 (`p1_chunk1`) and with 4 walks
  a thread together at 1 and 2 passes (`p1_together`, `p2_together`),
  each checked against the plain lookup, with CUDA-event ms and device
  ms (torch.profiler, `chip_smoke.device_ms`);
- `sweep` (unless `--no-sweep`): tables of 2^20 to 2^24 slots, 3/8 full
  (SF 1 orders' load), probed by 6,001,215 keys drawn from the build
  keys (one in 8 a miss): K5 through the pass route at 1-4 passes, the
  table at normal priority and evict-last, and K6b (a key set of the
  same keys, 70% kept) at 1-4 passes, each against the plain walk.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

PASS_CODE = r"""
// tools/k5_passes.py's pass route for K5 and K6b.
constexpr long long kPassBytes = 32ll << 20;  // table bytes a pass
constexpr int kMaxPasses = 4;
int forced_passes = 0;  // 0: lookup_passes's rule
int lookup_chunk = 8;   // probes a lane walks in turn (0: together_kernel)
int table_policy = 0;   // 1: evict-last reads of the table

int lookup_passes(int cap) {
  if (forced_passes > 0) return forced_passes < cap ? forced_passes : cap;
  long long p = ((long long)cap * (long long)sizeof(Slot) + kPassBytes - 1) /
                kPassBytes;
  return p < 1 ? 1 : (p > kMaxPasses ? kMaxPasses : (int)p);
}

template <bool kEvictLast>
__device__ __forceinline__ uint4 load_slot(const uint4* p, uint64_t policy) {
  if (!kEvictLast) return __ldg(p);
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

template <bool kRows, typename Out, bool kEvictLast>
__global__ void __launch_bounds__(kThreads)
    pass_kernel(const uint4* __restrict__ slots, uint32_t mask,
                const uint32_t* __restrict__ lo,
                const uint32_t* __restrict__ hi, int n, int chunk,
                uint32_t begin, uint32_t end, bool first,
                Out* __restrict__ out) {
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int r = warp * 32 * chunk + (threadIdx.x & 31);
  if (r >= n) return;
  uint64_t policy = 0;
  if (kEvictLast) {
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
        : "=l"(policy));
  }
  uint32_t a = __ldcs(lo + r), b = __ldcs(hi + r);
  for (int i = 0; i < chunk && r < n; ++i) {
    int next = r + 32;
    uint32_t na = 0u, nb = 0u;
    if (i + 1 < chunk && next < n) {
      na = __ldcs(lo + next);
      nb = __ldcs(hi + next);
    }
    uint32_t s = home_slot(a, b, mask);
    int32_t ans = -1;
    bool mine = s - begin < end - begin;
    if (mine) {
      for (;;) {
        uint4 v = load_slot<kEvictLast>(slots + s, policy);
        if (v.z == kEmpty) break;
        if (v.x == a && v.y == b) {
          ans = (int32_t)v.w;
          break;
        }
        s = (s + 1) & mask;
      }
    }
    if (first || (mine && ans >= 0)) {
      __stcs(out + r, kRows ? (Out)ans : (Out)(ans >= 0));
    }
    r = next;
    a = na;
    b = nb;
  }
}

// 4 probes a thread (rows 4t .. 4t + 3), their walks in flight together:
// a round loads the next slot of every walk still open.
template <bool kRows, typename Out>
__global__ void __launch_bounds__(kThreads)
    together_kernel(const uint4* __restrict__ slots, uint32_t mask,
                    const uint32_t* __restrict__ lo,
                    const uint32_t* __restrict__ hi, int n, uint32_t begin,
                    uint32_t end, bool first, Out* __restrict__ out) {
  int r0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (r0 >= n) return;
  uint32_t a[4], b[4], s[4];
  int32_t ans[4];
  bool walk[4], mine[4];
  bool any = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r = min(r0 + i, n - 1);
    a[i] = __ldcs(lo + r);
    b[i] = __ldcs(hi + r);
    s[i] = home_slot(a[i], b[i], mask);
    mine[i] = r0 + i < n && s[i] - begin < end - begin;
    walk[i] = mine[i];
    ans[i] = -1;
    any |= walk[i];
  }
  while (any) {
    uint4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (walk[i]) v[i] = __ldg(slots + s[i]);
    }
    any = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!walk[i]) continue;
      if (v[i].z == kEmpty) {
        walk[i] = false;
      } else if (v[i].x == a[i] && v[i].y == b[i]) {
        ans[i] = (int32_t)v[i].w;
        walk[i] = false;
      } else {
        s[i] = (s[i] + 1) & mask;
        any = true;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r0 + i < n && (first || (mine[i] && ans[i] >= 0))) {
      __stcs(out + r0 + i, kRows ? (Out)ans[i] : (Out)(ans[i] >= 0));
    }
  }
}

"""
LAUNCHER = r"""template <bool kRows, typename Out>
int launch_probe(const void* table, int cap, const void* lo, const void* hi,
                 int n, void* out, void* stream) {
  if (cap < 1 || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* slots = static_cast<const uint4*>(table);
  const uint32_t* lo32 = static_cast<const uint32_t*>(lo);
  const uint32_t* hi32 = static_cast<const uint32_t*>(hi);
  int tile = kThreads * (lookup_chunk > 0 ? lookup_chunk : 1);
  int grid = (n + tile - 1) / tile;
  int passes = lookup_passes(cap);
  for (int p = 0; p < passes; ++p) {
    uint32_t begin = (uint32_t)((long long)cap * p / passes);
    uint32_t end = (uint32_t)((long long)cap * (p + 1) / passes);
    if (lookup_chunk == 0) {
      together_kernel<kRows, Out>
          <<<(n + 4 * kThreads - 1) / (4 * kThreads), kThreads, 0, st>>>(
              slots, (uint32_t)(cap - 1), lo32, hi32, n, begin, end, p == 0,
              static_cast<Out*>(out));
    } else if (table_policy == 1) {
      pass_kernel<kRows, Out, true><<<grid, kThreads, 0, st>>>(
          slots, (uint32_t)(cap - 1), lo32, hi32, n, lookup_chunk, begin, end,
          p == 0, static_cast<Out*>(out));
    } else {
      pass_kernel<kRows, Out, false><<<grid, kThreads, 0, st>>>(
          slots, (uint32_t)(cap - 1), lo32, hi32, n, lookup_chunk, begin, end,
          p == 0, static_cast<Out*>(out));
    }
  }
  return (int)cudaGetLastError();
}
"""
EXTERN = r"""
int joinmap_lookup_passes(int cap) { return lookup_passes(cap); }

int joinmap_lookup_force(int passes, int chunk, int policy) {
  int was = forced_passes;
  forced_passes = passes >= 1 && passes <= kMaxPasses ? passes : 0;
  lookup_chunk = chunk >= 0 ? chunk : 8;
  table_policy = policy == 1 ? 1 : 0;
  return was;
}

"""


def pass_source(text: str) -> str:
    """`semijoin.cu` with the pass route in place of K5's and K6b's
    launcher, and its force entry points."""
    at = text.index("int log2_of(int cap) {")
    text = text[:at] + PASS_CODE + text[at:]
    m = re.search(r"template <bool kRows, typename Out>\nint launch_probe\("
                  r".*?\n}\n", text, re.S)
    text = text[:m.start()] + LAUNCHER + text[m.end():]
    at = text.rindex('}  // extern "C"')
    return text[:at] + EXTERN + text[at:]


def pass_library(cs, sj, build):
    """The pass route built and loaded through `sj._lib` (so the
    wrappers' argument types are set), with its force entry points'."""
    src = build.BUILD_DIR / "k5_passes.cu"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(pass_source(build.SOURCES["semijoin"].read_text()))
    so = build.BUILD_DIR / "libk5_passes.so"
    proc = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.INCLUDE_DIR),
         "-o", str(so), str(src)], capture_output=True, text=True)
    cs.check(proc.returncode == 0,
             f"k5_passes: nvcc:\n{proc.stdout}{proc.stderr}")
    own, library = sj._lib(), sj.library
    sj._LIB = None
    sj.library = lambda _: ctypes.CDLL(str(so))
    lib = sj._lib()
    sj.library, sj._LIB = library, own
    lib.joinmap_lookup_passes.argtypes = [ctypes.c_int]
    lib.joinmap_lookup_passes.restype = ctypes.c_int
    lib.joinmap_lookup_force.argtypes = [ctypes.c_int] * 3
    lib.joinmap_lookup_force.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k5_passes: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.core import bloom
    from repro_torch.kernels import build
    from repro_torch.kernels.semijoin import ops as sj

    dev = torch.device("cuda", 0)
    own = sj._lib()
    passes = pass_library(cs, sj, build)

    def halves(keys):
        return bloom.keys_to_device(keys, dev)

    def timed(lib, force, fn, want):
        sj._LIB = lib
        if force is not None:
            lib.joinmap_lookup_force(*force)
        try:
            got = fn()
            torch.cuda.synchronize()
            cs.check(torch.equal(got, want), "k5_passes: a walk disagrees")
            return {"ms": cs.cuda_ms(torch, fn, 20),
                    "device_ms": cs.device_ms(torch, fn)}
        finally:
            if force is not None:
                lib.joinmap_lookup_force(0, 8, 0)
            sj._LIB = own

    rng, _, _, _, orders = cs.joinmap_inputs(np)
    sf1_probe = cs.sf1_lookup_probe(np, rng, orders)
    inputs = {"SF 1 lineitem": (orders, sf1_probe),
              "SF 1 sorted": (orders, np.sort(sf1_probe)),
              cs.K5_PATH_CASE: cs.k5_path_keys(np)}
    rec = {"tool": "k5_passes", "src": args.src, "package": sj.__file__,
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(), "cases": {}, "sweep": []}
    variants = {"k5": (own, None), "rule": (passes, (0, 8, 0)),
                "p1": (passes, (1, 8, 0)), "p2": (passes, (2, 8, 0)),
                "p3": (passes, (3, 8, 0)), "p1_chunk1": (passes, (1, 1, 0)),
                "p1_together": (passes, (1, 0, 0)),
                "p2_together": (passes, (2, 0, 0))}
    for case, (keys, probe) in inputs.items():
        lo, hi = halves(keys)
        cap = sj.capacity_for(len(keys))
        table, _ = sj.build_rows(lo, hi, cap)
        plo, phi = halves(probe)
        want = sj.lookup_ref(table, plo, phi)
        out = rec["cases"][case] = {
            "n": len(probe), "cap": cap,
            "rule_passes": passes.joinmap_lookup_passes(cap)}
        for name, (lib, force) in variants.items():
            out[name] = timed(lib, force, lambda: sj.lookup(table, plo, phi),
                              want)
    if not args.no_sweep:
        sweep_rng = np.random.default_rng(47)
        for log2cap in range(20, 25):
            cap = 1 << log2cap
            keys = sweep_rng.choice(1 << 40, 3 * cap // 8,
                                    replace=False).astype(np.int64)
            probe = keys[sweep_rng.integers(0, len(keys), 6_001_215)]
            probe[::8] = sweep_rng.integers(1 << 41, 1 << 42,
                                            len(probe[::8]))
            lo, hi = halves(keys)
            plo, phi = halves(probe)
            table, _ = sj.build_rows(lo, hi, cap)
            keep = torch.from_numpy(sweep_rng.random(len(keys)) < 0.7).to(dev)
            kset, _ = sj.set_build(lo, hi, cap, keep)
            want = sj.lookup_ref(table, plo, phi)
            want_set = sj.set_probe_ref(kset, plo, phi)
            row = {"cap": cap, "table_mb": cap * 16 / 2**20,
                   "keys": len(keys), "n": len(probe),
                   "rule_passes": passes.joinmap_lookup_passes(cap)}
            for p in range(1, 5):
                for policy, name in ((0, "normal"), (1, "evict_last")):
                    row[f"p{p}_{name}"] = timed(
                        passes, (p, 8, policy),
                        lambda: sj.lookup(table, plo, phi), want)
                row[f"k6b_p{p}"] = timed(
                    passes, (p, 8, 0), lambda: sj.set_probe(kset, plo, phi),
                    want_set)
            rec["sweep"].append(row)
            del table, kset
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
