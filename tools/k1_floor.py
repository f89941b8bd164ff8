#!/usr/bin/env python3
"""K1 probe designs, and the floor of a probe that issues one filter
request a live row a filter, on one NVIDIA GPU.

    python3 tools/k1_floor.py

Each variant is a copy of `bloom.cu` whose K1 kernel
(`multi_probe_kernel`) is replaced, built beside the package's own
libraries (one nvcc each, all started together) and called through the
package's wrapper (`multi_probe`, its library swapped in), so every
variant runs as K1 does on the main path. At `chip_smoke.py`'s "2^23
m=2" case (the same inputs, `chip_smoke.probe_inputs`: 6,001,215 live
rows of 2^23, the orders- and lineitem-sized filters), one JSON line
with each variant's device ms (torch.profiler, `chip_smoke.device_ms`)
and CUDA-event ms, the first variant measured again last:

- `k1`: `bloom.cu` as it is (the per-bit probe: `block_hit` a row, k
  word reads stopping at the first missing bit);
- `coop16`: a warp-cooperative probe, exactly one sector request a live
  row a filter: two lanes a row, a 16-byte half each (16 rows a load
  instruction);
- `coop8`: the same with 8 lanes a row, a 4-byte word each (4 rows);
- `floor`: `k1` with one 4-byte load a live row a filter (the word of
  its first bit: the same blocks) and a coin from the row's hash that
  keeps one row in four live (K1 keeps 25.1% of this case's rows after
  the first filter), so about as many rows reach each filter;
- `no_probe`: `floor` without the filter load: the keys loaded and
  hashed, the output written.

`k1`, `coop16` and `coop8` must equal the plain version; `floor` and
`no_probe` answer wrongly by design.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

PER_BIT = r"""
__global__ void multi_probe_kernel(ProbeArgs args, int m, int k,
                                   const int32_t* __restrict__ idx, int n,
                                   int count, uint8_t* __restrict__ out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  bool ok = r < count;
  int src = (ok && idx != nullptr) ? __ldcs(idx + r) : r;
  for (int f = 0; f < m; ++f) {
    if (ok) {
      uint32_t h = key_hash(__ldcs(args.lo[f] + src), __ldcs(args.hi[f] + src));
      ok = PROBE;
    }
    __stcs(out + (size_t)f * n + r, (uint8_t)(ok ? 1 : 0));
  }
}

"""
#: A warp-cooperative K1: each lane hashes its own row; per filter the
#: warp queues its live rows in shared memory and probes them a group of
#: lanes a row (INNER), one sector request a row; a ballot carries the
#: answers back to the rows' lanes
COOP = r"""
__global__ void __launch_bounds__(kThreads)
    multi_probe_kernel(ProbeArgs args, int m, int k,
                       const int32_t* __restrict__ idx, int n, int count,
                       uint8_t* __restrict__ out) {
  __shared__ uint4 queues[kThreads];  // a warp's live rows: block, g1, g2
  // the filters' arguments, indexed by filter in shared memory rather than
  // in the parameter block
  __shared__ const uint4* f_words[kMaxFilters];
  __shared__ const uint32_t* f_lo[kMaxFilters];
  __shared__ const uint32_t* f_hi[kMaxFilters];
  __shared__ int f_log2nb[kMaxFilters];
  if (threadIdx.x < m) {
    f_words[threadIdx.x] =
        reinterpret_cast<const uint4*>(args.words[threadIdx.x]);
    f_lo[threadIdx.x] = args.lo[threadIdx.x];
    f_hi[threadIdx.x] = args.hi[threadIdx.x];
    f_log2nb[threadIdx.x] = args.log2nb[threadIdx.x];
  }
  __syncthreads();
  uint4* queue = queues + (threadIdx.x & ~31u);
  int lane = threadIdx.x & 31, half = lane & 1, pair = lane >> 1;
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  bool in = r < n;
  bool ok = in && r < count;
  int src = (ok && idx != nullptr) ? __ldcs(idx + r) : r;
  for (int f = 0; f < m; ++f) {
    unsigned live = __ballot_sync(0xffffffffu, ok);
    if (live) {
      int rank = __popc(live & ((1u << lane) - 1u));
      if (ok) {
        uint32_t h = key_hash(__ldcs(f_lo[f] + src), __ldcs(f_hi[f] + src));
        queue[rank] = make_uint4(block_of(h, f_log2nb[f]),
                                 fmix32(h ^ kGolden), fmix32(h ^ kP2) | 1u,
                                 0u);
      }
      __syncwarp();
      const uint4* blocks = f_words[f];
      int nlive = __popc(live);
INNER      __syncwarp();
    }
    if (in) __stcs(out + (size_t)f * n + r, (uint8_t)(ok ? 1 : 0));
  }
}
"""
#: COOP's INNER with two lanes a row (a 16-byte half each: 16 rows a load
#: instruction), and with 8 lanes a row (a 4-byte word each: 4 rows)
PAIRS = """      for (int base = 0; base < nlive; base += 16) {
        bool miss = false;
        if (base + pair < nlive) {
          uint4 row = queue[base + pair];
          uint4 w = __ldg(blocks + (size_t)row.x * 2 + half);
          for (int j = 0; j < k; ++j) {
            uint32_t pos = (row.y + (uint32_t)j * row.z) & 255u;
            uint32_t q = (pos >> 5) & 3u;
            uint32_t word = q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
            miss |= (pos >> 7) == (uint32_t)half &&
                    !((word >> (pos & 31u)) & 1u);
          }
        }
        unsigned missed = __ballot_sync(0xffffffffu, miss);
        int mine = rank - base;
        if (ok && mine >= 0 && mine < 16 && ((missed >> (2 * mine)) & 3u)) {
          ok = false;
        }
      }
"""
EIGHTS = """      for (int base = 0; base < nlive; base += 4) {
        bool miss = false;
        if (base + (lane >> 3) < nlive) {
          uint4 row = queue[base + (lane >> 3)];
          uint32_t word = __ldg(reinterpret_cast<const uint32_t*>(blocks) +
                                (size_t)row.x * 8 + (lane & 7));
          for (int j = 0; j < k; ++j) {
            uint32_t pos = (row.y + (uint32_t)j * row.z) & 255u;
            miss |= (pos >> 5) == (uint32_t)(lane & 7) &&
                    !((word >> (pos & 31u)) & 1u);
          }
        }
        unsigned missed = __ballot_sync(0xffffffffu, miss);
        int mine = rank - base;
        if (ok && mine >= 0 && mine < 4 && ((missed >> (8 * mine)) & 255u)) {
          ok = false;
        }
      }
"""
#: `magic` is never met in practice: testing for it keeps the load
PROBES = {
    "floor": "(((fmix32(h ^ kP2) >> 8) & 3u) == 0u) ^ (__ldg(args.words[f]"
             " + (size_t)block_of(h, args.log2nb[f]) * kLanes"
             " + ((fmix32(h ^ kGolden) & 255u) >> 5)) == 0x8BADF00Du)",
    "no_probe": "(((fmix32(h ^ kP2) >> 8) & 3u) == 0u) ^ (h == 0x8BADF00Du)",
}


def replace_k1(text: str, kernel: str) -> str:
    """bloom.cu with its K1 kernel replaced by `kernel`."""
    start = text.index("__global__ void multi_probe_kernel(ProbeArgs args")
    end = text.index("// K3. Replaces the TPU kernel")
    return text[:start] + kernel + "\n" + text[end:]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k1_floor: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import bloom
    from repro_torch.kernels import build
    from repro_torch.kernels.bloom import ops as kb

    text = build.SOURCES["bloom"].read_text()
    sources = {name: replace_k1(text, PER_BIT.replace("PROBE", probe))
               for name, probe in PROBES.items()}
    sources["coop16"] = replace_k1(text, COOP.replace("INNER", PAIRS))
    sources["coop8"] = replace_k1(text, COOP.replace("INNER", EIGHTS))
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, source in sources.items():
        src = build.BUILD_DIR / f"k1_{name}.cu"
        src.write_text(source)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I",
             str(build.INCLUDE_DIR), "-o",
             str(build.BUILD_DIR / f"libk1_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    own, library = kb._lib(), kb.library
    libs = {"k1": own}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"k1_floor: nvcc {name}:\n{log}")
        kb._LIB = None
        kb.library = lambda _, name=name: ctypes.CDLL(
            str(build.BUILD_DIR / f"libk1_{name}.so"))
        libs[name] = kb._lib()
    kb.library = library

    dev = torch.device("cuda", 0)
    _, cols, filt = cs.probe_inputs(np, kb, bloom, dev)
    count = 6_001_215
    args = ([filt[0], filt[1]], [cols[0][0], cols[1][0]],
            [cols[0][1], cols[1][1]])
    want = kb.multi_probe_ref(*args, count=count)
    rec = {"tool": "k1_floor", "case": "2^23 m=2", "n": cs.N_BIG,
           "count": count, "alive": [count, int(want[0].sum())],
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}
    order = ("k1", "coop16", "coop8", "floor", "no_probe", "k1")
    for i, name in enumerate(order):
        kb._LIB = libs[name]
        got = kb.multi_probe(*args, count=count)
        torch.cuda.synchronize()
        if name in ("k1", "coop16", "coop8"):
            cs.check(torch.equal(got, want), f"k1_floor: {name} disagrees")
        else:
            rec[f"{name}_alive"] = [count, int(got[0].sum())]
        fn = (lambda: kb.multi_probe(*args, count=count))
        key = name if name not in order[:i] else f"{name}_again"
        rec[f"{key}_ms"] = cs.cuda_ms(torch, fn, 20)
        rec[f"{key}_device_ms"] = cs.device_ms(torch, fn)
    kb._LIB = own
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
