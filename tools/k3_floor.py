#!/usr/bin/env python3
"""K3 (the single-filter Bloom probe) against probes that do less or
hold more rows a thread, on one NVIDIA GPU: what sets its pace, the key
stream or the filter requests.

    python3 tools/k3_floor.py [--src DIR]

`--src` is the `src/` directory whose `bloom.cu` is measured (default:
this checkout's). Each variant is a copy of that `bloom.cu` with a kernel
added (`floor_kernel`: R rows a thread, row i of thread t at row base +
i * blockDim + t, so the scalar loads of a warp are coalesced) and K3's
launcher (`bloom_probe`) replaced by one that launches it, built beside
the package's own libraries (one nvcc each, all started together) and
called through the package's wrapper (`probe`, its library swapped in):

- `k3`: `bloom.cu` as it is;
- `per_bit`: one row a thread, the per-bit probe (`block_hit`: k
  dependent word reads, stopping at the first missing bit): K3 before
  it took 4 rows a thread at large n;
- `hints`: `per_bit` with the keys and ids loaded, and the mask stored,
  with evict-first hints (`__ldcs`, `__stcs`, as K1 does);
- `no_probe`: keys loaded and hashed, the mask written, no filter load
  (a coin from the row's hash keeps one row in four);
- `one_load`: `no_probe` with one 4-byte filter load a live row (the
  word of its first bit: the same blocks);
- `whole`: two independent 16-byte loads of the row's block, all k bits
  tested from registers, no early exit;
- `r4_no_probe`, `r4_one_load`: those two at 4 rows a thread;
- `r2_levels`, `r4_levels`: 2 or 4 rows a thread probed by levels (bit j
  of every live row read before bit j + 1 of any);
- `r4_rows`: 4 rows a thread, each row's per-bit chain after the other's;
- `pairs`: a row's block read by a pair of lanes, a 16-byte half each in
  one load (one sector request a row), the halves' misses ORed by a
  shuffle, 4 adjacent rows a pair (keys or ids loaded 16 bytes at a time
  where aligned);
- `shared`: `per_bit` with the filter copied into each CTA's shared
  memory where it fits (at most 4,096 blocks), on a grid of as many CTAs
  as fit on the card.

Cases (inputs from `chip_smoke.probe_inputs`): "2^23 orders" (6,001,215
live rows of 2^23, the orders-sized filter of 2^17 blocks, no survivor
ids: `chip_smoke.py`'s K3 case) and the plane-off path's most frequent
and heaviest K3 shapes (`chip_smoke.K3_PATH_CASES`). One JSON line: each variant's CUDA-event ms
and device ms (torch.profiler, `chip_smoke.device_ms`) a case, `k3`
measured again last. `k3`, `per_bit`, `hints`, `whole`, `pairs`,
`shared` and the `levels`/`rows` variants must equal the plain
version; the others answer wrongly by design.
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

KERNEL = r"""
// tools/k3_floor.py's variant of K3.
__device__ __forceinline__ bool whole_hit(const uint32_t* __restrict__ words,
                                          uint32_t h, int log2nb, int k) {
  const uint4* blk =
      reinterpret_cast<const uint4*>(words) + (size_t)block_of(h, log2nb) * 2;
  uint4 a = __ldg(blk), b = __ldg(blk + 1);
  uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t g1 = fmix32(h ^ kGolden);
  uint32_t g2 = fmix32(h ^ kP2) | 1u;
  bool ok = true;
  for (int j = 0; j < k; ++j) {
    uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
    uint32_t word = 0u;
#pragma unroll
    for (int q = 0; q < 8; ++q) word = (pos >> 5) == (uint32_t)q ? w[q] : word;
    ok &= ((word >> (pos & 31u)) & 1u) != 0u;
  }
  return ok;
}

__global__ void floor_kernel(const uint32_t* __restrict__ words, int log2nb,
                             int k, const uint32_t* __restrict__ lo,
                             const uint32_t* __restrict__ hi,
                             const int32_t* __restrict__ idx, int n,
                             int count, uint8_t* __restrict__ out) {
  constexpr int R = ROWS;
  int base = blockIdx.x * blockDim.x * R + threadIdx.x;
  uint32_t h[R];
  bool ok[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    int r = base + i * blockDim.x;
    ok[i] = r < count;
    h[i] = 0u;
    if (ok[i]) {
      int src = idx != nullptr ? LOAD(idx + r) : r;
      h[i] = key_hash(LOAD(lo + src), LOAD(hi + src));
    }
  }
PROBE
#pragma unroll
  for (int i = 0; i < R; ++i) {
    int r = base + i * blockDim.x;
    if (r < n) STORE;
  }
}

"""
LAUNCHER = r"""int bloom_probe(const void* words, int log2nb, int k, const void* lo,
                const void* hi, const void* idx, int n, int count, void* out,
                void* stream) {
  if (n > 0) {
    int rows = kThreads * ROWS;
    floor_kernel<<<(n + rows - 1) / rows, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), log2nb, k,
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
        static_cast<const int32_t*>(idx), n, count,
        static_cast<uint8_t*>(out));
  }
  return (int)cudaGetLastError();
}
"""
#: `0x8BADF00D` is never met in practice: testing for it keeps the load
COIN = "(((fmix32(h[i] ^ kP2) >> 8) & 3u) == 0u)"
ONE_LOAD = (COIN + " ^ (__ldg(words + (size_t)block_of(h[i], log2nb) * "
            "kLanes + ((fmix32(h[i] ^ kGolden) & 255u) >> 5)) == "
            "0x8BADF00Du)")
NO_LOAD = COIN + " ^ (h[i] == 0x8BADF00Du)"
#: each row's probe, one row after another
ROW = ("#pragma unroll\n  for (int i = 0; i < R; ++i) {\n"
       "    if (ok[i]) ok[i] = %s;\n  }")
#: bit j of every live row read before bit j + 1 of any
LEVELS = r"""  for (int j = 0; j < k; ++j) {
    uint32_t w[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      uint32_t g1 = fmix32(h[i] ^ kGolden), g2 = fmix32(h[i] ^ kP2) | 1u;
      uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
      w[i] = ok[i] ? __ldg(words + (size_t)block_of(h[i], log2nb) * kLanes +
                           (pos >> 5)) : 0u;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      uint32_t g1 = fmix32(h[i] ^ kGolden), g2 = fmix32(h[i] ^ kP2) | 1u;
      uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
      ok[i] = ok[i] && ((w[i] >> (pos & 31u)) & 1u);
    }
  }"""
BLOCK_HIT = ROW % "block_hit(words, h[i], log2nb, k)"
PLAIN = ("__ldg", "out[r] = ok[i] ? 1 : 0")
HINTED = ("__ldcs", "__stcs(out + r, (uint8_t)(ok[i] ? 1 : 0))")
#: variant: (rows a thread, probe, key and id loads, mask store)
VARIANTS = {
    "per_bit": (1, BLOCK_HIT, *PLAIN),
    "hints": (1, BLOCK_HIT, *HINTED),
    "no_probe": (1, ROW % NO_LOAD, *PLAIN),
    "one_load": (1, ROW % ONE_LOAD, *PLAIN),
    "whole": (1, ROW % "whole_hit(words, h[i], log2nb, k)", *PLAIN),
    "r4_no_probe": (4, ROW % NO_LOAD, *PLAIN),
    "r4_one_load": (4, ROW % ONE_LOAD, *PLAIN),
    "r2_levels": (2, LEVELS, *PLAIN),
    "r4_levels": (4, LEVELS, *PLAIN),
    "r4_rows": (4, BLOCK_HIT, *PLAIN),
}
#: a row's block read by a lane pair, a 16-byte half each in one load (one
#: sector request a row), the pair's misses ORed by a shuffle; a pair takes
#: 4 adjacent rows, their keys (or ids) as one 16-byte load each where
#: aligned
PAIRS = r"""
// tools/k3_floor.py's variant of K3: lane pairs.
__global__ void floor_kernel(const uint32_t* __restrict__ words, int log2nb,
                             int k, const uint32_t* __restrict__ lo,
                             const uint32_t* __restrict__ hi,
                             const int32_t* __restrict__ idx, int n,
                             int count, bool vec, uint8_t* __restrict__ out) {
  int r = ((blockIdx.x * blockDim.x + threadIdx.x) >> 1) * 4;
  uint32_t half = threadIdx.x & 1u;
  uint32_t a[4] = {0u, 0u, 0u, 0u}, b[4] = {0u, 0u, 0u, 0u};
  bool ok[4];
  if (vec && r + 4 <= count) {
    if (idx != nullptr) {
      int4 s = __ldcs(reinterpret_cast<const int4*>(idx + r));
      int src[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = __ldg(lo + src[i]);
        b[i] = __ldg(hi + src[i]);
      }
    } else {
      uint4 x = __ldcs(reinterpret_cast<const uint4*>(lo + r));
      uint4 y = __ldcs(reinterpret_cast<const uint4*>(hi + r));
      a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
      b[0] = y.x, b[1] = y.y, b[2] = y.z, b[3] = y.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) ok[i] = true;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ok[i] = r + i < count;
      if (ok[i]) {
        int src = idx != nullptr ? __ldcs(idx + r + i) : r + i;
        a[i] = __ldg(lo + src);
        b[i] = __ldg(hi + src);
      }
    }
  }
  uint4 part[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    part[i] = make_uint4(0u, 0u, 0u, 0u);
    if (ok[i]) {
      part[i] = __ldg(reinterpret_cast<const uint4*>(words) +
                      (size_t)block_of(key_hash(a[i], b[i]), log2nb) * 2 +
                      half);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t h = key_hash(a[i], b[i]);
    uint32_t g1 = fmix32(h ^ kGolden), g2 = fmix32(h ^ kP2) | 1u;
    bool miss = false;
    for (int j = 0; j < k; ++j) {
      uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
      uint32_t q = (pos >> 5) & 3u;
      uint32_t word = q == 0u   ? part[i].x
                      : q == 1u ? part[i].y
                      : q == 2u ? part[i].z
                                : part[i].w;
      miss |= (pos >> 7) == half && !((word >> (pos & 31u)) & 1u);
    }
    miss |= __shfl_xor_sync(0xffffffffu, miss, 1);
    ok[i] = ok[i] && !miss;
  }
  if (half) return;
  if (vec && r + 4 <= n) {
    __stcs(reinterpret_cast<unsigned int*>(out + r),
           (unsigned int)ok[0] | (unsigned int)ok[1] << 8 |
               (unsigned int)ok[2] << 16 | (unsigned int)ok[3] << 24);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r + i < n) out[r + i] = ok[i] ? 1 : 0;
    }
  }
}

"""
PAIRS_LAUNCHER = r"""int bloom_probe(const void* words, int log2nb, int k, const void* lo,
                const void* hi, const void* idx, int n, int count, void* out,
                void* stream) {
  if (n > 0) {
    uintptr_t cols = idx != nullptr ? reinterpret_cast<uintptr_t>(idx)
                                    : reinterpret_cast<uintptr_t>(lo) |
                                          reinterpret_cast<uintptr_t>(hi);
    bool vec = (cols & 15u) == 0 &&
               (reinterpret_cast<uintptr_t>(out) & 3u) == 0;
    long long threads = 2ll * ((n + 3) / 4);
    floor_kernel<<<(int)((threads + kThreads - 1) / kThreads), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), log2nb, k,
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
        static_cast<const int32_t*>(idx), n, count, vec,
        static_cast<uint8_t*>(out));
  }
  return (int)cudaGetLastError();
}
"""
VARIANTS["pairs"] = (PAIRS, PAIRS_LAUNCHER)
#: `per_bit` with the filter copied into each CTA's shared memory where it
#: fits (at most 4,096 blocks, 128 KB), on a grid of as many CTAs as fit
#: on the card walking 256-row tiles; larger filters are read from L2
SHARED = r"""
// tools/k3_floor.py's variant of K3: the filter in shared memory.
__global__ void floor_kernel(const uint32_t* __restrict__ words, int log2nb,
                             int k, const uint32_t* __restrict__ lo,
                             const uint32_t* __restrict__ hi,
                             const int32_t* __restrict__ idx, int n,
                             int count, bool shared,
                             uint8_t* __restrict__ out) {
  extern __shared__ uint4 filter_vecs[];
  const uint32_t* filt = words;
  if (shared) {
    for (int i = threadIdx.x; i < (2 << log2nb); i += blockDim.x) {
      filter_vecs[i] = __ldg(reinterpret_cast<const uint4*>(words) + i);
    }
    __syncthreads();
    filt = reinterpret_cast<const uint32_t*>(filter_vecs);
  }
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += gridDim.x * blockDim.x) {
    bool ok = r < count;
    if (ok) {
      int src = idx != nullptr ? __ldg(idx + r) : r;
      uint32_t h = key_hash(__ldg(lo + src), __ldg(hi + src));
      const uint32_t* blk = filt + (size_t)block_of(h, log2nb) * kLanes;
      uint32_t g1 = fmix32(h ^ kGolden), g2 = fmix32(h ^ kP2) | 1u;
      for (int j = 0; j < k && ok; ++j) {
        uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
        ok = (blk[pos >> 5] >> (pos & 31u)) & 1u;
      }
    }
    out[r] = ok ? 1 : 0;
  }
}

"""
SHARED_LAUNCHER = r"""int bloom_probe(const void* words, int log2nb, int k, const void* lo,
                const void* hi, const void* idx, int n, int count, void* out,
                void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int grid = (n + kThreads - 1) / kThreads;
  bool shared = log2nb <= 12;
  size_t smem = shared ? (size_t)kLanes * 4 << log2nb : 0;
  if (shared) {
    int err = cudaFuncSetAttribute(
        floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kLanes * 4 << 12);
    int per_sm = 0, dev = 0, sms = 0;
    if (!err) err = cudaGetDevice(&dev);
    if (!err) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, floor_kernel, kThreads, smem);
    }
    if (!err) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err) return err;
    if (per_sm * sms > 0 && per_sm * sms < grid) grid = per_sm * sms;
  }
  floor_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), log2nb, k,
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const int32_t*>(idx), n, count, shared,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
"""
VARIANTS["shared"] = (SHARED, SHARED_LAUNCHER)
EXACT = ("k3", "per_bit", "hints", "whole", "r2_levels", "r4_levels",
         "r4_rows", "pairs", "shared")


def replace_k3(text: str, variant: tuple) -> str:
    """`bloom.cu` with the variant's kernel added and K3's launcher
    replaced by one that launches it."""
    if len(variant) == 2:
        kernel, launcher = variant
    else:
        rows, probe, load, store = variant
        kernel = (KERNEL.replace("PROBE", probe).replace("ROWS", str(rows))
                  .replace("LOAD", load).replace("STORE", store))
        launcher = LAUNCHER.replace("ROWS", str(rows))
    at = text.index("// ORs the key with hash h into its block in L2")
    text = text[:at] + kernel + text[at:]
    m = re.search(r"int bloom_probe\(.*?\n}\n", text, re.S)
    return text[:m.start()] + launcher + text[m.end():]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k3_floor: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.core import bloom
    from repro_torch.kernels import build
    from repro_torch.kernels.bloom import ops as kb

    text = build.SOURCES["bloom"].read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, variant in VARIANTS.items():
        src = build.BUILD_DIR / f"k3_{name}.cu"
        src.write_text(replace_k3(text, variant))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I",
             str(build.INCLUDE_DIR), "-o",
             str(build.BUILD_DIR / f"libk3_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    own, library = kb._lib(), kb.library
    libs = {"k3": own}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"k3_floor: nvcc {name}:\n{log}")
        kb._LIB = None
        kb.library = lambda _, name=name: ctypes.CDLL(
            str(build.BUILD_DIR / f"libk3_{name}.so"))
        libs[name] = kb._lib()
    kb.library = library

    dev = torch.device("cuda", 0)
    _, cols, filt = cs.probe_inputs(np, kb, bloom, dev)
    cases = {"2^23 orders": (filt[0], cols[0], None, 6_001_215)}
    for case in cs.K3_PATH_CASES:
        cases[case] = cs.k3_path_inputs(torch, np, kb, bloom, dev, case)
    rec = {"tool": "k3_floor", "src": args.src, "package": kb.__file__,
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(), "cases": {}}
    order = ("k3", *VARIANTS, "k3")
    for case, (words, (lo, hi), ix, count) in cases.items():
        want = kb.probe_ref(words, lo, hi, idx=ix, count=count)
        out = rec["cases"][case] = {
            "n": int(lo.shape[0] if ix is None else ix.shape[0]),
            "count": count, "nblocks": int(words.shape[0]),
            "gather": ix is not None, "survivors": int(want.sum())}
        for i, name in enumerate(order):
            kb._LIB = libs[name]
            got = kb.probe(words, lo, hi, idx=ix, count=count)
            torch.cuda.synchronize()
            if name in EXACT:
                cs.check(torch.equal(got, want),
                         f"k3_floor: {name} disagrees at {case}")

            def fn():
                return kb.probe(words, lo, hi, idx=ix, count=count)
            key = name if name not in order[:i] else f"{name}_again"
            out[f"{key}_ms"] = cs.cuda_ms(torch, fn, 20)
            out[f"{key}_device_ms"] = cs.device_ms(torch, fn)
    kb._LIB = own
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
