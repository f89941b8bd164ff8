#!/usr/bin/env python3
"""K7 (the fused Bloom filter transfer) against transfers that do less,
on one NVIDIA GPU: what sets its pace, the key and mask stream, the
probe of the incoming filter, the insert into the outgoing one, or the
outgoing filter's zeroing.

    python3 tools/k7_floor.py [--src DIR] [--variants all|NAME,...]
                              [--sweep]

Each variant is a copy of this checkout's `bloom.cu` with a kernel added
(`floor_kernel`) and K7's launcher (`bloom_transfer`) replaced by one
that zeroes the outgoing filter (`zero_words`, K7's own) and launches it,
built beside the package's own libraries (one nvcc each, all started
together) and called through the package's wrapper (`transfer`, its
library swapped in; the wrapper leaves the zeroing to the library):

- `memset`: the outgoing filter's zeroing alone (`zero_kernel`), no
  transfer kernel;
- `stream`: one row a thread, the mask byte and the masked rows' key
  halves loaded and hashed, the survivor byte written from a coin of the
  row's hash (one row in four), no filter load and no insert;
- `probe`: `stream` with the probe of the incoming filter (`block_hit`:
  k dependent word reads, stopping at the first missing bit) for the
  coin;
- `bit`: `probe` with the survivors' outgoing keys loaded and inserted
  one 32-bit `atomicOr` a bit (`bit_insert`): K7 up to this PR;
- `read_first`: `probe` with `block_insert<true>` (the block read from
  L2 first, 64-bit atomics for the quarters that lack a bit);
- `quarters`: `probe` with `block_insert<false>` (64-bit atomics, no
  read);
- `warp_or`: `probe` with the survivors of a warp that share an outgoing
  block ORed together first (`__match_any_sync` on the block,
  `__reduce_or_sync` a word) and one lane's 32-bit atomics a word;
- `r4_stream`, `r4_probe`, `r4_bit`: those at 4 rows a thread, row i of
  thread t at base + i * blockDim + t, each row's probe chain after the
  last;
- `c4_stream`, `c4_probe`, `c4_bit`, `c4_read_first`: at 4 adjacent
  rows a thread, one 16-byte load each of the key halves, one 4-byte
  load of the mask and one 4-byte store of the survivors where the
  columns allow it (else strided, as `r4_*`); `c4_bit` is K7's L2 route
  at the partitioned route's layout;
- `tiny4`: K7's tiny route at 4 adjacent rows a thread (its probe,
  `transfer_probe`, and its insert into shared memory), where K7 takes
  one; at outgoing filters of at most 64 blocks only (`--sweep`);
- `early_out`, `whole_probe`, `early_whole`: K7's partitioned route
  with another first kernel at four adjacent rows a thread: the
  outgoing key halves loaded with the incoming ones, before the probe,
  for every masked row (`early_*`), and the incoming block read whole in
  two 16-byte loads with every bit tested from registers (`*_whole`,
  `whole_probe`); `compact1`, `compact8`: its first kernel at one row or
  8 adjacent rows a thread instead of 4 (at case C's two shapes only:
  these need the route's scratch).

`k7` is the package's K7 as it is (its rule's route; at case C the
partitioned route), measured first and again last. Cases: "SF 1 case C" (`chip_smoke.py`'s
case: lineitem's 6,001,215 rows probed on `l_orderkey` against the
Q5-date orders filter of 16,384 blocks, survivors' `l_suppkey` into
524,288 blocks: about 90 copies of each of 10,000 keys) and "case C
distinct" (the same rows, every outgoing key distinct). `--sweep` adds
"2^20 case C rows", "5003 ragged" and the K7 sweep's shapes (`chip_smoke.transfer_sweep_cases`,
2^16-2^23 rows, foreign and distinct outgoing keys, and the out
filters of at most 64 blocks). One JSON line: each variant's CUDA-event
ms, device ms and device ops (torch.profiler, `chip_smoke.device_busy`:
a memset and each kernel apart) a case. `k7`,
`bit`, `read_first`, `quarters`, `warp_or`, `r4_bit`, `c4_bit`,
`c4_read_first`, `tiny4` and the five partitioned variants must equal
the plain version; the others answer wrongly by design.

`--src` is the `src/` directory whose package (wrapper and `bloom.cu`)
is measured as `k7` (default: this checkout's); with another tree's,
pass `--variants k7` (the variants' launchers zero the filter
themselves, which this checkout's wrapper leaves to them). To compare
two trees, run each in turn in one call.
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
#: the source the variants are cut into: this checkout's, whatever --src
BLOOM_CU = ROOT / "src/repro_torch/kernels/bloom/csrc/bloom.cu"

KERNEL = r"""
// tools/k7_floor.py's variant of K7.
__device__ __forceinline__ void warp_or_insert(uint32_t* __restrict__ words,
                                               bool live, uint32_t h,
                                               int log2nb, int k) {
  unsigned alive = __ballot_sync(0xffffffffu, live);
  if (!live) return;
  uint32_t b = block_of(h, log2nb);
  unsigned peers = __match_any_sync(alive, b);
  uint32_t g1 = fmix32(h ^ kGolden), g2 = fmix32(h ^ kP2) | 1u;
  uint32_t u[kLanes];
#pragma unroll
  for (int w = 0; w < kLanes; ++w) u[w] = 0u;
  for (int j = 0; j < k; ++j) {
    uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
#pragma unroll
    for (int w = 0; w < kLanes; ++w) {
      u[w] |= (pos >> 5) == (uint32_t)w ? 1u << (pos & 31u) : 0u;
    }
  }
  bool lead = (threadIdx.x & 31u) == (unsigned)(__ffs(peers) - 1);
#pragma unroll
  for (int w = 0; w < kLanes; ++w) {
    uint32_t bits = __reduce_or_sync(peers, u[w]);
    if (lead && bits) atomicOr(words + (size_t)b * kLanes + w, bits);
  }
}

__global__ void floor_kernel(const uint32_t* __restrict__ in_words,
                             int log2nb_in, const uint32_t* __restrict__ in_lo,
                             const uint32_t* __restrict__ in_hi,
                             const uint32_t* __restrict__ out_lo,
                             const uint32_t* __restrict__ out_hi,
                             const uint8_t* __restrict__ mask, int n,
                             int log2nb_out, int k, bool vec,
                             uint8_t* __restrict__ ok_out,
                             uint32_t* __restrict__ out_words) {
  constexpr int R = ROWS;
  int base = blockIdx.x * blockDim.x * R;
  bool adj = ADJACENT && vec;              // R adjacent rows a thread
  int first = adj ? base + threadIdx.x * R : base + threadIdx.x;
  int step = adj ? 1 : blockDim.x;
  bool full = adj && first + R <= n;       // one vector load a column
  bool ok[R];
  uint32_t h[R];
  if (full) {
    unsigned m4 = __ldg(reinterpret_cast<const unsigned*>(mask + first));
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    if (m4) {
      a = __ldg(reinterpret_cast<const uint4*>(in_lo + first));
      b = __ldg(reinterpret_cast<const uint4*>(in_hi + first));
    }
    uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < R; ++i) {
      ok[i] = (m4 >> (8 * i)) & 0xffu;
      h[i] = key_hash(x[i], y[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int r = first + i * step;
      ok[i] = r < n && mask[r];
      h[i] = ok[i] ? key_hash(__ldg(in_lo + r), __ldg(in_hi + r)) : 0u;
    }
  }
PROBE
  if (full) {
    unsigned packed = 0u;
#pragma unroll
    for (int i = 0; i < R; ++i) packed |= (unsigned)ok[i] << (8 * i);
    *reinterpret_cast<unsigned*>(ok_out + first) = packed;
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int r = first + i * step;
      if (r < n) ok_out[r] = ok[i] ? 1 : 0;
    }
  }
INSERT
}

"""
#: the survivors' outgoing hashes g[i] (0 for the others), then `INSERT`
OUT_KEYS = r"""  uint32_t g[R];
  if (full) {
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    bool any = false;
#pragma unroll
    for (int i = 0; i < R; ++i) any |= ok[i];
    if (any) {
      a = __ldg(reinterpret_cast<const uint4*>(out_lo + first));
      b = __ldg(reinterpret_cast<const uint4*>(out_hi + first));
    }
    uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < R; ++i) g[i] = ok[i] ? key_hash(x[i], y[i]) : 0u;
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int r = first + i * step;
      g[i] = ok[i] ? key_hash(__ldg(out_lo + r), __ldg(out_hi + r)) : 0u;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    INSERT;
  }"""
LAUNCHER = r"""int bloom_transfer(const void* in_words, int log2nb_in, const void* in_lo,
                   const void* in_hi, const void* out_lo, const void* out_hi,
                   const void* mask, int n, int log2nb_out, int k, void* ok,
                   void* out_words, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = zero_words(out_words, (size_t)kLanes * 4 << log2nb_out, st);
  if (err || n <= 0) return err;
  uintptr_t cols = reinterpret_cast<uintptr_t>(in_lo) |
                   reinterpret_cast<uintptr_t>(in_hi) |
                   reinterpret_cast<uintptr_t>(out_lo) |
                   reinterpret_cast<uintptr_t>(out_hi);
  bool vec = (cols & 15u) == 0 &&
             ((reinterpret_cast<uintptr_t>(mask) |
               reinterpret_cast<uintptr_t>(ok)) & 3u) == 0;
  int rows = kThreads * ROWS;
  floor_kernel<<<(n + rows - 1) / rows, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(in_words), log2nb_in,
      static_cast<const uint32_t*>(in_lo), static_cast<const uint32_t*>(in_hi),
      static_cast<const uint32_t*>(out_lo),
      static_cast<const uint32_t*>(out_hi),
      static_cast<const uint8_t*>(mask), n, log2nb_out, k, vec,
      static_cast<uint8_t*>(ok), static_cast<uint32_t*>(out_words));
  return (int)cudaGetLastError();
}
"""
#: the `memset` variant's launcher: the zeroing, no kernel
MEMSET_LAUNCHER = (LAUNCHER[:LAUNCHER.index("  if (err")]
                   + "  return err;\n}\n")
#: `0x8BADF00D` is never met in practice: testing for it keeps the hash
COIN = ("#pragma unroll\n  for (int i = 0; i < R; ++i) {\n"
        "    if (ok[i]) ok[i] = (((fmix32(h[i] ^ kP2) >> 8) & 3u) == 0u) ^ "
        "(h[i] == 0x8BADF00Du);\n  }")
#: each row's probe chain after the last's
HIT = ("#pragma unroll\n  for (int i = 0; i < R; ++i) {\n"
       "    if (ok[i]) ok[i] = block_hit(in_words, h[i], log2nb_in, k);\n  }")
INSERTS = {
    "bit": "if (ok[i]) bit_insert(out_words, g[i], log2nb_out, k)",
    "read_first": ("if (ok[i]) block_insert<true>(out_words, g[i], "
                   "log2nb_out, k)"),
    "quarters": ("if (ok[i]) block_insert<false>(out_words, g[i], "
                 "log2nb_out, k)"),
    "warp_or": "warp_or_insert(out_words, ok[i], g[i], log2nb_out, k)",
}
#: variant: (rows a thread, adjacent rows, probe, insert or None); None
#: for the variant that launches no kernel
VARIANTS = {
    "memset": None,
    "stream": (1, False, COIN, None),
    "probe": (1, False, HIT, None),
    "bit": (1, False, HIT, "bit"),
    "read_first": (1, False, HIT, "read_first"),
    "quarters": (1, False, HIT, "quarters"),
    "warp_or": (1, False, HIT, "warp_or"),
    "r4_stream": (4, False, COIN, None),
    "r4_probe": (4, False, HIT, None),
    "r4_bit": (4, False, HIT, "bit"),
    "c4_stream": (4, True, COIN, None),
    "c4_probe": (4, True, HIT, None),
    "c4_bit": (4, True, HIT, "bit"),
    "c4_read_first": (4, True, HIT, "read_first"),
}
#: K7's partitioned route with another compaction kernel at four adjacent
#: rows a thread: EARLY loads the outgoing key halves with the incoming
#: ones (for every masked row, before the probe) instead of for the
#: survivors after it; HIT is the probe (`block_hit`, or `whole_hit`: the
#: block's two 16-byte halves loaded at once, every bit tested from
#: registers, no early exit); the rest is K7's own
COMPACT = r"""
// tools/k7_floor.py's variant of K7: another compaction kernel.
__device__ __forceinline__ bool whole_hit(const uint32_t* __restrict__ words,
                                          uint32_t h, int log2nb, int k) {
  const uint4* blk =
      reinterpret_cast<const uint4*>(words) + (size_t)block_of(h, log2nb) * 2;
  uint4 a = __ldg(blk), b = __ldg(blk + 1);
  uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t g1 = fmix32(h ^ kGolden), g2 = fmix32(h ^ kP2) | 1u;
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

__global__ void __launch_bounds__(kThreads)
    floor_kernel(TransferArgs a, int* __restrict__ n,
                 uint32_t* __restrict__ list) {
  constexpr int R = kTransferRows;
  int base = blockIdx.x * kThreads * R, first = base + threadIdx.x * R;
  bool ok[R];
  uint32_t g[R];
  if (a.adjacent && first + R <= a.n) {
    unsigned m4 = __ldg(reinterpret_cast<const unsigned*>(a.mask + first));
    uint4 x = make_uint4(0u, 0u, 0u, 0u), y = x, u = x, v = x;
    if (m4) {
      x = __ldg(reinterpret_cast<const uint4*>(a.in_lo + first));
      y = __ldg(reinterpret_cast<const uint4*>(a.in_hi + first));
      if (EARLY) {
        u = __ldg(reinterpret_cast<const uint4*>(a.out_lo + first));
        v = __ldg(reinterpret_cast<const uint4*>(a.out_hi + first));
      }
    }
    uint32_t lo[4] = {x.x, x.y, x.z, x.w}, hi[4] = {y.x, y.y, y.z, y.w};
    unsigned packed = 0u;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      ok[i] = ((m4 >> (8 * i)) & 0xffu) &&
              HIT(a.in_words, key_hash(lo[i], hi[i]), a.log2nb_in, a.k);
      packed |= (unsigned)ok[i] << (8 * i);
    }
    *reinterpret_cast<unsigned*>(a.ok + first) = packed;
    if (!EARLY && packed) {
      u = __ldg(reinterpret_cast<const uint4*>(a.out_lo + first));
      v = __ldg(reinterpret_cast<const uint4*>(a.out_hi + first));
    }
    uint32_t olo[4] = {u.x, u.y, u.z, u.w}, ohi[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < R; ++i) g[i] = ok[i] ? key_hash(olo[i], ohi[i]) : 0u;
  } else {
    transfer_probe<R>(a, base, ok, g);
  }
  append_survivors<R>(ok, g, n, list);
}

"""
COMPACT_LAUNCHER = r"""int bloom_transfer(const void* in_words, int log2nb_in, const void* in_lo,
                   const void* in_hi, const void* out_lo, const void* out_hi,
                   const void* mask, int n, int log2nb_out, int k, void* ok,
                   void* out_words, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  uintptr_t cols = reinterpret_cast<uintptr_t>(in_lo) |
                   reinterpret_cast<uintptr_t>(in_hi) |
                   reinterpret_cast<uintptr_t>(out_lo) |
                   reinterpret_cast<uintptr_t>(out_hi);
  uintptr_t bytes = reinterpret_cast<uintptr_t>(mask) |
                    reinterpret_cast<uintptr_t>(ok);
  TransferArgs a = {static_cast<const uint32_t*>(in_words),
                    static_cast<const uint32_t*>(in_lo),
                    static_cast<const uint32_t*>(in_hi),
                    static_cast<const uint32_t*>(out_lo),
                    static_cast<const uint32_t*>(out_hi),
                    static_cast<const uint8_t*>(mask),
                    static_cast<uint8_t*>(ok),
                    static_cast<uint32_t*>(out_words),
                    log2nb_in, log2nb_out, k, n,
                    (cols & 15u) == 0 && (bytes & 3u) == 0};
  Partition q = partition(n, log2nb_out, kTransferCursors, scratch);
  int* count = q.fill + q.p + 1;
  uint32_t* list = q.overflow + n;
  int err = zero_words(q.fill, 4 * (size_t)q.cursors, st);
  if (err) return err;
  int rows = kThreads * kTransferRows;
  floor_kernel<<<(n + rows - 1) / rows, kThreads, 0, st>>>(a, count, list);
  return partitioned_kernels<true>(list, nullptr, nullptr, nullptr, count, n,
                                   q, log2nb_out, k,
                                   static_cast<uint32_t*>(out_words), st);
}
"""
for name, early, hit in (("early_out", "true", "block_hit"),
                         ("whole_probe", "false", "whole_hit"),
                         ("early_whole", "true", "whole_hit")):
    VARIANTS[name] = (COMPACT.replace("EARLY", early)
                      .replace("HIT(", hit + "("), COMPACT_LAUNCHER)
#: K7's partitioned route with its own first kernel at RR rows a thread
#: (adjacent where the columns allow at 8, strided at 1)
ROWS_COMPACT = r"""
// tools/k7_floor.py's variant of K7: the compaction at RR rows a thread.
__global__ void __launch_bounds__(kThreads)
    floor_kernel(TransferArgs a, int* __restrict__ n,
                 uint32_t* __restrict__ list) {
  bool ok[RR];
  uint32_t g[RR];
  transfer_probe<RR>(a, blockIdx.x * kThreads * RR, ok, g);
  append_survivors<RR>(ok, g, n, list);
}

"""
for rr in (1, 8):
    VARIANTS[f"compact{rr}"] = (
        ROWS_COMPACT.replace("RR", str(rr)),
        COMPACT_LAUNCHER.replace("kThreads * kTransferRows",
                                 f"kThreads * {rr}"))
#: K7's tiny route with its kernel at RR rows a thread
TINY = r"""
// tools/k7_floor.py's variant of K7: the tiny route at RR rows a thread.
__global__ void floor_kernel(TransferArgs a) {
  extern __shared__ uint4 tiny_vecs[];  // the outgoing filter
  uint32_t* tiny = reinterpret_cast<uint32_t*>(tiny_vecs);
  int vecs = (kLanes / 4) << a.log2nb_out;
  int rows = kThreads * RR;
  bool ok[RR];
  uint32_t g[RR];
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    tiny_vecs[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  for (int t = blockIdx.x * rows; t < a.n; t += gridDim.x * rows) {
    transfer_probe<RR>(a, t, ok, g);
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      if (!ok[i]) continue;
      uint32_t* blk = tiny + block_of(g[i], a.log2nb_out) * kLanes;
      uint32_t g1 = fmix32(g[i] ^ kGolden), g2 = fmix32(g[i] ^ kP2) | 1u;
      for (int j = 0; j < a.k; ++j) {
        uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
        slice_or(blk + (pos >> 5), 1u << (pos & 31u));
      }
    }
  }
  __syncthreads();
  if (gridDim.x == 1) {
    uint4* out = reinterpret_cast<uint4*>(a.out_words);
    for (int i = threadIdx.x; i < vecs; i += kThreads) out[i] = tiny_vecs[i];
  } else {
    const unsigned long long* src =
        reinterpret_cast<const unsigned long long*>(tiny);
    unsigned long long* out =
        reinterpret_cast<unsigned long long*>(a.out_words);
    for (int i = threadIdx.x; i < 2 * vecs; i += kThreads) {
      unsigned long long v = src[i];
      if (v) atomicOr(out + i, v);
    }
  }
}

"""
#: its launcher: K7's arguments as the partitioned variants take them, a
#: CTA a tile up to kTinyTransferCtas, the filter zeroed where they OR
TINY_LAUNCHER = (
    COMPACT_LAUNCHER[:COMPACT_LAUNCHER.index("  if (n <= 0")]
    + "  size_t filter_bytes = (size_t)kLanes * 4 << log2nb_out;\n"
    + "  if (n <= 0 || log2nb_out > kTinyLog2) "
      "return (int)cudaErrorInvalidValue;\n"
    + COMPACT_LAUNCHER[COMPACT_LAUNCHER.index("  uintptr_t cols"):
                       COMPACT_LAUNCHER.index("  Partition q")]
    + r"""  int rows = kThreads * RR;
  int grid = (n + rows - 1) / rows;
  if (grid > kTinyTransferCtas) grid = kTinyTransferCtas;
  if (grid > 1) {
    int err = zero_words(out_words, filter_bytes, st);
    if (err) return err;
  }
  floor_kernel<<<grid, kThreads, filter_bytes, st>>>(a);
  return (int)cudaGetLastError();
}
""")
VARIANTS["tiny4"] = (TINY.replace("RR", "4"),
                     TINY_LAUNCHER.replace("RR", "4"))
#: variants that need the partitioned route's scratch (case C's shapes:
#: the wrapper allocates it where K7's rule takes that route)
PARTITIONED = ("early_out", "whole_probe", "early_whole", "compact1",
               "compact8")
#: variants of the tiny route (outgoing filters of at most 64 blocks)
TINY_ONLY = ("tiny4",)
EXACT = ("k7", "bit", "read_first", "quarters", "warp_or", "r4_bit",
         "c4_bit", "c4_read_first", *TINY_ONLY, *PARTITIONED)


def replace_k7(text: str, variant) -> str:
    """`bloom.cu` with the variant's kernel added at the end of its
    anonymous namespace and K7's launcher replaced by one that zeroes
    the outgoing filter and launches it (`memset`: only zeroes it)."""
    if variant is None:
        kernel, launcher = "", MEMSET_LAUNCHER
    elif len(variant) == 2:
        kernel, launcher = variant
    else:
        rows, adjacent, probe, insert = variant
        body = ("" if insert is None else
                OUT_KEYS.replace("INSERT", INSERTS[insert]))
        kernel = (KERNEL.replace("PROBE", probe).replace("INSERT", body)
                  .replace("ADJACENT", "true" if adjacent else "false")
                  .replace("ROWS", str(rows)))
        launcher = LAUNCHER.replace("ROWS", str(rows))
    at = text.rindex("}  // namespace")
    text = text[:at] + kernel + text[at:]
    m = re.search(r"int bloom_transfer\(.*?\n}\n", text, re.S)
    return text[:m.start()] + launcher + text[m.end():]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--variants", default="all",
                    help="'all' or a comma list of variant names ('k7': "
                         "the package's kernel only)")
    ap.add_argument("--sweep", action="store_true",
                    help="also '5003 ragged' and the K7 sweep's shapes")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k7_floor: CUDA is not available", file=sys.stderr)
        return 2
    names = (list(VARIANTS) if args.variants == "all" else
             [v for v in args.variants.split(",") if v != "k7"])
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"k7_floor: no variant {name!r}")
        if args.sweep and name in PARTITIONED:
            raise SystemExit(f"k7_floor: {name} runs at case C only")
        if not args.sweep and name in TINY_ONLY:
            raise SystemExit(f"k7_floor: {name} runs with --sweep only")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.core import bloom
    from repro_torch.kernels import build
    from repro_torch.kernels.bloom import ops as kb
    from repro_torch.tpch import generate

    text = BLOOM_CU.read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = build.BUILD_DIR / f"k7_{name}.cu"
        src.write_text(replace_k7(text, VARIANTS[name]))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I",
             str(build.INCLUDE_DIR), "-o",
             str(build.BUILD_DIR / f"libk7_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    own, library = kb._lib(), kb.library
    libs = {"k7": own}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"k7_floor: nvcc {name}:\n{log}")
        kb._LIB = None
        kb.library = lambda _, name=name: ctypes.CDLL(
            str(build.BUILD_DIR / f"libk7_{name}.so"))
        libs[name] = kb._lib()
    kb.library = library

    dev = torch.device("cuda", 0)
    api = cs.api_inputs(np, generate(sf=1.0, seed=7))
    cases = cs.transfer_cases(torch, np, kb, bloom, dev, api)
    if not args.sweep:
        cases.pop("2^20 case C rows")
        cases.pop("5003 ragged")
    else:
        cases.update(cs.transfer_sweep_cases(torch, np, kb, bloom, dev))
    rec = {"tool": "k7_floor", "src": args.src, "package": kb.__file__,
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(), "cases": {}}
    order = ("k7", *names, "k7")
    for case, targs in cases.items():
        ok_ref, words_ref = bloom.transfer(*targs)
        out = rec["cases"][case] = {
            "n": int(targs[1].shape[0]), "live": int(targs[5].sum()),
            "nblocks_in": int(targs[0].shape[0]), "nblocks_out": targs[6],
            "survivors": int(ok_ref.sum())}
        for i, name in enumerate(order):
            if name in TINY_ONLY and targs[6] > 64:
                continue
            kb._LIB = libs[name]
            ok, words = kb.transfer(*targs)
            torch.cuda.synchronize()
            if name in EXACT:
                cs.check(torch.equal(ok, ok_ref)
                         and torch.equal(words, words_ref),
                         f"k7_floor: {name} disagrees at {case}")

            def fn():
                return kb.transfer(*targs)
            key = name if name not in order[:i] else f"{name}_again"
            out[f"{key}_ms"] = cs.cuda_ms(torch, fn, 20)
            busy = cs.device_busy(torch, fn, 20)
            out[f"{key}_device_ms"] = busy["device_busy_seconds"] * 50
            out[f"{key}_ops"] = {op["op"][:40]: op["ms"] / 20
                                 for op in busy["top_device_ms"]}
    kb._LIB = own
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
