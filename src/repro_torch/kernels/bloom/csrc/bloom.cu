// Blocked-Bloom kernels for Hopper (sm_90a): the fused multi-filter probe
// (K1), the filter build (K2), the single-filter probe (K3) and the fused
// filter transfer (K7). Plain C interface, loaded with ctypes by
// repro_torch/kernels/bloom/ops.py; every entry point launches on the
// caller's stream, never synchronises, and returns cudaGetLastError().
//
// Filter layout (shared with the plain torch versions in ops.py): an array
// of 256-bit blocks, 8 x uint32 words each. One 32-bit hash of the key
// halves, h = fmix32(lo ^ fmix32(hi)), picks the block from its top
// log2(nblocks) bits; k in-block bit positions come from double hashing,
// pos_j = (g1 + j * g2) & 255 with g1 = fmix32(h ^ GOLDEN) and
// g2 = fmix32(h ^ 0x7FEB352D) | 1 (odd stride). A key touches exactly one
// 32-byte block, which is one DRAM/L2 sector.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"
#include "scan.cuh"

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kP2 = 0x7FEB352Du;
constexpr int kLanes = 8;
constexpr int kMaxFilters = 16;
constexpr int kThreads = 256;

// log2nb == 0 (one block) must not shift: a shift by 32 is undefined
__device__ __forceinline__ uint32_t block_of(uint32_t h, int log2nb) {
  return log2nb ? (h >> (32 - log2nb)) : 0u;
}

// The key's whole 256-bit update, formed in registers as the reference's
// _update_rows forms its 8-lane row: bit pos of the block is bit pos & 63
// of 64-bit word pos >> 6 (little-endian, so word q holds 32-bit lanes 2q
// and 2q + 1). The word is picked with selects, never a dynamic index, so
// `u` stays in registers.
__device__ __forceinline__ void block_update(uint32_t h, int k,
                                             unsigned long long (&u)[4]) {
  uint32_t g1 = fmix32(h ^ kGolden);
  uint32_t g2 = fmix32(h ^ kP2) | 1u;
#pragma unroll
  for (int q = 0; q < 4; ++q) u[q] = 0ull;
  for (int j = 0; j < k; ++j) {
    uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
    unsigned long long bit = 1ull << (pos & 63u);
#pragma unroll
    for (int q = 0; q < 4; ++q) u[q] |= (pos >> 6) == (uint32_t)q ? bit : 0ull;
  }
}

// Does the key with hash h find all k of its bits in its block? Stops at
// the first missing bit; the k word reads fall in one 32-byte sector.
// K1's, K3's and K7's probe.
__device__ __forceinline__ bool block_hit(const uint32_t* __restrict__ words,
                                          uint32_t h, int log2nb, int k) {
  const uint32_t* blk = words + (size_t)block_of(h, log2nb) * kLanes;
  uint32_t g1 = fmix32(h ^ kGolden);
  uint32_t g2 = fmix32(h ^ kP2) | 1u;
  bool ok = true;
  for (int j = 0; j < k && ok; ++j) {
    uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
    ok = (__ldg(blk + (pos >> 5)) >> (pos & 31u)) & 1u;
  }
  return ok;
}

struct ProbeArgs {
  const uint32_t* words[kMaxFilters];
  const uint32_t* lo[kMaxFilters];
  const uint32_t* hi[kMaxFilters];
  int log2nb[kMaxFilters];
};

// K1. Replaces the TPU kernel repro/kernels/bloom/bloom.py
// multi_probe_pallas (_multi_probe_kernel), reached from the reference's
// engine_bloom._fused_pallas_count / _fused_pallas_gather.
//
// Bound on this card: memory. Per row it reads 8 bytes of key halves per
// filter the row is still live for (4-byte gathers through `idx` when a
// survivor-id array is given) and one 32-byte filter block per such
// filter, and writes m bytes. Filters are at most a few MB, so their
// blocks mostly come from the 50 MB L2.
//
// Design: one thread a row, so the key loads and the m output bytes are
// coalesced across a warp; per filter the row probes with block_hit, which
// stops at the first missing bit (the k word reads fall in one 32-byte
// sector). Keeping 2 or 4 rows in flight a thread, or reading each block
// whole, was no faster on the H100 at a quarter of rows passing. Nor is
// one sector request a row the way out: at the "2^23 m=2" case (0.094 ms
// device) a probe with a single 4-byte load a live row a filter takes
// 0.081 ms, and one with no filter load 0.053 (tools/k1_floor.py), so no
// probe of one request a row reaches 1.25x; warp-cooperative probes that
// issue exactly that (a row's block read by 2 lanes in 16-byte halves, or
// by 8 lanes a word each, the answers carried back by ballots) took 0.148
// and 0.269 ms: queueing, the shared hash seeds and the ballots cost more
// than the requests they save. The key
// halves and survivor ids are loaded, and the output stored, with
// streaming cache hints (each is touched once), so they do not push the
// filters out of L2. Each filter comes by its own pointer (no stacked
// copy of the filters a call). A row that missed loads no later key or
// block (the per-row form of the reference's survivors-only early exit),
// and its later rows of `out` are written False. Rows at and past `count`
// are written False here, which replaces the reference's separate iota
// mask, and the survivor-id gather happens in the kernel instead of
// building gathered copies of the key columns first.
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
      ok = block_hit(args.words[f], h, args.log2nb[f], k);
    }
    __stcs(out + (size_t)f * n + r, (uint8_t)(ok ? 1 : 0));
  }
}

// K3. Replaces the TPU kernel repro/kernels/bloom/bloom.py probe_pallas
// (_probe_kernel), reached from the reference's PallasEngine.probe_idx on
// the plane-off route: one filter per launch, the host reading a survivor
// count after each.
//
// Bound on this card: memory. Per live row it reads 8 bytes of key halves
// (plus a 4-byte survivor id with `idx`) and one 32-byte filter block, and
// it writes one byte per row; the filter mostly stays in the 50 MB L2.
//
// Design: K1's per-row body for one filter, as its own entry point so the
// launch counts tell the two routes apart. The kernel gathers the
// survivors' key halves through `idx` and writes False at and past
// `count`, which replaces the reference's _gather2 + _mask_count around
// probe_pallas: no gathered key copies, no separate mask pass. At the
// "2^23 orders" case (0.076 ms device on the H100, one row a thread) the
// key stream and mask alone take 0.031, and one 4-byte filter load a live
// row 0.058 (0.057 at 4 rows a thread), so no probe that reads a live
// row's block from L2 comes near the 0.054 that 1.4x needs
// (tools/k3_floor.py). Slower there: rows probed bit by bit across 2 or 4
// rows a thread (0.086, 0.096), a row's block read by a lane pair, a
// 16-byte half each in one load (0.117); the filter copied into shared
// memory where it fits was 3.3x slower at 2^23 rows into 4,096 blocks (a
// 128 KB copy leaves one CTA an SM). What gains: kProbeRows = 4 rows a
// thread, row i at base + i * blockDim + t (a warp's loads stay
// coalesced), each row's per-bit chain after the last's, so a warp waits
// on the sum of its lanes' chains and not on the longest of each round:
// 0.067 at "2^23 orders", 0.033-0.036 against 0.045 at 2^23 rows into
// 4,096 blocks (the plane-off path's largest calls). Four rows a thread
// quarter the CTAs, which costs below 2^21 rows (2^16 rows: 0.0037
// against 0.0021; 1.5 M survivor ids: 0.024 against 0.021), so the rule
// (probe_rows, here only) takes them from kManyRows = 2^22 rows on, where
// chip_smoke.py's probe_rows_sweep finds them the faster with and without
// survivor ids (2^21 rows: even); bloom_probe_force_rows forces either.
constexpr int kProbeRows = 4;
constexpr int kManyRows = 1 << 22;

// 0: probe_rows's rule; 1 or kProbeRows: that many rows a thread
// (bloom_probe_force_rows).
int forced_probe_rows = 0;

int probe_rows(int n) {
  if (forced_probe_rows > 0) return forced_probe_rows;
  return n >= kManyRows ? kProbeRows : 1;
}

template <int R>
__global__ void probe_kernel(const uint32_t* __restrict__ words, int log2nb,
                             int k, const uint32_t* __restrict__ lo,
                             const uint32_t* __restrict__ hi,
                             const int32_t* __restrict__ idx, int n,
                             int count, uint8_t* __restrict__ out) {
  int base = blockIdx.x * blockDim.x * R + threadIdx.x;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    int r = base + i * blockDim.x;
    if (r >= n) return;
    bool ok = r < count;
    if (ok) {
      int src = idx != nullptr ? idx[r] : r;
      ok = block_hit(words, key_hash(__ldg(lo + src), __ldg(hi + src)),
                     log2nb, k);
    }
    out[r] = ok ? 1 : 0;
  }
}

// ORs the key with hash h into its block in L2: one 64-bit atomicOr per
// non-zero quarter of its update (at k = 4, 4 * (1 - (3/4)^4) = 2.73 on
// average, instead of k 32-bit ones). With kReadFirst the block is read
// first (from L2: other threads are ORing into it) and only quarters with
// a bit it lacks are ORed, so a repeated key costs a read, not atomics (a
// stale read only costs an atomic: OR never clears a bit, and the words
// were zeroed before the kernel); without, no load waits before the
// atomics. OR is order-independent, so concurrent inserts leave the same
// words whatever the thread schedule. `words` is 16-byte aligned (the
// wrappers allocate it).
template <bool kReadFirst>
__device__ __forceinline__ void block_insert(uint32_t* __restrict__ words,
                                             uint32_t h, int log2nb, int k) {
  unsigned long long u[4];
  block_update(h, k, u);
  unsigned long long* blk = reinterpret_cast<unsigned long long*>(words) +
                            (size_t)block_of(h, log2nb) * (kLanes / 2);
  if (kReadFirst) {
    const uint4* vec = reinterpret_cast<const uint4*>(blk);
    uint4 a = __ldcg(vec), b = __ldcg(vec + 1);
    u[0] &= ~(a.x | (unsigned long long)a.y << 32);
    u[1] &= ~(a.z | (unsigned long long)a.w << 32);
    u[2] &= ~(b.x | (unsigned long long)b.y << 32);
    u[3] &= ~(b.z | (unsigned long long)b.w << 32);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (u[q]) atomicOr(blk + q, u[q]);
  }
}

// K2. Replaces the TPU kernel repro/kernels/bloom/bloom.py build_pallas
// (_build_kernel), reached from the reference's PallasEngine.build_idx.
//
// The TPU keeps the whole filter resident in VMEM and ORs each key's
// 8-lane update row (_update_rows) into it, one grid step after another.
// Here the filter is built in shared memory a slice at a time: the keys
// are partitioned by slice first, the top bits of a key's hash picking
// its slice as they pick its block. The hash alone fixes the block and
// all k bits, so the partition moves one uint32 a key. Routes (the rule
// lives here only, in build_route; bloom_build takes it):
//  - tiny (nblocks <= 64): the whole filter is one slice; a CTA hashes
//    kTinyChunk = 8,192 rows into it in shared memory (on one block a
//    warp ORs its 32 updates together first, __reduce_or_sync) and ORs
//    its non-zero 64-bit words into the output, zeroed by a memset (one
//    CTA: plain stores, no memset).
//  - direct (fewer than kFewRows = 2^18 rows, or more than 2^23 blocks):
//    one thread a row ORs its key into L2 (block_insert), after a
//    memset. Few rows cost few atomics, fewer than the partition costs:
//    on the H100 the direct route's device time is the lower up to 2^17
//    keys and the higher from 2^18 (chip_smoke.py's route_sweep, both
//    routes forced through bloom_build_force_route).
//  - partitioned (otherwise): S = 2^clamp(log2 nblocks - 8, 4, 11)
//    blocks a slice, so about 256 slices (two CTAs an SM) of up to 64 KB
//    each, 8 to 4,096 slices; three kernels after a memset of the
//    cursors. slice_scatter_kernel hashes a tile of 4,096 rows, sorts the
//    hashes by slice in shared memory and stores each slice's part
//    contiguously into that slice's region of the scratch `hs`, which
//    holds `cap` = 5/4 of the mean rows a slice + 256 (its place there
//    from an atomic cursor a slice: OR does not care about order); a
//    hash past its slice's `cap` (only skewed keys get there) goes to
//    the overflow list instead. slice_build_kernel, one CTA a slice,
//    ORs its region into shared memory and stores the slice plainly;
//    overflow_kernel then ORs the overflow list into L2 (block_insert,
//    reading each block first: the list holds skewed, often repeated,
//    keys; its CTAs return at once when the list is empty).
// In shared memory a key ORs each of its k bits in with one 32-bit
// atomicOr, skipped when a read finds the bit set already (OR never
// clears one), so repeated keys cost reads, not atomics. Rows at and past
// `count`, and rows whose `valid` byte is 0, insert nothing; `idx`
// gathers survivor rows, `valid` is indexed by the original row id.
// Scratch (partitioned route only, bloom_build_scratch_bytes): the
// cursors, the slices' regions (5/4 of 4 bytes a row, plus 1 KB a slice)
// and the overflow list (4 bytes a row).
//
// Bound on this card: memory. The function must read 8 bytes of key
// halves a row (4 more through `idx`, 1 with `valid`) and write the
// filter once; the partitioned route moves 8 + 2 x 4 bytes a row (the
// keys once, `hs` written and read once) plus the filter.
constexpr int kTinyLog2 = 6;            // the tiny route: <= 64 blocks
constexpr int kTinyChunk = 8192;        // rows a CTA on the tiny route
constexpr int kFewRows = 1 << 18;       // fewer rows: the direct route
constexpr int kSlicesLog2 = 8;          // about 256 slices ...
constexpr int kMinSliceLog2 = 4;        // ... of 16 ...
constexpr int kMaxSliceLog2 = 11;       // ... to 2,048 blocks (64 KB)
constexpr int kMaxSlicesLog2 = 12;      // at most 4,096 slices
constexpr int kBuildThreads = 1024;
constexpr int kPassThreads = 512;       // the scatter pass
constexpr int kTile = 4096;             // rows a scatter CTA stages at once
constexpr int kPassRows = kTile / kPassThreads;  // rows in flight a thread
constexpr int kBuildRows = 4;           // hashes in flight a build thread
constexpr int kOverflowCtas = 264;      // two an SM
constexpr int kMaxDevices = 64;

enum RouteKind { kTiny, kDirect, kPartitioned };
struct Route {
  RouteKind kind;
  int log2s;  // blocks a slice (partitioned)
};

// -1: build_route's rule; kDirect or kPartitioned: that route wherever
// the filter is not tiny and (partitioned) has at most 2^kMaxSlicesLog2
// slices (bloom_build_force_route, to time both routes at one shape).
int forced_route = -1;

// log2 of the blocks a slice of a 2^log2nb-block filter: about 256
// slices, of 2^kMinSliceLog2 to 2^kMaxSliceLog2 blocks.
int slice_log2(int log2nb) {
  int log2s = log2nb - kSlicesLog2;
  return log2s < kMinSliceLog2 ? kMinSliceLog2
                               : (log2s > kMaxSliceLog2 ? kMaxSliceLog2
                                                        : log2s);
}

Route build_route(int count, int log2nb) {
  if (log2nb <= kTinyLog2) return {kTiny, log2nb};
  int log2s = slice_log2(log2nb);
  bool direct = forced_route < 0 ? count < kFewRows
                                 : forced_route == kDirect;
  if (direct || log2nb - log2s > kMaxSlicesLog2) return {kDirect, 0};
  return {kPartitioned, log2s};
}

// Hashes a slice's region of `hs` holds: 5/4 of the mean, plus 256.
int slice_cap(int count, int log2p) {
  return (count >> log2p) + (count >> (log2p + 2)) + 256;
}

// Hashes of rows r0, r0 + step, ... (R of them) below `count`, through
// `idx`; live[i] false for rows past the end or dropped by `valid`. Every
// load is issued whatever `valid` says (a row past the end reads row
// count - 1), so none waits on another's result.
template <int R>
__device__ __forceinline__ void rows_hash(const uint32_t* __restrict__ lo,
                                          const uint32_t* __restrict__ hi,
                                          const int32_t* __restrict__ idx,
                                          const uint8_t* __restrict__ valid,
                                          int r0, int step, int count,
                                          uint32_t (&h)[R], bool (&live)[R]) {
  int src[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    int r = min(r0 + i * step, count - 1);
    src[i] = idx != nullptr ? __ldg(idx + r) : r;
  }
  uint32_t kl[R], kh[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    kl[i] = __ldg(lo + src[i]);
    kh[i] = __ldg(hi + src[i]);
    live[i] = r0 + i * step < count &&
              (valid == nullptr || __ldg(valid + src[i]));
  }
#pragma unroll
  for (int i = 0; i < R; ++i) h[i] = key_hash(kl[i], kh[i]);
}

__device__ __forceinline__ int slice_of(uint32_t h, int log2p) {
  return (int)(h >> (32 - log2p));  // log2p >= 3 on the partitioned route
}

// The partitioned route's scatter: each live row's hash into its slice's
// region of `hs` (or the overflow list), a tile of kTile rows at a time,
// staged in shared memory sorted by slice so the stores of a slice are
// contiguous. K2's rows (kList false): the hashes of the build rows
// through rows_hash. K7's (kList): the first *idx entries of `lo`, the
// survivors' outgoing hashes (transfer_compact_kernel's list, its length
// at *idx); `count` is then only the grid's bound. K2's instantiation is
// the kernel as it was before K7 shared it (tools/sass_compare.py holds
// the two). fill[s] counts the hashes meant for slice s, fill[p] those on
// the overflow list (all zeroed before).
template <bool kList>
__global__ void __launch_bounds__(kPassThreads)
    slice_scatter_kernel(const uint32_t* __restrict__ lo,
                         const uint32_t* __restrict__ hi,
                         const int32_t* __restrict__ idx,
                         const uint8_t* __restrict__ valid, int count,
                         int log2p, int cap, int* __restrict__ fill,
                         uint32_t* __restrict__ hs,
                         uint32_t* __restrict__ overflow) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[32];
  int p = 1 << log2p;
  int* tile = smem;            // [p + 1] the tile's rows a slice, scanned
  int* dst = tile + p + 1;     // [p] where the tile's rows of a slice go
  int* spill = dst + p;        // [p] ... and where those past `cap` go
  uint32_t* stage = reinterpret_cast<uint32_t*>(spill + p);  // [kTile]
  if (kList) count = *idx;
  for (int t0 = blockIdx.x * kTile; t0 < count; t0 += gridDim.x * kTile) {
    for (int s = threadIdx.x; s < p; s += blockDim.x) tile[s] = 0;
    uint32_t h[kPassRows];
    bool live[kPassRows];
    if constexpr (kList) {
#pragma unroll
      for (int i = 0; i < kPassRows; ++i) {
        int r = t0 + threadIdx.x + i * blockDim.x;
        live[i] = r < count;
        h[i] = live[i] ? __ldg(lo + r) : 0u;
      }
    } else {
      rows_hash(lo, hi, idx, valid, t0 + threadIdx.x, blockDim.x, count, h,
                live);
    }
    __syncthreads();
    int rank[kPassRows];
#pragma unroll
    for (int i = 0; i < kPassRows; ++i) {
      rank[i] = live[i] ? atomicAdd(&tile[slice_of(h[i], log2p)], 1) : -1;
    }
    __syncthreads();
    block_exclusive_scan(tile, p, warp_sums);
    for (int s = threadIdx.x; s < p; s += blockDim.x) {
      int c = tile[s + 1] - tile[s];
      if (c) {
        int at = atomicAdd(fill + s, c);
        int over = at + c - (at > cap ? at : cap);  // rows past `cap`
        dst[s] = at;
        if (over > 0) spill[s] = atomicAdd(fill + p, over);
      }
    }
#pragma unroll
    for (int i = 0; i < kPassRows; ++i) {
      if (rank[i] >= 0) stage[tile[slice_of(h[i], log2p)] + rank[i]] = h[i];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < tile[p]; j += blockDim.x) {
      uint32_t v = stage[j];
      int s = slice_of(v, log2p);
      int at = dst[s] + j - tile[s];
      if (at < cap) {
        hs[(size_t)s * cap + at] = v;
      } else {
        overflow[spill[s] + at - (dst[s] > cap ? dst[s] : cap)] = v;
      }
    }
    __syncthreads();
  }
}

// ORs `bit` into the shared word *w unless it is set already. A stale
// read only costs an atomic: OR never clears a bit.
__device__ __forceinline__ void slice_or(uint32_t* w, uint32_t bit) {
  if (!(*w & bit)) atomicOr(w, bit);
}

// A slice built in shared memory, then stored. With kTinyRoute the slice
// is the whole filter and CTA b takes rows [b * kTinyChunk, (b + 1) *
// kTinyChunk) of the build rows, hashed here, ORing its words into the
// (zeroed) output when it is not the only CTA; otherwise CTA b builds
// slice b from its region of `hs` and stores it plainly.
template <bool kTinyRoute>
__global__ void __launch_bounds__(kBuildThreads)
    slice_build_kernel(const uint32_t* __restrict__ lo,
                       const uint32_t* __restrict__ hi,
                       const int32_t* __restrict__ idx,
                       const uint8_t* __restrict__ valid,
                       const uint32_t* __restrict__ hs,
                       const int* __restrict__ fill, int cap, int count,
                       int log2nb, int log2s, int k,
                       uint32_t* __restrict__ words) {
  extern __shared__ uint4 slice_vecs[];  // the slice's words
  uint32_t* slice = reinterpret_cast<uint32_t*>(slice_vecs);
  int vecs = (kLanes / 4) << log2s;
  int begin, end;
  if (kTinyRoute) {
    begin = blockIdx.x * kTinyChunk;
    end = min(begin + kTinyChunk, count);
  } else {
    begin = blockIdx.x * cap;
    end = begin + min(__ldg(fill + blockIdx.x), cap);
  }
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    slice_vecs[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  uint32_t bmask = (1u << log2s) - 1u;
  int lane = threadIdx.x & 31;
  // trips are uniform across a warp, for the one-block warp OR
  for (int i0 = begin + (int)(threadIdx.x & ~31u); i0 < end;
       i0 += kBuildRows * blockDim.x) {
    uint32_t h[kBuildRows];
    bool live[kBuildRows];
    if (kTinyRoute) {
      rows_hash(lo, hi, idx, valid, i0 + lane, blockDim.x, end, h, live);
    } else {
#pragma unroll
      for (int i = 0; i < kBuildRows; ++i) {
        int r = i0 + lane + i * blockDim.x;
        live[i] = r < end;
        h[i] = __ldg(hs + min(r, end - 1));
      }
    }
#pragma unroll
    for (int i = 0; i < kBuildRows; ++i) {
      uint32_t g1 = fmix32(h[i] ^ kGolden);
      uint32_t g2 = fmix32(h[i] ^ kP2) | 1u;
      if (kTinyRoute && log2nb == 0) {
        // one block: the warp ORs its updates together, lane 0 ORs them in
        uint32_t u[kLanes];
#pragma unroll
        for (int w = 0; w < kLanes; ++w) u[w] = 0u;
        for (int j = 0; live[i] && j < k; ++j) {
          uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
#pragma unroll
          for (int w = 0; w < kLanes; ++w) {
            u[w] |= (pos >> 5) == (uint32_t)w ? 1u << (pos & 31u) : 0u;
          }
        }
#pragma unroll
        for (int w = 0; w < kLanes; ++w) {
          uint32_t bits = __reduce_or_sync(0xffffffffu, u[w]);
          if (lane == 0 && bits && (bits & ~slice[w])) {
            atomicOr(slice + w, bits);
          }
        }
      } else if (live[i]) {
        uint32_t* blk = slice + (block_of(h[i], log2nb) & bmask) * kLanes;
        for (int j = 0; j < k; ++j) {
          uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
          slice_or(blk + (pos >> 5), 1u << (pos & 31u));
        }
      }
    }
  }
  __syncthreads();
  if (kTinyRoute && gridDim.x > 1) {
    const unsigned long long* src =
        reinterpret_cast<const unsigned long long*>(slice);
    unsigned long long* out = reinterpret_cast<unsigned long long*>(words);
    for (int i = threadIdx.x; i < 2 * vecs; i += blockDim.x) {
      unsigned long long v = src[i];
      if (v) atomicOr(out + i, v);
    }
  } else {
    uint4* out = reinterpret_cast<uint4*>(words) +
                 ((size_t)(kTinyRoute ? 0 : blockIdx.x) * vecs);
    for (int i = threadIdx.x; i < vecs; i += blockDim.x) out[i] = slice_vecs[i];
  }
}

// The partitioned route's last kernel: the overflow list's hashes (fill[p]
// of them; usually none) ORed into L2.
__global__ void overflow_kernel(const uint32_t* __restrict__ overflow,
                                const int* __restrict__ novf, int log2nb,
                                int k, uint32_t* __restrict__ words) {
  int n = *novf;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    block_insert<true>(words, __ldg(overflow + i), log2nb, k);
  }
}

// K2's direct route: one thread a row, each key ORed into L2
// (block_insert). `words` is zeroed first.
__global__ void build_kernel(const uint32_t* __restrict__ lo,
                             const uint32_t* __restrict__ hi,
                             const int32_t* __restrict__ idx,
                             const uint8_t* __restrict__ valid, int count,
                             int log2nb, int k, uint32_t* __restrict__ words) {
  uint32_t h[1];
  bool live[1];
  rows_hash(lo, hi, idx, valid, blockIdx.x * blockDim.x + threadIdx.x, 0,
            count, h, live);
  if (live[0]) block_insert<false>(words, h[0], log2nb, k);
}

// K7's insert: the k bits of the key with hash h ORed into its block in
// L2, one 32-bit atomicOr a bit. K7 inserts its survivors' outgoing keys,
// and those repeat (foreign keys: at SF 1, case C of chip_smoke.py ORs in
// about 90 copies of each of 10,000 supplier keys). There this was faster
// on the H100 than block_insert's 64-bit quarters (0.082 against 0.093 ms
// device), which are the faster on distinct keys (K2's direct route) and
// on K2's overflow list (chip_smoke.py's route sweep and skew case).
__device__ __forceinline__ void bit_insert(uint32_t* __restrict__ words,
                                           uint32_t h, int log2nb, int k) {
  uint32_t* blk = words + (size_t)block_of(h, log2nb) * kLanes;
  uint32_t g1 = fmix32(h ^ kGolden);
  uint32_t g2 = fmix32(h ^ kP2) | 1u;
  for (int j = 0; j < k; ++j) {
    uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
    atomicOr(blk + (pos >> 5), 1u << (pos & 31u));
  }
}

// K7. Replaces the TPU kernel repro/kernels/bloom/bloom.py transfer_pallas
// (_transfer_kernel), reached through kernels/bloom/ops.py bloom_transfer:
// the fused filter transformation of the paper's §3.2. Each row probes the
// incoming filter on its incoming key, ok = mask && hit, writes ok, and if
// ok inserts its outgoing key into the outgoing filter.
//
// The TPU keeps the outgoing filter resident in VMEM across its sequential
// grid and ORs the survivors' blocks in one at a time. Here the rows run in
// parallel and OR into one filter: OR is order-independent, so the words
// are bit-exact whatever the schedule.
//
// Bound on this card: memory. The mask byte in and the ok byte out per
// row, the incoming key halves of the masked rows and the outgoing ones of
// the survivors only (each 32-byte sector once), the incoming filter read
// and the outgoing one written once: at chip_smoke.py's "SF 1 case C"
// (6,000,205 rows, 987,900 survivors, a 16 MB outgoing filter) 0.0286 ms
// on the H100.
//
// What sets the pace there (tools/k7_floor.py, device ms on the H100):
// the outgoing filter's zeroing takes 0.006; the key and mask stream alone
// 0.042 at one row a thread and 0.030 at four adjacent rows; the stream
// and the incoming probe 0.053 and 0.045; the probe and the survivors'
// inserts into L2 0.083 (one atomicOr a bit, the parent's kernel) and
// 0.085. The inserts' ~4 M L2 atomics cost 0.030-0.040, on repeated keys
// (about 90 copies each) and distinct ones alike; reading the block first
// (block_insert<true>), 64-bit quarters, or a warp's survivors ORed
// together first (__match_any_sync) all cost more (0.092-0.195).
//
// Design (the rule lives here only, in transfer_plan; bloom_transfer takes
// it, bloom_transfer_force forces its route):
//  - kPartitionedTransfer (outgoing filters of more than 64 blocks and of
//    at most 2^kMaxSlicesLog2 of K2's slices, from kManyTransferRows =
//    2^22 rows on): no L2 atomics and no zeroing of the filter.
//    transfer_compact_kernel probes kTransferRows = 4 rows a thread, each
//    row's probe chain (block_hit) after the last's, the rows adjacent
//    where the key columns are 16-byte aligned and the mask and ok 4-byte
//    aligned (one 16-byte load a key half column, one 4-byte mask load and
//    one 4-byte ok store per 4 rows; otherwise, as for column views such
//    as lo[1:], row i of thread t is base + i * blockDim + t, in the same
//    kernel), and appends the survivors' outgoing hashes to a list (one
//    atomicAdd a CTA, append_survivors); K2's scatter, slice build and
//    overflow kernels then build the filter from the list
//    (slice_scatter_kernel<true>) a slice at a time in shared memory and
//    store each slice whole. At case C: 0.070-0.072 ms against the
//    parent's 0.080-0.083 (1.16x; 1.2x needed 0.0687): the compaction
//    kernel 0.0515, K2's scatter 0.0088 and slice build 0.0090, the
//    overflow kernel 0.0012, the cursors' zeroing 0.0009. Loading the
//    outgoing keys with the incoming ones before the probe (0.083), or
//    reading the incoming block whole (0.104), was slower; so were the
//    probe inside K2's scatter (0.087: a tile's survivors are too few a
//    slice), a compaction a warp at a time (0.073), and one row or 8 a
//    thread (0.091, 0.077). Below 2^22 rows the four kernels' fixed cost
//    loses to the L2 route (chip_smoke.py's transfer_sweep).
//  - kTinyTransferRoute (at most 2^kTinyLog2 = 64 blocks, 2 KB, from
//    kTinyRowsABlock = 128 rows a block on): each CTA (kTinyTransferCtas
//    at most, walking the tiles) builds the filter in shared memory and
//    ORs its non-zero 64-bit words into the output (one CTA: plain stores,
//    no zeroing), one row a thread: 0.0041 against 0.0142 ms at 2^16 rows
//    into one block (four adjacent rows a thread were slower).
//  - kL2Route (otherwise): one row a thread, bit_insert into L2 after the
//    filter is zeroed, the kernel from before the other routes (four
//    adjacent rows a thread, tools/k7_floor.py's c4_bit, were slower on
//    this route at every size up to 2^22 rows).
// Zeroing is zero_kernel's (a 16-byte store a thread): a cudaMemsetAsync
// of the same bytes took 0.0002 ms more at small filters.
constexpr int kTransferRows = 4;
constexpr int kManyTransferRows = 1 << 22;  // the partitioned route's rows
constexpr int kTinyRowsABlock = 128;        // the tiny route's rows a block
constexpr int kTinyTransferCtas = 264;      // two an SM

enum TransferRoute {
  kL2Route = 1,
  kTinyTransferRoute = 2,
  kPartitionedTransfer = 3
};

// 0: transfer_plan's rule; otherwise that route where the filter allows
// it (bloom_transfer_force).
int forced_transfer = 0;

// The route for n rows into 2^log2nb_out blocks: the tiny one only into
// at most 64 blocks, the partitioned one only into more, in at most
// 2^kMaxSlicesLog2 slices (K2's scatter's shared memory), L2 otherwise.
TransferRoute transfer_plan(int n, int log2nb_out) {
  int route = forced_transfer;
  if (log2nb_out <= kTinyLog2) {
    bool tiny = route ? route != kL2Route
                      : n >= kTinyRowsABlock << log2nb_out;
    return tiny ? kTinyTransferRoute : kL2Route;
  }
  bool many = route ? route == kPartitionedTransfer : n >= kManyTransferRows;
  return many && log2nb_out - slice_log2(log2nb_out) <= kMaxSlicesLog2
             ? kPartitionedTransfer
             : kL2Route;
}

struct TransferArgs {
  const uint32_t* in_words;
  const uint32_t* in_lo;
  const uint32_t* in_hi;
  const uint32_t* out_lo;
  const uint32_t* out_hi;
  const uint8_t* mask;
  uint8_t* ok;
  uint32_t* out_words;
  int log2nb_in, log2nb_out, k, n;
  bool adjacent;  // the columns allow adjacent rows (see K7's note)
};

// Probes R rows a thread of the tile from row `base` (blockDim.x threads;
// at R a multiple of 4 adjacent rows where a.adjacent, else strided),
// writes their ok bytes, and returns each row's ok and its outgoing key's
// hash (0 where not ok).
template <int R>
__device__ __forceinline__ void transfer_probe(const TransferArgs& a,
                                               int base, bool (&ok)[R],
                                               uint32_t (&g)[R]) {
  constexpr bool kAdjacent = R % 4 == 0;
  bool adj = kAdjacent && a.adjacent;
  int first = adj ? base + threadIdx.x * R : base + threadIdx.x;
  int step = adj ? 1 : blockDim.x;
  bool full = adj && first + R <= a.n;  // one vector access per 4 rows
  uint32_t h[R];
  if constexpr (kAdjacent) {
    if (full) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        unsigned m4 =
            __ldg(reinterpret_cast<const unsigned*>(a.mask + first) + q);
        uint4 x = make_uint4(0u, 0u, 0u, 0u), y = x;
        if (m4) {
          x = __ldg(reinterpret_cast<const uint4*>(a.in_lo + first) + q);
          y = __ldg(reinterpret_cast<const uint4*>(a.in_hi + first) + q);
        }
        uint32_t lo[4] = {x.x, x.y, x.z, x.w}, hi[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ok[4 * q + i] = (m4 >> (8 * i)) & 0xffu;
          h[4 * q + i] = key_hash(lo[i], hi[i]);
        }
      }
    }
  }
  if (!full) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int r = first + i * step;
      ok[i] = r < a.n && a.mask[r];
      h[i] = ok[i] ? key_hash(__ldg(a.in_lo + r), __ldg(a.in_hi + r)) : 0u;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (ok[i]) ok[i] = block_hit(a.in_words, h[i], a.log2nb_in, a.k);
  }
  if constexpr (kAdjacent) {
    if (full) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        unsigned packed = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          packed |= (unsigned)ok[4 * q + i] << (8 * i);
        }
        reinterpret_cast<unsigned*>(a.ok + first)[q] = packed;
        uint4 x = make_uint4(0u, 0u, 0u, 0u), y = x;
        if (packed) {
          x = __ldg(reinterpret_cast<const uint4*>(a.out_lo + first) + q);
          y = __ldg(reinterpret_cast<const uint4*>(a.out_hi + first) + q);
        }
        uint32_t lo[4] = {x.x, x.y, x.z, x.w}, hi[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[4 * q + i] = ok[4 * q + i] ? key_hash(lo[i], hi[i]) : 0u;
        }
      }
    }
  }
  if (!full) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int r = first + i * step;
      if (r < a.n) a.ok[r] = ok[i] ? 1 : 0;
      g[i] = ok[i] ? key_hash(__ldg(a.out_lo + r), __ldg(a.out_hi + r)) : 0u;
    }
  }
}

// K7's kernel on the L2 and tiny routes, one row a thread. L2: the row's
// probe, then its key ORed into the (zeroed) output (bit_insert), the
// kernel's body from before the other routes (through transfer_probe<1>
// it compiles to 240 instructions and 29 registers against 232 and 28,
// tools/sass_compare.py, and took 0.0001-0.00015 ms more a launch on the
// H100 at 2^10-2^17 rows, tools/k7_floor.py's device ops). Tiny: each CTA
// walks tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... into its shared copy of the outgoing filter
// (slice_or a bit), then ORs it into the (zeroed) output, or, alone,
// stores it.
template <bool kTiny>
__global__ void transfer_kernel(TransferArgs a) {
  extern __shared__ uint4 tiny_vecs[];  // kTiny: the outgoing filter
  uint32_t* tiny = reinterpret_cast<uint32_t*>(tiny_vecs);
  int vecs = (kLanes / 4) << a.log2nb_out;
  bool ok[1];
  uint32_t g[1];
  if (!kTiny) {
    int r = blockIdx.x * kThreads + threadIdx.x;
    if (r >= a.n) return;
    bool hit = a.mask[r] &&
               block_hit(a.in_words,
                         key_hash(__ldg(a.in_lo + r), __ldg(a.in_hi + r)),
                         a.log2nb_in, a.k);
    a.ok[r] = hit ? 1 : 0;
    if (hit) {
      bit_insert(a.out_words,
                 key_hash(__ldg(a.out_lo + r), __ldg(a.out_hi + r)),
                 a.log2nb_out, a.k);
    }
    return;
  }
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    tiny_vecs[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  for (int t = blockIdx.x * kThreads; t < a.n; t += gridDim.x * kThreads) {
    transfer_probe<1>(a, t, ok, g);
    if (!ok[0]) continue;
    uint32_t* blk = tiny + block_of(g[0], a.log2nb_out) * kLanes;
    uint32_t g1 = fmix32(g[0] ^ kGolden), g2 = fmix32(g[0] ^ kP2) | 1u;
    for (int j = 0; j < a.k; ++j) {
      uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
      slice_or(blk + (pos >> 5), 1u << (pos & 31u));
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

// Appends the survivors (ok) of a CTA's rows, R a thread, to K7's list of
// outgoing hashes: the CTA counts them by a scan, takes its place in the
// list with one atomicAdd on *n (zeroed before), and its threads store
// their survivors' hashes contiguously there (the order does not matter:
// OR is order-independent). Every thread of the CTA calls it.
template <int R>
__device__ __forceinline__ void append_survivors(const bool (&ok)[R],
                                                 const uint32_t (&g)[R],
                                                 int* __restrict__ n,
                                                 uint32_t* __restrict__ list) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int base[kWarps];
  int c = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) c += ok[i];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = c;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) base[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? base[lane] : 0;  // inclusive scan of the warps
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    int at = 0;
    if (lane == kWarps - 1 && w) at = atomicAdd(n, w);
    at = __shfl_sync(0xffffffffu, at, kWarps - 1);
    if (lane < kWarps) base[lane] = at + w - base[lane];
  }
  __syncthreads();
  int at = base[warp] + x - c;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (ok[i]) list[at++] = g[i];
  }
}

// K7's partitioned route, first kernel: kTransferRows rows a thread
// probed (transfer_probe), the survivors' outgoing hashes appended to the
// list.
__global__ void __launch_bounds__(kThreads)
    transfer_compact_kernel(TransferArgs a, int* __restrict__ n,
                            uint32_t* __restrict__ list) {
  constexpr int R = kTransferRows;
  bool ok[R];
  uint32_t g[R];
  transfer_probe<R>(a, blockIdx.x * kThreads * R, ok, g);
  append_survivors<R>(ok, g, n, list);
}

// Zeroes `nvec` 16-byte words (K7's outgoing filter, or its cursors): a
// store each, as torch's own fill does (cheaper on the card than a
// cudaMemsetAsync of the same bytes).
__global__ void zero_kernel(uint4* __restrict__ p, long long nvec) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nvec) p[i] = make_uint4(0u, 0u, 0u, 0u);
}

int zero_words(void* p, size_t bytes, cudaStream_t st) {
  long long nvec = (long long)(bytes / 16);
  zero_kernel<<<(unsigned)((nvec + kThreads - 1) / kThreads), kThreads, 0,
                st>>>(static_cast<uint4*>(p), nvec);
  return (int)cudaGetLastError();
}

// K2's partitioned route's layout of its scratch for up to `count` rows
// into 2^log2nb blocks: the cursors first (fill: an int a slice, one for
// the overflow list, then `extra` more for the caller), the slices'
// regions `hs` ([p, cap]), the overflow list ([count]).
struct Partition {
  int log2s, log2p, p, cap, cursors;
  int* fill;
  uint32_t* hs;
  uint32_t* overflow;
};

Partition partition(int count, int log2nb, int extra, void* scratch) {
  Partition q;
  q.log2s = slice_log2(log2nb);
  q.log2p = log2nb - q.log2s;
  q.p = 1 << q.log2p;
  q.cap = slice_cap(count, q.log2p);
  q.cursors = q.p + 1 + extra;
  q.fill = static_cast<int*>(scratch);
  q.hs = reinterpret_cast<uint32_t*>(q.fill + q.cursors);
  q.overflow = q.hs + (size_t)q.p * q.cap;
  return q;
}

long long partition_bytes(const Partition& q, int count) {
  return 4ll * q.cursors + 4ll * q.p * q.cap + 4ll * count;
}

// K2's partitioned route after its cursors are zeroed: the scatter (of
// count build rows, or of K7's list in lo, its length at *idx and count
// its bound), each slice built in shared memory and stored whole, the
// overflow list ORed into L2. `words` need not be zeroed.
template <bool kList>
int partitioned_kernels(const uint32_t* lo, const uint32_t* hi,
                        const int32_t* idx, const uint8_t* valid, int count,
                        const Partition& q, int log2nb, int k,
                        uint32_t* words, cudaStream_t st) {
  // the largest shared memory sizes, once a device
  static bool attrs_set[kMaxDevices] = {};
  int dev = 0;
  int err = cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= kMaxDevices || !attrs_set[dev]) {
    int scatter_max = 4 * (3 * (1 << kMaxSlicesLog2) + 1 + kTile);
    err = cudaFuncSetAttribute(slice_scatter_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               scatter_max);
    if (!err) {
      err = cudaFuncSetAttribute(slice_scatter_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 scatter_max);
    }
    if (!err) {
      err = cudaFuncSetAttribute(slice_build_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kLanes * 4 << kMaxSliceLog2);
    }
    if (err) return err;
    if (dev < kMaxDevices) attrs_set[dev] = true;
  }
  size_t scatter_smem = 4 * ((size_t)3 * q.p + 1 + kTile);
  size_t build_smem = (size_t)kLanes * 4 << q.log2s;
  slice_scatter_kernel<kList><<<(count + kTile - 1) / kTile, kPassThreads,
                                scatter_smem, st>>>(
      lo, hi, idx, valid, count, q.log2p, q.cap, q.fill, q.hs, q.overflow);
  slice_build_kernel<false><<<q.p, kBuildThreads, build_smem, st>>>(
      nullptr, nullptr, nullptr, nullptr, q.hs, q.fill, q.cap, count, log2nb,
      q.log2s, k, words);
  overflow_kernel<<<kOverflowCtas, kThreads, 0, st>>>(q.overflow, q.fill + q.p,
                                                      log2nb, k, words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bloom_max_filters() { return kMaxFilters; }

// words/los/his: host arrays of m device pointers: filter f's words,
// uint32 [2^log2nbs[f], 8], and its key halves, uint32
// [>= n or >= max(idx)+1]; log2nbs: host int array of m; idx: int32 [n]
// survivor ids or null; out: uint8 [m, n].
int bloom_multi_probe(const void* const* words, const void* const* los,
                      const void* const* his, const int* log2nbs, int m,
                      int k, const void* idx, int n, int count, void* out,
                      void* stream) {
  if (m < 1 || m > kMaxFilters) return (int)cudaErrorInvalidValue;
  ProbeArgs args;
  for (int f = 0; f < m; ++f) {
    args.words[f] = static_cast<const uint32_t*>(words[f]);
    args.lo[f] = static_cast<const uint32_t*>(los[f]);
    args.hi[f] = static_cast<const uint32_t*>(his[f]);
    args.log2nb[f] = log2nbs[f];
  }
  if (n > 0) {
    int grid = (n + kThreads - 1) / kThreads;
    multi_probe_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        args, m, k, static_cast<const int32_t*>(idx), n, count,
        static_cast<uint8_t*>(out));
  }
  return (int)cudaGetLastError();
}

// Makes every later bloom_build (and its scratch query) take `route`
// (1 direct, 2 partitioned) where the filter allows it, or, at -1,
// build_route's rule again; returns the setting it replaces. For timing
// the two routes at one shape; not thread-safe.
int bloom_build_force_route(int route) {
  int was = forced_route;
  forced_route = route == kDirect || route == kPartitioned ? route : -1;
  return was;
}

// Bytes of device scratch bloom_build needs for `count` rows into
// 2^log2nb blocks: on the partitioned route the cursors (an int a slice,
// and one), the slices' regions and the overflow list; none on the
// others.
long long bloom_build_scratch_bytes(int count, int log2nb) {
  Route route = build_route(count, log2nb);
  if (route.kind != kPartitioned) return 0;
  return partition_bytes(partition(count, log2nb, 0, nullptr), count);
}

// lo/hi: uint32 key halves (device); idx: int32 [>= count] or null;
// valid: uint8 per original row or null; words: uint32 [nblocks, 8],
// 16-byte aligned, need not be zeroed; scratch:
// bloom_build_scratch_bytes(count, log2nb) bytes, 16-byte aligned. Up to
// three kernels and a memset on `stream` (K2's note).
int bloom_build(const void* lo, const void* hi, const void* idx,
                const void* valid, int count, int log2nb, int k, void* words,
                void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* lo32 = static_cast<const uint32_t*>(lo);
  const uint32_t* hi32 = static_cast<const uint32_t*>(hi);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  uint32_t* w = static_cast<uint32_t*>(words);
  size_t filter_bytes = (size_t)kLanes * 4 << log2nb;
  if (count <= 0) return (int)cudaMemsetAsync(words, 0, filter_bytes, st);
  Route route = build_route(count, log2nb);
  int err = 0;
  switch (route.kind) {
    case kTiny: {
      int grid = (count + kTinyChunk - 1) / kTinyChunk;
      if (grid > 1) err = cudaMemsetAsync(words, 0, filter_bytes, st);
      if (err) return err;
      slice_build_kernel<true><<<grid, kBuildThreads, filter_bytes, st>>>(
          lo32, hi32, ix, ok, nullptr, nullptr, 0, count, log2nb, log2nb, k,
          w);
      break;
    }
    case kDirect: {
      err = cudaMemsetAsync(words, 0, filter_bytes, st);
      if (err) return err;
      int grid = (count + kThreads - 1) / kThreads;
      build_kernel<<<grid, kThreads, 0, st>>>(lo32, hi32, ix, ok, count,
                                              log2nb, k, w);
      break;
    }
    case kPartitioned: {
      Partition q = partition(count, log2nb, 0, scratch);
      err = cudaMemsetAsync(q.fill, 0, 4 * ((size_t)q.p + 1), st);
      if (err) return err;
      return partitioned_kernels<false>(lo32, hi32, ix, ok, count, q, log2nb,
                                        k, w, st);
    }
  }
  return (int)cudaGetLastError();
}

// words: uint32 [nblocks, 8] (device); lo/hi: uint32 key halves [>= n, or
// >= max(idx)+1]; idx: int32 [n] survivor ids or null; out: uint8 [n].
int bloom_probe(const void* words, int log2nb, int k, const void* lo,
                const void* hi, const void* idx, int n, int count, void* out,
                void* stream) {
  if (n > 0) {
    int rows = probe_rows(n);
    auto kernel = rows == kProbeRows ? probe_kernel<kProbeRows>
                                     : probe_kernel<1>;
    int tile = kThreads * rows;
    kernel<<<(n + tile - 1) / tile, kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), log2nb, k,
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
        static_cast<const int32_t*>(idx), n, count,
        static_cast<uint8_t*>(out));
  }
  return (int)cudaGetLastError();
}

// Makes every later bloom_probe take `rows` rows a thread (1 or
// kProbeRows), or, at 0, probe_rows's rule again; returns the setting it
// replaces. For timing both at one shape; not thread-safe.
int bloom_probe_force_rows(int rows) {
  int was = forced_probe_rows;
  forced_probe_rows = rows == 1 || rows == kProbeRows ? rows : 0;
  return was;
}

// The rows a thread bloom_probe takes for n rows.
int bloom_probe_rows(int n) { return probe_rows(n); }

// K7's partitioned route keeps 3 ints after K2's cursors: the survivors'
// count at fill[p + 1], and 2 to make the cursors whole 16-byte words (p
// is a power of two >= 8) for zero_words; the survivors' list (n hashes:
// the survivors are not known before the probe, and are at most n) follows
// K2's scratch.
constexpr int kTransferCursors = 3;

// Bytes of device scratch bloom_transfer needs for n rows into
// 2^log2nb_out blocks: on the partitioned route K2's scratch for n rows
// with K7's cursors, and the survivors' list; none on the others.
long long bloom_transfer_scratch_bytes(int n, int log2nb_out) {
  if (n <= 0 || transfer_plan(n, log2nb_out) != kPartitionedTransfer) {
    return 0;
  }
  return partition_bytes(partition(n, log2nb_out, kTransferCursors, nullptr),
                         n) +
         4ll * n;
}

// in_words: uint32 [2^log2nb_in, 8]; in_lo/in_hi/out_lo/out_hi: uint32 key
// halves [n]; mask: uint8 [n]; ok: uint8 [n]; out_words: uint32
// [2^log2nb_out, 8], 16-byte aligned, need not be zeroed; scratch:
// bloom_transfer_scratch_bytes(n, log2nb_out) bytes, 16-byte aligned. On
// `stream`: zero_kernel and one kernel (the tiny route's single CTA: that
// kernel alone), or on the partitioned route zero_kernel (the cursors) and
// four kernels (K7's note).
int bloom_transfer(const void* in_words, int log2nb_in, const void* in_lo,
                   const void* in_hi, const void* out_lo, const void* out_hi,
                   const void* mask, int n, int log2nb_out, int k, void* ok,
                   void* out_words, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t filter_bytes = (size_t)kLanes * 4 << log2nb_out;
  if (n <= 0) return zero_words(out_words, filter_bytes, st);
  TransferRoute route = transfer_plan(n, log2nb_out);
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
  int err = 0;
  if (route == kPartitionedTransfer) {
    Partition q = partition(n, log2nb_out, kTransferCursors, scratch);
    int* count = q.fill + q.p + 1;
    uint32_t* list = q.overflow + n;
    err = zero_words(q.fill, 4 * (size_t)q.cursors, st);
    if (err) return err;
    int rows = kThreads * kTransferRows;
    transfer_compact_kernel<<<(n + rows - 1) / rows, kThreads, 0, st>>>(
        a, count, list);
    return partitioned_kernels<true>(list, nullptr, count, nullptr, n, q,
                                     log2nb_out, k,
                                     static_cast<uint32_t*>(out_words), st);
  }
  bool tiny = route == kTinyTransferRoute;
  int grid = (n + kThreads - 1) / kThreads;
  if (tiny && grid > kTinyTransferCtas) grid = kTinyTransferCtas;
  if (!tiny || grid > 1) {
    err = zero_words(out_words, filter_bytes, st);
    if (err) return err;
  }
  auto kernel = tiny ? transfer_kernel<true> : transfer_kernel<false>;
  kernel<<<grid, kThreads, tiny ? filter_bytes : 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Makes every later bloom_transfer (and its scratch query) take `route`
// (1 L2; 2 tiny where the filter has at most 64 blocks; 3 partitioned
// where it has more, in at most 2^kMaxSlicesLog2 slices), or, at 0, the
// rule's. For timing the routes against each other at one shape; not
// thread-safe. Returns 0, or cudaErrorInvalidValue for a value out of
// range (nothing is changed then).
int bloom_transfer_force(int route) {
  if (route < 0 || route > kPartitionedTransfer) {
    return (int)cudaErrorInvalidValue;
  }
  forced_transfer = route;
  return 0;
}

// The route bloom_transfer takes for n rows into 2^log2nb_out blocks (the
// values bloom_transfer_force takes).
int bloom_transfer_plan(int n, int log2nb_out) {
  return transfer_plan(n, log2nb_out);
}

}  // extern "C"
