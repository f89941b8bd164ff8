// Blocked-Bloom kernels for Hopper (sm_90a): the fused multi-filter probe
// (K1) and the filter build (K2). Plain C interface, loaded with ctypes by
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

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kP2 = 0x7FEB352Du;
constexpr int kLanes = 8;
constexpr int kMaxFilters = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// log2nb == 0 (one block) must not shift: a shift by 32 is undefined
__device__ __forceinline__ uint32_t block_of(uint32_t h, int log2nb) {
  return log2nb ? (h >> (32 - log2nb)) : 0u;
}

struct ProbeArgs {
  const uint32_t* lo[kMaxFilters];
  const uint32_t* hi[kMaxFilters];
  int log2nb[kMaxFilters];
  int offset[kMaxFilters];  // first block of filter f in the stacked words
};

// K1. Replaces the TPU kernel repro/kernels/bloom/bloom.py
// multi_probe_pallas (_multi_probe_kernel), reached from the reference's
// engine_bloom._fused_pallas_count / _fused_pallas_gather.
//
// Bound on this card: memory. Per row it reads 8 bytes of key halves per
// filter (4-byte gathers through `idx` when a survivor-id array is given)
// and one 32-byte filter block per filter, and writes m bytes. Filters are
// at most a few MB, so their blocks mostly come from the 50 MB L2.
//
// Design: one thread per row, so the key loads and the m output bytes are
// coalesced across a warp; the k word reads of one filter fall in one
// sector. A row that missed stops probing (its later rows of `out` are
// written False without touching the filter), the per-row form of the
// reference's survivors-only early exit. Rows at and past `count` are
// written False here, which replaces the reference's separate iota mask,
// and the survivor-id gather happens in the kernel instead of building
// gathered copies of the key columns first.
__global__ void multi_probe_kernel(const uint32_t* __restrict__ words,
                                   ProbeArgs args, int m, int k,
                                   const int32_t* __restrict__ idx, int n,
                                   int count, uint8_t* __restrict__ out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  bool ok = r < count;
  int src = (ok && idx != nullptr) ? idx[r] : r;
  for (int f = 0; f < m; ++f) {
    if (ok) {
      uint32_t h = fmix32(__ldg(args.lo[f] + src) ^
                          fmix32(__ldg(args.hi[f] + src)));
      const uint32_t* blk =
          words + (size_t)(block_of(h, args.log2nb[f]) + args.offset[f]) *
                      kLanes;
      uint32_t g1 = fmix32(h ^ kGolden);
      uint32_t g2 = fmix32(h ^ kP2) | 1u;
      for (int j = 0; j < k && ok; ++j) {
        uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
        ok = (__ldg(blk + (pos >> 5)) >> (pos & 31u)) & 1u;
      }
    }
    out[(size_t)f * n + r] = ok ? 1 : 0;
  }
}

// K2. Replaces the TPU kernel repro/kernels/bloom/bloom.py build_pallas
// (_build_kernel), reached from the reference's PallasEngine.build_idx.
//
// The TPU serialises this read-modify-write (its vector unit has no
// scatter-OR). Here each key does k atomicOr's on 32-bit words of its
// block; OR is order-independent, so the words are bit-exact whatever the
// thread schedule. Bound on this card: the atomics, which land in L2 (the
// filter is at most a few MB), plus 8 bytes of key halves read per row.
// Rows at and past `count`, and rows whose `valid` byte is 0, insert
// nothing; `idx` gathers survivor rows, `valid` is indexed by the original
// row id. The output words are zeroed by the caller.
__global__ void build_kernel(const uint32_t* __restrict__ lo,
                             const uint32_t* __restrict__ hi,
                             const int32_t* __restrict__ idx,
                             const uint8_t* __restrict__ valid, int count,
                             int log2nb, int k, uint32_t* __restrict__ words) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= count) return;
  int src = idx != nullptr ? idx[r] : r;
  if (valid != nullptr && !valid[src]) return;
  uint32_t h = fmix32(__ldg(lo + src) ^ fmix32(__ldg(hi + src)));
  uint32_t* blk = words + (size_t)block_of(h, log2nb) * kLanes;
  uint32_t g1 = fmix32(h ^ kGolden);
  uint32_t g2 = fmix32(h ^ kP2) | 1u;
  for (int j = 0; j < k; ++j) {
    uint32_t pos = (g1 + (uint32_t)j * g2) & 255u;
    atomicOr(blk + (pos >> 5), 1u << (pos & 31u));
  }
}

}  // namespace

extern "C" {

int bloom_max_filters() { return kMaxFilters; }

// words: uint32 [sum nblocks_f, 8] (device); los/his: host arrays of m
// device pointers to uint32 [>= n or >= max(idx)+1]; log2nbs/offsets: host
// int arrays of m; idx: int32 [n] survivor ids or null; out: uint8 [m, n].
int bloom_multi_probe(const void* words, const void* const* los,
                      const void* const* his, const int* log2nbs,
                      const int* offsets, int m, int k, const void* idx,
                      int n, int count, void* out, void* stream) {
  if (m < 1 || m > kMaxFilters) return (int)cudaErrorInvalidValue;
  ProbeArgs args;
  for (int f = 0; f < m; ++f) {
    args.lo[f] = static_cast<const uint32_t*>(los[f]);
    args.hi[f] = static_cast<const uint32_t*>(his[f]);
    args.log2nb[f] = log2nbs[f];
    args.offset[f] = offsets[f];
  }
  if (n > 0) {
    int grid = (n + kThreads - 1) / kThreads;
    multi_probe_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), args, m, k,
        static_cast<const int32_t*>(idx), n, count,
        static_cast<uint8_t*>(out));
  }
  return (int)cudaGetLastError();
}

// lo/hi: uint32 key halves (device); idx: int32 [>= count] or null;
// valid: uint8 per original row or null; words: uint32 [nblocks, 8],
// zeroed by the caller.
int bloom_build(const void* lo, const void* hi, const void* idx,
                const void* valid, int count, int log2nb, int k, void* words,
                void* stream) {
  if (count > 0) {
    int grid = (count + kThreads - 1) / kThreads;
    build_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
        static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(valid),
        count, log2nb, k, static_cast<uint32_t*>(words));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
