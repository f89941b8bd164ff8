// Open-addressing key -> row map kernels for Hopper (sm_90a): the build
// (K4) and the lookup (K5) of the plane-off hash-map join. Plain C
// interface, loaded with ctypes by repro_torch/kernels/semijoin/ops.py;
// every entry point launches on the caller's stream, never synchronises,
// and returns cudaGetLastError().
//
// Table layout (shared with the plain torch versions in ops.py): `cap`
// 16-byte slots, cap a power of two at <= 50% load. A slot is one record
// {lo, hi, state, row}: the int64 key's uint32 halves, its state (0 empty,
// 1 published, 2 claimed while its owner writes it) and the build row it
// maps to. The reference keeps four separate lanes (klo, khi, occ, row),
// so a probe there touches four 32-byte sectors per slot; here it touches
// one. A finished table holds only states 0 and 1, so its four columns are
// the reference's four lanes. Any int64 value is a legal key, which is why
// emptiness is a state and not a sentinel key. A key's home slot is
// fmix32(lo ^ fmix32(hi)) & (cap - 1): the LOW bits of the hash the Bloom
// kernels take their block index from (their top bits); collisions probe
// linearly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kEmpty = 0u;
constexpr uint32_t kPublished = 1u;
constexpr uint32_t kClaimed = 2u;

struct alignas(16) Slot {
  uint32_t lo, hi, state, row;
};

__device__ __forceinline__ uint32_t home_slot(uint32_t lo, uint32_t hi,
                                              uint32_t mask) {
  return key_hash(lo, hi) & mask;
}

// K4. Replaces the TPU kernel repro/kernels/semijoin/semijoin.py
// build_rows_pallas (_build_rows_kernel), reached from the reference's
// PallasJoinEngine._build through kernels/semijoin/ops.py joinmap_build.
//
// The TPU inserts one key at a time. Here each key has its own thread and
// claims a slot with atomicCAS on the state (empty -> claimed), writes its
// key halves and row, fences, and publishes (claimed -> published). A
// thread that meets a claimed slot spins until it is published (the key is
// written before the state, behind __threadfence), then compares keys:
// equal keys dedup into one slot, so `occupied` (the count of claimed
// slots, summed per block) is exact whatever the schedule, and "last row
// wins" becomes atomicMax on the row, the row the sequential insert would
// leave. Slots never return to empty, so two threads with one key walk
// the same probe sequence and meet at the same slot. The layout differs
// from the sequential insert's; K5's answers do not depend on it.
//
// Bound on this card: memory. 8 bytes of key halves per row in, and the
// table (16 bytes a slot) out; the slot accesses are random 16-byte
// atomics and stores, one sector each, and at SF 1 (cap 2^22, 64 MB) the
// table does not fit in the 50 MB L2.
__global__ void build_rows_kernel(const uint32_t* __restrict__ lo,
                                  const uint32_t* __restrict__ hi, int n,
                                  uint32_t mask, Slot* table,
                                  unsigned long long* occupied) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  int claimed = 0;
  if (r < n) {
    uint32_t a = __ldg(lo + r), b = __ldg(hi + r);
    uint32_t s = home_slot(a, b, mask);
    for (;;) {
      Slot* p = table + s;
      uint32_t st = atomicCAS(&p->state, kEmpty, kClaimed);
      if (st == kEmpty) {
        p->lo = a;
        p->hi = b;
        p->row = (uint32_t)r;
        __threadfence();
        atomicExch(&p->state, kPublished);
        claimed = 1;
        break;
      }
      while (st == kClaimed) {
        st = *reinterpret_cast<volatile uint32_t*>(&p->state);
      }
      __threadfence();
      if (__ldcg(&p->lo) == a && __ldcg(&p->hi) == b) {
        atomicMax(&p->row, (uint32_t)r);
        break;
      }
      s = (s + 1) & mask;
    }
  }
  int nclaimed = __syncthreads_count(claimed);
  if (threadIdx.x == 0 && nclaimed > 0) {
    atomicAdd(occupied, (unsigned long long)nclaimed);
  }
}

// K5. Replaces the TPU kernel repro/kernels/semijoin/semijoin.py
// lookup_pallas (_lookup_kernel), reached from PallasJoinEngine._lookup
// through joinmap_lookup.
//
// One thread per probe key walks the probe sequence from the key's home
// slot and stops at the key (its row) or at an empty slot (-1). Each step
// is one 16-byte load, a single sector, instead of the reference's four
// lane reads. Bound on this card: memory, 8 bytes of key halves in and 4
// bytes out per key plus one 32-byte sector per slot visited; a table
// larger than L2 sends those sector reads to HBM.
__global__ void lookup_kernel(const Slot* __restrict__ table, uint32_t mask,
                              const uint32_t* __restrict__ lo,
                              const uint32_t* __restrict__ hi, int n,
                              int32_t* __restrict__ out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  uint32_t a = __ldg(lo + r), b = __ldg(hi + r);
  uint32_t s = home_slot(a, b, mask);
  const uint4* slots = reinterpret_cast<const uint4*>(table);
  int32_t ans = -1;
  for (;;) {
    uint4 v = __ldg(slots + s);
    if (v.z == kEmpty) break;
    if (v.x == a && v.y == b) {
      ans = (int32_t)v.w;
      break;
    }
    s = (s + 1) & mask;
  }
  out[r] = ans;
}

}  // namespace

extern "C" {

// lo/hi: uint32 key halves [n] (device); cap: a power of two >= 2n; table:
// Slot [cap], zeroed by the caller; occupied: uint64 [1], zeroed by the
// caller, receives the number of distinct keys.
int joinmap_build_rows(const void* lo, const void* hi, int n, int cap,
                       void* table, void* occupied, void* stream) {
  if (cap < 1 || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int grid = (n + kThreads - 1) / kThreads;
    build_rows_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi), n,
        (uint32_t)(cap - 1), static_cast<Slot*>(table),
        static_cast<unsigned long long*>(occupied));
  }
  return (int)cudaGetLastError();
}

// table: Slot [cap] from joinmap_build_rows; lo/hi: uint32 key halves [n];
// out: int32 [n], the matched build row or -1.
int joinmap_lookup(const void* table, int cap, const void* lo, const void* hi,
                   int n, void* out, void* stream) {
  if (cap < 1 || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int grid = (n + kThreads - 1) / kThreads;
    lookup_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Slot*>(table), (uint32_t)(cap - 1),
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi), n,
        static_cast<int32_t*>(out));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
