// Open-addressing hash table kernels for Hopper (sm_90a): the key -> row
// map build (K4) and lookup (K5) of the plane-off hash-map join, and the
// key set build (K6a) and membership probe (K6b) of the semi-join
// (semijoin_build / semijoin_probe / semi_mask). K4 and K6a are one
// template, as are K5 and K6b. Plain C interface, loaded with ctypes by
// repro_torch/kernels/semijoin/ops.py; every entry point launches on the
// caller's stream, never synchronises, and returns cudaGetLastError().
//
// Table layout (shared with the plain torch versions in ops.py): `cap`
// 16-byte slots, cap a power of two at <= 50% load. A slot is one record
// {lo, hi, state, row}: the int64 key's uint32 halves, its state (0 empty,
// 1 published, 2 claimed while its owner writes it) and the build row it
// maps to (0 in a key set). The reference keeps separate lanes (klo, khi,
// occ, and row for the map), so a probe there touches three or four
// 32-byte sectors per slot; here it touches one. A finished table holds
// only states 0 and 1, so its columns are the reference's lanes. Any
// int64 value is a legal key, which is why emptiness is a state and not a
// sentinel key. A key's home slot is
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

// Inserts the key (a, b) from its home slot and returns 1 if this thread
// claimed a fresh slot for it, 0 if the key was there already.
//
// The TPU inserts one key at a time. Here each key has its own thread and
// claims a slot with atomicCAS on the state (empty -> claimed), writes its
// key halves (and, with kRows, its row), fences, and publishes (claimed ->
// published). A thread that meets a claimed slot spins until it is
// published (the key is written before the state, behind __threadfence),
// then compares keys: equal keys dedup into one slot, so the count of
// claimed slots is exact whatever the schedule, and with kRows "last row
// wins" becomes atomicMax on the row, the row the sequential insert would
// leave. Slots never return to empty, so two threads with one key walk the
// same probe sequence and meet at the same slot. The layout differs from
// the sequential insert's; the walks' answers do not depend on it.
template <bool kRows>
__device__ __forceinline__ int insert_key(Slot* table, uint32_t mask,
                                          uint32_t a, uint32_t b,
                                          uint32_t row) {
  uint32_t s = home_slot(a, b, mask);
  for (;;) {
    Slot* p = table + s;
    uint32_t st = atomicCAS(&p->state, kEmpty, kClaimed);
    if (st == kEmpty) {
      p->lo = a;
      p->hi = b;
      if (kRows) p->row = row;
      __threadfence();
      atomicExch(&p->state, kPublished);
      return 1;
    }
    while (st == kClaimed) {
      st = *reinterpret_cast<volatile uint32_t*>(&p->state);
    }
    __threadfence();
    if (__ldcg(&p->lo) == a && __ldcg(&p->hi) == b) {
      if (kRows) atomicMax(&p->row, row);
      return 0;
    }
    s = (s + 1) & mask;
  }
}

// K4 (kRows, every row, keep == nullptr). Replaces the TPU kernel
// repro/kernels/semijoin/semijoin.py build_rows_pallas (_build_rows_kernel),
// reached from the reference's PallasJoinEngine._build through
// kernels/semijoin/ops.py joinmap_build: a key -> row map.
//
// K6a (!kRows, rows whose keep byte is 1). Replaces the TPU kernel
// repro/kernels/semijoin/semijoin.py build_pallas (_build_kernel), reached
// through kernels/semijoin/ops.py semijoin_build / semi_mask: a key set.
// Its slots keep K4's 16-byte record with the row left at 0, so one table
// format and one walk serve both. Masked-off rows touch no slot.
//
// One thread per row runs insert_key; `occupied` (the claimed slots,
// summed per block) is the count of distinct inserted keys.
//
// Bound on this card: memory. 8 bytes of key halves per row in (K6a: its
// keep byte, and the key halves of the kept rows only, each 32-byte sector
// once), and the table (16 bytes a slot) out; the slot accesses
// are random 16-byte atomics and stores, one sector each, and at SF 1 (cap
// 2^22, 64 MB; K6a's lineitem build 2^24, 256 MB) the table does not fit in
// the 50 MB L2.
template <bool kRows>
__global__ void build_kernel(const uint32_t* __restrict__ lo,
                             const uint32_t* __restrict__ hi,
                             const uint8_t* __restrict__ keep, int n,
                             uint32_t mask, Slot* table,
                             unsigned long long* occupied) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  int claimed = 0;
  if (r < n && (keep == nullptr || keep[r])) {
    claimed = insert_key<kRows>(table, mask, __ldg(lo + r), __ldg(hi + r),
                                (uint32_t)r);
  }
  int nclaimed = __syncthreads_count(claimed);
  if (threadIdx.x == 0 && nclaimed > 0) {
    atomicAdd(occupied, (unsigned long long)nclaimed);
  }
}

// The walk from the key's home slot: the row of the slot that holds the
// key, or -1 at the first empty slot. Each step is one 16-byte load, a
// single sector, instead of the reference's three (K6b) or four (K5) lane
// reads.
__device__ __forceinline__ int32_t walk(const uint4* __restrict__ slots,
                                        uint32_t mask, uint32_t a,
                                        uint32_t b) {
  uint32_t s = home_slot(a, b, mask);
  for (;;) {
    uint4 v = __ldg(slots + s);
    if (v.z == kEmpty) return -1;
    if (v.x == a && v.y == b) return (int32_t)v.w;
    s = (s + 1) & mask;
  }
}

// K5. Replaces the TPU kernel repro/kernels/semijoin/semijoin.py
// lookup_pallas (_lookup_kernel), reached from PallasJoinEngine._lookup
// through joinmap_lookup: one thread per probe key writes the walk's row
// or -1.
//
// K6b (kRows false). Replaces the TPU kernel
// repro/kernels/semijoin/semijoin.py probe_pallas (_probe_kernel), reached
// through semijoin_probe / semi_mask: the same walk over a K6a table
// (rows 0), writing 1 where it found the key.
//
// Bound on this card: memory, 8 bytes of key halves in and 4 bytes (K6b:
// one byte) out per key plus one 32-byte sector per slot visited; a table
// larger than L2 sends those sector reads to HBM.
template <bool kRows, typename Out>
__global__ void probe_kernel(const Slot* __restrict__ table, uint32_t mask,
                             const uint32_t* __restrict__ lo,
                             const uint32_t* __restrict__ hi, int n,
                             Out* __restrict__ out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  int32_t ans = walk(reinterpret_cast<const uint4*>(table), mask,
                     __ldg(lo + r), __ldg(hi + r));
  out[r] = kRows ? (Out)ans : (Out)(ans >= 0);
}

template <bool kRows>
int launch_build(const void* lo, const void* hi, const void* keep, int n,
                 int cap, void* table, void* occupied, void* stream) {
  if (cap < 1 || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int grid = (n + kThreads - 1) / kThreads;
    build_kernel<kRows><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
        static_cast<const uint8_t*>(keep), n, (uint32_t)(cap - 1),
        static_cast<Slot*>(table),
        static_cast<unsigned long long*>(occupied));
  }
  return (int)cudaGetLastError();
}

template <bool kRows, typename Out>
int launch_probe(const void* table, int cap, const void* lo, const void* hi,
                 int n, void* out, void* stream) {
  if (cap < 1 || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int grid = (n + kThreads - 1) / kThreads;
    probe_kernel<kRows, Out><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Slot*>(table), (uint32_t)(cap - 1),
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi), n,
        static_cast<Out*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lo/hi: uint32 key halves [n] (device); cap: a power of two >= 2n; table:
// Slot [cap], zeroed by the caller; occupied: uint64 [1], zeroed by the
// caller, receives the number of distinct keys.
int joinmap_build_rows(const void* lo, const void* hi, int n, int cap,
                       void* table, void* occupied, void* stream) {
  return launch_build<true>(lo, hi, nullptr, n, cap, table, occupied, stream);
}

// table: Slot [cap] from joinmap_build_rows; lo/hi: uint32 key halves [n];
// out: int32 [n], the matched build row or -1.
int joinmap_lookup(const void* table, int cap, const void* lo, const void* hi,
                   int n, void* out, void* stream) {
  return launch_probe<true, int32_t>(table, cap, lo, hi, n, out, stream);
}

// As joinmap_build_rows, inserting only the rows whose keep byte (uint8
// [n]) is 1, and leaving every row at 0: a key set.
int semijoin_set_build(const void* lo, const void* hi, const void* keep,
                       int n, int cap, void* table, void* occupied,
                       void* stream) {
  return launch_build<false>(lo, hi, keep, n, cap, table, occupied, stream);
}

// table: Slot [cap] from semijoin_set_build; out: uint8 [n], 1 where the
// key is in the set.
int semijoin_set_probe(const void* table, int cap, const void* lo,
                       const void* hi, int n, void* out, void* stream) {
  return launch_probe<false, uint8_t>(table, cap, lo, hi, n, out, stream);
}

}  // extern "C"
