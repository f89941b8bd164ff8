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
// 1 published) and the build row it maps to (0 in a key set). An empty
// slot is all zero. The reference keeps separate lanes (klo, khi, occ,
// and row for the map), so a probe there touches three or four 32-byte
// sectors per slot; here it touches one, and a table's columns are the
// reference's lanes. Any int64 value is a legal key, which is why
// emptiness is a state and not a sentinel key. A key's home slot is
// fmix32(lo ^ fmix32(hi)) & (cap - 1): the LOW bits of the hash the Bloom
// kernels take their block index from (their top bits); collisions probe
// linearly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kEmpty = 0u;
constexpr uint32_t kPublished = 1u;

struct alignas(16) Slot {
  uint32_t lo, hi, state, row;
};

__device__ __forceinline__ uint32_t home_slot(uint32_t lo, uint32_t hi,
                                              uint32_t mask) {
  return key_hash(lo, hi) & mask;
}

// One 128-bit compare-and-swap of the whole slot against the empty slot
// (all zero): the slot's old contents, all zero where `val` went in.
// atom.cas.b128 needs sm_90 (PTX ISA 8.3).
__device__ __forceinline__ uint4 claim_slot(Slot* p, uint4 val) {
  unsigned long long v0 = (unsigned long long)val.y << 32 | val.x;
  unsigned long long v1 = (unsigned long long)val.w << 32 | val.z;
  unsigned long long o0, o1;
  asm volatile(
      "{\n\t"
      ".reg .b128 cmp, val, old;\n\t"
      "mov.b128 cmp, {%3, %3};\n\t"
      "mov.b128 val, {%4, %5};\n\t"
      "atom.global.cas.b128 old, [%2], cmp, val;\n\t"
      "mov.b128 {%0, %1}, old;\n\t"
      "}"
      : "=l"(o0), "=l"(o1)
      : "l"(p), "l"(0ull), "l"(v0), "l"(v1)
      : "memory");
  return make_uint4((uint32_t)o0, (uint32_t)(o0 >> 32), (uint32_t)o1,
                    (uint32_t)(o1 >> 32));
}

// Inserts the key (a, b) from its home slot and returns 1 if this thread
// filled a fresh slot with it, 0 if the key was there already.
//
// The TPU inserts one key at a time. Here each key has its own thread and
// claims and publishes a slot at once: one 128-bit atomicCAS of the whole
// record {a, b, published, row} against the empty slot. A failed CAS
// returns the slot's record, whole, so no thread ever sees a half-written
// key and none waits: equal keys dedup into one slot, so the count of
// filled slots is exact whatever the schedule, and with kRows "last row
// wins" becomes atomicMax on the row, the row the sequential insert would
// leave. Slots never return to empty, so two threads with one key walk the
// same probe sequence and meet at the same slot. The layout differs from
// the sequential insert's; the walks' answers do not depend on it.
template <bool kRows>
__device__ __forceinline__ int insert_key(Slot* table, uint32_t mask,
                                          uint32_t a, uint32_t b,
                                          uint32_t row) {
  uint4 mine = make_uint4(a, b, kPublished, kRows ? row : 0u);
  for (uint32_t s = home_slot(a, b, mask);; s = (s + 1) & mask) {
    uint4 old = claim_slot(table + s, mine);
    if (old.z == kEmpty) return 1;
    if (old.x == a && old.y == b) {
      if (kRows && old.w < row) atomicMax(&table[s].row, row);
      return 0;
    }
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
// The TPU keeps the table resident in VMEM and inserts one key after
// another. Here the table (64 MB at SF 1's 2^22 slots, K6a's lineitem
// build 256 MB) is larger than the 50 MB L2, so a key inserted straight
// into it costs an HBM-bound atomic at a random slot, and the table must
// be zeroed first (an eighth of the old one-thread-a-key build's device
// time at SF 1 went to that memset alone). Two routes (the rule lives here
// only, in build_route; joinmap_build_rows and semijoin_set_build take
// it):
//  - direct (fewer than kFewKeys = 2^19 keys, or more than
//    2^kMaxRegionsLog2 regions): a memset of the table, then one thread a
//    row runs insert_key. Below 2^19 keys the table (at most 8 MB at
//    capacity_for's sizes) stays in L2 and this is the cheaper route: on
//    the H100 its device time is the lower up to 2^18 keys (0.024 against
//    0.027 ms) and the partitioned route's from 2^19 (0.033 against 0.036;
//    at 2^21 keys 0.089 against 0.186), chip_smoke.py's
//    joinmap_route_sweep, each route forced through
//    joinmap_build_force_route.
//  - partitioned (otherwise): the top bits of a key's home slot pick its
//    region, 2^kRegionLog2 = 8,192 slots (128 KB of table), so p = cap /
//    8,192 regions (512 at SF 1), each built by a CTA of kBuildThreads =
//    1,024 threads, two an SM (tools/k4_variants.py: at SF 1 this was the
//    fastest of regions of 2^12 and 2^13 slots, CTAs of 256 to 1,024
//    threads and scatter tiles of 2,048 to 8,192 rows).
//    region_scatter_kernel copies each live key as one 16-byte record
//    {lo, hi, row, 0} into its region's part of the scratch, as K2's
//    slice scatter does (a tile of rows
//    sorted by region in shared memory, an atomic cursor a region), at
//    most `rcap` = 5/4 of the mean keys a region + 256 (skew beyond goes
//    to the overflow list). One CTA a region (region_build_kernel) then
//    builds the region in shared memory, a slot there holding the index
//    of the key that claimed it (a 32-bit atomicCAS), and stores all its
//    slots with coalesced 16-byte stores: that store initialises the
//    table, so the table needs no memset. A key whose linear walk runs
//    past its region's end (the last region's wrap into slot 0 included)
//    goes to the overflow list too; overflow_kernel inserts the list with
//    insert_key after every region is stored (its CTAs return at once
//    when the list is empty). Scattering a row id alone and gathering
//    the key halves in the build was slower on the H100: the gathers
//    missed L2 (0.057 ms build against 0.040), and 12-byte records
//    slowed the scatter (0.027 against 0.022). The wrapper launches the
//    scatter first (joinmap_build_scatter) and allocates the table while
//    it runs.
// The partitioned table is a valid linear-probe table: a key is stored at
// or before the first empty slot of its walk, and filling an empty slot
// later only lengthens walks. Equal keys walk identical slots, so in a
// region they meet, and a copy sent to the overflow list meets the other
// there or in the table; `occupied` counts the slots claimed, exact.
// Scratch (partitioned route only, joinmap_build_scratch_bytes): the
// regions' parts (rcap records each), the overflow list (a record a row)
// and the cursors (an int a region, and one).
//
// Bound on this card: memory. 8 bytes of key halves per row in (K6a: its
// keep byte, and the key halves of the kept rows only, each 32-byte sector
// once), and the table (16 bytes a slot) out; the partitioned route moves
// 2 x 16 bytes a key more (its scratch written and read once, which mostly
// stays in L2) and nothing at random but the overflow list.
constexpr int kFewKeys = 1 << 19;        // fewer keys: the direct route
constexpr int kRegionLog2 = 13;          // slots a region: 8,192 (128 KB)
constexpr int kMinRegionLog2 = 8;        // region sizes the sweep may set
constexpr int kMaxRegionLog2 = 13;
constexpr int kMaxRegionsLog2 = 12;      // at most 4,096 regions
constexpr int kPassThreads = 512;        // the scatter pass
constexpr int kTile = 4096;              // rows a scatter CTA stages at once
constexpr int kPassRows = kTile / kPassThreads;  // rows in flight a thread
constexpr int kBuildThreads = 1024;
constexpr int kOverflowCtas = 264;       // two an SM
constexpr int kMaxDevices = 64;

enum RouteKind { kDirect = 1, kPartitioned = 2 };
struct Route {
  RouteKind kind;
  int log2r;  // slots a region (partitioned)
};

// -1: build_route's rule; kDirect or kPartitioned: that route wherever the
// table allows it (joinmap_build_force_route, to time both routes at one
// shape). region_log2: the region size of the partitioned route (0:
// kRegionLog2).
int forced_route = -1;
int region_log2 = 0;

Route build_route(int n, int log2cap) {
  int log2r = region_log2 ? region_log2 : kRegionLog2;
  if (log2r > log2cap) log2r = log2cap;
  bool direct = forced_route < 0 ? n < kFewKeys : forced_route == kDirect;
  if (direct || log2cap - log2r > kMaxRegionsLog2) return {kDirect, 0};
  return {kPartitioned, log2r};
}

// Keys a region's part of the scratch holds: 5/4 of the mean, plus 256,
// and never more than the region has slots.
int region_cap(int n, int log2p, int log2r) {
  int c = (n >> log2p) + (n >> (log2p + 2)) + 256;
  return c < (1 << log2r) ? c : (1 << log2r);
}

// Shared memory of region_build_kernel: a claim word a slot, and the
// region's keys (halves and rows).
size_t build_smem(int log2r, int rcap) {
  return 4 * ((size_t)1 << log2r) + 12 * (size_t)rcap;
}

// Shared memory of region_scatter_kernel: the tile's counts, cursors and
// spill cursors (3p + 1 ints, padded to 8 bytes) and the staged keys
// (halves and rows).
size_t scatter_smem(int log2p) {
  return 4 * ((3 * ((size_t)1 << log2p) + 1 + 1) & ~(size_t)1) +
         12 * (size_t)kTile;
}

// The direct route: one thread a row, each key inserted in L2
// (insert_key); the table is zeroed first.
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

// The partitioned route's scatter: each live row's key {lo, hi, row} as
// one 16-byte record into its region's part of the scratch (or the
// overflow list), a tile of kTile rows at a time, staged in shared memory
// sorted by region so the records of a region are stored contiguously.
// The key columns are loaded with streaming hints (each is read once) and
// the records stored plainly, so the records stay in L2 for the build.
// fill[s] counts the keys meant for region s, fill[p] those on the
// overflow list (all zeroed before).
__global__ void __launch_bounds__(kPassThreads, 1536 / kPassThreads)
    region_scatter_kernel(const uint32_t* __restrict__ lo,
                          const uint32_t* __restrict__ hi,
                          const uint8_t* __restrict__ keep, int n,
                          uint32_t mask, int log2r, int log2p, int rcap,
                          int* __restrict__ fill, uint4* __restrict__ parts,
                          uint4* __restrict__ overflow) {
  extern __shared__ uint4 smem_vecs[];
  __shared__ int warp_sums[32];
  int p = 1 << log2p;
  int* tile = reinterpret_cast<int*>(smem_vecs);  // [p + 1] keys a region
  int* dst = tile + p + 1;     // [p] where the tile's keys of a region go
  int* spill = dst + p;        // [p] ... and where those past `rcap` go
  uint2* stage = reinterpret_cast<uint2*>(tile + ((3 * p + 1 + 1) & ~1));
  uint32_t* stage_row = reinterpret_cast<uint32_t*>(stage + kTile);
  for (int t0 = blockIdx.x * kTile; t0 < n; t0 += gridDim.x * kTile) {
    for (int s = threadIdx.x; s < p; s += blockDim.x) tile[s] = 0;
    uint32_t a[kPassRows], b[kPassRows];
    bool live[kPassRows];
#pragma unroll
    for (int i = 0; i < kPassRows; ++i) {
      int r = t0 + threadIdx.x + i * blockDim.x;
      int rr = min(r, n - 1);
      a[i] = __ldcs(lo + rr);
      b[i] = __ldcs(hi + rr);
      live[i] = r < n && (keep == nullptr || __ldcs(keep + rr));
    }
    int reg[kPassRows];
#pragma unroll
    for (int i = 0; i < kPassRows; ++i) {
      reg[i] = (int)(home_slot(a[i], b[i], mask) >> log2r);
    }
    __syncthreads();
    int rank[kPassRows];
#pragma unroll
    for (int i = 0; i < kPassRows; ++i) {
      rank[i] = live[i] ? atomicAdd(&tile[reg[i]], 1) : -1;
    }
    __syncthreads();
    block_exclusive_scan(tile, p, warp_sums);
    for (int s = threadIdx.x; s < p; s += blockDim.x) {
      int c = tile[s + 1] - tile[s];
      if (c) {
        int at = atomicAdd(fill + s, c);
        int over = at + c - (at > rcap ? at : rcap);  // keys past `rcap`
        dst[s] = at;
        if (over > 0) spill[s] = atomicAdd(fill + p, over);
      }
    }
#pragma unroll
    for (int i = 0; i < kPassRows; ++i) {
      if (rank[i] >= 0) {
        int j = tile[reg[i]] + rank[i];
        stage[j] = make_uint2(a[i], b[i]);
        stage_row[j] = (uint32_t)(t0 + threadIdx.x + i * blockDim.x);
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < tile[p]; j += blockDim.x) {
      uint2 key = stage[j];
      uint4 v = make_uint4(key.x, key.y, stage_row[j], 0u);
      int s = (int)(home_slot(key.x, key.y, mask) >> log2r);
      int at = dst[s] + j - tile[s];
      if (at < rcap) {
        parts[(size_t)s * rcap + at] = v;
      } else {
        overflow[spill[s] + at - (dst[s] > rcap ? dst[s] : rcap)] = v;
      }
    }
    __syncthreads();
  }
}

// The partitioned route's build: CTA s builds region s from its part of
// the scratch in shared memory and stores all of the region's slots. A
// shared slot holds 1 + the index of the key that claimed it (0 empty), so
// a claim is one 32-bit atomicCAS and a key compares itself with the
// claimant's halves, staged in shared memory before any claim. Equal keys
// dedup into one slot (atomicMax on the claimant's row); a walk that runs
// past the region's end sends its key to the overflow list (fill[p] its
// cursor). The table is stored with streaming hints: it is read again
// only by later lookups, and 64 MB of it would push the records out of
// L2 before the later CTAs read them.
template <bool kRows>
__global__ void __launch_bounds__(kBuildThreads)
    region_build_kernel(const uint4* __restrict__ parts,
                        int* __restrict__ fill, int log2r, int log2p,
                        int rcap, Slot* __restrict__ table,
                        uint4* __restrict__ overflow,
                        unsigned long long* occupied) {
  extern __shared__ uint4 smem_vecs[];
  __shared__ unsigned int nclaimed;
  int nslots = 1 << log2r;
  uint32_t* claim = reinterpret_cast<uint32_t*>(smem_vecs);  // [nslots]
  uint2* keys = reinterpret_cast<uint2*>(claim + nslots);    // [rcap]
  uint32_t* rows = reinterpret_cast<uint32_t*>(keys + rcap);  // [rcap]
  int nkeys = min(__ldg(fill + blockIdx.x), rcap);
  const uint4* part = parts + (size_t)blockIdx.x * rcap;
  if (threadIdx.x == 0) nclaimed = 0u;
  for (int i = threadIdx.x; i < nslots; i += blockDim.x) claim[i] = 0u;
  for (int e = threadIdx.x; e < nkeys; e += blockDim.x) {
    uint4 v = __ldcs(part + e);
    keys[e] = make_uint2(v.x, v.y);
    rows[e] = v.z;
  }
  __syncthreads();
  uint32_t smask = (uint32_t)nslots - 1u;
  int claimed = 0;
  for (int e = threadIdx.x; e < nkeys; e += blockDim.x) {
    uint2 key = keys[e];
    uint32_t row = rows[e];
    for (uint32_t s = key_hash(key.x, key.y) & smask;; ++s) {
      if (s == (uint32_t)nslots) {
        overflow[atomicAdd(fill + (1 << log2p), 1)] =
            make_uint4(key.x, key.y, row, 0u);
        break;
      }
      uint32_t old = atomicCAS(claim + s, 0u, (uint32_t)e + 1u);
      if (old == 0u) {
        ++claimed;
        break;
      }
      uint2 other = keys[old - 1u];
      if (other.x == key.x && other.y == key.y) {
        if (kRows) atomicMax(rows + (old - 1u), row);
        break;
      }
    }
  }
  if (claimed) atomicAdd(&nclaimed, (unsigned int)claimed);
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(table) + ((size_t)blockIdx.x << log2r);
  for (int i = threadIdx.x; i < nslots; i += blockDim.x) {
    uint32_t c = claim[i];
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c) {
      uint2 key = keys[c - 1u];
      v = make_uint4(key.x, key.y, kPublished, kRows ? rows[c - 1u] : 0u);
    }
    __stcs(out + i, v);
  }
  if (threadIdx.x == 0 && nclaimed > 0u) {
    atomicAdd(occupied, (unsigned long long)nclaimed);
  }
}

// The partitioned route's last kernel: the overflow list's keys (*novf of
// them; usually a few a region) inserted in the table (insert_key).
template <bool kRows>
__global__ void overflow_kernel(const uint4* __restrict__ overflow,
                                const int* __restrict__ novf, uint32_t mask,
                                Slot* table, unsigned long long* occupied) {
  int n = *novf;
  int claimed = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    uint4 v = overflow[i];
    claimed += insert_key<kRows>(table, mask, v.x, v.y, v.z);
  }
  if (claimed) atomicAdd(occupied, (unsigned long long)claimed);
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
// larger than L2 sends those sector reads to HBM. At SF 1 (6,001,215
// random probes, 2^22 slots: 64 MB) the walk reads 7,995,080 slots in
// 0.141 ms device on the H100, about one 64-byte burst a step at 3.35
// TB/s: the floor of one random pass. Walking the table a 32 MB range of
// slots at a time (each pass reading every key, walking those homed in
// its range; tools/k5_passes.py) took 0.127 at two passes, but a pass
// costs 0.02 even where the table sits in L2, the walk alone takes 0.068
// there (2^20 slots), and with the probe keys in lineitem's order (sorted,
// each key's probes together) the passes lose: 0.108 against 0.085. More
// walks in flight a thread were slower (a warp waits on its longest).
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

int log2_of(int cap) {
  int l = 0;
  while ((1 << l) < cap) ++l;
  return l;
}

// Scratch layout of the partitioned route: the regions' parts (uint4
// [p * rcap] records {lo, hi, row, 0}), the overflow list (uint4 [n]),
// the cursors (int [p + 1]).
long long scratch_bytes(int n, int cap) {
  if (n <= 0 || cap < 1 || (cap & (cap - 1)) != 0) return 0;
  int log2cap = log2_of(cap);
  Route route = build_route(n, log2cap);
  if (route.kind != kPartitioned) return 0;
  int log2p = log2cap - route.log2r;
  long long p = 1ll << log2p;
  return 16 * (p * region_cap(n, log2p, route.log2r) + n) + 4 * (p + 1);
}

// Sets the partitioned route's largest dynamic shared memory, once a
// device.
int set_attributes() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  int err = cudaGetDevice(&dev);
  if (err) return err;
  if (dev < kMaxDevices && done[dev]) return 0;
  int build_max = (int)build_smem(kMaxRegionLog2, 1 << kMaxRegionLog2);
  err = cudaFuncSetAttribute(region_scatter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)scatter_smem(kMaxRegionsLog2));
  if (!err) {
    err = cudaFuncSetAttribute(region_build_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               build_max);
  }
  if (!err) {
    err = cudaFuncSetAttribute(region_build_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               build_max);
  }
  if (!err && dev < kMaxDevices) done[dev] = true;
  return err;
}

// The partitioned route's scratch, cut into its parts.
struct Scratch {
  int log2r, log2p, rcap;
  uint4* parts;
  uint4* overflow;
  int* fill;
};

Scratch scratch_of(void* scratch, int n, int log2cap, int log2r) {
  int log2p = log2cap - log2r;
  int rc = region_cap(n, log2p, log2r);
  uint4* parts = static_cast<uint4*>(scratch);
  uint4* overflow = parts + ((size_t)rc << log2p);
  return {log2r, log2p, rc, parts, overflow,
          reinterpret_cast<int*>(overflow + n)};
}

// The partitioned route's first step (nothing on the direct route): the
// cursors zeroed, and the scatter.
int launch_scatter(const void* lo, const void* hi, const void* keep, int n,
                   int cap, void* scratch, void* stream) {
  if (cap < 1 || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  int log2cap = log2_of(cap);
  Route route = build_route(n, log2cap);
  if (n <= 0 || route.kind == kDirect) return 0;
  int err = set_attributes();
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch sc = scratch_of(scratch, n, log2cap, route.log2r);
  err = cudaMemsetAsync(sc.fill, 0, 4 * (((size_t)1 << sc.log2p) + 1), st);
  if (err) return err;
  region_scatter_kernel<<<(n + kTile - 1) / kTile, kPassThreads,
                          scatter_smem(sc.log2p), st>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint8_t*>(keep), n, (uint32_t)(cap - 1), sc.log2r,
      sc.log2p, sc.rcap, sc.fill, sc.parts, sc.overflow);
  return (int)cudaGetLastError();
}

// The rest of a build: on the direct route a memset and build_kernel; on
// the partitioned one, after launch_scatter, the regions' build and the
// overflow list's inserts. `occupied` is zeroed here first.
template <bool kRows>
int launch_build(const void* lo, const void* hi, const void* keep, int n,
                 int cap, void* table, void* occupied, void* scratch,
                 void* stream) {
  if (cap < 1 || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Slot* slots = static_cast<Slot*>(table);
  unsigned long long* occ = static_cast<unsigned long long*>(occupied);
  uint32_t mask = (uint32_t)(cap - 1);
  int log2cap = log2_of(cap);
  Route route = build_route(n, log2cap);
  int err = cudaMemsetAsync(occupied, 0, sizeof(*occ), st);
  if (n <= 0 || route.kind == kDirect) {
    if (!err) err = cudaMemsetAsync(table, 0, (size_t)cap * sizeof(Slot), st);
    if (err || n <= 0) return err;
    build_kernel<kRows><<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
        static_cast<const uint8_t*>(keep), n, mask, slots, occ);
    return (int)cudaGetLastError();
  }
  if (err) return err;
  Scratch sc = scratch_of(scratch, n, log2cap, route.log2r);
  int p = 1 << sc.log2p;
  region_build_kernel<kRows><<<p, kBuildThreads,
                               build_smem(sc.log2r, sc.rcap), st>>>(
      sc.parts, sc.fill, sc.log2r, sc.log2p, sc.rcap, slots, sc.overflow,
      occ);
  overflow_kernel<kRows><<<kOverflowCtas, kThreads, 0, st>>>(
      sc.overflow, sc.fill + p, mask, slots, occ);
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

// The first step of a K4 or K6a build (keep: uint8 [n] or null, as the
// build's), on `stream` before joinmap_build_rows / semijoin_set_build
// with the same arguments: on the partitioned route a memset and the
// scatter into `scratch`, nothing on the direct one. The build's table
// and count need not exist yet, so a caller can allocate them while the
// scatter runs.
int joinmap_build_scatter(const void* lo, const void* hi, const void* keep,
                          int n, int cap, void* scratch, void* stream) {
  return launch_scatter(lo, hi, keep, n, cap, scratch, stream);
}

// lo/hi: uint32 key halves [n] (device); cap: a power of two > n; table:
// Slot [cap], 16-byte aligned, need not be zeroed; occupied: uint64 [1],
// need not be zeroed, receives the number of distinct keys; scratch:
// joinmap_build_scratch_bytes(n, cap) bytes, 16-byte aligned, after
// joinmap_build_scatter. Up to two kernels and two memsets on `stream`
// (K4's note).
int joinmap_build_rows(const void* lo, const void* hi, int n, int cap,
                       void* table, void* occupied, void* scratch,
                       void* stream) {
  return launch_build<true>(lo, hi, nullptr, n, cap, table, occupied,
                            scratch, stream);
}

// table: Slot [cap] from joinmap_build_rows; lo/hi: uint32 key halves [n];
// out: int32 [n], the matched build row or -1.
int joinmap_lookup(const void* table, int cap, const void* lo, const void* hi,
                   int n, void* out, void* stream) {
  return launch_probe<true, int32_t>(table, cap, lo, hi, n, out, stream);
}

// As joinmap_build_rows, inserting only the rows whose keep byte (uint8
// [n]) is 1, and leaving every row at 0: a key set (after
// joinmap_build_scatter with the same keep).
int semijoin_set_build(const void* lo, const void* hi, const void* keep,
                       int n, int cap, void* table, void* occupied,
                       void* scratch, void* stream) {
  return launch_build<false>(lo, hi, keep, n, cap, table, occupied, scratch,
                             stream);
}

// table: Slot [cap] from semijoin_set_build; out: uint8 [n], 1 where the
// key is in the set.
int semijoin_set_probe(const void* table, int cap, const void* lo,
                       const void* hi, int n, void* out, void* stream) {
  return launch_probe<false, uint8_t>(table, cap, lo, hi, n, out, stream);
}

// Bytes of device scratch a build of n rows into cap slots needs (K4 and
// K6a alike): on the partitioned route the regions' parts, the overflow
// list and the cursors; none on the direct route.
long long joinmap_build_scratch_bytes(int n, int cap) {
  return scratch_bytes(n, cap);
}

// Makes every later build (and its scratch query) take `route` (1 direct,
// 2 partitioned) where the table allows it, or, at -1, build_route's rule
// again, with regions of 2^log2r slots (kMinRegionLog2..kMaxRegionLog2;
// 0: kRegionLog2); returns the route setting it replaces. For timing the
// routes at one shape; not thread-safe.
int joinmap_build_force_route(int route, int log2r) {
  int was = forced_route;
  forced_route = route == kDirect || route == kPartitioned ? route : -1;
  region_log2 = log2r >= kMinRegionLog2 && log2r <= kMaxRegionLog2 ? log2r
                                                                   : 0;
  return was;
}

}  // extern "C"
