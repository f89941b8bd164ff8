// Flash attention forward (K8) for Hopper (sm_90a): a prefill variant and a
// decode variant (one query row) from one source. Plain C interface, loaded
// with ctypes by repro_torch/kernels/flashattn/ops.py; every entry point
// launches on the caller's stream, never synchronises, and returns
// cudaGetLastError().
//
// Replaces the TPU kernel repro/kernels/flashattn/flashattn.py flash_pallas
// (_kernel) together with its wrapper ops.py::flash_attention: forward
// attention with an online softmax (f32 running max and sum), a kv-validity
// mask, a causal mask and a sliding-window mask built from position vectors.
//
// What it computes, element for element as the TPU kernel does:
//   s = (q . k in f32) * 1/sqrt(D); a masked entry is set to NEG = -1e30 and
//   the running max starts at NEG, so a row that has seen only masked keys
//   so far sums p = exp(0) = 1 per key until a valid key wipes that out
//   through alpha = exp(NEG - m) = 0; p is rounded to v's dtype (bf16)
//   before the P.V product; o and l accumulate in f32; the finish is
//   o / max(l, 1e-30), rounded to q's dtype.
// What differs from the TPU kernel's blocks, on purpose:
//   * q, k, v are read in the model's [B, S, H, D] layout through strides
//     and o is written as [B, Sq, H, DV]: no folded [B*H, S, D] copies;
//   * v's head size DV may be below q and k's DK: MLA (deepseek-v2) folds
//     [q_nope; q_rope] into DK = 128 + 64 = 192 with DV = 128, where the
//     reference pads v with zeros to 192 and slices o back to 128. Both
//     variants are templates on (DK, DV), compiled for (64, 64),
//     (128, 128) and (192, 128); the scale stays 1/sqrt(DK);
//   * GQA: query head h reads kv head h / (H / KVH), which is what the
//     reference's jnp.repeat(k, H / KVH, axis=2) gives, without the copy;
//   * nothing is padded to 128: keys past Skv take no part at all (their
//     score is -inf, so p = 0), query rows past Sq are not written. A row
//     with no valid key therefore averages V over the Skv real keys, as
//     ref.sdpa_ref does (the padded Pallas path averages over the padded
//     length instead).
//
// Bound on this card (the H100 SXM's published peaks, which assume its
// 700 W limit): prefill is bound by operations (2 * (DK + DV) flops per
// unmasked (q, k) pair over 989 TFLOP/s bf16: qwen1.5-4b's prompt of
// 2048, causal, 80 heads, is 0.087 ms, and deepseek-v2-lite's at 64 heads
// of (192, 128) the same), decode by bytes (each K and V row read once:
// 85.5 MB a layer at batch 4 and a 2088-slot cache for either model,
// 0.026 ms at 3.35 TB/s).
//
// Design of the prefill variant, prefill_kernel<DK, DV>, for the tensor
// cores that bound it:
//   * one CTA of three warpgroups per (q-tile of 128 rows, head, batch),
//     the heaviest q-tiles first (under a causal mask the last rows see
//     most keys, so they start in the first wave and light tiles fill the
//     tail). One producer warp loads; its warpgroup hands its registers to
//     the two consumer warpgroups (setmaxnreg: 40 against 232), which
//     compute 64 rows each.
//   * loads are TMA: 4-D tensor maps over q, k and v's [B, S, H, D]
//     strides, made on the host at each call (cuTensorMapEncodeTiled,
//     reached through the runtime, so no libcuda is linked); boxes of 128
//     rows x 64 d land with the 128-byte swizzle wgmma reads, and rows
//     past Sq or Skv arrive as zeros. K and V tiles of 128 keys pass
//     through a ring of 2 stages with full and empty mbarriers, so the
//     next tile loads while the consumers work: 160 KB of shared memory
//     at (128, 128), 208 KB at (192, 128) (q and k tiles of three
//     64-column blocks, v of two), one CTA per SM.
//   * S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
//     memory, DK / 16 steps; O += P V is wgmma m64nDVk16 with P in
//     registers (the S accumulators, rounded to bf16, are already its A
//     fragment) and V read as the MN-major B operand, so no copy of V is
//     transposed. The registers a consumer holds (S and O) depend on DV
//     only, so (192, 128) keeps (128, 128)'s budget.
//   * masked tiles are skipped: before it loads a tile the producer reads
//     the tile's positions and validity and drops it when no row of the
//     CTA may see any of its keys (tile_state compares the rows' position
//     range with the tile's valid-key range, so any order of positions,
//     a wrapped ring included, is handled). This is exact: for a row with
//     an allowed key, a tile it may not see adds p = 2^(NEG - m) = 0 after
//     its first allowed key, and whatever it added before that is wiped
//     by alpha = 2^(NEG - m_new) = 0. A row with no allowed key at all
//     must average V over every real key, so when a consumer ends with
//     m == NEG for a row below Sq, the CTA runs a second pass over every
//     tile (never on the serve path).
//   * a tile whose every pair is allowed (interior tiles under a causal
//     mask) takes no element mask; scores are scaled by scale * log2 e
//     and exponentiated with ex2.approx.
//   * what it leaves on the table: each consumer runs QK^T, softmax and
//     PV in turn, so the tensor cores idle through its softmax unless the
//     other warpgroup fills the gap; no ping-pong schedule and no overlap
//     of one tile's softmax with the next tile's QK^T.
// Design of the decode variant, decode_kernel<DK, DV, R> (R: the query
// heads of a kv head, rounded up to 1, 2, 4, 8 or 16), for the bytes that
// bound it:
//   * a split over the cache: the cache is cut into tiles of kTile = 64
//     slots and the grid is (splits, KVH, B), each CTA walking `tps`
//     consecutive tiles for all H / KVH query heads of its group, so each
//     K and V row is still read once. decode_tps picks tps = ceil(B *
//     KVH * tiles / kDecodeCtas), at least 2 and at most kMaxSplitTiles:
//     kDecodeCtas = 792 CTAs are two waves of 3 CTAs on an H100's 132
//     SMs, enough to keep every SM's loads in flight, and no more, since
//     each split adds a prologue, a record to write and one to merge; with
//     2 tiles or more a split always has a tile loading while it computes
//     one. qwen1.5-4b's decode shape (B 4, 20 kv heads, 33 tiles) gets 4
//     tiles a split, 9 splits, 720 CTAs (one CTA per (kv head, batch) gave
//     80 on 132 SMs); B 1 over 32,768 slots 13 tiles, 40 splits, 800 CTAs.
//   * bytes in flight: a CTA's tiles pass through a ring of 2 stages in
//     shared memory, each tile's K and V rows loaded as 16-byte cp.async
//     copies through the caller's strides (stacked and strided cache
//     views); tile i + 1 loads while tile i is computed, so only the
//     first load and the epilogue are exposed. 69 KB of shared memory at
//     (128, 128) and a group of 1: 3 CTAs and up to 200 KB an SM; 84 KB
//     at (192, 128): 2 CTAs an SM.
//   * a tile's softmax in two passes, not a chain per key: first every
//     key's score for each head of the group (256 threads, a key and a
//     quarter of DK each, from shared memory; K rows padded by 16 bytes,
//     so a warp's 16-byte reads hit no bank twice), then a warp per head
//     takes the tile's max once and p = exp(s - m) into the running sum,
//     rounded to bf16 for P.V, which 256 threads share out by pair of DV
//     columns and key slice. Across the split's tiles the running max and
//     sum move on as in the prefill (alpha = exp(m_old - m_new)).
//   * the merge in the same launch: each CTA writes (m, l, o) in f32 to the
//     scratch, fences, and takes a ticket on its group's int32 counter;
//     the CTA that draws the last ticket merges the group's records, writes
//     o and sets the counter back to 0. One launch a call, as the
//     host-bound decode step needs. The counters assume that calls sharing
//     them run one after another: ops.py keeps a buffer per (device,
//     stream), so concurrent calls on two streams never share one.
//   * skipping: the CTA first reads its range's positions (a bit a key);
//     a tile none of whose keys the query may see (the empty slots of a
//     cache not yet full, slots outside a window) is never loaded, and a
//     split with no live tile reports m = -inf, which the merge leaves
//     out. Exact for a row with an allowed key: a masked key after it adds
//     p = exp(NEG - m) = 0, one before it is wiped by alpha = exp(NEG -
//     m_new) = 0. With no live split the row has no allowed key, and the
//     merging CTA writes the mean of V over the Skv keys, as ref.sdpa_ref
//     gives.
//   * the log-sum-exp, where the caller asks for it (`lse`, [B, H] f32):
//     the merging CTA writes M + log(L) beside o, the row's log of its sum
//     of exp(s) over the keys it may see, so a caller that cut the cache
//     into ranges (context parallelism: a mesh point's slots) can merge
//     the ranges' outputs by their weights exp(lse - max). Every launch
//     merges through the ticket, one split included, so no path writes o
//     without it. A row with no allowed key reports -inf (weight 0 in
//     such a merge), whatever its o (the mean of V, as above).
//   * bound: bytes, each K and V row of a live tile read once (85.5 MB a
//     layer at the qwen shape, 0.026 ms at 3.35 TB/s); its 2 * (DK + DV)
//     flops a head and key run on CUDA cores in a small share of that
//     time.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kDecodeThreads = 256;
constexpr int kMaxGroup = 16;     // most H / KVH the decode variant takes
                                  // (MAX_GROUP in ops.py)
constexpr int kTile = 64;         // keys per decode tile
constexpr int kMaxSplitTiles = 64;  // most tiles a decode CTA walks
constexpr int kDecodeCtas = 792;  // CTAs a decode call aims at

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const int32_t* q_pos;     // [B, Sq]
  const int32_t* kv_pos;    // [B, Skv]
  const uint8_t* kv_valid;  // [B, Skv]
  long long q_b, q_s, q_h;  // element strides; the head dimension is dense
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_s, o_h;
  int B, Sq, Skv, H, KVH;
  int causal, has_window, window;
  float scale;
  float* lse;               // [B, H] f32, decode only; null: not written
};

__device__ __forceinline__ bool allowed(const Args& a, int qp, int kp,
                                        uint8_t valid) {
  return valid && (!a.causal || kp <= qp) &&
         (!a.has_window || qp - kp < a.window);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One kv tile's standing for a CTA whose rows' positions span [rmin, rmax]
// (rows below Sq only): kSkip if no row of the CTA has an allowed key in
// it, kFull if every row is allowed every key (no element mask needed),
// kMasked otherwise. Holds for any positions (a wrapped ring cache is not
// monotone): it reads only the tile's min and max over its valid keys.
constexpr int kSkip = 0, kMasked = 1, kFull = 2;
__device__ __forceinline__ int tile_state(const Args& a, int rmin, int rmax,
                                          int tmin, int tmax, bool any,
                                          bool all) {
  if (!any || (a.causal && tmin > rmax) ||
      (a.has_window && (long long)tmax <= (long long)rmin - a.window))
    return kSkip;
  if (all && (!a.causal || tmax <= rmin) &&
      (!a.has_window || (long long)rmax - tmin < a.window))
    return kFull;
  return kMasked;
}

// ---- Hopper primitives: mbarriers, TMA, wgmma --------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that
// outlasts any real load (2^28 tries, seconds) traps rather than hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 28)) __trap();
  }
}

// one box of a 4-D tensor map ({d, head, row, batch}) into shared memory,
// completing `bytes` on the barrier
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (MN-major: the step between 64-element column blocks) and
// stride byte offset (the step between 8-row groups), all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64 x 128, f32] (+)= A[64 x 16] B[16 x 128]: A and B bf16 in shared
// memory, both K-major with the 128-byte swizzle, read through
// descriptors
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128, f32] (+)= A[64 x 16] B[16 x 128]: A bf16 in registers (each
// warp's 16 rows as the m16n8k16 A fragment), B bf16 in shared memory,
// MN-major (transposed) with the 128-byte swizzle
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64 x 64, f32] (+)= A[64 x 16] B[16 x 64]: A bf16 in registers (each
// warp's 16 rows as the m16n8k16 A fragment), B bf16 in shared memory,
// MN-major (transposed) with the 128-byte swizzle
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


template <int DV>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (DV == 128)
    wgmma_rs_n128(o, a, db, 1);
  else
    wgmma_rs_n64(o, a, db, 1);
}

// ---- the prefill kernel --------------------------------------------------

constexpr int kBM = 128;       // query rows per CTA: two consumer warpgroups
constexpr int kBN = 128;       // keys per kv tile
constexpr int kStages = 2;     // depth of the K/V ring
constexpr int kPrefillThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kBlockBytes = 128 * 128;  // 128 rows of one 64-column block

struct TileMeta {     // what the producer learned of one kv tile
  int kpos[kBN];
  uint8_t kval[kBN];  // 0 masked key, 1 valid, 2 past Skv
  int tile;           // kv tile index; -1 ends a pass
  int state;          // kMasked or kFull
};

template <int DK, int DV>
struct Smem {         // dynamic shared memory, 1024-byte aligned
  static constexpr int kNBK = DK / 64;  // 64-column (128-byte) blocks
  static constexpr int kNBV = DV / 64;
  static constexpr int kKBytes = kNBK * kBlockBytes;  // a q or k tile
  static constexpr int kVBytes = kNBV * kBlockBytes;
  uint8_t q[kKBytes];
  uint8_t k[kStages][kKBytes];
  uint8_t v[kStages][kVBytes];
  TileMeta meta[kStages];
  uint64_t q_full, full[kStages], empty[kStages];
  int rmin, rmax, redo;
};

template <int DK, int DV>
__global__ void __launch_bounds__(kPrefillThreads, 1)
    prefill_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Args a) {
  using S = Smem<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  S& sm = *reinterpret_cast<S*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  // heaviest q-tiles first: under a causal mask the last rows see most
  // keys, so they start in the first wave and the tail runs light tiles
  const int nqt = (a.Sq + kBM - 1) / kBM;
  const int bh = blockIdx.x % (a.B * a.H);
  const int q0 = (nqt - 1 - blockIdx.x / (a.B * a.H)) * kBM;
  const int h = bh % a.H, b = bh / a.H;
  const int kvh = h / (a.H / a.KVH);
  const int ntiles = (a.Skv + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&sm.q_full), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&sm.full[s]), 1);
      mbar_init(smem_u32(&sm.empty[s]), 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm.rmin = INT_MAX;
    sm.rmax = INT_MIN;
    sm.redo = 0;
  }
  __syncthreads();
  if (threadIdx.x < kBM && q0 + threadIdx.x < a.Sq) {
    int p = a.q_pos[(long long)b * a.Sq + q0 + threadIdx.x];
    atomicMin(&sm.rmin, p);
    atomicMax(&sm.rmax, p);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;

  if (wg == 0) {
    // ---- producer: one warp picks the live tiles and issues TMA loads ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 0) return;
    const int rmin = sm.rmin, rmax = sm.rmax;
    if (lane == 0) {
      uint32_t bar = smem_u32(&sm.q_full);
      mbar_expect_tx(bar, S::kKBytes);
      for (int j = 0; j < S::kNBK; ++j)
        tma_load_4d(smem_u32(sm.q + j * kBlockBytes), &tq, bar, j * 64, h, q0,
                    b);
    }
    const int32_t* kpos_g = a.kv_pos + (long long)b * a.Skv;
    const uint8_t* kval_g = a.kv_valid + (long long)b * a.Skv;
    int stage = 0, phase = 0;
    for (int pass = 0; pass < 2; ++pass) {
      for (int t = 0; t <= ntiles; ++t) {
        const bool end = t == ntiles;  // the pass's last slot ends it
        int kp[kBN / 32], kst[kBN / 32], state = kMasked;
        if (!end) {
          int mn = INT_MAX, mx = INT_MIN;
          bool any = false, all = true;
#pragma unroll
          for (int i = 0; i < kBN / 32; ++i) {
            int j = t * kBN + i * 32 + lane;
            bool in = j < a.Skv;
            kp[i] = in ? kpos_g[j] : 0;
            bool val = in && kval_g[j];
            kst[i] = in ? (val ? 1 : 0) : 2;
            mn = val ? min(mn, kp[i]) : mn;
            mx = val ? max(mx, kp[i]) : mx;
            any |= val;
            all &= val;
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
            mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          }
          any = __any_sync(0xffffffffu, any);
          all = __all_sync(0xffffffffu, all);
          if (pass == 0) state = tile_state(a, rmin, rmax, mn, mx, any, all);
          if (state == kSkip) continue;
        }
        mbar_wait(smem_u32(&sm.empty[stage]), phase ^ 1);
        TileMeta& m = sm.meta[stage];
        if (!end) {
#pragma unroll
          for (int i = 0; i < kBN / 32; ++i) {
            m.kpos[i * 32 + lane] = kp[i];
            m.kval[i * 32 + lane] = (uint8_t)kst[i];
          }
        }
        if (lane == 0) {
          m.tile = end ? -1 : t;
          m.state = state;
        }
        __syncwarp();
        if (lane == 0) {
          uint32_t bar = smem_u32(&sm.full[stage]);
          if (end) {
            mbar_arrive(bar);
          } else {
            mbar_expect_tx(bar, S::kKBytes + S::kVBytes);
            for (int j = 0; j < S::kNBK; ++j)
              tma_load_4d(smem_u32(sm.k[stage] + j * kBlockBytes), &tk, bar,
                          j * 64, kvh, t * kBN, b);
            for (int j = 0; j < S::kNBV; ++j)
              tma_load_4d(smem_u32(sm.v[stage] + j * kBlockBytes), &tv, bar,
                          j * 64, kvh, t * kBN, b);
          }
        }
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
      // the consumers say whether a row saw no allowed key (then pass 1
      // runs over every tile)
      asm volatile("bar.sync 1, 288;\n" ::: "memory");
      if (!sm.redo) break;
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup, 16 per warp ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int g = lane >> 2, t4 = lane & 3;
    const int qr0 = q0 + cw * 64 + warp * 16 + g, qr1 = qr0 + 8;
    const int qp0 = qr0 < a.Sq ? a.q_pos[(long long)b * a.Sq + qr0] : 0;
    const int qp1 = qr1 < a.Sq ? a.q_pos[(long long)b * a.Sq + qr1] : 0;
    const float scale2 = a.scale * 1.4426950408889634f;  // log2 domain
    const uint32_t q_base = smem_u32(sm.q) + cw * 64 * 128;

    float o[DV / 2];
    float s[kBN / 2];
    float m0, m1, l0, l1;
    int stage = 0, phase = 0;
    mbar_wait(smem_u32(&sm.q_full), 0);
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
      m0 = m1 = kNeg;
      l0 = l1 = 0.f;
      for (;;) {
        mbar_wait(smem_u32(&sm.full[stage]), phase);
        const TileMeta& meta = sm.meta[stage];
        const int tile = meta.tile, state = meta.state;
        if (tile >= 0) {
          // S = Q K^T over DK in steps of 16
          const uint32_t k_base = smem_u32(sm.k[stage]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk) {
            uint32_t off = (kk / 4) * kBlockBytes + (kk % 4) * 32;
            wgmma_ss_n128(s, sw128_desc(q_base + off, 16, 1024),
                          sw128_desc(k_base + off, 16, 1024), kk > 0);
          }
          wgmma_commit_wait();
          reg_fence<kBN / 2>(s);

          // scores in the log2 domain, masks, the rows' new running max;
          // s[4j + {0,1}] is row g, keys 8j + 2 t4 + {0,1}; s[4j + {2,3}]
          // row g + 8
          float mx0 = m0, mx1 = m1;
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x0 = s[4 * j + e] * scale2, x1 = s[4 * j + 2 + e] * scale2;
              if (state != kFull) {
                int c = 8 * j + 2 * t4 + e;
                int kst = meta.kval[c], kp = meta.kpos[c];
                x0 = kst == 2 ? -INFINITY
                              : (allowed(a, qp0, kp, kst) ? x0 : kNeg);
                x1 = kst == 2 ? -INFINITY
                              : (allowed(a, qp1, kp, kst) ? x1 : kNeg);
              }
              s[4 * j + e] = x0;
              s[4 * j + 2 + e] = x1;
              mx0 = fmaxf(mx0, x0);
              mx1 = fmaxf(mx1, x1);
            }
          }
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
          const float al0 = fast_exp2(m0 - mx0), al1 = fast_exp2(m1 - mx1);
          m0 = mx0;
          m1 = mx1;

          // P in f32 for the sums, rounded to bf16 as the A operand of P V
          float rs0 = 0.f, rs1 = 0.f;
          uint32_t pf[kBN / 16][4];
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
            float p00 = fast_exp2(s[4 * j] - m0), p01 = fast_exp2(s[4 * j + 1] - m0);
            float p10 = fast_exp2(s[4 * j + 2] - m1),
                  p11 = fast_exp2(s[4 * j + 3] - m1);
            rs0 += p00 + p01;
            rs1 += p10 + p11;
            pf[j >> 1][(j & 1) * 2] = pack_bf16(p00, p01);
            pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p10, p11);
          }
          rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
          rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
          rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
          rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
          l0 = l0 * al0 + rs0;
          l1 = l1 * al1 + rs1;
#pragma unroll
          for (int j = 0; j < DV / 8; ++j) {
            o[4 * j] *= al0;
            o[4 * j + 1] *= al0;
            o[4 * j + 2] *= al1;
            o[4 * j + 3] *= al1;
          }

          // O += P V: V [keys][d] is the MN-major B operand, 16 keys a step
          const uint32_t v_base = smem_u32(sm.v[stage]);
          reg_fence<DV / 2>(o);
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < kBN / 16; ++kc)
            wgmma_pv<DV>(o, pf[kc],
                         sw128_desc(v_base + kc * 16 * 128, kBlockBytes, 1024));
          wgmma_commit_wait();
          reg_fence<DV / 2>(o);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&sm.empty[stage]));
        if (++stage == kStages) stage = 0, phase ^= 1;
        if (tile < 0) break;
      }
      if ((qr0 < a.Sq && m0 == kNeg) || (qr1 < a.Sq && m1 == kNeg))
        sm.redo = 1;
      asm volatile("bar.sync 1, 288;\n" ::: "memory");
      if (!sm.redo) break;
    }

    const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = a.o + b * a.o_b + h * a.o_h;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      int col = 8 * j + 2 * t4;
      if (qr0 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qr0 * a.o_s + col) =
            __floats2bfloat162_rn(o[4 * j] / L0, o[4 * j + 1] / L0);
      if (qr1 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qr1 * a.o_s + col) =
            __floats2bfloat162_rn(o[4 * j + 2] / L1, o[4 * j + 3] / L1);
    }
  }
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// 16-byte asynchronous copy from global to shared memory, past L1
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One split's partial softmax state for the group's `rep` query heads, in
// the scratch at [B * KVH][splits][rep * (DV + 2)] f32: m[rep], l[rep],
// o[rep][DV] (o unnormalised). A split with no allowed key writes only
// m = -inf (kNeg is finite, so a live split's m is always above it).
template <int DV>
__device__ __forceinline__ float* decode_record(const Args& a, float* part,
                                                int rep, int split, int kvh,
                                                int b) {
  const long long g = (long long)b * a.KVH + kvh;
  return part + (g * gridDim.x + split) * rep * (DV + 2);
}

// Run by every thread of a decode CTA once its record is written: the CTA
// takes a ticket on its group's counter, and the last of the group's
// `splits` CTAs merges their records and writes o: M = the largest
// split max, each live split weighed by exp(m - M) (skipped splits left
// out), o = sum(w o) / max(sum(w l), 1e-30). With no live split the row
// has no allowed key, and p = exp(NEG - NEG) = 1 for every key makes it
// the mean of V over the Skv keys. Where `a.lse` is given, the row's
// M + log(L) goes there, -inf for a row with no allowed key. The last CTA
// sets the counter back to 0 for the next call on the stream.
template <int DV>
__device__ void decode_finish(const Args& a, float* part, int* tickets,
                              int rep, int kvh, int b) {
  __shared__ int ticket;
  __shared__ float big[kMaxGroup];
  const int splits = gridDim.x;
  const int g = b * a.KVH + kvh;
  __threadfence();  // this thread's record, visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(tickets + g, 1);
  __syncthreads();
  if (ticket != splits - 1) return;
  __threadfence();
  if (threadIdx.x == 0) tickets[g] = 0;
  const int rec = rep * (DV + 2);
  const float* pg = decode_record<DV>(a, part, rep, 0, kvh, b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < rep; r += nwarps) {
    float mx = -INFINITY;
    for (int sp = lane; sp < splits; sp += 32)
      mx = fmaxf(mx, __ldcg(pg + (long long)sp * rec + r));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) big[r] = mx;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rep * DV; i += blockDim.x) {
    const int r = i / DV, d = i % DV;
    const float M = big[r];
    float out;
    if (M == -INFINITY) {
      const __nv_bfloat16* vb = a.v + b * a.v_b + kvh * a.v_h + d;
      float sum = 0.f;
      for (int j = 0; j < a.Skv; ++j)
        sum += __bfloat162float(vb[(long long)j * a.v_s]);
      out = sum / fmaxf((float)a.Skv, 1.f);
      if (a.lse != nullptr && d == 0)
        a.lse[(long long)b * a.H + kvh * rep + r] = -INFINITY;
    } else {
      constexpr int kBatch = 8;  // records whose loads are in flight
      float L = 0.f, O = 0.f;
      for (int sp0 = 0; sp0 < splits; sp0 += kBatch) {
        float mm[kBatch], ll[kBatch], oo[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const float* ps = pg + (long long)(sp0 + u) * rec;
          const bool in = sp0 + u < splits;
          mm[u] = in ? __ldcg(ps + r) : -INFINITY;
          ll[u] = in ? __ldcg(ps + rep + r) : 0.f;
          oo[u] = in ? __ldcg(ps + 2 * rep + i) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (mm[u] == -INFINITY) continue;  // a skipped split (or none)
          const float w = expf(mm[u] - M);
          L += ll[u] * w;
          O += oo[u] * w;
        }
      }
      out = O / fmaxf(L, 1e-30f);
      if (a.lse != nullptr && d == 0)
        a.lse[(long long)b * a.H + kvh * rep + r] = M + logf(L);
    }
    a.o[b * a.o_b + (kvh * rep + r) * a.o_h + d] = __float2bfloat16_rn(out);
  }
}

// Dynamic shared memory of one decode CTA: two stages of a K tile (rows
// padded by 16 bytes) and a V tile, the group's q in f32, the quarter dot
// products of a tile's scores and its p.
__host__ __device__ constexpr size_t decode_stage_bytes(int DK, int DV) {
  return 2 * (size_t)kTile * (DK + 8) + 2 * (size_t)kTile * DV;
}
__host__ __device__ constexpr size_t decode_smem(int DK, int DV, int rep) {
  return 2 * decode_stage_bytes(DK, DV) + 4 * (size_t)rep * DK +
         4 * 4 * (size_t)rep * kTile + 4 * (size_t)rep * kTile;
}

template <int DK, int DV, int R>
__global__ void __launch_bounds__(kDecodeThreads, R <= 4 ? 3 : 2)
    decode_kernel(const Args a, int tps, float* part, int* tickets) {
  constexpr int KROW = DK + 8;  // K row in shared memory: 16 bytes of pad
                                // keep the score pass free of bank conflicts
  constexpr int CPK = DK / 8;   // 16-byte pieces of a K row
  constexpr int CPV = DV / 8;   // and of a V row
  constexpr int QPR = CPK / 4;  // pieces of a quarter K row
  constexpr int NS = kDecodeThreads / (DV / 2);  // key slices of P.V
  static_assert(CPK % 4 == 0 && kDecodeThreads % (DV / 2) == 0,
                "a quarter K row and P.V's key slices must be whole");
  constexpr int KBYTES = 2 * kTile * KROW;
  constexpr int STAGE = (int)decode_stage_bytes(DK, DV);
  extern __shared__ __align__(16) uint8_t dsm[];
  __shared__ unsigned long long bits[kMaxSplitTiles];  // allowed keys
  __shared__ int live[kMaxSplitTiles];  // the split's live tiles, in order
  __shared__ int nlive;
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], al_s[kMaxGroup];
  const int rep = a.H / a.KVH;
  float* q_s = reinterpret_cast<float*>(dsm + 2 * STAGE);  // [rep][DK]
  float* sq_s = q_s + rep * DK;          // [4][rep][kTile] quarter dots
  float* p_s = sq_s + 4 * rep * kTile;   // [rep][kTile]
  float* red = reinterpret_cast<float*>(dsm);  // [NS][rep][DV], over the
                                               // stages at the end

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int h0 = kvh * rep, tile0 = split * tps;
  const int ntiles = min(tps, (a.Skv + kTile - 1) / kTile - tile0);
  float* rec = decode_record<DV>(a, part, rep, split, kvh, b);

  // which keys of the split's tiles the query may see, a bit a key
  const int qp = a.q_pos[b];
  for (int ti = warp; ti < ntiles; ti += kDecodeThreads / 32) {
    unsigned long long m = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = (tile0 + ti) * kTile + h * 32 + lane;
      bool ok = false;
      if (j < a.Skv) {
        const long long g = (long long)b * a.Skv + j;
        ok = allowed(a, qp, a.kv_pos[g], a.kv_valid[g]);
      }
      m |= (unsigned long long)__ballot_sync(0xffffffffu, ok) << (32 * h);
    }
    if (lane == 0) bits[ti] = m;
  }
  __syncthreads();
  if (t == 0) {
    int n = 0;
    for (int ti = 0; ti < ntiles; ++ti)
      if (bits[ti]) live[n++] = ti;
    nlive = n;
  }
  __syncthreads();
  const int nl = nlive;
  if (nl == 0) {  // no allowed key in the split: skip it
    if (t < rep) rec[t] = -INFINITY;
    decode_finish<DV>(a, part, tickets, rep, kvh, b);
    return;
  }

  const __nv_bfloat16* kg = a.k + b * a.k_b + kvh * a.k_h;
  const __nv_bfloat16* vg = a.v + b * a.v_b + kvh * a.v_h;
  // a tile's K and V rows (those below Skv) into a stage, as 16-byte
  // copies in one group
  auto load_tile = [&](int ti, int stage) {
    const int j0 = (tile0 + ti) * kTile, n = min(kTile, a.Skv - j0);
    uint8_t* base = dsm + stage * STAGE;
    for (int i = t; i < n * CPK; i += kDecodeThreads) {
      const int row = i / CPK, c = (i % CPK) * 8;
      cp_async16(smem_u32(base + 2 * (row * KROW + c)),
                 kg + (long long)(j0 + row) * a.k_s + c);
    }
    for (int i = t; i < n * CPV; i += kDecodeThreads) {
      const int row = i / CPV, c = (i % CPV) * 8;
      cp_async16(smem_u32(base + KBYTES + 2 * (row * DV + c)),
                 vg + (long long)(j0 + row) * a.v_s + c);
    }
    cp_async_commit();
  };
  load_tile(live[0], 0);
  for (int i = t; i < rep * DK; i += kDecodeThreads)
    q_s[i] = __bfloat162float(a.q[b * a.q_b + (h0 + i / DK) * a.q_h + i % DK]);
  if (t < rep) {
    m_s[t] = kNeg;
    l_s[t] = 0.f;
  }

  const int c2 = t % (DV / 2), sl = t / (DV / 2);
  float acc[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int ii = 0; ii < nl; ++ii) {
    const int stage = ii & 1, ti = live[ii];
    if (ii + 1 < nl)
      load_tile(live[ii + 1], stage ^ 1);  // its stage was freed by the last
    else                               // iteration's closing barrier
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks =
        reinterpret_cast<const __nv_bfloat16*>(dsm + stage * STAGE);
    const __nv_bfloat16* vs =
        reinterpret_cast<const __nv_bfloat16*>(dsm + stage * STAGE + KBYTES);
    const int j0 = (tile0 + ti) * kTile, n = min(kTile, a.Skv - j0);

    // quarter dot products: key t % kTile over the quarter t / kTile of DK
    {
      const int j = t % kTile, qd = t / kTile;
      if (j < n) {
        float dot[R];
#pragma unroll
        for (int r = 0; r < R; ++r) dot[r] = 0.f;
        const uint4* kr =
            reinterpret_cast<const uint4*>(ks + j * KROW) + qd * QPR;
#pragma unroll
        for (int c = 0; c < QPR; ++c) {
          float kf[8];
          unpack8(kr[c], kf);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < rep) {
              const float4* qv = reinterpret_cast<const float4*>(
                  q_s + r * DK + (qd * QPR + c) * 8);
              const float4 qa = qv[0], qb = qv[1];
              dot[r] = fmaf(qa.x, kf[0], dot[r]);
              dot[r] = fmaf(qa.y, kf[1], dot[r]);
              dot[r] = fmaf(qa.z, kf[2], dot[r]);
              dot[r] = fmaf(qa.w, kf[3], dot[r]);
              dot[r] = fmaf(qb.x, kf[4], dot[r]);
              dot[r] = fmaf(qb.y, kf[5], dot[r]);
              dot[r] = fmaf(qb.z, kf[6], dot[r]);
              dot[r] = fmaf(qb.w, kf[7], dot[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < rep) sq_s[(qd * rep + r) * kTile + j] = dot[r];
      }
    }
    __syncthreads();

    // the tile's softmax, a warp per head: scores (masked NEG, past Skv
    // none), the tile's max once, p = exp(s - m) summed into l and kept
    // rounded to bf16 for P.V, the running max and sum moved on
    const unsigned long long ok = bits[ti];
    for (int r = warp; r < rep; r += kDecodeThreads / 32) {
      float x[2], mx = kNeg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = h * 32 + lane;
        x[h] = -INFINITY;
        if (j < n) {
          const float dot = sq_s[r * kTile + j] +
                            sq_s[(rep + r) * kTile + j] +
                            sq_s[(2 * rep + r) * kTile + j] +
                            sq_s[(3 * rep + r) * kTile + j];
          x[h] = (ok >> j) & 1 ? dot * a.scale : kNeg;
        }
        mx = fmaxf(mx, x[h]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p = expf(x[h] - m_new);
        sum += p;
        p_s[r * kTile + h * 32 + lane] =
            __bfloat162float(__float2bfloat16_rn(p));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        al_s[r] = al;
        l_s[r] = l_s[r] * al + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // P.V: the column pair c2 of DV over the keys sl + NS i of the tile
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rep) {
        const float al = al_s[r];
        acc[r][0] *= al;
        acc[r][1] *= al;
      }
    }
#pragma unroll 4
    for (int j = sl; j < n; j += NS) {
      const float2 vf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vs + j * DV + 2 * c2));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rep) {
          const float p = p_s[r * kTile + j];
          acc[r][0] = fmaf(p, vf.x, acc[r][0]);
          acc[r][1] = fmaf(p, vf.y, acc[r][1]);
        }
      }
    }
    __syncthreads();  // the stage and the tile's scores are free again
  }

  // the key slices' sums through shared memory, then the record
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < rep)
      *reinterpret_cast<float2*>(red + (sl * rep + r) * DV + 2 * c2) =
          make_float2(acc[r][0], acc[r][1]);
  __syncthreads();
  for (int i = t; i < rep * DV; i += kDecodeThreads) {
    float o = 0.f;
#pragma unroll
    for (int k = 0; k < NS; ++k) o += red[k * rep * DV + i];
    rec[2 * rep + i] = o;
  }
  if (t < rep) {
    rec[t] = m_s[t];
    rec[rep + t] = l_s[t];
  }
  decode_finish<DV>(a, part, tickets, rep, kvh, b);
}

Args make_args(const void* q, const void* k, const void* v, void* o,
               const void* q_pos, const void* kv_pos, const void* kv_valid,
               const long long* strides, int B, int Sq, int Skv, int H,
               int KVH, int causal, int has_window, int window, float scale) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.q_pos = static_cast<const int32_t*>(q_pos);
  a.kv_pos = static_cast<const int32_t*>(kv_pos);
  a.kv_valid = static_cast<const uint8_t*>(kv_valid);
  a.q_b = strides[0], a.q_s = strides[1], a.q_h = strides[2];
  a.k_b = strides[3], a.k_s = strides[4], a.k_h = strides[5];
  a.v_b = strides[6], a.v_s = strides[7], a.v_h = strides[8];
  a.o_b = strides[9], a.o_s = strides[10], a.o_h = strides[11];
  a.B = B, a.Sq = Sq, a.Skv = Skv, a.H = H, a.KVH = KVH;
  a.causal = causal, a.has_window = has_window, a.window = window;
  a.scale = scale;
  a.lse = nullptr;
  return a;
}

// Tiles a decode split walks, and the splits, for B, KVH and Skv (the rule
// in the note at the top).
int decode_tps(int B, int KVH, int Skv) {
  const long long tiles = (Skv + kTile - 1) / kTile;
  const long long want = (B * KVH * tiles + kDecodeCtas - 1) / kDecodeCtas;
  return (int)(want < 2 ? 2 : want > kMaxSplitTiles ? kMaxSplitTiles : want);
}
int decode_splits(int B, int KVH, int Skv) {
  const int tiles = (Skv + kTile - 1) / kTile, tps = decode_tps(B, KVH, Skv);
  return tiles > 0 ? (tiles + tps - 1) / tps : 1;
}

template <int DK, int DV, int R>
cudaError_t launch_decode(const Args& a, int tps, float* part, int* tickets,
                          cudaStream_t stream) {
  const size_t smem = decode_smem(DK, DV, a.H / a.KVH);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<DK, DV, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int splits = decode_splits(a.B, a.KVH, a.Skv);
  decode_kernel<DK, DV, R><<<dim3(splits, a.KVH, a.B), kDecodeThreads, smem,
                             stream>>>(a, tps, part, tickets);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t decode_for_rep(const Args& a, int tps, float* part, int* tickets,
                           cudaStream_t stream) {
  int rep = a.H / a.KVH;
  if (rep <= 1) return launch_decode<DK, DV, 1>(a, tps, part, tickets, stream);
  if (rep <= 2) return launch_decode<DK, DV, 2>(a, tps, part, tickets, stream);
  if (rep <= 4) return launch_decode<DK, DV, 4>(a, tps, part, tickets, stream);
  if (rep <= 8) return launch_decode<DK, DV, 8>(a, tps, part, tickets, stream);
  return launch_decode<DK, DV, kMaxGroup>(a, tps, part, tickets, stream);
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so that the
// library links no libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map over a [B, S, heads, D] bf16 tensor with element strides
// (sb, ss, sh) and a dense head dimension: boxes of 64 d x 1 head x 128
// rows x 1 batch, stored with the 128-byte swizzle; rows at and past S
// read as zeros, so no garbage (NaN) meets a zero weight.
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* base, int B,
              int S, int heads, int D, long long sb, long long ss,
              long long sh) {
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                        (cuuint64_t)B};
  cuuint64_t bytes[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                         (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {64, 1, kBN, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, bytes, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DK, int DV>
size_t prefill_smem() {
  return sizeof(Smem<DK, DV>) + 1024;  // + the slack that aligns it to 1024
}

template <int DK, int DV>
cudaError_t launch_prefill(const Args& a, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, encode, a.q, a.B, a.Sq, a.H, DK, a.q_b, a.q_s, a.q_h) ||
      !make_map(&tk, encode, a.k, a.B, a.Skv, a.KVH, DK, a.k_b, a.k_s,
                a.k_h) ||
      !make_map(&tv, encode, a.v, a.B, a.Skv, a.KVH, DV, a.v_b, a.v_s, a.v_h))
    return cudaErrorInvalidValue;
  const size_t smem = prefill_smem<DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.Sq + kBM - 1) / kBM * a.H * a.B;
  prefill_kernel<DK, DV><<<grid, kPrefillThreads, smem, stream>>>(tq, tk, tv,
                                                                  a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K8, prefill variant: q [B, Sq, H, D], k [B, Skv, KVH, D], v [B, Skv, KVH,
// Dv], o [B, Sq, H, Dv] (bf16; `strides` holds the batch, sequence and head
// strides of q, k, v and o, in elements; the head dimension is dense).
// (D, Dv) is (64, 64), (128, 128) or (192, 128).
int flash_prefill(const void* q, const void* k, const void* v, void* o,
                  const void* q_pos, const void* kv_pos, const void* kv_valid,
                  const long long* strides, int B, int Sq, int Skv, int H,
                  int KVH, int D, int Dv, int causal, int has_window,
                  int window, float scale, void* stream) {
  Args a = make_args(q, k, v, o, q_pos, kv_pos, kv_valid, strides, B, Sq, Skv,
                     H, KVH, causal, has_window, window, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && Dv == 64) return (int)launch_prefill<64, 64>(a, s);
  if (D == 128 && Dv == 128) return (int)launch_prefill<128, 128>(a, s);
  if (D == 192 && Dv == 128) return (int)launch_prefill<192, 128>(a, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one prefill CTA at head sizes (D, Dv) (dynamic; it has
// no static shared memory); -1 for a pair it is not compiled for.
int flash_prefill_smem_bytes(int D, int Dv) {
  if (D == 64 && Dv == 64) return (int)prefill_smem<64, 64>();
  if (D == 128 && Dv == 128) return (int)prefill_smem<128, 128>();
  if (D == 192 && Dv == 128) return (int)prefill_smem<192, 128>();
  return -1;
}

// Splits of the decode variant's grid for B, KVH and Skv.
int flash_decode_splits(int B, int KVH, int Skv) {
  return decode_splits(B, KVH, Skv);
}

// K8, decode variant: as flash_prefill with Sq == 1. `lse` is null or
// [B, H] f32, where each row's log-sum-exp goes (-inf for a row with no
// allowed key). `part` is f32 scratch of B * H * flash_decode_splits(B,
// KVH, Skv) * (Dv + 2) floats, `tickets` B * KVH int32 counters, zero
// before the call and zero again after it. Calls that share `tickets`
// must run in order (one stream).
int flash_decode(const void* q, const void* k, const void* v, void* o,
                 const void* q_pos, const void* kv_pos, const void* kv_valid,
                 const long long* strides, int B, int Skv, int H, int KVH,
                 int D, int Dv, int causal, int has_window, int window,
                 float scale, void* lse, void* part, void* tickets,
                 void* stream) {
  Args a = make_args(q, k, v, o, q_pos, kv_pos, kv_valid, strides, B, 1, Skv,
                     H, KVH, causal, has_window, window, scale);
  a.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % KVH != 0 || H / KVH > kMaxGroup) return (int)cudaErrorInvalidValue;
  const int tps = decode_tps(B, KVH, Skv);
  float* p = static_cast<float*>(part);
  int* t = static_cast<int*>(tickets);
  if (D == 64 && Dv == 64) return (int)decode_for_rep<64, 64>(a, tps, p, t, s);
  if (D == 128 && Dv == 128)
    return (int)decode_for_rep<128, 128>(a, tps, p, t, s);
  if (D == 192 && Dv == 128)
    return (int)decode_for_rep<192, 128>(a, tps, p, t, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
