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
//     and o is written as [B, Sq, H, D]: no folded [B*H, S, D] copies;
//   * GQA: query head h reads kv head h / (H / KVH), which is what the
//     reference's jnp.repeat(k, H / KVH, axis=2) gives, without the copy;
//   * nothing is padded to 128: keys past Skv take no part at all (their
//     score is -inf, so p = 0), query rows past Sq are not written. A row
//     with no valid key therefore averages V over the Skv real keys, as
//     ref.sdpa_ref does (the padded Pallas path averages over the padded
//     length instead).
//
// Bound on this card (the H100 SXM's published peaks, which assume its
// 700 W limit): prefill is bound by operations (4*D flops per unmasked
// (q, k) pair over 989 TFLOP/s bf16: qwen1.5-4b's prompt of 2048, causal,
// 80 heads, is 0.087 ms), decode by bytes (each K and V row read once:
// 85.5 MB a layer at batch 4 and a 2088-slot cache, 0.026 ms at
// 3.35 TB/s).
//
// Design of the prefill variant, prefill_kernel<D>, for the tensor cores
// that bound it:
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
//     at D 128, one CTA per SM.
//   * S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
//     memory; O += P V is wgmma m64nDk16 with P in registers (the S
//     accumulators, rounded to bf16, are already its A fragment) and V
//     read as the MN-major B operand, so no copy of V is transposed.
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
// Design of the decode variant:
//   * decode_kernel<D, R>: one CTA of 8 warps per (kv head, batch) serves
//     the H / KVH query heads of that group, so each K and V row is read
//     once for all of them. D / 8 lanes share one key (16 bytes each), so a
//     warp holds 32 / (D / 8) keys and every thread keeps four keys' loads
//     in flight; each key group keeps its own running max, sum and output,
//     merged across the warp by shuffles and across warps in shared memory.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kDecodeWarps = 8;
constexpr int kDecodeUnroll = 4;  // keys in flight per key group
constexpr int kMaxGroup = 16;     // most H / KVH the decode variant takes
                                  // (MAX_GROUP in ops.py)

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


template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 128)
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

template <int D>
struct Smem {         // dynamic shared memory, 1024-byte aligned
  static constexpr int kNB = D / 64;  // 64-column (128-byte) blocks
  static constexpr int kTileBytes = kNB * kBlockBytes;
  uint8_t q[kTileBytes];
  uint8_t k[kStages][kTileBytes];
  uint8_t v[kStages][kTileBytes];
  TileMeta meta[kStages];
  uint64_t q_full, full[kStages], empty[kStages];
  int rmin, rmax, redo;
};

template <int D>
__global__ void __launch_bounds__(kPrefillThreads, 1)
    prefill_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Args a) {
  using S = Smem<D>;
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
      mbar_expect_tx(bar, S::kTileBytes);
      for (int j = 0; j < S::kNB; ++j)
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
            mbar_expect_tx(bar, 2 * S::kTileBytes);
            for (int j = 0; j < S::kNB; ++j) {
              tma_load_4d(smem_u32(sm.k[stage] + j * kBlockBytes), &tk, bar,
                          j * 64, kvh, t * kBN, b);
              tma_load_4d(smem_u32(sm.v[stage] + j * kBlockBytes), &tv, bar,
                          j * 64, kvh, t * kBN, b);
            }
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

    float o[D / 2];
    float s[kBN / 2];
    float m0, m1, l0, l1;
    int stage = 0, phase = 0;
    mbar_wait(smem_u32(&sm.q_full), 0);
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m0 = m1 = kNeg;
      l0 = l1 = 0.f;
      for (;;) {
        mbar_wait(smem_u32(&sm.full[stage]), phase);
        const TileMeta& meta = sm.meta[stage];
        const int tile = meta.tile, state = meta.state;
        if (tile >= 0) {
          // S = Q K^T over D in steps of 16
          const uint32_t k_base = smem_u32(sm.k[stage]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
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
          for (int j = 0; j < D / 8; ++j) {
            o[4 * j] *= al0;
            o[4 * j + 1] *= al0;
            o[4 * j + 2] *= al1;
            o[4 * j + 3] *= al1;
          }

          // O += P V: V [keys][d] is the MN-major B operand, 16 keys a step
          const uint32_t v_base = smem_u32(sm.v[stage]);
          reg_fence<D / 2>(o);
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < kBN / 16; ++kc)
            wgmma_pv<D>(o, pf[kc],
                        sw128_desc(v_base + kc * 16 * 128, kBlockBytes, 1024));
          wgmma_commit_wait();
          reg_fence<D / 2>(o);
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
    for (int j = 0; j < D / 8; ++j) {
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

// Merge (m2, l2, acc2) into (m, l, acc): two online-softmax partial states
__device__ __forceinline__ void merge(float& m, float& l, float* acc,
                                      float m2, float l2, const float* acc2) {
  float mn = fmaxf(m, m2);
  float ea = expf(m - mn), eb = expf(m2 - mn);
  l = l * ea + l2 * eb;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = acc[e] * ea + acc2[e] * eb;
  m = mn;
}

template <int D, int R>
__global__ void __launch_bounds__(kDecodeWarps * 32)
    decode_kernel(const Args a) {
  constexpr int LPK = D / 8;     // lanes per key, 8 elements (16 bytes) each
  constexpr int GPW = 32 / LPK;  // key groups per warp
  constexpr int NG = kDecodeWarps * GPW;
  constexpr int U = kDecodeUnroll;
  extern __shared__ float sm[];
  const int rep = a.H / a.KVH;
  float* q_s = sm;                          // [rep][D]
  float* m_s = q_s + rep * D;               // [warps][rep]
  float* l_s = m_s + kDecodeWarps * rep;    // [warps][rep]
  float* acc_s = l_s + kDecodeWarps * rep;  // [warps][rep][D]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % LPK, grp = warp * GPW + lane / LPK;
  const int h0 = kvh * rep;
  for (int i = threadIdx.x; i < rep * D; i += kDecodeWarps * 32)
    q_s[i] = __bfloat162float(a.q[b * a.q_b + (h0 + i / D) * a.q_h + i % D]);
  __syncthreads();

  const int qp = a.q_pos[b];  // Sq == 1
  const __nv_bfloat16* kb = a.k + b * a.k_b + kvh * a.k_h + sub * 8;
  const __nv_bfloat16* vb = a.v + b * a.v_b + kvh * a.v_h + sub * 8;
  const int32_t* kpos = a.kv_pos + (long long)b * a.Skv;
  const uint8_t* kval = a.kv_valid + (long long)b * a.Skv;

  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  for (int base = 0; base < a.Skv; base += NG * U) {
    uint4 kr[U], vr[U];
    int st[U];  // 0 masked key, 1 valid, 2 past Skv
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int j = base + u * NG + grp;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      st[u] = 2;
      if (j < a.Skv) {
        kr[u] = *reinterpret_cast<const uint4*>(kb + (long long)j * a.k_s);
        vr[u] = *reinterpret_cast<const uint4*>(vb + (long long)j * a.v_s);
        st[u] = allowed(a, qp, kpos[j], kval[j]) ? 1 : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8], vf[8];
      unpack8(kr[u], kf);
      unpack8(vr[u], vf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rep) {
          const float* qr = q_s + r * D + sub * 8;
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qr[e], kf[e], dot);
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (st[u] != 2) {
            float x = st[u] ? dot * a.scale : kNeg;
            float mn = fmaxf(m[r], x);
            float al = expf(m[r] - mn), p = expf(x - mn);
            l[r] = l[r] * al + p;
            float pb = __bfloat162float(__float2bfloat16_rn(p));
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pb, vf[e], acc[r][e] * al);
            m[r] = mn;
          }
        }
      }
    }
  }

  // merge the key groups of the warp, then the warps through shared memory
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rep) {
#pragma unroll
      for (int off = LPK; off < 32; off <<= 1) {
        float m2 = __shfl_xor_sync(0xffffffffu, m[r], off);
        float l2 = __shfl_xor_sync(0xffffffffu, l[r], off);
        float a2[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          a2[e] = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        merge(m[r], l[r], acc[r], m2, l2, a2);
      }
      if (lane < LPK) {
        if (sub == 0) {
          m_s[warp * rep + r] = m[r];
          l_s[warp * rep + r] = l[r];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc_s[(warp * rep + r) * D + sub * 8 + e] = acc[r][e];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rep * D; i += kDecodeWarps * 32) {
    int r = i / D, d = i % D;
    float mx = kNeg;
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, m_s[w * rep + r]);
    float L = 0.f, O = 0.f;
    for (int w = 0; w < kDecodeWarps; ++w) {
      float e = expf(m_s[w * rep + r] - mx);
      L += l_s[w * rep + r] * e;
      O += acc_s[(w * rep + r) * D + d] * e;
    }
    a.o[b * a.o_b + (h0 + r) * a.o_h + d] = __float2bfloat16_rn(O / fmaxf(L, 1e-30f));
  }
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
  return a;
}

template <int D, int R>
cudaError_t launch_decode(const Args& a, cudaStream_t stream) {
  int rep = a.H / a.KVH;
  size_t smem = sizeof(float) * ((size_t)rep * D + 2 * kDecodeWarps * rep +
                                 (size_t)kDecodeWarps * rep * D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<D, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_kernel<D, R><<<dim3(a.KVH, a.B), kDecodeWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t decode_for_rep(const Args& a, cudaStream_t stream) {
  int rep = a.H / a.KVH;
  if (rep <= 1) return launch_decode<D, 1>(a, stream);
  if (rep <= 2) return launch_decode<D, 2>(a, stream);
  if (rep <= 4) return launch_decode<D, 4>(a, stream);
  if (rep <= 8) return launch_decode<D, 8>(a, stream);
  return launch_decode<D, kMaxGroup>(a, stream);
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

template <int D>
size_t prefill_smem() {
  return sizeof(Smem<D>) + 1024;  // + the slack that aligns it to 1024
}

template <int D>
cudaError_t launch_prefill(const Args& a, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, encode, a.q, a.B, a.Sq, a.H, D, a.q_b, a.q_s, a.q_h) ||
      !make_map(&tk, encode, a.k, a.B, a.Skv, a.KVH, D, a.k_b, a.k_s, a.k_h) ||
      !make_map(&tv, encode, a.v, a.B, a.Skv, a.KVH, D, a.v_b, a.v_s, a.v_h))
    return cudaErrorInvalidValue;
  const size_t smem = prefill_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.Sq + kBM - 1) / kBM * a.H * a.B;
  prefill_kernel<D><<<grid, kPrefillThreads, smem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K8, prefill variant: q [B, Sq, H, D], k/v [B, Skv, KVH, D], o [B, Sq, H, D]
// (bf16; `strides` holds the batch, sequence and head strides of q, k, v
// and o, in elements; the head dimension is dense). D is 64 or 128.
int flash_prefill(const void* q, const void* k, const void* v, void* o,
                  const void* q_pos, const void* kv_pos, const void* kv_valid,
                  const long long* strides, int B, int Sq, int Skv, int H,
                  int KVH, int D, int causal, int has_window, int window,
                  float scale, void* stream) {
  Args a = make_args(q, k, v, o, q_pos, kv_pos, kv_valid, strides, B, Sq, Skv,
                     H, KVH, causal, has_window, window, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_prefill<64>(a, s);
  if (D == 128) return (int)launch_prefill<128>(a, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one prefill CTA at head_dim D (dynamic; it has no
// static shared memory).
int flash_prefill_smem_bytes(int D) {
  return D == 64 ? (int)prefill_smem<64>()
                 : D == 128 ? (int)prefill_smem<128>() : -1;
}

// K8, decode variant: as flash_prefill with Sq == 1.
int flash_decode(const void* q, const void* k, const void* v, void* o,
                 const void* q_pos, const void* kv_pos, const void* kv_valid,
                 const long long* strides, int B, int Skv, int H, int KVH,
                 int D, int causal, int has_window, int window, float scale,
                 void* stream) {
  Args a = make_args(q, k, v, o, q_pos, kv_pos, kv_valid, strides, B, 1, Skv,
                     H, KVH, causal, has_window, window, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % KVH != 0 || H / KVH > kMaxGroup)
    return (int)cudaErrorInvalidValue;
  if (D == 64) return (int)decode_for_rep<64>(a, s);
  if (D == 128) return (int)decode_for_rep<128>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
