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
// Design (a simple kernel that is right; wgmma, TMA, pipelined loads and
// causal tile skipping are later work):
//   * prefill_kernel<D>: one CTA of 4 warps per (q-tile of 64 rows, head,
//     batch). Q is held in registers as mma.sync A fragments; 64-key K and
//     V tiles are staged in shared memory (rows padded by 16 bytes, so
//     ldmatrix is free of bank conflicts); S = Q K^T and O += P V run on the
//     tensor cores as mma.sync.m16n8k16 bf16 -> f32, P going from the S
//     accumulators to A fragments in registers. Every tile of every row is
//     computed: masked tiles are not skipped yet, so causal prefill does
//     about twice the bound's operations.
//   * decode_kernel<D, R>: one CTA of 8 warps per (kv head, batch) serves
//     the H / KVH query heads of that group, so each K and V row is read
//     once for all of them. D / 8 lanes share one key (16 bytes each), so a
//     warp holds 32 / (D / 8) keys and every thread keeps four keys' loads
//     in flight; each key group keeps its own running max, sum and output,
//     merged across the warp by shuffles and across warps in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kQTile = 64;   // query rows per prefill CTA (16 per warp)
constexpr int kKvTile = 64;  // keys per shared-memory tile
constexpr int kPad = 8;      // bf16 elements of padding per shared row
constexpr int kPrefillThreads = 128;
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c[16x8, f32] += a[16x16, bf16, row] * b[16x8, bf16, col]
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Copy rows [r0, r0 + 64) of a [rows, D] bf16 matrix (row stride `stride`
// elements) into shared memory with row stride D + kPad; rows at and past
// `rows` become zeros, so no garbage (NaN) meets a zero weight.
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long stride, int r0,
                                           int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kKvTile * kChunks; c += kPrefillThreads) {
    int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride +
                                            col);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kPrefillThreads)
    prefill_kernel(const Args a) {
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;  // k-steps of the Q K^T product
  constexpr int NT = kKvTile / 8;  // 8-key column tiles of S
  __shared__ __align__(16) __nv_bfloat16 ks[kKvTile * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kKvTile * LD];
  __shared__ int kpos_s[kKvTile];
  __shared__ uint8_t kval_s[kKvTile];  // 0 masked key, 1 valid, 2 past Skv

  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* qb = a.q + b * a.q_b + h * a.q_h;
  const __nv_bfloat16* kb = a.k + b * a.k_b + kvh * a.k_h;
  const __nv_bfloat16* vb = a.v + b * a.v_b + kvh * a.v_h;

  // Q tile through the K buffer into A fragments (rows warp*16 .. +15)
  stage_tile<D>(ks, qb, a.q_s, q0, a.Sq);
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk], ks + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
  __syncthreads();

  // this thread's two query rows: g and g + 8 of the warp's sixteen
  const int qr0 = q0 + warp * 16 + g, qr1 = qr0 + 8;
  const int qp0 = qr0 < a.Sq ? a.q_pos[(long long)b * a.Sq + qr0] : 0;
  const int qp1 = qr1 < a.Sq ? a.q_pos[(long long)b * a.Sq + qr1] : 0;

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  for (int kv0 = 0; kv0 < a.Skv; kv0 += kKvTile) {
    stage_tile<D>(ks, kb, a.k_s, kv0, a.Skv);
    stage_tile<D>(vs, vb, a.v_s, kv0, a.Skv);
    if (threadIdx.x < kKvTile) {
      int j = kv0 + threadIdx.x;
      bool in = j < a.Skv;
      long long at = (long long)b * a.Skv + j;
      kpos_s[threadIdx.x] = in ? a.kv_pos[at] : 0;
      kval_s[threadIdx.x] = in ? (a.kv_valid[at] ? 1 : 0) : 2;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (nt * 8 + (lane & 7)) * LD + kk * 16 +
                            (lane >> 3) * 8);
        mma16816(s[nt], qf[kk], bf[0], bf[1]);
        mma16816(s[nt], qf[kk + 1], bf[2], bf[3]);
      }
    }

    // masks, scale and the new running max of rows g (regs 0,1), g+8 (2,3)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int c = nt * 8 + t4 * 2 + e;
        int st = kval_s[c], kp = kpos_s[c];
        float x0 = s[nt][e] * a.scale, x1 = s[nt][2 + e] * a.scale;
        x0 = st == 2 ? -INFINITY : (allowed(a, qp0, kp, st) ? x0 : kNeg);
        x1 = st == 2 ? -INFINITY : (allowed(a, qp1, kp, st) ? x1 : kNeg);
        s[nt][e] = x0;
        s[nt][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float al0 = expf(m0 - mx0), al1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // P in f32 for the sums, rounded to bf16 as the A operand of P V
    float rs0 = 0.f, rs1 = 0.f;
    uint32_t pf[kKvTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p00 = expf(s[nt][0] - m0), p01 = expf(s[nt][1] - m0);
      float p10 = expf(s[nt][2] - m1), p11 = expf(s[nt][3] - m1);
      rs0 += p00 + p01;
      rs1 += p10 + p11;
      pf[nt >> 1][(nt & 1) * 2] = pack_bf16(p00, p01);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p10, p11);
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= al0;
      o[dt][1] *= al0;
      o[dt][2] *= al1;
      o[dt][3] *= al1;
    }

    // O += P V: V's rows are the k dimension, read transposed by ldmatrix
#pragma unroll
    for (int kc = 0; kc < kKvTile / 16; ++kc) {
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  dt * 8 + (lane >> 4) * 8);
        mma16816(o[dt], pf[kc], bf[0], bf[1]);
        mma16816(o[dt + 1], pf[kc], bf[2], bf[3]);
      }
    }
    __syncthreads();  // the next tile overwrites ks and vs
  }

  const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = a.o + b * a.o_b + h * a.o_h;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    int col = dt * 8 + t4 * 2;
    if (qr0 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qr0 * a.o_s + col) =
          __floats2bfloat162_rn(o[dt][0] / L0, o[dt][1] / L0);
    if (qr1 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qr1 * a.o_s + col) =
          __floats2bfloat162_rn(o[dt][2] / L1, o[dt][3] / L1);
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
  dim3 grid((Sq + kQTile - 1) / kQTile, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    prefill_kernel<64><<<grid, kPrefillThreads, 0, s>>>(a);
  else if (D == 128)
    prefill_kernel<128><<<grid, kPrefillThreads, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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
