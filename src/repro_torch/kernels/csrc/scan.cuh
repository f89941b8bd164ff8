// A CTA-wide exclusive scan shared by the partitioned builds (K2's slice
// scatter in bloom.cu, K4's and K6a's region scatter in semijoin.cu).
#pragma once

// Exclusive scan, in place, of a[0..n) in shared memory by the whole CTA
// (blockDim.x a multiple of 32); a[n] = the total. Ends synchronised.
__device__ __forceinline__ void block_exclusive_scan(int* a, int n,
                                                     int* warp_sums) {
  int per = (n + blockDim.x - 1) / blockDim.x;
  int begin = min((int)threadIdx.x * per, n), end = min(begin + per, n);
  int sum = 0;
  for (int i = begin; i < end; ++i) sum += a[i];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int nwarps = blockDim.x >> 5;
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = x - sum + (warp ? warp_sums[warp - 1] : 0);
  for (int i = begin; i < end; ++i) {
    int v = a[i];
    a[i] = run;
    run += v;
  }
  if (threadIdx.x == 0) a[n] = warp_sums[nwarps - 1];
  __syncthreads();
}
