// The key hash shared by every kernel of the port (the device form of
// repro_torch/core/hashing.py): h = fmix32(lo ^ fmix32(hi)) over an int64
// key's uint32 halves. The Bloom kernels take a filter block from its top
// bits, the hash-map kernels a home slot from its low bits.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t key_hash(uint32_t lo, uint32_t hi) {
  return fmix32(lo ^ fmix32(hi));
}
