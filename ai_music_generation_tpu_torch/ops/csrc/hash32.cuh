// The port's 32-bit counter hash (utils/hash32.py) as device functions, for
// kernels that make the training path's random bits in registers: the same
// bits as the int64 torch ops of utils/hash32.py, on every element. A header,
// so that any kernel that drops inside itself (dropout.cu; a fused attention
// later) draws the mask of ops/dropout.py::dropout_keep with these functions.

#pragma once

#include <stdint.h>

// odd, so mul32(x, kGolden) is a bijection mod 2^32 (utils/hash32.py GOLDEN)
constexpr uint32_t kGolden = 0x9E3779B1u;

// x * c mod 2^32: a uint32_t product wraps exactly as utils/hash32.py::mul32
__device__ __forceinline__ uint32_t mul32(uint32_t x, uint32_t c) { return x * c; }

// murmur3's 32-bit finalizer (utils/hash32.py::mix32)
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h = mul32(h, 0x85EBCA6Bu);
  h ^= h >> 13;
  h = mul32(h, 0xC2B2AE35u);
  return h ^ (h >> 16);
}

// ops/dropout.py::dropout_keep: element idx of a site whose key is k (the
// host's mix32(key ^ mul32(layer * 4 + site + 1, GOLDEN))) is kept iff its
// bits reach the threshold round(p * 2^32), held in 64 bits so that p = 1
// drops every element
__device__ __forceinline__ bool dropout_kept(uint32_t idx, uint32_t k, uint64_t threshold) {
  return static_cast<uint64_t>(mix32(mul32(idx, kGolden) ^ k)) >= threshold;
}
