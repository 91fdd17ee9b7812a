// Device helpers shared by the kernel sources of this directory: warp and
// block reductions, cp.async copies, 16-byte cache loads widened to floats,
// and the float conversions of the bf16 and fp32 instantiations. Every
// function is inline, so each source's object holds its own copy.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// block-wide max / sum over the kWarps warps of a block; stat holds kWarps
// floats and is free again on return
template <int kWarps>
__device__ __forceinline__ float block_max(float x, float* stat) {
  x = warp_max(x);
  if ((threadIdx.x & 31) == 0) stat[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = stat[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, stat[w]);
  __syncthreads();
  return r;
}

template <int kWarps>
__device__ __forceinline__ float block_sum(float x, float* stat) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) stat[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = stat[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += stat[w];
  __syncthreads();
  return r;
}

// cp.async: a 16-byte copy from global to shared memory, issued without
// waiting; commit closes a group of copies, wait<N> returns once at most N
// of this thread's groups are still in flight
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of cache -> floats: 16 int8 values, 8 bf16 values or 4 fp32 values
__device__ __forceinline__ void unpack(const int4& w, float (&f)[16]) {
  const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[4 * j + i] = static_cast<float>(static_cast<int8_t>((words[j] >> (8 * i)) & 0xff));
}

__device__ __forceinline__ void unpack(const int4& w, float (&f)[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h2[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack(const int4& w, float (&f)[4]) {
  f[0] = __int_as_float(w.x);
  f[1] = __int_as_float(w.y);
  f[2] = __int_as_float(w.z);
  f[3] = __int_as_float(w.w);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
