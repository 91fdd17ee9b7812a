// Single-query (T=1) multi-head decode attention over the valid prefix of a
// flat KV cache: for every row b and head h,
//   out[b, h] = sum_{s < L} softmax_s(q[b, h] . k[b, s, h] / sqrt(D)) v[b, s, h]
// with L = min(max(length, 1), S). No column at or past L is ever read.
//
// Replaces three TPU kernels (the contracts and the plain PyTorch twins live
// in ai_music_generation_tpu_torch/ops/decode_attention.py and
// decode_attention_int8.py):
// - ai_music_generation_tpu/ops/decode_attention.py::_decode_attention (K4):
//   a bf16 (or fp32) cache;
// - ai_music_generation_tpu/ops/decode_attention_int8.py::
//   _decode_attention_int8 (K5): an int8 cache with one fp32 scale per (row,
//   position), factored onto the scores (x k_scale) and the probabilities
//   (x v_scale);
// - ..._decode_attention_int8_multirow (K6): K5 with R rows per grid
//   program, an MXU tiling knob. Here every launch is one block per (row,
//   head) whatever R is; the Python wrapper only checks that R divides B,
//   as the JAX version asserts. The [B, 1, S] scales of K5 and the [B, S]
//   scales of K6 are the same bytes; this kernel reads both.
//
// What bounds it: device-memory bytes. At the attn_impl="pallas" decode
// path's shape (B=4096, S=256, H=6, D=64, bf16) one call reads
// 2 * B * H * D * 2 bytes = 6.29 MB per live position: 1.61 GB at L=256, a
// bound of 0.48 ms at 3.35 TB/s. A generate's live length averages ~162
// positions, so ~0.31 ms per call. It does 2 FLOP per cache byte, far below
// the ~295 FLOP/byte where an H100 becomes compute-bound. The int8 cache
// (K5, K6) halves the bytes: ~0.82 GB at L=256, a bound of ~0.245 ms.
//
// What this simple design does about it (wgmma is pointless at 2 FLOP per
// byte; TMA, cp.async pipelining and split-S for short batches are later
// work):
// - one block of 128 threads per (row, head), the heads of one row
//   adjacent in the grid so they stream the same cache rows together;
// - every cache read is a 16-byte vector, and the kD/kVec threads of a
//   group read one column's head slice together: a warp reads whole 128-byte
//   (bf16, D=64) or 64-byte (int8) segments, and each block keeps kUnroll
//   such loads per thread in flight before it uses them;
// - columns at or past L are never loaded (the TPU kernel skipped their
//   64- or 128-position DMA chunks; this one skips them column by column);
// - scores of the live prefix sit in shared memory (S x 4 bytes: 1 KiB at
//   S=256); the softmax is exact (max, exp, sum over the stored row) and
//   in fp32, and PV keeps fp32 sums (the Pallas kernels round the
//   probabilities to the cache dtype before PV; this kernel does not).
//
// Build with nvcc -gencode arch=compute_90a,code=sm_90a and WITHOUT
// --use_fast_math (expf at full accuracy).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads per thread in flight together

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// block-wide max / sum over kThreads threads; stat holds kWarps floats and
// is free again on return
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

// 16 bytes of cache -> floats: 16 int8, 8 bf16 or 4 fp32 values
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

// Grid: one block per (row, head), the head fastest. Thread
// tid belongs to column group tid / kTPC and reads the kVec values of the
// head slice from (tid % kTPC) * kVec; the kGroups groups take the columns
// s = group (mod kGroups). Dynamic shared memory: the row's scores, then its
// probabilities, [S] fp32 (only the first L are used).
template <typename QT, typename CacheT, int kD>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const QT* __restrict__ q,              // [B, H*D]
    const CacheT* __restrict__ k,          // [B, S, H*D]
    const CacheT* __restrict__ v,          // [B, S, H*D]
    const float* __restrict__ k_scale,     // [B, S] (int8 cache) or null
    const float* __restrict__ v_scale,     // [B, S] (int8 cache) or null
    const int32_t* __restrict__ length,    // scalar
    QT* __restrict__ out,                  // [B, H*D]
    int S, int H) {
  constexpr bool kQuant = std::is_same<CacheT, int8_t>::value;
  constexpr int kVec = 16 / static_cast<int>(sizeof(CacheT));
  constexpr int kTPC = kD / kVec;  // threads per column's head slice
  static_assert(kD % kVec == 0 && kTPC >= 1 && kTPC <= 32 && 32 % kTPC == 0,
                "head size must be a multiple of 16 bytes' values, at most a warp's");
  constexpr int kGroups = kThreads / kTPC;
  constexpr int kStride = kGroups * kUnroll;  // columns per pass
  extern __shared__ float p_s[];
  __shared__ float red_s[kWarps][kD];
  __shared__ float stat_s[kWarps];

  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = tid / kTPC;
  const int part = tid % kTPC;
  const int HD = H * kD;
  const int L = min(max(*length, 1), S);
  const float sm_scale = 1.f / sqrtf(static_cast<float>(kD));

  const int64_t slice = static_cast<int64_t>(b) * S * HD + h * kD + part * kVec;
  const CacheT* kb = k + slice;  // this thread's 16 bytes of column 0
  const CacheT* vb = v + slice;
  const float* ks_row = kQuant ? k_scale + static_cast<int64_t>(b) * S : nullptr;
  const float* vs_row = kQuant ? v_scale + static_cast<int64_t>(b) * S : nullptr;

  float qv[kVec];
  const QT* qb = q + static_cast<int64_t>(b) * HD + h * kD + part * kVec;
#pragma unroll
  for (int e = 0; e < kVec; ++e) qv[e] = to_float(qb[e]);

  // ---- 1. scores of the live columns, the group's partial dots summed
  // by shuffles (every lane runs every pass: the shuffles need them all)
  for (int s0 = 0; s0 < L; s0 += kStride) {
    int4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kGroups + grp;
      raw[u] = s < L ? *reinterpret_cast<const int4*>(kb + static_cast<int64_t>(s) * HD)
                     : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kVec];
      unpack(raw[u], kf);
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) a = fmaf(qv[e], kf[e], a);
#pragma unroll
      for (int o = kTPC / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      const int s = s0 + u * kGroups + grp;
      if (part == 0 && s < L) p_s[s] = kQuant ? a * ks_row[s] * sm_scale : a * sm_scale;
    }
  }
  __syncthreads();

  // ---- 2. exact fp32 softmax over the L live scores; x v_scale (int8)
  float m = -INFINITY;
  for (int s = tid; s < L; s += kThreads) m = fmaxf(m, p_s[s]);
  m = block_max(m, stat_s);
  float sum = 0.f;
  for (int s = tid; s < L; s += kThreads) {
    const float e = expf(p_s[s] - m);
    p_s[s] = e;
    sum += e;
  }
  sum = block_sum(sum, stat_s);  // >= 1: the maximum's own term
  for (int s = tid; s < L; s += kThreads) {
    const float p = p_s[s] / sum;
    p_s[s] = kQuant ? p * vs_row[s] : p;
  }
  __syncthreads();

  // ---- 3. PV: each thread sums its kVec values of V over its group's
  // columns, then the groups meet: by shuffles inside a warp, through
  // shared memory across the kWarps warps
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  for (int s0 = 0; s0 < L; s0 += kStride) {
    int4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kGroups + grp;
      raw[u] = s < L ? *reinterpret_cast<const int4*>(vb + static_cast<int64_t>(s) * HD)
                     : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kGroups + grp;
      if (s >= L) continue;
      float vf[kVec];
      unpack(raw[u], vf);
      const float p = p_s[s];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
  }
#pragma unroll
  for (int o = kTPC; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (lane < kTPC) {  // lane == part here
#pragma unroll
    for (int e = 0; e < kVec; ++e) red_s[warp][part * kVec + e] = acc[e];
  }
  __syncthreads();
  QT* ob = out + static_cast<int64_t>(b) * HD + h * kD;
  for (int i = tid; i < kD; i += kThreads) {
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) y += red_s[w][i];
    ob[i] = from_float<QT>(y);
  }
}

template <typename QT, typename CacheT, int kD>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* k_scale,
                     const void* v_scale, const void* length, void* out, int B, int S, int H,
                     cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<QT, CacheT, kD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = static_cast<int64_t>(B) * H;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  decode_attention_kernel<QT, CacheT, kD><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CacheT*>(k), static_cast<const CacheT*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(length), static_cast<QT*>(out), S, H);
  return cudaGetLastError();
}

// the head size is a template parameter: 16, 32, 64 or 128
template <typename QT, typename CacheT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* k_scale,
                   const void* v_scale, const void* length, void* out, int B, int S, int H,
                   int D, cudaStream_t stream) {
#define DECODE_LAUNCH(DD) \
  case DD:                \
    return launch_d<QT, CacheT, DD>(q, k, v, k_scale, v_scale, length, out, B, S, H, stream);
  switch (D) {
    DECODE_LAUNCH(16)
    DECODE_LAUNCH(32)
    DECODE_LAUNCH(64)
    DECODE_LAUNCH(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODE_LAUNCH
}

}  // namespace

// Plain C entry point (loaded with ctypes). Every pointer is a device
// pointer to a contiguous tensor; length is an int32 scalar. mode 0: q,
// cache and out bf16 (K4); mode 1: all fp32 (K4); mode 2: q and out bf16,
// int8 cache with fp32 scales [B, S] (K5, K6), else k_scale/v_scale null.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale,
                                       const void* length, void* out, int B, int S, int H, int D,
                                       int mode, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return static_cast<int>(launch<__nv_bfloat16, __nv_bfloat16>(
          q, k, v, nullptr, nullptr, length, out, B, S, H, D, st));
    case 1:
      return static_cast<int>(
          launch<float, float>(q, k, v, nullptr, nullptr, length, out, B, S, H, D, st));
    case 2:
      return static_cast<int>(launch<__nv_bfloat16, int8_t>(q, k, v, k_scale, v_scale, length,
                                                            out, B, S, H, D, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
