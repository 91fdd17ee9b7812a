// One T=1 grouped-query decode step over a flat KV cache: the fresh K/V
// column is written (int8 mode: quantized first) and all H query heads
// attend over the cache, in one kernel.
//
// Replaces the TPU kernel ai_music_generation_tpu/ops/gqa_decode.py::
// _gqa_decode_update (Pallas). The contract and the plain PyTorch twin live
// in ai_music_generation_tpu_torch/ops/gqa_decode.py.
//
// What bounds it: device-memory bytes. At the batched decode shape
// (B=4096, S=128, KH=2, D=64, int8 cache) one call reads the K and V caches,
// B*S*KH*D*2 bytes = 128 MiB, plus 2*B*KH*S*2 bytes = 4 MiB of bf16 scales,
// and does about 2 FLOP per cache byte, far below the ~295 FLOP/byte where
// an H100 becomes compute-bound. What this simple design does about it: one
// block per batch row, each valid column of K and V is read from device
// memory once (the G query heads sharing a kv-head hit the same lines in
// L1), and masked columns (past pos in lockstep mode, outside the ring
// window in ring mode) are never read. Wider loads, several rows per block,
// cp.async/TMA pipelining and a CUDA graph around the decode step are later
// work.
//
// Build with nvcc -gencode arch=compute_90a,code=sm_90a and WITHOUT
// --use_fast_math: the int8 scale max(|x|, 1e-6) / 127 must be an IEEE
// division (and rintf round-half-even) to stay bit-exact with
// models/gpt.py::quantize_int8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Grid: one block per batch row b. Dynamic shared memory holds q as fp32
// [H*D], the scores and then the probabilities [H*S] fp32, and the column
// validity [S] (the mask does not depend on the head).
template <typename CacheT>
__global__ void __launch_bounds__(kThreads) gqa_decode_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, H, D]
    CacheT* __restrict__ k,                    // [B, S, KH*D], written at pos
    CacheT* __restrict__ v,                    // [B, S, KH*D], written at pos
    const __nv_bfloat16* __restrict__ k_slab,  // [B, KH*D] fresh column
    const __nv_bfloat16* __restrict__ v_slab,  // [B, KH*D] fresh column
    __nv_bfloat16* __restrict__ k_scale,       // [B, KH, S] (int8 mode) or null
    __nv_bfloat16* __restrict__ v_scale,       // [B, KH, S] (int8 mode) or null
    const int32_t* __restrict__ mask_rel,      // [B, S] (ring mode) or null
    const int32_t* __restrict__ pos_ptr,       // scalar: column written this step
    __nv_bfloat16* __restrict__ out,           // [B, H, D]
    int S, int H, int KH, int D) {
  constexpr bool kQuant = std::is_same<CacheT, int8_t>::value;
  extern __shared__ float smem[];
  const int KHD = KH * D;
  const int G = H / KH;
  float* q_s = smem;
  float* p_s = q_s + H * D;
  int* valid_s = reinterpret_cast<int*>(p_s + H * S);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int pos = *pos_ptr;
  CacheT* kb = k + static_cast<int64_t>(b) * S * KHD;
  CacheT* vb = v + static_cast<int64_t>(b) * S * KHD;
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * H * D;
  __nv_bfloat16* ob = out + static_cast<int64_t>(b) * H * D;

  if (pos < 0 || pos >= S) {
    // no column to write: write nothing and make the output NaN, so a
    // caller that broke the length < S invariant cannot miss it
    for (int i = tid; i < H * D; i += blockDim.x) ob[i] = __float2bfloat16_rn(NAN);
    return;
  }

  // ---- 1. the fresh column (and, int8 mode, its scale) into the cache
  if constexpr (kQuant) {
    // one warp per (buffer, kv-head): fp32 abs-max, s = max(m, 1e-6) / 127
    // (IEEE division), q = clip(rint(x / s), -127, 127), bf16 scale (RN)
    for (int t = warp; t < 2 * KH; t += n_warps) {
      const bool is_v = t >= KH;
      const int kh = is_v ? t - KH : t;
      const __nv_bfloat16* src =
          (is_v ? v_slab : k_slab) + static_cast<int64_t>(b) * KHD + kh * D;
      float m = 0.f;
      for (int d = lane; d < D; d += 32) m = fmaxf(m, fabsf(__bfloat162float(src[d])));
      m = warp_max(m);
      const float s = fmaxf(m, 1e-6f) / 127.f;
      int8_t* dst = (is_v ? vb : kb) + static_cast<int64_t>(pos) * KHD + kh * D;
      for (int d = lane; d < D; d += 32) {
        const float r = fminf(fmaxf(rintf(__bfloat162float(src[d]) / s), -127.f), 127.f);
        dst[d] = static_cast<int8_t>(r);
      }
      if (lane == 0) {
        __nv_bfloat16* scale = is_v ? v_scale : k_scale;
        scale[(static_cast<int64_t>(b) * KH + kh) * S + pos] = __float2bfloat16_rn(s);
      }
    }
  } else {
    for (int i = tid; i < KHD; i += blockDim.x) {
      kb[static_cast<int64_t>(pos) * KHD + i] = k_slab[static_cast<int64_t>(b) * KHD + i];
      vb[static_cast<int64_t>(pos) * KHD + i] = v_slab[static_cast<int64_t>(b) * KHD + i];
    }
  }
  for (int i = tid; i < H * D; i += blockDim.x) q_s[i] = __bfloat162float(qb[i]);
  for (int s = tid; s < S; s += blockDim.x)
    valid_s[s] = mask_rel ? (mask_rel[static_cast<int64_t>(b) * S + s] >= 0) : (s <= pos);
  // the column and scale writes above are global-memory writes of this
  // block; __syncthreads makes them visible to every thread of the block
  __syncthreads();

  // ---- 2. scores, one thread per (column, head); masked columns unread
  const float sm_scale = 1.f / sqrtf(static_cast<float>(D));
  for (int i = tid; i < S * H; i += blockDim.x) {
    const int s = i / H;
    const int h = i - s * H;
    if (!valid_s[s]) {
      p_s[h * S + s] = -INFINITY;
      continue;
    }
    const int kh = h / G;  // query head h reads kv-head h // G
    const CacheT* kc = kb + static_cast<int64_t>(s) * KHD + kh * D;
    const float* qh = q_s + h * D;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc += qh[d] * to_float(kc[d]);
    if constexpr (kQuant)
      acc *= __bfloat162float(k_scale[(static_cast<int64_t>(b) * KH + kh) * S + s]);
    p_s[h * S + s] = acc * sm_scale;
  }
  __syncthreads();

  // ---- 3. fp32 softmax per head (one warp per head) over valid columns
  for (int h = warp; h < H; h += n_warps) {
    float* ph = p_s + h * S;
    const int kh = h / G;
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32)
      if (valid_s[s]) m = fmaxf(m, ph[s]);
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float e = valid_s[s] ? expf(ph[s] - m) : 0.f;
      ph[s] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int s = lane; s < S; s += 32) {
      float p = ph[s] * inv;
      if constexpr (kQuant)
        p *= __bfloat162float(v_scale[(static_cast<int64_t>(b) * KH + kh) * S + s]);
      ph[s] = p;
    }
  }
  __syncthreads();

  // ---- 4. PV, one thread per (head, d); masked columns unread
  for (int i = tid; i < H * D; i += blockDim.x) {
    const int h = i / D;
    const int d = i - h * D;
    const float* ph = p_s + h * S;
    const CacheT* vc = vb + (h / G) * D + d;
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      if (valid_s[s]) acc += ph[s] * to_float(vc[static_cast<int64_t>(s) * KHD]);
    ob[i] = __float2bfloat16_rn(acc);
  }
}

template <typename CacheT>
cudaError_t launch(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
                   void* k_scale, void* v_scale, const void* mask_rel, const void* pos,
                   void* out, int B, int S, int H, int KH, int D, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(H) * D + static_cast<size_t>(H) * S) +
                      sizeof(int) * static_cast<size_t>(S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gqa_decode_kernel<CacheT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  gqa_decode_kernel<CacheT><<<B, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<CacheT*>(k), static_cast<CacheT*>(v),
      static_cast<const __nv_bfloat16*>(k_slab), static_cast<const __nv_bfloat16*>(v_slab),
      static_cast<__nv_bfloat16*>(k_scale), static_cast<__nv_bfloat16*>(v_scale),
      static_cast<const int32_t*>(mask_rel), static_cast<const int32_t*>(pos),
      static_cast<__nv_bfloat16*>(out), S, H, KH, D);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Every pointer is a device
// pointer to a contiguous tensor; k_scale/v_scale are null in bf16-cache
// mode, mask_rel is null in lockstep mode. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int gqa_decode_update_launch(const void* q, void* k, void* v, const void* k_slab,
                                        const void* v_slab, void* k_scale, void* v_scale,
                                        const void* mask_rel, const void* pos, void* out, int B,
                                        int S, int H, int KH, int D, int quantized,
                                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized)
    return static_cast<int>(launch<int8_t>(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel,
                                           pos, out, B, S, H, KH, D, st));
  return static_cast<int>(launch<__nv_bfloat16>(q, k, v, k_slab, v_slab, k_scale, v_scale,
                                                mask_rel, pos, out, B, S, H, KH, D, st));
}
