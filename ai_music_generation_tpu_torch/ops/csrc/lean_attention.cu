// Lean single-query (T=1) decode attention over an int8 or a position-packed
// int4 cache, one bf16 scale per (row, head, position), every position read:
// for every row b and head h,
//   out[b, h] = sum_s P(softmax_s(q[b, h] . k[b, s, h] * k_scale / sqrt(D))
//                       * v_scale) v[b, s, h]
// where, in lean8 (an unpacked int8 cache), q and the probabilities are
// requantized to int8 per (row, head) and both dots are int8 x int8 with
// int32 sums, and, in lean4 (int4 values, position p in the low nibble and
// p + S/2 in the high nibble of byte p), both dots are fp32 sums against bf16
// q and bf16-rounded probabilities. The contract, and the plain PyTorch twin
// that states the order of operations, live in
// ai_music_generation_tpu_torch/ops/lean_attention.py.
//
// Replaces docs/experiments/int4_kernel_probe.py::_lean_kernel (K7, called
// by lean_attention), a TPU kernel that ran R rows per grid program with q
// broadcast to 8 sublanes, head rows padded to 8, a lane-ownership mask and
// a ones-dot fold, and unpacked the nibbles with float arithmetic (a TPU
// compiler workaround). None of that shape is kept.
//
// What bounds it: device-memory bytes. At the probe's shape (B=4096, S=256,
// H=6, D=64) one lean8 call reads 805 MB of K and V and 25 MB of scales (a
// bound of ~0.25 ms at 3.35 TB/s); lean4 reads half the cache bytes (~0.13
// ms). It does about 2 operations per cache byte (4 per byte in lean4),
// far below where the card becomes compute-bound.
//
// What this simple design does about it (wgmma, TMA and the heads of one row
// in one block are later work):
// - one block of 128 threads per (row, head), the heads of one row adjacent
//   in the grid; every cache read is a 16-byte vector, the D/16 threads of a
//   group read one position's 64-byte (D=64) head slice together, and each
//   thread keeps kUnroll loads in flight before it uses them;
// - lean8 quantizes q in the block (IEEE division, rintf: bit-exact with the
//   twin) and dots it with __dp4a, so the scores equal the twin's bit for
//   bit; PV sums p8 * v8 in int32, exact;
// - lean4 unpacks each byte with integer shifts into its two positions;
// - two passes over the scores in shared memory (S x 4 bytes, 1 KiB at
//   S=256): lean8's requantize needs the finished probabilities' maximum,
//   so an online one-pass softmax would not compute the same function.
//
// Build with nvcc -gencode arch=compute_90a,code=sm_90a and WITHOUT
// --use_fast_math: the q / qs and probs / ps divisions must be IEEE.

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
constexpr int kVec = 16;    // cache bytes per 16-byte load

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

// the 4-bit two's-complement value in the low bits of x
__device__ __forceinline__ int sext4(int x) { return ((x & 0xF) ^ 8) - 8; }

// byte i (0..3) of a word, unsigned
__device__ __forceinline__ int byte_of(int w, int i) { return (w >> (8 * i)) & 0xff; }

// Grid: one block per (row, head), the head fastest. Thread tid belongs to
// position group tid / kTPC and reads the 16 cache bytes of the head slice
// from (tid % kTPC) * 16; the kGroups groups take the stored positions
// p = group (mod kGroups), p < Sp (Sp = S, or S/2 packed). Dynamic shared
// memory: [S] fp32, the scores, then the probabilities (lean8: p8).
template <int kD, bool kPacked>
__global__ void __launch_bounds__(kThreads) lean_attention_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, H*D]
    const int8_t* __restrict__ k,               // [B, Sp, H*D]
    const int8_t* __restrict__ v,               // [B, Sp, H*D]
    const __nv_bfloat16* __restrict__ k_scale,  // [B, H, S]
    const __nv_bfloat16* __restrict__ v_scale,  // [B, H, S]
    float* __restrict__ out,                    // [B, H*D]
    int S, int H) {
  using Acc = typename std::conditional<kPacked, float, int>::type;
  constexpr int kTPC = kD / kVec;  // threads per position's head slice
  static_assert(kD % kVec == 0 && kTPC >= 1 && kTPC <= 32 && 32 % kTPC == 0,
                "head size must be a multiple of 16, at most 512");
  constexpr int kGroups = kThreads / kTPC;
  constexpr int kStride = kGroups * kUnroll;  // stored positions per pass
  extern __shared__ float p_s[];
  __shared__ Acc red_s[kWarps][kD];
  __shared__ float stat_s[kWarps];

  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = tid / kTPC;
  const int part = tid % kTPC;
  const int HD = H * kD;
  const int Sp = kPacked ? S / 2 : S;
  // 1/sqrt(D) rounded once to fp32, as JAX rounds the Python float
  const float sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(kD)));

  const int64_t slice = static_cast<int64_t>(b) * Sp * HD + h * kD + part * kVec;
  const int8_t* kb = k + slice;  // this thread's 16 bytes of stored position 0
  const int8_t* vb = v + slice;
  const int64_t row = (static_cast<int64_t>(b) * H + h) * S;
  const __nv_bfloat16* ks_row = k_scale + row;
  const __nv_bfloat16* vs_row = v_scale + row;

  float qv[kVec];
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * HD + h * kD + part * kVec;
#pragma unroll
  for (int e = 0; e < kVec; ++e) qv[e] = __bfloat162float(qb[e]);

  // lean8: q8 = clip(round(q / qs), +-127), qs = max(max|q_h|, 1e-20) / 127,
  // the head's max met across the kTPC threads of the group by shuffles
  float qs = 0.f;
  int qw[kVec / 4];  // q8, four to a word, for __dp4a
  if constexpr (!kPacked) {
    float m = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) m = fmaxf(m, fabsf(qv[e]));
#pragma unroll
    for (int o = kTPC / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    qs = fmaxf(m, 1e-20f) / 127.0f;
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j) {
      int w = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = static_cast<int>(fminf(fmaxf(rintf(qv[4 * j + i] / qs), -127.f), 127.f));
        w |= (x & 0xff) << (8 * i);
      }
      qw[j] = w;
    }
  }

  // ---- A. scores of all S positions into shared memory (every lane runs
  // every pass: the shuffles need them all)
  for (int s0 = 0; s0 < Sp; s0 += kStride) {
    int4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = s0 + u * kGroups + grp;
      raw[u] = p < Sp ? *reinterpret_cast<const int4*>(kb + static_cast<int64_t>(p) * HD)
                      : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = s0 + u * kGroups + grp;
      const int words[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
      if constexpr (kPacked) {
        float lo = 0.f, hi = 0.f;  // positions p and p + Sp
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int by = byte_of(words[j], i);
            lo = fmaf(qv[4 * j + i], static_cast<float>(sext4(by)), lo);
            hi = fmaf(qv[4 * j + i], static_cast<float>(sext4(by >> 4)), hi);
          }
#pragma unroll
        for (int o = kTPC / 2; o > 0; o >>= 1) {
          lo += __shfl_xor_sync(0xffffffffu, lo, o);
          hi += __shfl_xor_sync(0xffffffffu, hi, o);
        }
        if (part == 0 && p < Sp) {
          p_s[p] = lo * __bfloat162float(ks_row[p]) * sm_scale;
          p_s[p + Sp] = hi * __bfloat162float(ks_row[p + Sp]) * sm_scale;
        }
      } else {
        int a = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) a = __dp4a(words[j], qw[j], a);
#pragma unroll
        for (int o = kTPC / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (part == 0 && p < Sp)
          p_s[p] = static_cast<float>(a) * qs * __bfloat162float(ks_row[p]) * sm_scale;
      }
    }
  }
  __syncthreads();

  // ---- B. exact fp32 softmax over the S scores, x v_scale; then lean8
  // requantizes against the row's largest probability, lean4 rounds to bf16
  float m = -INFINITY;
  for (int s = tid; s < S; s += kThreads) m = fmaxf(m, p_s[s]);
  m = block_max(m, stat_s);
  float sum = 0.f;
  for (int s = tid; s < S; s += kThreads) {
    const float e = expf(p_s[s] - m);
    p_s[s] = e;
    sum += e;
  }
  sum = block_sum(sum, stat_s);  // >= 1: the maximum's own term
  float pmax = 0.f;
  for (int s = tid; s < S; s += kThreads) {
    const float p = (p_s[s] / sum) * __bfloat162float(vs_row[s]);
    if constexpr (kPacked) {
      p_s[s] = __bfloat162float(__float2bfloat16_rn(p));
    } else {
      p_s[s] = p;
      pmax = fmaxf(pmax, p);
    }
  }
  float ps = 0.f;
  if constexpr (!kPacked) {
    pmax = block_max(pmax, stat_s);  // its barrier publishes p_s too
    ps = fmaxf(pmax, 1e-20f) / 127.0f;
    for (int s = tid; s < S; s += kThreads)
      p_s[s] = fminf(fmaxf(rintf(p_s[s] / ps), 0.f), 127.f);
  }
  __syncthreads();

  // ---- C. PV: each thread sums its 16 lanes of V over its group's
  // positions (lean8 in int32, exact; lean4 in fp32), then the groups meet:
  // by shuffles inside a warp, through shared memory across the kWarps warps
  Acc acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0;
  for (int s0 = 0; s0 < Sp; s0 += kStride) {
    int4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = s0 + u * kGroups + grp;
      raw[u] = p < Sp ? *reinterpret_cast<const int4*>(vb + static_cast<int64_t>(p) * HD)
                      : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = s0 + u * kGroups + grp;
      if (p >= Sp) continue;
      const int words[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
      if constexpr (kPacked) {
        const float plo = p_s[p], phi = p_s[p + Sp];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int by = byte_of(words[j], i);
            acc[4 * j + i] = fmaf(plo, static_cast<float>(sext4(by)), acc[4 * j + i]);
            acc[4 * j + i] = fmaf(phi, static_cast<float>(sext4(by >> 4)), acc[4 * j + i]);
          }
      } else {
        const int p8 = static_cast<int>(p_s[p]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[4 * j + i] += p8 * static_cast<int>(static_cast<int8_t>(byte_of(words[j], i)));
      }
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
  float* ob = out + static_cast<int64_t>(b) * HD + h * kD;
  for (int i = tid; i < kD; i += kThreads) {
    Acc y = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) y += red_s[w][i];
    ob[i] = kPacked ? static_cast<float>(y) : static_cast<float>(y) * ps;
  }
}

template <int kD, bool kPacked>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* k_scale,
                     const void* v_scale, void* out, int B, int S, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(lean_attention_kernel<kD, kPacked>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = static_cast<int64_t>(B) * H;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  lean_attention_kernel<kD, kPacked><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<float*>(out), S, H);
  return cudaGetLastError();
}

template <bool kPacked>
cudaError_t launch(const void* q, const void* k, const void* v, const void* k_scale,
                   const void* v_scale, void* out, int B, int S, int H, int D,
                   cudaStream_t stream) {
#define LEAN_LAUNCH(DD) \
  case DD:              \
    return launch_d<DD, kPacked>(q, k, v, k_scale, v_scale, out, B, S, H, stream);
  switch (D) {
    LEAN_LAUNCH(16)
    LEAN_LAUNCH(32)
    LEAN_LAUNCH(64)
    LEAN_LAUNCH(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef LEAN_LAUNCH
}

}  // namespace

// Plain C entry point (loaded with ctypes). Every pointer is a device pointer
// to a contiguous tensor: q [B, H*D] bf16; k, v [B, Sp, H*D] int8 with Sp = S
// (packed = 0, lean8) or S/2 (packed = 1, lean4; S even); k_scale, v_scale
// [B, H, S] bf16; out [B, H*D] fp32. Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int lean_attention_launch(const void* q, const void* k, const void* v,
                                     const void* k_scale, const void* v_scale, void* out, int B,
                                     int S, int H, int D, int packed, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || (packed && S % 2)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(packed ? launch<true>(q, k, v, k_scale, v_scale, out, B, S, H, D, st)
                                 : launch<false>(q, k, v, k_scale, v_scale, out, B, S, H, D, st));
}
