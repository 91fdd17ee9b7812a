// Speculative-verify attention over the flat spec KV cache: T query tokens
// per row, column s readable by query t iff col_pos[b, s] <= lengths[b] + t,
// optionally preceded by the write of the step's Tw-column K/V slab at the
// shared cursor.
//
// Replaces the TPU kernels ai_music_generation_tpu/ops/spec_attention.py::
// _spec_attention_update (slab write + attention) and _spec_attention
// (attention alone), which share their body _make_attend. The contract and
// the plain PyTorch twins live in ai_music_generation_tpu_torch/ops/
// spec_attention.py.
//
// What bounds it: device-memory bytes in both regimes. At the verify step
// (B=4096, S=256, H=6, D=64, int8 cache, T=5) one call reads about 0.8 GB of
// K and V and does 2T = 10 FLOP per cache byte; at a refresh (T=128 at
// cursor 0 over an empty history) each query reads only the columns up to
// its own, 0.5 GB move, and the 52 GFLOP of the products take 0.77 ms on
// CUDA cores at their 67 TFLOP/s peak but 0.05 ms on the tensor cores,
// below the 0.49 ms byte bound. So both products run on the tensor cores.
// What holds the kernel back on the card is the work of a block between
// its loads (conversions, softmax, synchronisation), not the loads: its
// design keeps that work small and as many blocks as possible on an SM.
//
// Design of the tensor-core kernel (every mode but int8_dots):
// - regimes, chosen by the launcher from T: verify (T <= 16) runs one block
//   of 4 warps per (row, head) with a 16-row query tile (T rows live), the
//   warps splitting each column tile; refresh (T > 16) runs one block of 8
//   warps per (row, head, 64-query tile), two warps per 16 query rows, so
//   a tile reads only the columns up to its last query. Where the 64-row
//   buffers do not fit shared memory (long caches: the refresh at S=1024)
//   the launcher takes 16-row tiles of 4 warps, several per (row, head);
// - tiles: the block stages the K and then the V column tiles (64 columns
//   each) of its (row, head), double-buffered with cp.async 16-byte copies:
//   the next tile is in flight while the current one is used. (Measured:
//   deeper rings, up to the whole row in flight, were slower at every
//   shape, since they cost blocks on an SM.) Each column is copied from the
//   slab inside the write window [cursor, cursor+Tw) and from the cache
//   elsewhere; a column that no query of the block may read is zero-filled,
//   not read, and tiles with no such column are skipped. (TMA cannot
//   choose the source per column, and wgmma's 64-row minimum would waste
//   more at T=5 than mma.sync's 16.) col_pos and the scales are loaded once
//   per block;
// - scores: S = Q K^T with mma.sync m16n8k16, fp32 accumulation; q held as
//   A fragments in registers, K read from shared memory. The depth index is
//   permuted so that each thread reads one contiguous run of every column.
//   The epilogue applies k_scale, 1/sqrt(D) and the col_pos mask and keeps
//   each row's running maximum in registers;
// - softmax: exact, over a [live rows, S] fp32 score buffer in shared
//   memory (only the block's live query rows: 5 at a T=5 verify step): the
//   maximum from the warps' running maxima, then one pass of exp, sum and
//   x v_scale, 8 lanes per row and 4 rows of a warp at once; 1/sum is
//   applied as PV reads the row;
// - PV: O = P V with mma.sync m16n8k16 (int8 V in fp16, bf16 V in bf16),
//   the column index permuted so that each thread reads 4 whole column runs
//   per 16 columns; the warps' partial sums meet in shared memory;
// - the slab write: the query-tile blocks of (row, head) share the writing
//   of head h's slice of the slab, 4 pieces of K and V in flight per
//   thread; every block reads the fresh columns from the slab, never from
//   the cache being written (no write-then-read race).
//
// Numerics of the tensor-core kernel:
// - scores, bf16 cache: q and K are bf16, so every product is exact in fp32
//   and the scores differ from the fp32 twin's only in summation order;
// - scores, int8 cache: the products run in fp16 (an int8 value is exact
//   there, converted with 5 instructions per 4 values where bf16 takes 11):
//   each q row is scaled by the power of two that lifts its largest |q|
//   into [2^14, 2^15), where every bf16 value within 2^28 of it is an
//   exact fp16, and the scores are scaled back exactly; so the products are
//   exact too except for q values 2^28 below their row's largest, whose
//   error is below 2^-24 of that largest;
// - k_scale, 1/sqrt(D) and log2(e) multiply the fp32 scores; the softmax
//   is fp32 with exp2 of the log2-scaled scores (the hardware's exp2,
//   relative error about 2^-22) and an IEEE division for 1/sum;
// - PV, int8 cache: int8 V is exact in fp16; P x v_scale is scaled per row
//   by the power of two that lifts its largest value into [2^14, 2^15)
//   and rounded to fp16 (a relative error of at most 2^-11 per term, clear
//   of fp16's subnormals below 6.1e-5), the output divided back exactly;
// - PV, bf16 cache: P is split into bf16 hi + lo, two products (relative
//   error about 2^-16 per term);
// - the output is rounded once, to bf16; it stays within one bf16 ulp
//   (2^-7) of its range of the twin evaluated in fp32. The slab write is a
//   bit-exact copy. A query whose every column is dead gets 0, not NaN.
// (ops/spec_attention.py::spec_attention_mma_model evaluates the PV
// roundings on the CPU.)
//
// int8_dots mode keeps its CUDA-core kernel (below, first): one block per
// (row, head, 8-query tile); q and the scaled probabilities quantized per
// (head, query) row exactly as the Pallas kernel does, both products in
// int32 with __dp4a / integer multiply-adds; scores, softmax and the scales
// in fp32. No path calls it (models/gpt.py sets it only with
// spec_int8_dots=True).
//
// Build with nvcc -gencode arch=compute_90a,code=sm_90a and WITHOUT
// --use_fast_math: the int8_dots scales max(|x|, 1e-20) / 127 need an IEEE
// division and rintf (round half to even), and expf its full accuracy.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

// ===========================================================================
// The int8_dots kernel (CUDA cores)
// ===========================================================================

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 8;      // queries per block
constexpr int kUnroll = 8;  // PV columns whose V loads are in flight together
constexpr size_t kSmemLimit = 227 * 1024;
constexpr int kTooLarge = -1;  // returned when a block's buffers exceed shared memory

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// floats of the [kTQ*S] score region, which PV's partial sums reuse
__host__ __device__ constexpr int p_len(int S, int D) {
  return kTQ * S > kWarps * kTQ * D ? kTQ * S : kWarps * kTQ * D;
}

// Grid: one block per (query tile, head, row), the query tile fastest so
// the blocks of one (row, head) run close together and share the cache
// lines in L2. Dynamic shared memory: q8 [kTQ*D] int8, then fp32 q
// [kTQ*D], p [p_len] (scores, probabilities, then PV partial sums), q
// scales [kTQ], p scales [kTQ], and the row's col_pos [S] as int.
template <int kD>
__global__ void __launch_bounds__(kThreads) spec_attention_dots_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, T, H*D]
    int8_t* __restrict__ k,               // [B, S, H*D], slab written at cursor
    int8_t* __restrict__ v,               // [B, S, H*D], slab written at cursor
    const int8_t* __restrict__ k_slab,    // [B, Tw, H*D] or null (no write)
    const int8_t* __restrict__ v_slab,    // [B, Tw, H*D] or null
    const __nv_bfloat16* __restrict__ k_scale,  // [B, H, S]
    const __nv_bfloat16* __restrict__ v_scale,  // [B, H, S]
    const int32_t* __restrict__ col_pos,  // [B, S]
    const int32_t* __restrict__ lengths,  // [B]
    const int32_t* __restrict__ cursor_ptr,  // scalar, or null without a slab
    __nv_bfloat16* __restrict__ out,      // [B, T, H*D]
    int T, int S, int H) {
  constexpr int kE = kD >= 32 ? kD / 32 : 1;  // V values per lane in PV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* q8_s = reinterpret_cast<int8_t*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(smem_raw + kTQ * kD);
  float* p_s = q_s + kTQ * kD;
  float* qscale_s = p_s + p_len(S, kD);
  float* pscale_s = qscale_s + kTQ;
  int* cp_s = reinterpret_cast<int*>(pscale_s + kTQ);

  const int n_qt = (T + kTQ - 1) / kTQ;
  int blk = blockIdx.x;
  const int qt = blk % n_qt;
  blk /= n_qt;
  const int h = blk % H;
  const int b = blk / H;
  const int t0 = qt * kTQ;
  const int nq = min(kTQ, T - t0);
  const int HD = H * kD;
  const int hoff = h * kD;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * T + t0) * HD + hoff;

  int cursor = 0, Tw = 0;
  if (k_slab != nullptr) {
    cursor = *cursor_ptr;
    Tw = (T + 7) / 8 * 8;
    if (cursor < 0 || cursor > S - Tw) {
      // no window to write: write nothing and make the output NaN, so a
      // caller that broke the cursor + Tw <= S invariant cannot miss it
      for (int i = tid; i < nq * kD; i += kThreads)
        ob[static_cast<int64_t>(i / kD) * HD + i % kD] = __float2bfloat16_rn(NAN);
      return;
    }
  }
  int8_t* kb = k + static_cast<int64_t>(b) * S * HD;
  int8_t* vb = v + static_cast<int64_t>(b) * S * HD;
  const int8_t* ksb = k_slab ? k_slab + static_cast<int64_t>(b) * Tw * HD : nullptr;
  const int8_t* vsb = v_slab ? v_slab + static_cast<int64_t>(b) * Tw * HD : nullptr;
  // where column s of this row is read from: the slab inside the write
  // window (Tw == 0 without a slab), the cache elsewhere
  auto col = [&](const int8_t* cache_row, const int8_t* slab_row, int s) -> const int8_t* {
    const unsigned j = static_cast<unsigned>(s - cursor);
    return j < static_cast<unsigned>(Tw) ? slab_row + static_cast<int64_t>(j) * HD + hoff
                                         : cache_row + static_cast<int64_t>(s) * HD + hoff;
  };

  // ---- 1. the slab write: head h's slice of the Tw columns, by tile 0
  if (ksb != nullptr && qt == 0) {
    constexpr int vecs = kD / 16;  // 16-byte vectors per column slice
    for (int i = tid; i < Tw * vecs; i += kThreads) {
      const int j = i / vecs;
      const int64_t src = static_cast<int64_t>(j) * HD + hoff + (i % vecs) * 16;
      const int64_t dst = static_cast<int64_t>(cursor + j) * HD + hoff + (i % vecs) * 16;
      *reinterpret_cast<int4*>(kb + dst) = *reinterpret_cast<const int4*>(ksb + src);
      *reinterpret_cast<int4*>(vb + dst) = *reinterpret_cast<const int4*>(vsb + src);
    }
  }

  // ---- 2. the query tile (rows past nq zeroed) and the row's col_pos
  const __nv_bfloat16* qb = q + (static_cast<int64_t>(b) * T + t0) * HD + hoff;
  for (int i = tid; i < kTQ * kD; i += kThreads) {
    const int t = i / kD;
    q_s[i] = t < nq ? __bfloat162float(qb[static_cast<int64_t>(t) * HD + i % kD]) : 0.f;
  }
  const int len = lengths[b];
  for (int s = tid; s < S; s += kThreads) cp_s[s] = col_pos[static_cast<int64_t>(b) * S + s];
  __syncthreads();
  // q per (head, query): s = max(max|q|, 1e-20) / 127 (IEEE division),
  // q8 = clip(rint(q / s), -127, 127); one warp per query row
  for (int t = warp; t < kTQ; t += kWarps) {
    float m = 0.f;
    for (int d = lane; d < kD; d += 32) m = fmaxf(m, fabsf(q_s[t * kD + d]));
    const float qs = fmaxf(warp_max(m), 1e-20f) / 127.f;
    for (int d = lane; d < kD; d += 32)
      q8_s[t * kD + d] =
          static_cast<int8_t>(fminf(fmaxf(rintf(q_s[t * kD + d] / qs), -127.f), 127.f));
    if (lane == 0) qscale_s[t] = qs;
  }
  __syncthreads();

  // ---- 3. scores, one thread per column; columns no query of the tile
  // may read are never loaded
  const float sm_scale = 1.f / sqrtf(static_cast<float>(kD));
  const int q_last = len + t0 + nq - 1;  // position of the tile's last query
  const __nv_bfloat16* ks_row = k_scale + (static_cast<int64_t>(b) * H + h) * S;
  const __nv_bfloat16* vs_row = v_scale + (static_cast<int64_t>(b) * H + h) * S;
  for (int s = tid; s < S; s += kThreads) {
    const int cp = cp_s[s];
    if (cp > q_last) {
#pragma unroll
      for (int t = 0; t < kTQ; ++t) p_s[t * S + s] = -INFINITY;
      continue;
    }
    const int8_t* kc = col(kb, ksb, s);
    float score[kTQ];  // rows past nq stay 0 and are never read
#pragma unroll
    for (int t = 0; t < kTQ; ++t) score[t] = 0.f;
    int4 kw[kD / 16];
#pragma unroll
    for (int c = 0; c < kD / 16; ++c) kw[c] = *reinterpret_cast<const int4*>(kc + 16 * c);
    int acc[kTQ];
#pragma unroll
    for (int t = 0; t < kTQ; ++t) {
      if (t >= nq) break;
      acc[t] = 0;
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) {
        const int4 qw = *reinterpret_cast<const int4*>(q8_s + t * kD + 16 * c);
        acc[t] = __dp4a(qw.x, kw[c].x, acc[t]);
        acc[t] = __dp4a(qw.y, kw[c].y, acc[t]);
        acc[t] = __dp4a(qw.z, kw[c].z, acc[t]);
        acc[t] = __dp4a(qw.w, kw[c].w, acc[t]);
      }
      score[t] = static_cast<float>(acc[t]) * qscale_s[t];
    }
    const float ks = __bfloat162float(ks_row[s]);
#pragma unroll
    for (int t = 0; t < kTQ; ++t)
      p_s[t * S + s] = cp <= len + t0 + t ? score[t] * ks * sm_scale : -INFINITY;
  }
  __syncthreads();

  // ---- 4. fp32 softmax per query (one warp per row), x v_scale, the
  // scaled row quantized to [0, 127]
  for (int t = warp; t < nq; t += kWarps) {
    float* pr = p_s + t * S;
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, pr[s]);
    m = warp_max(m);
    if (m == -INFINITY) {  // every column dead: the query reads nothing
      for (int s = lane; s < S; s += 32) pr[s] = 0.f;
      if (lane == 0) pscale_s[t] = 0.f;
      continue;
    }
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(pr[s] - m);  // exp(-inf) = 0 for masked columns
      pr[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float pmax = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float p = pr[s] / sum * __bfloat162float(vs_row[s]);
      pr[s] = p;
      pmax = fmaxf(pmax, p);
    }
    const float ps = fmaxf(warp_max(pmax), 1e-20f) / 127.f;
    for (int s = lane; s < S; s += 32) pr[s] = fminf(fmaxf(rintf(pr[s] / ps), 0.f), 127.f);
    if (lane == 0) pscale_s[t] = ps;
  }
  __syncthreads();

  // ---- 5. PV: warp w sums the columns s = w (mod kWarps), lane l the kE
  // values of V from l*kE (lanes past the head idle when D = 16), kUnroll
  // columns' loads in flight at once. Columns no query of the tile may
  // read are neither loaded nor multiplied. Sums are exact int32.
  const int d_lane = lane * kE;
  const bool lane_on = d_lane < kD;
  int acc[kTQ][kE];
#pragma unroll
  for (int t = 0; t < kTQ; ++t)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[t][e] = 0;
  for (int s0 = warp; s0 < S; s0 += kUnroll * kWarps) {
    int8_t vv[kUnroll][kE];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kWarps;
      live[u] = s < S && cp_s[s] <= q_last;
      if (live[u] && lane_on) {
        const int8_t* vc = col(vb, vsb, s) + d_lane;
#pragma unroll
        for (int e = 0; e < kE; ++e) vv[u][e] = vc[e];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!live[u] || !lane_on) continue;
      const int s = s0 + u * kWarps;
#pragma unroll
      for (int t = 0; t < kTQ; ++t) {
        if (t >= nq) break;
        const float p = p_s[t * S + s];
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[t][e] += static_cast<int>(p) * static_cast<int>(vv[u][e]);
      }
    }
  }
  __syncthreads();  // every warp is done reading p_s: reuse it for the sums
  int* red_s = reinterpret_cast<int*>(p_s);  // [kWarps][kTQ][kD]
  if (lane_on) {
#pragma unroll
    for (int t = 0; t < kTQ; ++t)
#pragma unroll
      for (int e = 0; e < kE; ++e) red_s[(warp * kTQ + t) * kD + d_lane + e] = acc[t][e];
  }
  __syncthreads();
  for (int i = tid; i < nq * kD; i += kThreads) {
    const int t = i / kD;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red_s[w * kTQ * kD + i];
    ob[static_cast<int64_t>(t) * HD + i % kD] =
        __float2bfloat16_rn(static_cast<float>(sum) * pscale_s[t]);
  }
}

size_t dots_smem_bytes(int S, int D) {
  return static_cast<size_t>(kTQ) * D +
         sizeof(float) * (static_cast<size_t>(kTQ) * D + p_len(S, D) + 2 * kTQ +
                          static_cast<size_t>(S));
}

template <int kD>
int launch_dots_d(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
                  const void* k_scale, const void* v_scale, const void* col_pos,
                  const void* lengths, const void* cursor, void* out, int B, int T, int S, int H,
                  cudaStream_t stream) {
  const size_t smem = dots_smem_bytes(S, kD);
  if (smem > kSmemLimit) return kTooLarge;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(spec_attention_dots_kernel<kD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = static_cast<int64_t>((T + kTQ - 1) / kTQ) * H * B;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  spec_attention_dots_kernel<kD><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<int8_t*>(k), static_cast<int8_t*>(v),
      static_cast<const int8_t*>(k_slab), static_cast<const int8_t*>(v_slab),
      static_cast<const __nv_bfloat16*>(k_scale), static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int32_t*>(col_pos), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(cursor), static_cast<__nv_bfloat16*>(out), T, S, H);
  return cudaGetLastError();
}

// the head size is a template parameter: 16, 32, 64 or 128
int launch_dots(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
                const void* k_scale, const void* v_scale, const void* col_pos,
                const void* lengths, const void* cursor, void* out, int B, int T, int S, int H,
                int D, cudaStream_t stream) {
#define SPEC_DOTS_LAUNCH(DD)                                                                 \
  case DD:                                                                                   \
    return launch_dots_d<DD>(q, k, v, k_slab, v_slab, k_scale, v_scale, col_pos, lengths,   \
                             cursor, out, B, T, S, H, stream);
  switch (D) {
    SPEC_DOTS_LAUNCH(16)
    SPEC_DOTS_LAUNCH(32)
    SPEC_DOTS_LAUNCH(64)
    SPEC_DOTS_LAUNCH(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef SPEC_DOTS_LAUNCH
}
// ===========================================================================
// The tensor-core kernel (every mode but int8_dots)
// ===========================================================================

constexpr int kCH = 64;     // cache columns per staged tile
constexpr int kStages = 2;  // staged tiles in shared memory (the ring)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  // src_bytes 0 reads nothing and fills the 16 bytes with zeros
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D += A * B on the tensor cores, m16n8k16, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// N bytes of shared memory (N = 1, 2, 4, 8 or a multiple of 16) as words
template <int N>
__device__ __forceinline__ void load_bytes(const unsigned char* p, uint32_t (&w)[(N + 3) / 4]) {
  if constexpr (N % 16 == 0) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (N == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x;
    w[1] = x.y;
  } else if constexpr (N == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (N == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    static_assert(N == 1, "1, 2, 4, 8 or a multiple of 16 bytes");
    w[0] = *p;
  }
}

// fp16 bits 0x64uu are 1024 + uu: over the byte x + 128 of an int8 x,
// minus 1152 is x, exactly
__device__ __forceinline__ uint32_t magic_to_f16(uint32_t t) {
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&t),
                            __half2half2(__ushort_as_half(0x6480)));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// four int8 values (one word) -> two f16x2 words (values 0, 1 and 2, 3)
__device__ __forceinline__ void s8x4_to_f16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  lo = magic_to_f16(__byte_perm(u, 0x64646464u, 0x4140));
  hi = magic_to_f16(__byte_perm(u, 0x64646464u, 0x4342));
}

// byte j of ua and of ub (words of int8 values already XORed with 0x80) ->
// one f16x2 word
__device__ __forceinline__ uint32_t u8_pair_to_f16(uint32_t ua, uint32_t ub, int j) {
  return magic_to_f16((__byte_perm(ua, ub, j | ((j + 4) << 8)) & 0x00FF00FFu) | 0x64006400u);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// warps of a block: 4 at a verify step (16 rows), 8 at a refresh (64 rows)
__host__ __device__ constexpr int mma_warps(int rows) { return rows == 16 ? 4 : 8; }

// floats in a row of the probability buffer (a multiple of 4): the padded
// width + 4 (the 4 keeps the A-fragment reads conflict-free), and room for
// the PV partial sums [2][rows][D + 1] that reuse the buffer at the end
__host__ __device__ constexpr int p_stride(int S, int D) {
  return round_up(S, kCH) + 4 > round_up(2 * (D + 1), 4) ? round_up(S, kCH) + 4
                                                         : round_up(2 * (D + 1), 4);
}

// Dynamic shared memory, in order: the ring of kStages tiles [kCH][D] of
// the cache type, P [min(rows, T)][p_stride] fp32 (only the block's live
// query rows), col_pos [Sp] int, k and v scales [Sp] fp32 each, the rows' PV
// factors [2][rows], the warps' row maxima [warps / (rows/16)][rows], the
// live tile list [Sp/kCH] and its length.
size_t mma_smem_bytes(int S, int D, int item, int rows, int T) {
  const size_t Sp = static_cast<size_t>(round_up(S, kCH));
  const size_t pr = static_cast<size_t>(T < rows ? T : rows);
  return static_cast<size_t>(kStages) * kCH * D * item +
         sizeof(float) * (pr * p_stride(S, D) + 3 * Sp + 2 * rows + mma_warps(rows) * 16 +
                          Sp / kCH + 1);
}

// Grid: one block per (query tile, head, row), the query tile fastest.
// kWR row groups of 16 queries per block: 1 (verify: 4 warps split each
// tile's columns) or 4 (refresh: 8 warps, two per 16 rows).
// Registers are capped so that 8 verify blocks (int8 cache; 6 with bf16)
// or 2 refresh blocks share an SM: measured, more blocks in flight beat
// fewer spilled registers.
template <typename CacheT, int kD, int kWR>
__global__ void __launch_bounds__(32 * mma_warps(16 * kWR),
                                  kWR == 4 ? 2 : (std::is_same<CacheT, int8_t>::value ? 8 : 6))
    spec_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, T, H*D]
    CacheT* __restrict__ k,               // [B, S, H*D], slab written at cursor
    CacheT* __restrict__ v,               // [B, S, H*D], slab written at cursor
    const CacheT* __restrict__ k_slab,    // [B, Tw, H*D] or null (no write)
    const CacheT* __restrict__ v_slab,    // [B, Tw, H*D] or null
    const __nv_bfloat16* __restrict__ k_scale,  // [B, H, S] (int8 mode) or null
    const __nv_bfloat16* __restrict__ v_scale,  // [B, H, S] (int8 mode) or null
    const int32_t* __restrict__ col_pos,  // [B, S]
    const int32_t* __restrict__ lengths,  // [B]
    const int32_t* __restrict__ cursor_ptr,  // scalar, or null without a slab
    __nv_bfloat16* __restrict__ out,      // [B, T, H*D]
    int T, int S, int H) {
  constexpr bool kQuant = std::is_same<CacheT, int8_t>::value;
  constexpr int kItem = static_cast<int>(sizeof(CacheT));
  constexpr int kElems = 16 / kItem;            // cache values per 16 bytes
  constexpr int kChunks = kD / kElems;          // 16-byte chunks per column slice
  constexpr int kTile = kCH * kD * kItem;       // bytes of one staged tile
  constexpr int kR = 16 * kWR;                  // query rows per block
  constexpr int kWarpsM = mma_warps(kR);        // warps of the block
  constexpr int kThreadsM = 32 * kWarpsM;
  constexpr int kNcs = kWarpsM / kWR;           // warps sharing a row group
  constexpr int kNK = kD / 16;                  // k-steps of QK^T
  constexpr int kNT = kD / 8;                   // n-tiles of PV
  constexpr int kQW = kD / 8;                   // q words per row and thread
  constexpr int kKB = kD / 4 * kItem;           // K bytes per column and thread
  constexpr int kVB = kD / 8 * kItem;           // V bytes per column and thread
  constexpr int kKS = 2;                        // PV: warps splitting the k-steps
  constexpr int kNS = kNcs / kKS;               // ... and the n-tiles
  constexpr int kNTw = kNT / kNS;               // n-tiles of a warp
  constexpr int kVBw = kVB / kNS;               // its V bytes per column and thread
  constexpr int kNTs = kCH / 8 / kNcs;          // QK^T n-tiles of a tile per warp
  constexpr int kGrp = kNTs < 4 ? kNTs : 4;     // ... taken together
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Sp = round_up(S, kCH);
  const int PS = p_stride(S, kD);
  const int PR = min(kR, T);  // rows of P: the most live query rows a block has
  unsigned char* ring = smem_raw;
  float* p_s = reinterpret_cast<float*>(ring + kStages * kTile);
  int* cp_s = reinterpret_cast<int*>(p_s + PR * PS);
  float* ks_s = reinterpret_cast<float*>(cp_s + Sp);
  float* vs_s = ks_s + Sp;
  float* rowa_s = vs_s + Sp;  // the row's multiplier of P in PV
  float* rowo_s = rowa_s + kR;  // ... and of the output (int8: 2^-k)
  float* rmax_s = rowo_s + kR;  // [kNcs][kR] the warps' row maxima
  int* live_s = reinterpret_cast<int*>(rmax_s + kNcs * kR);
  int* n_live_s = live_s + Sp / kCH;

  const int n_qt = (T + kR - 1) / kR;
  int blk = blockIdx.x;
  const int qt = blk % n_qt;
  blk /= n_qt;
  const int h = blk % H;
  const int b = blk / H;
  const int t0 = qt * kR;
  const int nq = min(kR, T - t0);
  const int HD = H * kD;
  const int hoff = h * kD;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // mma group: row (A, C) or column (B) in the tile
  const int t4 = lane & 3;   // thread in the group
  const int rg = warp % kWR;  // the warp's row group
  const int cs = warp / kWR;  // its share of the columns
  const int kpart = cs % kKS;  // PV: its k-steps kpart, kpart + kKS, ...
  const int npart = cs / kKS;  // ... and its n-tiles npart*kNTw ...
  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * T + t0) * HD + hoff;

  int cursor = 0, Tw = 0;
  if (k_slab != nullptr) {
    cursor = *cursor_ptr;
    Tw = (T + 7) / 8 * 8;
    if (cursor < 0 || cursor > S - Tw) {
      // no window to write: write nothing and make the output NaN, so a
      // caller that broke the cursor + Tw <= S invariant cannot miss it
      for (int i = tid; i < nq * kD; i += kThreadsM)
        ob[static_cast<int64_t>(i / kD) * HD + i % kD] = __float2bfloat16_rn(NAN);
      return;
    }
  }
  CacheT* kb = k + static_cast<int64_t>(b) * S * HD;
  CacheT* vb = v + static_cast<int64_t>(b) * S * HD;
  const CacheT* ksb = k_slab ? k_slab + static_cast<int64_t>(b) * Tw * HD : nullptr;
  const CacheT* vsb = v_slab ? v_slab + static_cast<int64_t>(b) * Tw * HD : nullptr;

  // ---- 1. the prologue's loads, issued together: the slab pieces this
  // block writes (the query-tile blocks of (row, head) share head h's slice
  // of the Tw columns), col_pos and the scales of the row (loaded whole:
  // a column no query of the block reads gets scale 0, so its probability
  // is 0); then the slab stores. col_pos and the scales are loaded once per
  // block
  constexpr int kU = kWR == 1 ? 1 : 4;  // slab pieces (16 bytes) per thread and pass
  const int n_pieces = ksb != nullptr ? Tw * kChunks : 0;
  const int step = n_qt * kThreadsM * kU;
  int4 kx[kU], vx[kU];
  auto slab_load = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u;
      if (i < n_pieces) {
        const int src = (i / kChunks) * HD + hoff + (i % kChunks) * kElems;
        kx[u] = *reinterpret_cast<const int4*>(ksb + src);
        vx[u] = *reinterpret_cast<const int4*>(vsb + src);
      }
    }
  };
  auto slab_store = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u;
      if (i < n_pieces) {
        const int dst = (cursor + i / kChunks) * HD + hoff + (i % kChunks) * kElems;
        *reinterpret_cast<int4*>(kb + dst) = kx[u];
        *reinterpret_cast<int4*>(vb + dst) = vx[u];
      }
    }
  };
  const int i_first = (qt * kThreadsM + tid) * kU;
  slab_load(i_first);
  const int len = lengths[b];
  const int q_last = len + t0 + nq - 1;  // position of the block's last query
  const int64_t srow = (static_cast<int64_t>(b) * H + h) * S;
#pragma unroll 2
  for (int s = tid; s < Sp; s += kThreadsM) {
    const bool in = s < S;
    const int cp = in ? col_pos[static_cast<int64_t>(b) * S + s] : INT_MAX;
    float ks = 0.f, vs = 0.f;
    if (kQuant && in) {
      ks = __bfloat162float(k_scale[srow + s]);
      vs = __bfloat162float(v_scale[srow + s]);
    }
    cp_s[s] = cp;
    if (kQuant) {
      const bool read = cp <= q_last;
      ks_s[s] = read ? ks : 0.f;
      vs_s[s] = read ? vs : 0.f;
    }
  }
  slab_store(i_first);
  for (int i0 = i_first + step; i0 < n_pieces; i0 += step) {  // long slabs only
    slab_load(i0);
    slab_store(i0);
  }

  // ---- 2. the column tiles that any query of the block may read
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int ch = 0; ch < Sp / kCH; ++ch) {
      const bool any = __any_sync(0xffffffffu, cp_s[ch * kCH + lane] <= q_last ||
                                                   cp_s[ch * kCH + 32 + lane] <= q_last);
      if (any) {
        if (lane == 0) live_s[n] = ch;
        ++n;
      }
    }
    if (lane == 0) *n_live_s = n;
  }
  __syncthreads();
  const int n_live = *n_live_s;

  // ---- 3. the staged tiles: K of every live tile, then V of every live
  // tile, double-buffered: the next tile's copies are in flight while the
  // current one is used (more buffers cost blocks on an SM, which hide
  // more). A column is read from the slab inside the write window and from
  // the cache elsewhere; one that no query of the block may read is not
  // read at all (its 16-byte pieces are zero-filled)
  auto issue = [&](int i) {
    if (i < 2 * n_live) {
      const bool is_v = i >= n_live;
      const int c0 = live_s[is_v ? i - n_live : i] * kCH;
      const CacheT* cache_h = (is_v ? vb : kb) + hoff;  // column 0, head h
      const CacheT* slab_h = Tw ? (is_v ? vsb : ksb) + hoff : cache_h;
      unsigned char* dst = ring + (i % kStages) * kTile;
#pragma unroll
      for (int u = 0; u < (kCH * kChunks + kThreadsM - 1) / kThreadsM; ++u) {
        const int idx = tid + u * kThreadsM;  // 16-byte piece c of column cl
        if (idx >= kCH * kChunks) break;
        const int cl = idx / kChunks;
        const int c = idx - cl * kChunks;
        const int s = c0 + cl;
        const bool live = cp_s[s] <= q_last;  // false past S (INT_MAX)
        const unsigned j = static_cast<unsigned>(s - cursor);
        const CacheT* src = (j < static_cast<unsigned>(Tw) ? slab_h + static_cast<int>(j) * HD
                                                           : cache_h + s * HD) +
                            c * kElems;
        cp_async16(dst + 16 * idx, live ? src : cache_h, live ? 16 : 0);
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // the queries of the warp's row group as A fragments (rows past T are 0).
  // The depth index of QK^T is permuted so that thread t4 owns the D/4
  // consecutive values from t4*D/4 of every column: k-step j, slots
  // {2t4, 2t4+1, 2t4+8, 2t4+9} are depths t4*D/4 + 4j + {0, 1, 2, 3}.
  // With an int8 cache the products run in fp16 (int8 K is exact there, at
  // 5 instructions per 4 values against bf16's 11): each q row is scaled by
  // the power of two that lifts its largest |q| into [2^14, 2^15), where
  // every bf16 value within 2^28 of that largest one is an exact fp16, and
  // the scores are scaled back exactly (qi0, qi1: rows g and g+8)
  uint32_t qa[kNK][4];
  float qi0 = 1.f, qi1 = 1.f;
  {
    uint32_t w0[kQW], w1[kQW];
    const int r0 = t0 + 16 * rg + g;
#pragma unroll
    for (int i = 0; i < kQW; ++i) {
      const __nv_bfloat16* base =
          q + static_cast<int64_t>(b) * T * HD + hoff + t4 * (kD / 4) + 2 * i;
      const int64_t o0 = static_cast<int64_t>(r0) * HD, o1 = o0 + 8 * HD;
      w0[i] = r0 < T ? *reinterpret_cast<const uint32_t*>(base + o0) : 0u;
      w1[i] = r0 + 8 < T ? *reinterpret_cast<const uint32_t*>(base + o1) : 0u;
    }
    if constexpr (kQuant) {
      float x0 = 0.f, x1 = 0.f;  // the rows' largest |q| (a row spans a quad)
#pragma unroll
      for (int i = 0; i < kQW; ++i) {
        x0 = fmaxf(x0, fmaxf(fabsf(bf16_lo(w0[i])), fabsf(bf16_hi(w0[i]))));
        x1 = fmaxf(x1, fmaxf(fabsf(bf16_lo(w1[i])), fabsf(bf16_hi(w1[i]))));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, o));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, o));
      }
      // x < 2^e with e from the exponent bits (e >= -100: a row of zeros
      // or of subnormals keeps finite factors); 2^n built from its bits
      const int e0 = max(((__float_as_int(x0) >> 23) & 0xff) - 126, -100);
      const int e1 = max(((__float_as_int(x1) >> 23) & 0xff) - 126, -100);
      const float s0 = __int_as_float((127 + 15 - e0) << 23);
      const float s1 = __int_as_float((127 + 15 - e1) << 23);
      qi0 = __int_as_float((127 - 15 + e0) << 23);
      qi1 = __int_as_float((127 - 15 + e1) << 23);
#pragma unroll
      for (int i = 0; i < kQW; ++i) {
        w0[i] = pack_f16(bf16_lo(w0[i]) * s0, bf16_hi(w0[i]) * s0);
        w1[i] = pack_f16(bf16_lo(w1[i]) * s1, bf16_hi(w1[i]) * s1);
      }
    }
#pragma unroll
    for (int j = 0; j < kNK; ++j) {
      qa[j][0] = w0[2 * j];
      qa[j][1] = w1[2 * j];
      qa[j][2] = w0[2 * j + 1];
      qa[j][3] = w1[2 * j + 1];
    }
  }
  // scores are kept in log2 units, x * log2(e), so that the softmax takes
  // exp2 (one hardware instruction): exp(x - m) = exp2((x - m) log2(e))
  const float sm_scale = 1.f / sqrtf(static_cast<float>(kD)) * 1.4426950408889634f;

  // PV accumulators: n-tile j, slot n = g is depth g*D/8 + j (this
  // thread's D/8 consecutive values of every V column); the warp holds the
  // n-tiles npart*kNTw + jj, jj < kNTw
  float acc[kNTw][4];
#pragma unroll
  for (int j = 0; j < kNTw; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int ra = 16 * rg + g;  // the thread's rows in the block: ra, ra + 8
  const bool on0 = ra < nq, on1 = ra + 8 < nq;  // live query rows
  const int qp0 = len + t0 + ra, qp1 = qp0 + 8;  // their positions
  float mx0 = -INFINITY, mx1 = -INFINITY;  // their largest scores so far
  float m0 = 0.f, m1 = 0.f;  // their multipliers of P (0 past nq)

  for (int i = 0; i < 2 * n_live; ++i) {
    __syncthreads();                // every warp is done with tile i-1's buffer
    issue(i + kStages - 1);         // ... which now receives tile i+kStages-1
    cp_async_wait<kStages - 1>();   // tile i has landed (this thread's pieces)
    __syncthreads();                // ... and every thread's
    const unsigned char* tile = ring + (i % kStages) * kTile;
    if (i < n_live) {
      // ---- 4. scores of this tile: S = Q K^T on the tensor cores, the
      // warp's n-tiles nt = cs + kNcs*n, kGrp of them at a time
      const int c0 = live_s[i] * kCH;
      for (int n0 = 0; n0 < kNTs; n0 += kGrp) {
        uint32_t kw[kGrp][(kKB + 3) / 4];
        float sc[kGrp][4];
#pragma unroll
        for (int n = 0; n < kGrp; ++n) {
          load_bytes<kKB>(tile + (8 * (cs + kNcs * (n0 + n)) + g) * kD * kItem + t4 * kKB, kw[n]);
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < kNK; ++j)
#pragma unroll
          for (int n = 0; n < kGrp; ++n) {
            uint32_t b0, b1;
            if constexpr (kQuant) {
              s8x4_to_f16(kw[n][j], b0, b1);
              mma_f16(sc[n], qa[j], b0, b1);
            } else {
              mma_bf16(sc[n], qa[j], kw[n][2 * j], kw[n][2 * j + 1]);
            }
          }
        // C: rows ra, ra+8, columns 2t4, 2t4+1 of the n-tile: x = q.k x
        // k_scale x log2(e)/sqrt(D), -inf where col_pos > the query's position,
        // stored, and the rows' running maxima; rows past nq are neither
        // stored nor read
#pragma unroll
        for (int n = 0; n < kGrp; ++n) {
          const int s = c0 + 8 * (cs + kNcs * (n0 + n)) + 2 * t4;
          const float k0 = kQuant ? ks_s[s] : 1.f, k1 = kQuant ? ks_s[s + 1] : 1.f;
          const int cp0 = cp_s[s], cp1 = cp_s[s + 1];
          if (on0) {
            const float x0 = cp0 <= qp0 ? sc[n][0] * qi0 * k0 * sm_scale : -INFINITY;
            const float x1 = cp1 <= qp0 ? sc[n][1] * qi0 * k1 * sm_scale : -INFINITY;
            *reinterpret_cast<float2*>(p_s + ra * PS + s) = make_float2(x0, x1);
            mx0 = fmaxf(mx0, fmaxf(x0, x1));
          }
          if (on1) {
            const float x0 = cp0 <= qp1 ? sc[n][2] * qi1 * k0 * sm_scale : -INFINITY;
            const float x1 = cp1 <= qp1 ? sc[n][3] * qi1 * k1 * sm_scale : -INFINITY;
            *reinterpret_cast<float2*>(p_s + (ra + 8) * PS + s) = make_float2(x0, x1);
            mx1 = fmaxf(mx1, fmaxf(x0, x1));
          }
        }
      }
      if (i == n_live - 1) {
        // ---- 5. exact fp32 softmax over the live tiles. The row maximum m
        // comes from the warps' running maxima (a quad holds a row's
        // columns of a warp); then one pass over the score rows in shared
        // memory, 8 lanes per query row, 4 rows of a warp at once, 8
        // independent columns per lane and tile: e = exp2(x - m), their
        // sum, and (int8 mode) e x v_scale stored. The normalization 1/sum
        // is applied when PV reads the row; in int8 mode with the power of
        // two f that lifts the row's largest probability into [2^14,
        // 2^15), so its fp16 rounding stays clear of fp16's subnormals,
        // and the output is multiplied by 1/f (exact). A row whose every
        // column is dead reads nothing: 0, not NaN
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
        }
        if (t4 == 0) {
          if (on0) rmax_s[cs * kR + ra] = mx0;
          if (on1) rmax_s[cs * kR + ra + 8] = mx1;
        }
        __syncthreads();
        const int sub = lane >> 3, l8 = lane & 7;
        for (int r0 = 4 * warp; r0 < nq; r0 += 4 * kWarpsM) {
          const bool on = r0 + sub < nq;
          const int r = on ? r0 + sub : r0;  // idle lanes reread row r0
          float* pr = p_s + r * PS + l8;
          float m = -INFINITY;
#pragma unroll
          for (int c = 0; c < kNcs; ++c) m = fmaxf(m, rmax_s[c * kR + r]);
          float sum = 0.f, pmax = 0.f;
          for (int li = 0; li < n_live; ++li) {
            const int c0 = live_s[li] * kCH + l8;
            float* t = pr + live_s[li] * kCH;
            float e[kCH / 8];
#pragma unroll
            for (int k = 0; k < kCH / 8; ++k) e[k] = t[8 * k];
#pragma unroll
            for (int k = 0; k < kCH / 8; ++k) {
              e[k] = m == -INFINITY ? 0.f : exp2f(e[k] - m);  // exp2(-inf) = 0
              sum += e[k];
              if constexpr (kQuant) e[k] *= vs_s[c0 + 8 * k];
              pmax = fmaxf(pmax, e[k]);
            }
            if (on) {
#pragma unroll
              for (int k = 0; k < kCH / 8; ++k) t[8 * k] = e[k];
            }
          }
#pragma unroll
          for (int o = 1; o < 8; o <<= 1) {
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
            pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
          }
          if (on && l8 == 0) {
            const float inv = sum > 0.f ? 1.f / sum : 0.f;
            float f = 1.f;
            if (kQuant && pmax > 0.f) {
              int ex = 0;
              frexpf(pmax * inv, &ex);  // pmax / sum < 2^ex
              f = ldexpf(1.f, 15 - max(ex, -100));
            }
            rowa_s[r] = inv * f;
            rowo_s[r] = 1.f / f;
          }
        }
      }
    } else {
      // ---- 6. O += P V on the tensor cores: int8 V in fp16 (exact) with P
      // x the row factor rounded to fp16; bf16 V with P split into bf16
      // hi + lo (two products). The column index is permuted so that
      // thread t4 takes columns t4 + {0, 4, 8, 12} of each 16: k-step
      // slots {2t4, 2t4+1, 2t4+8, 2t4+9} are columns t4 + {0, 4, 8, 12}
      const int c0 = live_s[i - n_live] * kCH;
      if (i == n_live) {
        m0 = on0 ? rowa_s[ra] : 0.f;
        m1 = on1 ? rowa_s[ra + 8] : 0.f;
      }
      for (int kk = kpart; kk < kCH / 16; kk += kKS) {
        const int s0 = 16 * kk + t4;  // tile column of slot 2t4
        uint32_t vw[4][(kVBw + 3) / 4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          load_bytes<kVBw>(tile + (s0 + 4 * u) * kD * kItem + g * kVB + npart * kVBw, vw[u]);
          if constexpr (kQuant) {
#pragma unroll
            for (int w = 0; w < (kVBw + 3) / 4; ++w) vw[u][w] ^= 0x80808080u;
          }
        }
        const float* pa = p_s + ra * PS + c0 + s0;
        const float* pb = pa + 8 * PS;
        float pv[2][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // P of rows past nq is never read
          pv[0][u] = on0 ? pa[4 * u] * m0 : 0.f;
          pv[1][u] = on1 ? pb[4 * u] * m1 : 0.f;
        }
        uint32_t a[4], alo[4];
        if constexpr (kQuant) {
          a[0] = pack_f16(pv[0][0], pv[0][1]);
          a[1] = pack_f16(pv[1][0], pv[1][1]);
          a[2] = pack_f16(pv[0][2], pv[0][3]);
          a[3] = pack_f16(pv[1][2], pv[1][3]);
        } else {
          a[0] = pack_bf16(pv[0][0], pv[0][1]);
          a[1] = pack_bf16(pv[1][0], pv[1][1]);
          a[2] = pack_bf16(pv[0][2], pv[0][3]);
          a[3] = pack_bf16(pv[1][2], pv[1][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e & 1, cc = (e >> 1) * 2;
            alo[e] = pack_bf16(pv[rr][cc] - bf16_lo(a[e]), pv[rr][cc + 1] - bf16_hi(a[e]));
          }
        }
#pragma unroll
        for (int j = 0; j < kNTw; ++j) {
          uint32_t b0, b1;
          if constexpr (kQuant) {
            b0 = u8_pair_to_f16(vw[0][j / 4], vw[1][j / 4], j % 4);
            b1 = u8_pair_to_f16(vw[2][j / 4], vw[3][j / 4], j % 4);
            mma_f16(acc[j], a, b0, b1);
          } else {
            const int sel = j % 2 ? 0x7632 : 0x5410;
            b0 = __byte_perm(vw[0][j / 2], vw[1][j / 2], sel);
            b1 = __byte_perm(vw[2][j / 2], vw[3][j / 2], sel);
            mma_bf16(acc[j], a, b0, b1);
            mma_bf16(acc[j], alo, b0, b1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- 7. the warps' partial sums meet in the probability buffer; rows
  // of the block past T are not written
  __syncthreads();
  constexpr int kRS = kD + 1;  // odd row stride: at most 2-way bank conflicts
  float* red_s = p_s;          // [kKS][PR][kRS]
#pragma unroll
  for (int j = 0; j < kNTw; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ra + (e >> 1) * 8;
      const int d = (2 * t4 + (e & 1)) * kNT + npart * kNTw + j;
      if (r < nq) red_s[(kpart * PR + r) * kRS + d] = acc[j][e];
    }
  __syncthreads();
  for (int i = tid; i < nq * kD; i += kThreadsM) {
    const int r = i / kD;
    const int d = i - r * kD;
    float y = 0.f;
#pragma unroll
    for (int c = 0; c < kKS; ++c) y += red_s[(c * PR + r) * kRS + d];
    if (kQuant && n_live > 0) y *= rowo_s[r];  // 2^-k: exact
    ob[static_cast<int64_t>(r) * HD + d] = __float2bfloat16_rn(y);
  }
}

template <typename CacheT, int kD, int kWR>
int launch_mma_d(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
                 const void* k_scale, const void* v_scale, const void* col_pos,
                 const void* lengths, const void* cursor, void* out, int B, int T, int S, int H,
                 cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(S, kD, sizeof(CacheT), 16 * kWR, T);
  if (smem > kSmemLimit) return kTooLarge;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(spec_attention_mma_kernel<CacheT, kD, kWR>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = static_cast<int64_t>((T + 16 * kWR - 1) / (16 * kWR)) * H * B;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  spec_attention_mma_kernel<CacheT, kD, kWR>
      <<<static_cast<unsigned>(blocks), 32 * mma_warps(16 * kWR), smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<CacheT*>(k),
          static_cast<CacheT*>(v), static_cast<const CacheT*>(k_slab),
          static_cast<const CacheT*>(v_slab), static_cast<const __nv_bfloat16*>(k_scale),
          static_cast<const __nv_bfloat16*>(v_scale), static_cast<const int32_t*>(col_pos),
          static_cast<const int32_t*>(lengths), static_cast<const int32_t*>(cursor),
          static_cast<__nv_bfloat16*>(out), T, S, H);
  return cudaGetLastError();
}

// The regime: 64 query rows per block (refresh) for T > 16 where those
// buffers fit shared memory, else 16 (verify, and a refresh over a long
// cache). The head size is a template parameter: 16, 32, 64 or 128
template <typename CacheT>
int launch_mma(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
               const void* k_scale, const void* v_scale, const void* col_pos,
               const void* lengths, const void* cursor, void* out, int B, int T, int S, int H,
               int D, cudaStream_t stream) {
  const bool refresh = T > 16 && mma_smem_bytes(S, D, sizeof(CacheT), 64, T) <= kSmemLimit;
#define SPEC_MMA_LAUNCH(DD)                                                                  \
  case DD:                                                                                   \
    return refresh ? launch_mma_d<CacheT, DD, 4>(q, k, v, k_slab, v_slab, k_scale, v_scale,  \
                                                 col_pos, lengths, cursor, out, B, T, S, H,  \
                                                 stream)                                     \
                   : launch_mma_d<CacheT, DD, 1>(q, k, v, k_slab, v_slab, k_scale, v_scale,  \
                                                 col_pos, lengths, cursor, out, B, T, S, H,  \
                                                 stream);
  switch (D) {
    SPEC_MMA_LAUNCH(16)
    SPEC_MMA_LAUNCH(32)
    SPEC_MMA_LAUNCH(64)
    SPEC_MMA_LAUNCH(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef SPEC_MMA_LAUNCH
}

}  // namespace

// Plain C entry point (loaded with ctypes). Every pointer is a device
// pointer to a contiguous tensor. k_slab, v_slab and cursor are null for the
// attention alone (K3) and all set for the write + attention (K2);
// k_scale/v_scale are null in bf16-cache mode; int8_dots needs quantized.
// Returns the cudaError_t of the launch (0 = launched), or -1 without
// launching when the block's buffers exceed shared memory.
extern "C" int spec_attention_launch(const void* q, void* k, void* v, const void* k_slab,
                                     const void* v_slab, const void* k_scale,
                                     const void* v_scale, const void* col_pos,
                                     const void* lengths, const void* cursor, void* out, int B,
                                     int T, int S, int H, int D, int quantized, int int8_dots,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_dots && !quantized) return static_cast<int>(cudaErrorInvalidValue);
  if (int8_dots)
    return launch_dots(q, k, v, k_slab, v_slab, k_scale, v_scale, col_pos, lengths, cursor, out,
                       B, T, S, H, D, st);
  if (quantized)
    return launch_mma<int8_t>(q, k, v, k_slab, v_slab, k_scale, v_scale, col_pos, lengths,
                              cursor, out, B, T, S, H, D, st);
  return launch_mma<__nv_bfloat16>(q, k, v, k_slab, v_slab, k_scale, v_scale, col_pos, lengths,
                                   cursor, out, B, T, S, H, D, st);
}
