// Speculative-verify attention over the flat spec KV cache: T query tokens
// per row, column s readable by query t iff col_pos[b, s] <= lengths[b] + t,
// optionally preceded by the write of the step's Tw-column K/V slab at the
// shared cursor. This source holds the entry point of a bf16 q (a bf16
// model): the tensor-core kernel of spec_attention_mma.cuh instantiated
// for bf16 q and output (its note gives the design, what bounds it and its
// numerics; spec_attention_f32.cu instantiates it for fp32), and the
// int8_dots mode's CUDA-core kernel.
//
// Replaces the TPU kernels ai_music_generation_tpu/ops/spec_attention.py::
// _spec_attention_update (slab write + attention) and _spec_attention
// (attention alone), which share their body _make_attend. The contract and
// the plain PyTorch twins live in ai_music_generation_tpu_torch/ops/
// spec_attention.py.
//
// int8_dots mode keeps its CUDA-core kernel (below): one block per (row,
// head, 8-query tile); q and the scaled probabilities quantized per (head,
// query) row exactly as the Pallas kernel does, both products in int32
// with __dp4a / integer multiply-adds; scores, softmax and the scales in
// fp32. No path calls it (models/gpt.py sets it only with
// spec_int8_dots=True).
//
// Build with nvcc -gencode arch=compute_90a,code=sm_90a and WITHOUT
// --use_fast_math: the int8_dots scales max(|x|, 1e-20) / 127 need an IEEE
// division and rintf (round half to even), and expf its full accuracy.

#include "spec_attention_mma.cuh"

namespace {

// ===========================================================================
// The int8_dots kernel (CUDA cores)
// ===========================================================================

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 8;      // queries per block
constexpr int kUnroll = 8;  // PV columns whose V loads are in flight together

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

}  // namespace

// Plain C entry point of a bf16 q (loaded with ctypes). Every pointer is a
// device pointer to a contiguous tensor. k_slab, v_slab and cursor are null for the
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
    return launch_mma<__nv_bfloat16, int8_t>(q, k, v, k_slab, v_slab, k_scale, v_scale,
                                             col_pos, lengths, cursor, out, B, T, S, H, D, st);
  return launch_mma<__nv_bfloat16, __nv_bfloat16>(q, k, v, k_slab, v_slab, k_scale, v_scale,
                                                  col_pos, lengths, cursor, out, B, T, S, H, D,
                                                  st);
}
