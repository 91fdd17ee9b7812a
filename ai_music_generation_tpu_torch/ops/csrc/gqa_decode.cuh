// One T=1 grouped-query decode step over a flat KV cache: the fresh K/V
// column is written (int8 mode: quantized first) and all H query heads
// attend over the cache, in one kernel. This kernel serves G = H/KH > 1;
// gqa_decode.cu's entry point sends G = 1 (multi-head attention, one query
// head per kv-head) to gqa_decode_mha.cuh, whose warp-per-row design (no
// block barrier, tiles of 32 columns, an online softmax, no limit on S)
// serves one query a kv-head better than this block of 128 threads.
//
// Replaces the TPU kernel ai_music_generation_tpu/ops/gqa_decode.py::
// _gqa_decode_update (Pallas). The contract and the plain PyTorch twin live
// in ai_music_generation_tpu_torch/ops/gqa_decode.py.
//
// What bounds it: device-memory bytes. At the batched decode shape
// (B=4096, S=128, KH=2, D=64, int8 cache) one call reads the K and V caches,
// B*S*KH*D*2 bytes = 128 MiB, plus 2*B*KH*S*2 bytes = 4 MiB of bf16 scales,
// and does about 2 FLOP per cache byte, far below the ~295 FLOP/byte where
// an H100 becomes compute-bound. A block holds only a few KB of a row, so
// the card reaches its memory rate only when every block has all of its
// bytes in flight at once.
//
// Design:
// - one block of 128 threads per (row b, kv-head kh): the G = H/KH query
//   heads of a group read the same K/V slices, and the int8 quantize of the
//   fresh column is per (row, kv-head), so the block needs nothing from the
//   other kv-heads;
// - column order: every column the block works on is a LOGICAL index l:
//   in lockstep mode the column itself; in ring mode the l-th column of the
//   row's window, oldest first (the window is the n = mask_rel[b, pos] + 1
//   columns up to the fresh one at pos, capped at S: physical column
//   (pos + 1 - n + l) mod S, the fresh one l = n-1; the rest follow).
//   The scores and every sum run in that order, so a ring row's result
//   does not depend on where the shared cursor stands (a served request
//   gives the same bits in any slot, at any time), and a ring row that
//   started at column 0 sums as a lockstep row. Streamed tiles (S > 128)
//   are staged in that order too; a row of one tile (S <= 128) is staged
//   by physical column and read at l's physical row, so its copies, like
//   the mask and scale loads, are issued before the window start (a load
//   of mask_rel[b, pos]) is known (experiments/k1_ab.py times the order
//   against another version of this source);
// - fetch: the live columns ([0, pos] in lockstep mode, those with
//   mask_rel >= 0 in ring mode) stream through a ring of two staged tiles of
//   128 columns in shared memory, the K tiles and then the V tiles, copied
//   with cp.async 16-byte pieces by every thread; the next tile is in flight
//   while the current one is used. At the bench shape (S=128) a row's K and
//   V are one tile each, so all of its bytes are in flight before any
//   arithmetic; a long cache (S=1024 and past) costs only the ring, the
//   fp32 scores and the per-column scales. Masked columns are never read;
// - the fresh column is quantized in the block (one warp for K, one for V)
//   and goes from registers into its own shared-memory row and to the cache
//   in global memory; it is never read back, so no global write has to
//   become visible to an async copy;
// - scores: one thread per column of a K tile reads its K slice as 16-byte
//   shared-memory vectors (rows padded by 16 bytes: conflict-free) and forms
//   the dots of all G query heads from that one read (up to 4 heads a pass:
//   more accumulators cost registers, and so blocks on an SM) on CUDA
//   cores: 2*G FLOP per byte needs no tensor core;
// - softmax: after the last K tile, fp32, one warp per query head, exact
//   (max, exp, sum) over the scores of every column kept in shared memory;
// - PV: thread (c, j) of a V tile takes 16-byte chunk c of the head size and
//   the tile's columns j (mod 128/chunks), reading V from shared memory;
//   per tile, lanes of a warp with the same chunk meet by warp shuffles and
//   add into the warp's partial sums in shared memory; the 4 warps' sums
//   meet at the end.
//
// Numerics: scores and PV in fp32 (the cache values converted exactly), the
// output rounded once to q's type; the int8 quantize of the fresh column is
// bit-exact with models/gpt.py::quantize_int8 (fp32 abs-max, IEEE
// max(m, 1e-6) / 127, rintf, clip to +-127, bf16 scale).
//
// Types: q, the fresh slabs and the output share one type QT, bf16 or fp32
// (an fp32 model), as the Pallas kernel computes in q's dtype; the cache is
// int8 (with bf16 scales) or QT. Everything inside is fp32 either way, so
// the fp32 instantiation differs only in its loads and its final store (an
// fp32 cache stages 4 values per 16-byte piece instead of 8 or 16).
//
// Sources: gqa_decode.cu instantiates the lockstep kernels and holds the C
// entry point; gqa_decode_ring.cu the ring ones, in its own nvcc process.
// The S limit: smem_bytes grows by G + 3 floats a column, so S reaches
// about 8,000 at G = 3 before a block's buffers pass shared memory.
//
// Build with nvcc -gencode arch=compute_90a,code=sm_90a and WITHOUT
// --use_fast_math: the int8 scale must be an IEEE division (and rintf
// round-half-even) to stay bit-exact with models/gpt.py::quantize_int8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGPass = 4;  // query heads whose dots one K read feeds (a pass)
constexpr int kCH = kThreads;  // columns per staged tile: one per thread in the scores
constexpr int kStages = 2;     // staged tiles in shared memory (the ring)
constexpr size_t kSmemLimit = 227 * 1024;
constexpr int kTooLarge = -1;  // returned when a block's buffers exceed shared memory

// bytes of one padded K or V row in shared memory
template <typename CacheT, int kD>
__host__ __device__ constexpr int row_bytes() {
  return kD * static_cast<int>(sizeof(CacheT)) + 16;
}

// Dynamic shared memory, in order: the ring [kStages][kCH][row_bytes], the
// fresh column's K and V rows [2][row_bytes], then fp32 q [G*D],
// scores/probabilities [G*S], k and v scales [S] each, each logical column's
// staged row or -1 where it is masked [S] (int), and the 4 warps' PV partial sums [4][G*D].
template <typename CacheT, int kD>
size_t smem_bytes(int S, int G) {
  return static_cast<size_t>(kStages * kCH + 2) * row_bytes<CacheT, kD>() +
         sizeof(float) * (static_cast<size_t>(G) * kD + static_cast<size_t>(G) * S +
                          3 * static_cast<size_t>(S) + kWarps * static_cast<size_t>(G) * kD);
}

// Grid: one block per (row b, kv-head kh), kh fastest. kStream: the row
// has more than one tile of columns (S > kCH), so tiles past the first K
// and V tile are issued as the ring frees; without it the two tiles issued
// first are the whole row, and the kernel keeps no copy state live (fewer
// registers: 8 blocks on an SM). kRing: ring mode (mask_rel given); the
// lockstep instantiations carry no window arithmetic and no mask test.
// Registers are capped for 8 blocks.
template <typename QT, typename CacheT, int kD, bool kStream, bool kRing>
__global__ void __launch_bounds__(kThreads, 8) gqa_decode_kernel(
    const QT* __restrict__ q,                  // [B, H, D]
    CacheT* __restrict__ k,                    // [B, S, KH*D], written at pos
    CacheT* __restrict__ v,                    // [B, S, KH*D], written at pos
    const QT* __restrict__ k_slab,             // [B, KH*D] fresh column
    const QT* __restrict__ v_slab,             // [B, KH*D] fresh column
    __nv_bfloat16* __restrict__ k_scale,       // [B, KH, S] (int8 mode) or null
    __nv_bfloat16* __restrict__ v_scale,       // [B, KH, S] (int8 mode) or null
    const int32_t* __restrict__ mask_rel,      // [B, S] (ring mode) or null
    const int32_t* __restrict__ pos_ptr,       // scalar: column written this step
    QT* __restrict__ out,                      // [B, H, D]
    int S, int H, int KH) {
  constexpr bool kQuant = std::is_same<CacheT, int8_t>::value;
  constexpr int kElems = 16 / sizeof(CacheT);  // cache values per 16 bytes
  constexpr int kChunks = kD / kElems;         // 16-byte chunks per slice
  constexpr int kRow = row_bytes<CacheT, kD>();
  constexpr int kTile = kCH * kRow;            // bytes of one staged tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / KH;
  unsigned char* ring = smem_raw;
  unsigned char* kf_s = ring + kStages * kTile;  // the fresh column's K
  unsigned char* vf_s = kf_s + kRow;             // ... and V
  float* q_s = reinterpret_cast<float*>(vf_s + kRow);
  float* p_s = q_s + G * kD;
  float* ks_s = p_s + G * S;
  float* vs_s = ks_s + S;
  int* valid_s = reinterpret_cast<int*>(vs_s + S);
  float* red_s = reinterpret_cast<float*>(valid_s + S);

  const int b = blockIdx.x / KH;
  const int kh = blockIdx.x - b * KH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = *pos_ptr;
  const int KHD = KH * kD;
  const int64_t row0 = static_cast<int64_t>(b) * S * KHD + kh * kD;  // column 0, head kh
  QT* ob = out + (static_cast<int64_t>(b) * H + kh * G) * kD;

  if (pos < 0 || pos >= S) {
    // no column to write: write nothing and make the output NaN, so a
    // caller that broke the length < S invariant cannot miss it
    for (int i = tid; i < G * kD; i += kThreads) ob[i] = from_float<QT>(NAN);
    return;
  }
  const int32_t* mrow = kRing ? mask_rel + static_cast<int64_t>(b) * S : nullptr;
  // columns a query may read: [0, pos] in lockstep mode, any in ring mode;
  // logical column l sits at physical column phys(l), the fresh one at lpos
  const int n_cols = kRing ? S : pos + 1;
  const int n_win = kRing ? min(max(mrow[pos] + 1, 1), S) : pos + 1;
  const int start = kRing ? (pos + 1 - n_win + S) % S : 0;
  const int lpos = n_win - 1;
  auto phys = [&](int l) { return !kRing ? l : l < S - start ? start + l : start + l - S; };
  const int n_t = (n_cols + kCH - 1) / kCH;  // tiles of K, and of V
  // the staged row of logical column l: streamed tiles hold logical columns
  // in order (row l % kCH); the one K and one V tile of a row that fits
  // (!kStream) hold physical columns (row phys(l), kept in valid_s), so its
  // fetch needs no window start (no load of mask_rel[b, pos] before the
  // copies are issued)
  constexpr bool kRowMap = kRing && !kStream;

  // ---- 1. tile i (K tiles 0 .. n_t-1, then V tiles) into ring slot
  // i % kStages: every live column but the fresh one; one commit group per
  // tile (an empty one past the last keeps the count uniform). Thread
  // (c, j) copies 16-byte chunk c of the tile's columns j (mod kSlices):
  // the pieces PV reads from it later
  constexpr int kSlices = kThreads / kChunks;
  const int c = tid % kChunks;
  const int j = tid / kChunks;
  auto issue = [&](int i) {
    if (i < 2 * n_t) {
      const bool is_v = i >= n_t;
      const int s0 = (is_v ? i - n_t : i) * kCH + j;  // the thread's first column
      const CacheT* src = (is_v ? v : k) + row0 + c * kElems;
      unsigned char* dst = ring + (i % kStages) * kTile + j * kRow + 16 * c;
#pragma unroll
      for (int m = 0; m < kCH / kSlices; ++m) {
        const int s = s0 + m * kSlices;  // logical (kStream) or physical column
        if (s >= n_cols || s == (kStream ? lpos : pos)) continue;
        const int ps = kStream ? phys(s) : s;
        if (kRing && mrow[ps] < 0) continue;
        cp_async16(dst + m * kSlices * kRow, src + static_cast<int64_t>(ps) * KHD);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < kStages; ++i) issue(i);

  // ---- 2. the fresh column into the cache and into its shared-memory
  // rows, from registers; meanwhile q, the scales, the column validity and
  // zeroed PV partial sums
  if (warp < 2) {
    const bool is_v = warp == 1;
    const QT* src = (is_v ? v_slab : k_slab) + static_cast<int64_t>(b) * KHD + kh * kD;
    CacheT* dst = (is_v ? v : k) + row0 + static_cast<int64_t>(pos) * KHD;
    CacheT* dst_s = reinterpret_cast<CacheT*>(is_v ? vf_s : kf_s);
    if constexpr (kQuant) {
      // fp32 abs-max, s = max(m, 1e-6) / 127 (IEEE division), q =
      // clip(rint(x / s), -127, 127), bf16 scale (RN)
      float m = 0.f;
      for (int d = lane; d < kD; d += 32) m = fmaxf(m, fabsf(to_float(src[d])));
      const float s = fmaxf(warp_max(m), 1e-6f) / 127.f;
      for (int d = lane; d < kD; d += 32) {
        const float r = fminf(fmaxf(rintf(to_float(src[d]) / s), -127.f), 127.f);
        dst[d] = dst_s[d] = static_cast<int8_t>(r);
      }
      if (lane == 0) {
        const __nv_bfloat16 sb = __float2bfloat16_rn(s);
        (is_v ? v_scale : k_scale)[(static_cast<int64_t>(b) * KH + kh) * S + pos] = sb;
        (is_v ? vs_s : ks_s)[lpos] = __bfloat162float(sb);
      }
    } else {
      for (int d = lane; d < kD; d += 32) dst[d] = dst_s[d] = src[d];
    }
  } else {
    const int t = tid - 64;
    const QT* qb = q + (static_cast<int64_t>(b) * H + kh * G) * kD;
    for (int i = t; i < G * kD; i += kThreads - 64) q_s[i] = to_float(qb[i]);
    for (int i = t; i < kWarps * G * kD; i += kThreads - 64) red_s[i] = 0.f;
    const int64_t srow = (static_cast<int64_t>(b) * KH + kh) * S;
    // by physical column p (its loads wait for no window start), kept at
    // its logical index s
    for (int p = t; p < n_cols; p += kThreads - 64) {
      const bool valid = !kRing || mrow[p] >= 0;
      const int s = !kRing ? p : p >= start ? p - start : p - start + S;
      valid_s[s] = valid ? p : -1;
      if (kQuant && valid && p != pos) {
        ks_s[s] = __bfloat162float(k_scale[srow + p]);
        vs_s[s] = __bfloat162float(v_scale[srow + p]);
      }
    }
  }

  // tile i has landed in its ring slot, for every thread: before that
  // (kStream), every warp is done with tile i-1's slot, which receives tile
  // i+kStages-1 (tiles 0 .. kStages-1 were issued above)
  auto next_tile = [&](int i) -> const unsigned char* {
    if constexpr (kStream) {
      if (i > 0) {
        __syncthreads();
        issue(i + kStages - 1);
      }
      cp_async_wait<kStages - 1>();
    } else if (i > 0) {  // i = 1, the V tile: the last group
      cp_async_wait<0>();
    } else {
      cp_async_wait<kStages - 1>();
    }
    __syncthreads();
    return ring + (i % kStages) * kTile;
  };

  // ---- 3. scores of each K tile, one thread per column, all G heads from
  // one K read
  const float sm_scale = 1.f / sqrtf(static_cast<float>(kD));
  for (int i = 0; i < n_t; ++i) {
    const unsigned char* tile = next_tile(i);
    const int s = i * kCH + tid;
    if (s >= n_cols) continue;
    const int row = valid_s[s];
    if (row < 0) {
      for (int g = 0; g < G; ++g) p_s[g * S + s] = -INFINITY;
      continue;
    }
    const int4* kr =
        reinterpret_cast<const int4*>(s == lpos ? kf_s : tile + (kRowMap ? row : tid) * kRow);
    for (int g0 = 0; g0 < G; g0 += kGPass) {
      float acc[kGPass];
#pragma unroll
      for (int g = 0; g < kGPass; ++g) acc[g] = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float kv[kElems];
        unpack(kr[c], kv);
#pragma unroll
        for (int g = 0; g < kGPass; ++g) {
          if (g0 + g >= G) break;
          const float4* qr = reinterpret_cast<const float4*>(q_s + (g0 + g) * kD + c * kElems);
          float a = acc[g];
#pragma unroll
          for (int e = 0; e < kElems / 4; ++e) {
            const float4 qq = qr[e];
            a = fmaf(qq.x, kv[4 * e], a);
            a = fmaf(qq.y, kv[4 * e + 1], a);
            a = fmaf(qq.z, kv[4 * e + 2], a);
            a = fmaf(qq.w, kv[4 * e + 3], a);
          }
          acc[g] = a;
        }
      }
#pragma unroll
      for (int g = 0; g < kGPass; ++g)
        if (g0 + g < G) p_s[(g0 + g) * S + s] = kQuant ? acc[g] * ks_s[s] * sm_scale
                                                       : acc[g] * sm_scale;
    }
  }
  __syncthreads();

  // ---- 4. fp32 softmax per query head (one warp per head) over every
  // column's score, x v_scale; a head whose every column is masked reads
  // nothing (probabilities 0)
  for (int g = warp; g < G; g += kWarps) {
    float* ph = p_s + g * S;
    float m = -INFINITY;
    for (int s = lane; s < n_cols; s += 32) m = fmaxf(m, ph[s]);
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < n_cols; s += 32) {
      const float e = m == -INFINITY ? 0.f : expf(ph[s] - m);  // exp(-inf) = 0
      ph[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    for (int s = lane; s < n_cols; s += 32) {
      float p = ph[s] * inv;
      if constexpr (kQuant) p *= vs_s[s];
      ph[s] = p;
    }
  }

  // ---- 5. PV over each V tile: thread (chunk c, column slice j); masked
  // columns unread. Per tile, the lanes of a warp with the same chunk (the
  // same d) meet by shuffles and add into the warp's partial sums
  for (int i = n_t; i < 2 * n_t; ++i) {
    const unsigned char* tile = next_tile(i);
    const int c0 = (i - n_t) * kCH;
    for (int g = 0; g < G; ++g) {
      const float* ph = p_s + g * S;
      float acc[kElems];
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[e] = 0.f;
#pragma unroll
      for (int m = 0; m < kCH / kSlices; ++m) {
        const int cl = j + m * kSlices;
        const int s = c0 + cl;
        if (s >= n_cols) continue;
        const int row = valid_s[s];
        if (row < 0) continue;
        float vv[kElems];
        unpack(*reinterpret_cast<const int4*>(
                   (s == lpos ? vf_s : tile + (kRowMap ? row : cl) * kRow) + 16 * c),
               vv);
        const float p = ph[s];
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
      }
#pragma unroll
      for (int o = kChunks; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
      if (lane < kChunks) {
        float* r = red_s + (warp * G + g) * kD + c * kElems;
#pragma unroll
        for (int e = 0; e < kElems; ++e) r[e] += acc[e];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < G * kD; i += kThreads) {
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) y += red_s[w * G * kD + i];
    ob[i] = from_float<QT>(y);
  }
}

template <typename QT, typename CacheT, int kD, bool kStream, bool kRing>
int launch_k(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
             void* k_scale, void* v_scale, const void* mask_rel, const void* pos, void* out,
             int B, int S, int H, int KH, cudaStream_t stream) {
  const size_t smem = smem_bytes<CacheT, kD>(S, H / KH);
  if (smem > kSmemLimit) return kTooLarge;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(gqa_decode_kernel<QT, CacheT, kD, kStream, kRing>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = static_cast<int64_t>(B) * KH;
  if (blocks < 1 || blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  gqa_decode_kernel<QT, CacheT, kD, kStream, kRing>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<CacheT*>(k), static_cast<CacheT*>(v),
      static_cast<const QT*>(k_slab), static_cast<const QT*>(v_slab),
      static_cast<__nv_bfloat16*>(k_scale), static_cast<__nv_bfloat16*>(v_scale),
      static_cast<const int32_t*>(mask_rel), static_cast<const int32_t*>(pos),
      static_cast<QT*>(out), S, H, KH);
  return cudaGetLastError();
}

template <typename QT, typename CacheT, int kD, bool kRing>
int launch_d(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
             void* k_scale, void* v_scale, const void* mask_rel, const void* pos, void* out,
             int B, int S, int H, int KH, cudaStream_t stream) {
  return S > kCH ? launch_k<QT, CacheT, kD, true, kRing>(q, k, v, k_slab, v_slab, k_scale,
                                                         v_scale, mask_rel, pos, out, B, S, H,
                                                         KH, stream)
                 : launch_k<QT, CacheT, kD, false, kRing>(q, k, v, k_slab, v_slab, k_scale,
                                                          v_scale, mask_rel, pos, out, B, S, H,
                                                          KH, stream);
}

// the head size is a template parameter: 16, 32, 64 or 128
template <typename QT, typename CacheT, bool kRing>
int launch(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
           void* k_scale, void* v_scale, const void* mask_rel, const void* pos, void* out, int B,
           int S, int H, int KH, int D, cudaStream_t stream) {
  if (KH < 1 || H % KH) return cudaErrorInvalidValue;
#define GQA_LAUNCH(DD)                                                                   \
  case DD:                                                                               \
    return launch_d<QT, CacheT, DD, kRing>(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel, \
                                           pos, out, B, S, H, KH, stream);
  switch (D) {
    GQA_LAUNCH(16)
    GQA_LAUNCH(32)
    GQA_LAUNCH(64)
    GQA_LAUNCH(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef GQA_LAUNCH
}

// the types and the head size of one call, in one mode
template <bool kRing>
int dispatch(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
             void* k_scale, void* v_scale, const void* mask_rel, const void* pos, void* out,
             int B, int S, int H, int KH, int D, int quantized, int fp32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GQA_TYPES(QT, CT)                                                                  \
  launch<QT, CT, kRing>(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel, pos, out, B, S, H, \
                        KH, D, st)
  if (fp32) return quantized ? GQA_TYPES(float, int8_t) : GQA_TYPES(float, float);
  return quantized ? GQA_TYPES(__nv_bfloat16, int8_t) : GQA_TYPES(__nv_bfloat16, __nv_bfloat16);
#undef GQA_TYPES
}

}  // namespace

// dispatch<true>, compiled in gqa_decode_ring.cu
int gqa_decode_ring_launch(const void* q, void* k, void* v, const void* k_slab,
                           const void* v_slab, void* k_scale, void* v_scale, const void* mask_rel,
                           const void* pos, void* out, int B, int S, int H, int KH, int D,
                           int quantized, int fp32, void* stream);
