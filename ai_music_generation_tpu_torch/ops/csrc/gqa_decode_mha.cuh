// One T=1 decode step over a flat KV cache for multi-head attention (K1 at
// G = H/KH = 1: one query head per kv-head): the fresh K/V column is written
// (int8 mode: quantized first) and every head attends over the cache, in one
// kernel. gqa_decode.cu's entry point sends every call with H == KH here;
// G > 1 runs the kernel of gqa_decode.cuh.
//
// Replaces the TPU kernel ai_music_generation_tpu/ops/gqa_decode.py::
// _gqa_decode_update (Pallas) at G = 1. The contract and the plain PyTorch
// twin live in ai_music_generation_tpu_torch/ops/gqa_decode.py.
//
// What bounds it: device-memory bytes. A (row, head) reads S columns of D
// K values and D V values and does 4*D FLOP a column, ~1 FLOP per cache
// byte. At the models' steps (TunesFormer's char step B=1024, S=32, H=12;
// the MoE step B=256, S=256, H=6; GPT-2's B=256, S=1024, H=12; D=64, bf16)
// a call moves 100-800 MB, and the card reaches its memory rate only when
// each SM keeps tens of KB of copies in flight. gqa_decode.cuh's block of
// 128 threads a (row, kv-head) was laid out for G = 3 at S = 128: at G = 1
// it serves one query with four warps, 128-column tiles and 4-5 block
// barriers, whatever S is.
//
// Design:
// - a warp per (row b, head h), 4 warps a block (2 where a warp's buffers
//   are large: fp32 at D = 128). Each warp stages its own tiles of 32
//   columns (K and V) in its own shared memory with cp.async 16-byte copies,
//   in a ring of two (one where S <= 32: the row is one tile). Rows never
//   wait on each other: no block barrier on the way. Registers are capped
//   for as many blocks as shared memory holds on an SM, at most 6 (24
//   warps: the int8 cache's kernel at 80 registers, no spill);
// - each copy asks L2 for the 256-byte block around its 16 bytes: a
//   column's 128-byte slice of head h (bf16, D = 64) shares it with head
//   h ^ 1, whose warp runs beside this one;
// - column split: where the launch has few rows for its columns (fewer
//   than kSplitWarps warps; the MoE and GPT-2 steps), P = 2 or 4 warps of a
//   block share one row: warp w takes the row's tiles w, w+P, w+2P, ...
//   The warps of a row merge their (max, sum, accumulator) once at the end
//   through shared memory, after a barrier of the row's warps alone. P
//   depends on B*H and S only, never on pos or the mask;
// - tiles hold LOGICAL columns: in lockstep mode the column itself; in ring
//   mode the l-th column of the row's window, oldest first (the window is
//   the n = mask_rel[b, pos] + 1 columns up to the fresh one at pos, capped
//   at S: physical column (pos + 1 - n + l) mod S, the fresh one l = n-1;
//   the rest follow). Every sum runs in that order, and tiles, their
//   owners and the merge depend only on the logical index: a ring row's
//   output does not depend on where the cursor stands, and a ring row that
//   started at column 0 gives the lockstep row's bits (the same code
//   serves both modes). Masked columns are never copied; a tile with no
//   live column is skipped (it would change nothing); the mask of the next
//   tile is loaded a tile ahead, so copies wait on no mask load but the
//   first;
// - staged rows are not padded: 16-byte chunk c of a column's row sits at
//   chunk c ^ f(row), f spreading 8 consecutive rows over the 8 16-byte
//   slots of a 128-byte bank line, so the scores' reads (a lane a row) and
//   PV's (8 lanes a row) are conflict-free at every D and cache type;
// - scores: a lane per column, its K row read as 16-byte vectors, dotted
//   with q (fp32 in shared memory, broadcast reads) in fp32 in the order of
//   gqa_decode.cuh (x k_scale, then x log2(e)/sqrt(D): log2 units);
// - softmax: fp32, online: the warp's running max m and a per-lane running
//   sum, each tile's probabilities exp2(s - m) (x v_scale) handed to PV by
//   shuffles, the accumulator rescaled by exp2(m_old - m) when m grows
//   (exp2f in place of expf took 2.7% off the MoE step, where each warp
//   sums two tiles once they land). Nothing in shared memory grows with S,
//   so S has no limit here;
// - PV: lane (chunk c, group g) holds 16 bytes' worth of the head size (8
//   values at bf16, D = 64) and sums the tile's columns g, g + 32/chunks,
//   ...: V is read once, from shared memory; the groups meet by shuffles
//   once per row, not per tile;
// - the fresh column: the warp that owns its tile quantizes it (int8: fp32
//   abs-max, IEEE max(m, 1e-6) / 127, rintf, clip, bf16 scale, bit-exact
//   with models/gpt.py::quantize_int8 as gqa_decode.cuh does) and writes it
//   from registers to the cache and to a staged row of its own; it is never
//   read back from global memory.
//
// Numerics: fp32 throughout (cache values converted exactly), the output
// (sum_s e_s v_s) / (sum_s e_s) rounded once to q's type. It sums in
// another order than gqa_decode.cuh and the twin (online, per tile, split
// and merged): the CPU test test_torch_gqa_decode.py::
// test_mha_reduction_order_matches_the_twin follows this order in torch.
//
// Sources: gqa_decode_mha.cu instantiates the lockstep kernels and holds
// gqa_decode_mha_launch; gqa_decode_mha_ring.cu the ring ones, in its own
// nvcc process.
//
// Build with nvcc -gencode arch=compute_90a,code=sm_90a and WITHOUT
// --use_fast_math (the int8 scale's IEEE division, rintf).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTC = 32;  // columns per tile: one per lane in the scores
constexpr size_t kSmemLimit = 227 * 1024;
// split a row's columns over warps until the launch has this many warps
// (about five waves of 12 resident warps on each of 132 SMs). Timed with
// experiments/k1_ab.py: 16384 splits the TunesFormer ring step (12,288
// rows) and slows it 19%; no split slows the GPT-2 step 1% and the MoE
// step 3%
constexpr int64_t kSplitWarps = 8192;

template <typename CacheT, int kD>
struct Cols {
  static constexpr int kElems = 16 / static_cast<int>(sizeof(CacheT));  // values per 16 bytes
  static constexpr int kChunks = kD / kElems;  // 16-byte chunks of a column's row
  static constexpr int kRowB = 16 * kChunks;   // bytes of a staged row
  static constexpr int kGroups = 32 / kChunks;  // PV: column groups of a warp
  // rows whose chunks share one 128-byte bank line: the swizzle key steps
  // once every kPack rows
  static constexpr int kPack = kChunks >= 8 ? 1 : 8 / kChunks;
  __device__ static int swz(int row, int c) { return c ^ ((row / kPack) & (kChunks - 1)); }
};

// One warp's shared memory: kStages staged K tiles and V tiles, the fresh
// column's K and V rows, q in fp32 [kD], and what the row's warps merge:
// max, sum, 2 floats of padding, the accumulator [kD]
template <typename CacheT, int kD, int kStages>
__host__ __device__ constexpr int warp_bytes() {
  return (2 * kStages * kTC + 2) * Cols<CacheT, kD>::kRowB + 4 * (2 * kD + 4);
}

// warps a block: 4, or fewer where 4 warps' buffers pass shared memory
template <typename CacheT, int kD, int kStages>
__host__ __device__ constexpr int block_warps() {
  return 4 * warp_bytes<CacheT, kD, kStages>() <= kSmemLimit   ? 4
         : 2 * warp_bytes<CacheT, kD, kStages>() <= kSmemLimit ? 2
                                                              : 1;
}

// blocks an SM holds by shared memory (its 228 KB, 1 KB of them reserved a
// block), at most 6: the register cap of __launch_bounds__ (80 registers a
// thread at 6 blocks of 4 warps; 6 blocks of the int8 cache's 2-stage
// kernel timed 10% faster than the 3 of a 154-register build)
template <typename CacheT, int kD, int kStages>
__host__ __device__ constexpr int min_blocks() {
  constexpr int fit =
      (228 * 1024) / (block_warps<CacheT, kD, kStages>() * warp_bytes<CacheT, kD, kStages>() + 1024);
  return fit < 6 ? fit : 6;
}

// cp.async of 16 bytes that asks L2 to fetch the 256-byte block around
// them (the design note says why)
__device__ __forceinline__ void cp_async16_pair(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void row_barrier(int id, int n_threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n_threads) : "memory");
}

// what a tile's issue leaves for its compute: the live columns (a bit a
// lane), and the int8 scales of the lane's column
struct Tile {
  unsigned live;
  float ks, vs;
};

// Grid: blocks of kWarps warps, kWarps / split rows (b, h) a block, h
// fastest; warp w of a row's split takes the row's tiles w, w + split, ...
template <typename QT, typename CacheT, int kD, int kStages, bool kRing>
__global__ void __launch_bounds__(32 * block_warps<CacheT, kD, kStages>(),
                                  min_blocks<CacheT, kD, kStages>())
    gqa_decode_mha_kernel(const QT* __restrict__ q,              // [B, H, D]
                          CacheT* __restrict__ k,                // [B, S, H*D], written at pos
                          CacheT* __restrict__ v,                // [B, S, H*D], written at pos
                          const QT* __restrict__ k_slab,         // [B, H*D] fresh column
                          const QT* __restrict__ v_slab,         // [B, H*D] fresh column
                          __nv_bfloat16* __restrict__ k_scale,   // [B, H, S] (int8) or null
                          __nv_bfloat16* __restrict__ v_scale,   // [B, H, S] (int8) or null
                          const int32_t* __restrict__ mask_rel,  // [B, S] (ring) or null
                          const int32_t* __restrict__ pos_ptr,   // scalar: column written
                          QT* __restrict__ out,                  // [B, H, D]
                          int B, int S, int H, int split) {
  using C = Cols<CacheT, kD>;
  constexpr bool kQuant = std::is_same<CacheT, int8_t>::value;
  constexpr int kElems = C::kElems;
  constexpr int kChunks = C::kChunks;
  constexpr int kRowB = C::kRowB;
  constexpr int kTileB = kTC * kRowB;
  constexpr int kWarpB = warp_bytes<CacheT, kD, kStages>();
  constexpr int kWarps = block_warps<CacheT, kD, kStages>();
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (kWarps / split) + warp / split;  // row b*H + h
  const int w = warp % split;                                  // its share of the row
  if (r >= B * H) return;  // the last block's spare rows: every warp of a row leaves
  const int b = r / H;
  const int h = r - b * H;
  const int pos = *pos_ptr;
  QT* orow = out + static_cast<int64_t>(r) * kD;
  if (pos < 0 || pos >= S) {
    // no column to write: write nothing and make the output NaN, so a
    // caller that broke the length < S invariant cannot miss it
    if (w == 0)
      for (int d = lane; d < kD; d += 32) orow[d] = from_float<QT>(NAN);
    return;
  }

  unsigned char* ws = smem_raw + warp * kWarpB;
  unsigned char* kf_s = ws + 2 * kStages * kTileB;  // the fresh column's K row
  unsigned char* vf_s = kf_s + kRowB;               // ... and V row
  float* q_s = reinterpret_cast<float*>(vf_s + kRowB);
  float* merge_s = q_s + kD;
  const int HD = H * kD;
  const int64_t row0 = static_cast<int64_t>(b) * S * HD + h * kD;  // column 0 of (b, h)
  const int64_t srow = static_cast<int64_t>(r) * S;                 // its scales
  const int32_t* mrow = kRing ? mask_rel + static_cast<int64_t>(b) * S : nullptr;
  // logical columns: [0, pos] in lockstep mode, the S columns of the ring
  // in window order; logical l sits at physical column phys(l)
  const int n_cols = kRing ? S : pos + 1;
  const int n_win = kRing ? min(max(mrow[pos] + 1, 1), S) : pos + 1;
  const int start = kRing ? (pos + 1 - n_win + S) % S : 0;
  const int lpos = n_win - 1;
  auto phys = [&](int l) { return !kRing ? l : l < S - start ? start + l : start + l - S; };
  const int n_t = (n_cols + kTC - 1) / kTC;
  const int n_my = n_t > w ? (n_t - w + split - 1) / split : 0;
  auto base_of = [&](int j) { return (w + j * split) * kTC; };  // first column of tile j

  // ---- 1. tile j (the warp's j-th) into ring slot j % kStages: its live
  // columns but the fresh one; one commit group a tile (an empty one past
  // the last keeps the count uniform). Ring mode: the mask of the lane's
  // column of tile j + 1 is loaded while tile j issues
  int m_next = 0;
  auto load_mask = [&](int j) {
    const int l = base_of(j) + lane;
    return l < n_cols ? mrow[phys(l)] : -1;
  };
  if (kRing && n_my > 0) m_next = load_mask(0);
  auto issue = [&](int j, Tile& t) {
    if (j < n_my) {
      const int base = base_of(j);
      const int l = base + lane;
      const int m_cur = m_next;
      if (kRing && j + 1 < n_my) m_next = load_mask(j + 1);
      const bool live = l < n_cols && (!kRing || m_cur >= 0);
      t.live = __ballot_sync(0xffffffffu, live);
      const unsigned copy =
          t.live & ~(lpos >= base && lpos < base + kTC ? 1u << (lpos - base) : 0u);
      unsigned char* dk = ws + (j % kStages) * 2 * kTileB;
      unsigned char* dv = dk + kTileB;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {  // kTC * kChunks pieces, 32 a pass
        const int piece = i * 32 + lane;
        const int col = piece / kChunks;
        const int c = piece % kChunks;
        if (copy >> col & 1u) {
          const int64_t off = row0 + static_cast<int64_t>(phys(base + col)) * HD + c * kElems;
          const int so = col * kRowB + 16 * C::swz(col, c);
          cp_async16_pair(dk + so, k + off);
          cp_async16_pair(dv + so, v + off);
        }
      }
      if constexpr (kQuant) {
        if (copy >> lane & 1u) {
          const int p = phys(l);
          t.ks = __bfloat162float(k_scale[srow + p]);
          t.vs = __bfloat162float(v_scale[srow + p]);
        }
      }
    }
    cp_async_commit();
  };
  Tile tiles[kStages];
#pragma unroll
  for (int s = 0; s + 1 < kStages; ++s) issue(s, tiles[s]);

  // ---- 2. the fresh column, by the warp that owns its tile: into the
  // cache and into the warp's fresh rows (swizzled as row lpos % kTC of
  // its tile), from registers; then q
  float ks_fresh = 1.f, vs_fresh = 1.f;
  if (w == (lpos / kTC) % split) {
    const int fr = lpos % kTC;
#pragma unroll
    for (int is_v = 0; is_v < 2; ++is_v) {
      const QT* src = (is_v ? v_slab : k_slab) + static_cast<int64_t>(b) * HD + h * kD;
      CacheT* dst = (is_v ? v : k) + row0 + static_cast<int64_t>(pos) * HD;
      CacheT* dst_s = reinterpret_cast<CacheT*>(is_v ? vf_s : kf_s);
      auto at = [&](int d) { return C::swz(fr, d / kElems) * kElems + d % kElems; };
      if constexpr (kQuant) {
        // fp32 abs-max, s = max(m, 1e-6) / 127 (IEEE division), q =
        // clip(rint(x / s), -127, 127), bf16 scale (RN)
        float m = 0.f;
        for (int d = lane; d < kD; d += 32) m = fmaxf(m, fabsf(to_float(src[d])));
        const float s = fmaxf(warp_max(m), 1e-6f) / 127.f;
        for (int d = lane; d < kD; d += 32) {
          const float x = fminf(fmaxf(rintf(to_float(src[d]) / s), -127.f), 127.f);
          dst[d] = dst_s[at(d)] = static_cast<int8_t>(x);
        }
        const __nv_bfloat16 sb = __float2bfloat16_rn(s);
        if (lane == 0) (is_v ? v_scale : k_scale)[srow + pos] = sb;
        (is_v ? vs_fresh : ks_fresh) = __bfloat162float(sb);
      } else {
        for (int d = lane; d < kD; d += 32) dst[d] = dst_s[at(d)] = src[d];
      }
    }
  }
  const QT* qr = q + static_cast<int64_t>(r) * kD;
  for (int d = lane; d < kD; d += 32) q_s[d] = to_float(qr[d]);
  __syncwarp();

  // ---- 3. per tile: scores (a lane a column), the online softmax, PV
  // (lane = chunk c of the head size, column group g)
  // scores in log2 units (x log2(e)): the softmax's exponentials are exp2f
  const float sm_scale = 1.4426950408889634f / sqrtf(static_cast<float>(kD));
  const int c = lane % kChunks;
  const int g = lane / kChunks;
  float m = -INFINITY;  // the warp's running max (uniform)
  float l_sum = 0.f;    // the lane's running sum of exp(s - m)
  float acc[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) acc[e] = 0.f;
  for (int j = 0; j < n_my; ++j) {
    issue(j + kStages - 1, tiles[kStages - 1]);  // into the slot tile j-1 freed
    cp_async_wait<kStages - 1>();                // tile j has landed (this lane's pieces)
    __syncwarp();
    const Tile t = tiles[0];
#pragma unroll
    for (int s = 0; s + 1 < kStages; ++s) tiles[s] = tiles[s + 1];
    if (t.live) {
      const int base = base_of(j);
      const int fresh = lpos - base;  // the fresh column's lane, if in this tile
      const unsigned char* tk = ws + (j % kStages) * 2 * kTileB;
      const unsigned char* tv = tk + kTileB;
      float sc = -INFINITY;
      if (t.live >> lane & 1u) {
        const unsigned char* kr = lane == fresh ? kf_s : tk + lane * kRowB;
        float a = 0.f;
#pragma unroll
        for (int cc = 0; cc < kChunks; ++cc) {
          float kv[kElems];
          unpack(*reinterpret_cast<const int4*>(kr + 16 * C::swz(lane, cc)), kv);
          const float4* qv = reinterpret_cast<const float4*>(q_s + cc * kElems);
#pragma unroll
          for (int e = 0; e < kElems / 4; ++e) {
            const float4 qq = qv[e];
            a = fmaf(qq.x, kv[4 * e], a);
            a = fmaf(qq.y, kv[4 * e + 1], a);
            a = fmaf(qq.z, kv[4 * e + 2], a);
            a = fmaf(qq.w, kv[4 * e + 3], a);
          }
        }
        sc = kQuant ? a * (lane == fresh ? ks_fresh : t.ks) * sm_scale : a * sm_scale;
      }
      const float m_new = fmaxf(m, warp_max(sc));
      // m_new > -inf: this tile has a live column
      const float corr = exp2f(m - m_new);  // 0 while m was -inf
      const float ev = sc == -INFINITY ? 0.f : exp2f(sc - m_new);
      m = m_new;
      l_sum = l_sum * corr + ev;
      const float pv = kQuant ? ev * (lane == fresh ? vs_fresh : t.vs) : ev;
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[e] *= corr;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {  // the group's columns g, g + kGroups, ...
        const int col = g + i * C::kGroups;
        const float p = __shfl_sync(0xffffffffu, pv, col);
        if (t.live >> col & 1u) {
          float vv[kElems];
          unpack(*reinterpret_cast<const int4*>((col == fresh ? vf_s : tv + col * kRowB) +
                                                16 * C::swz(col, c)),
                 vv);
#pragma unroll
          for (int e = 0; e < kElems; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
        }
      }
    }
    __syncwarp();  // every lane is done with slot j % kStages
  }
  cp_async_wait<0>();

  // ---- 4. the warp's sum and accumulator; the groups meet (lane c < kChunks
  // holds chunk c of the head size)
  l_sum = warp_sum(l_sum);
#pragma unroll
  for (int o = kChunks; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (split == 1) {
    const float inv = l_sum > 0.f ? 1.f / l_sum : 0.f;  // no live column: 0
    if (lane < kChunks)
#pragma unroll
      for (int e = 0; e < kElems; ++e) orow[c * kElems + e] = from_float<QT>(acc[e] * inv);
    return;
  }
  // ---- 5. the row's warps merge, in warp order, after a barrier of the
  // row's warps alone (named barrier 1 + the row's place in the block)
  if (lane == 0) {
    merge_s[0] = m;
    merge_s[1] = l_sum;
  }
  if (lane < kChunks)
#pragma unroll
    for (int e = 0; e < kElems; ++e) merge_s[4 + c * kElems + e] = acc[e];
  row_barrier(1 + warp / split, 32 * split);
  if (w != 0) return;
  const float* first = merge_s;  // warp w == 0's; warp i's lies i * kWarpB bytes on
  auto part = [&](int i) {
    return reinterpret_cast<const float*>(reinterpret_cast<const unsigned char*>(first) +
                                          i * kWarpB);
  };
  float mx = -INFINITY;
  for (int i = 0; i < split; ++i) mx = fmaxf(mx, part(i)[0]);
  float total = 0.f;
  for (int i = 0; i < split; ++i) {
    const float mi = part(i)[0];
    total += (mi == -INFINITY ? 0.f : exp2f(mi - mx)) * part(i)[1];
  }
  const float inv = total > 0.f ? 1.f / total : 0.f;
  for (int d = lane; d < kD; d += 32) {
    float y = 0.f;
    for (int i = 0; i < split; ++i) {
      const float mi = part(i)[0];
      y += (mi == -INFINITY ? 0.f : exp2f(mi - mx)) * part(i)[4 + d];
    }
    orow[d] = from_float<QT>(y * inv);
  }
}

template <typename QT, typename CacheT, int kD, int kStages, bool kRing>
int launch_k(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
             void* k_scale, void* v_scale, const void* mask_rel, const void* pos, void* out,
             int B, int S, int H, cudaStream_t stream) {
  constexpr int kWarps = block_warps<CacheT, kD, kStages>();
  constexpr size_t smem = static_cast<size_t>(kWarps) * warp_bytes<CacheT, kD, kStages>();
  static_assert(smem <= kSmemLimit, "one warp's buffers pass shared memory");
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gqa_decode_mha_kernel<QT, CacheT, kD, kStages, kRing>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t rows = static_cast<int64_t>(B) * H;
  const int n_t = (S + kTC - 1) / kTC;
  int split = 1;
  while (split < kWarps && 2 * split <= n_t && rows * split < kSplitWarps) split *= 2;
  const int64_t blocks = (rows + kWarps / split - 1) / (kWarps / split);
  if (blocks < 1 || blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  gqa_decode_mha_kernel<QT, CacheT, kD, kStages, kRing>
      <<<static_cast<unsigned>(blocks), 32 * kWarps, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<CacheT*>(k), static_cast<CacheT*>(v),
      static_cast<const QT*>(k_slab), static_cast<const QT*>(v_slab),
      static_cast<__nv_bfloat16*>(k_scale), static_cast<__nv_bfloat16*>(v_scale),
      static_cast<const int32_t*>(mask_rel), static_cast<const int32_t*>(pos),
      static_cast<QT*>(out), B, S, H, split);
  return cudaGetLastError();
}

// the head size and the ring's depth (one tile: the row fits) are template
// parameters
template <typename QT, typename CacheT, bool kRing>
int launch(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
           void* k_scale, void* v_scale, const void* mask_rel, const void* pos, void* out, int B,
           int S, int H, int D, cudaStream_t stream) {
#define MHA_LAUNCH(DD)                                                                      \
  case DD:                                                                                  \
    return S <= kTC ? launch_k<QT, CacheT, DD, 1, kRing>(q, k, v, k_slab, v_slab, k_scale,  \
                                                         v_scale, mask_rel, pos, out, B, S, \
                                                         H, stream)                         \
                    : launch_k<QT, CacheT, DD, 2, kRing>(q, k, v, k_slab, v_slab, k_scale,  \
                                                         v_scale, mask_rel, pos, out, B, S, \
                                                         H, stream);
  switch (D) {
    MHA_LAUNCH(16)
    MHA_LAUNCH(32)
    MHA_LAUNCH(64)
    MHA_LAUNCH(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef MHA_LAUNCH
}

// the types and the head size of one call, in one mode
template <bool kRing>
int dispatch(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
             void* k_scale, void* v_scale, const void* mask_rel, const void* pos, void* out,
             int B, int S, int H, int D, int quantized, int fp32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MHA_TYPES(QT, CT) \
  launch<QT, CT, kRing>(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel, pos, out, B, S, H, D, st)
  if (fp32) return quantized ? MHA_TYPES(float, int8_t) : MHA_TYPES(float, float);
  return quantized ? MHA_TYPES(__nv_bfloat16, int8_t) : MHA_TYPES(__nv_bfloat16, __nv_bfloat16);
#undef MHA_TYPES
}

}  // namespace

// dispatch<true>, compiled in gqa_decode_mha_ring.cu
int gqa_decode_mha_ring_launch(const void* q, void* k, void* v, const void* k_slab,
                               const void* v_slab, void* k_scale, void* v_scale,
                               const void* mask_rel, const void* pos, void* out, int B, int S,
                               int H, int D, int quantized, int fp32, void* stream);
