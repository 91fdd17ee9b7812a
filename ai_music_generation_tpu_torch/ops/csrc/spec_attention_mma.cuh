// The tensor-core kernel of the speculative-verify attention (K2 with its
// slab write, K3 without), templated on the type of q and of the output,
// bf16 (a bf16 model) or fp32 (an fp32 model), and on the int8_dots mode.
// spec_attention.cu instantiates the bf16 modes, spec_attention_f32.cu the
// fp32 ones and spec_attention_dots.cu int8_dots for both types, each
// source in its own nvcc process (ops/_build.py::build), so they build
// side by side. The contract and the plain PyTorch twins live in
// ai_music_generation_tpu_torch/ops/spec_attention.py.
//
// Replaces the TPU kernels ai_music_generation_tpu/ops/spec_attention.py::
// _spec_attention_update (slab write + attention) and _spec_attention
// (attention alone), which share their body _make_attend and compute in
// q's dtype (its int8_dots branch in int8 x int8 dots).
//
// What bounds it: device-memory bytes in both regimes and both types. At
// the verify step (B=4096, S=256, H=6, D=64, int8 cache, T=5) one call
// reads about 0.8 GB of K and V and does 2T = 10 FLOP per cache byte; at a
// refresh (T=128 at cursor 0 over an empty history) each query reads only
// the columns up to its own, 0.5 GB of cache move (2.4 GB with fp32 q and
// output), and the 52 GFLOP of the products take 0.77 ms on CUDA cores at
// their 67 TFLOP/s peak but 0.05 ms per pass on the tensor cores, below the
// byte bound. So both products run on the tensor cores, in fp32 too: there
// as split passes (below) that keep fp32 accuracy. What holds the kernel
// back on the card is the work of a block between its loads (conversions,
// softmax, synchronisation), not the loads: its design keeps that work
// small and as many blocks as possible on an SM. int8_dots is bound the
// same way: at spec_trace's verify step (T=8, 248 live history columns)
// 0.8 GB of K and V move (0.27 ms at 3.35 TB/s) against 12.9 GOP of
// integer products (0.0065 ms at 1,979 TOP/s).
//
// Design:
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
//   per block. Every mode, int8_dots included, shares this staging;
// - scores: S = Q K^T with mma.sync (m16n8k16 fp16 or bf16, m16n8k8 tf32),
//   fp32 accumulation; q held as A fragments in registers, K read from
//   shared memory. The depth index is permuted so that each thread reads
//   one contiguous run of every column. The epilogue applies k_scale,
//   1/sqrt(D) and the col_pos mask and keeps each row's running maximum in
//   registers;
// - softmax: exact, over a [live rows, S] fp32 score buffer in shared
//   memory (only the block's live query rows: 5 at a T=5 verify step): the
//   maximum from the warps' running maxima, then one pass of exp, sum and
//   x v_scale, 8 lanes per row and 4 rows of a warp at once; 1/sum is
//   applied as PV reads the row;
// - PV: O = P V with mma.sync, the column index permuted so that each
//   thread reads 4 whole column runs per 16 columns; the warps' partial
//   sums meet in shared memory; the output is written once, in q's type;
// - the slab write: the query-tile blocks of (row, head) share the writing
//   of head h's slice of the slab, 4 pieces of K and V in flight per
//   thread; every block reads the fresh columns from the slab, never from
//   the cache being written (no write-then-read race).
//
// Numerics. Every product runs on the tensor cores with fp32 accumulation;
// an operand that the unit's input type cannot hold exactly is split into
// parts that it can, one pass per part (never a single rounding pass of an
// fp32 value):
// - scores, int8 cache: the products run in fp16 (an int8 value is exact
//   there, converted with 5 instructions per 4 values where bf16 takes 11):
//   each q row is scaled by the power of two that lifts its largest |q|
//   into [2^14, 2^15), and the scores are scaled back exactly (qi0, qi1).
//   A bf16 q is then one exact fp16 pass (every bf16 value within 2^28 of
//   its row's largest is an exact fp16). An fp32 q is split into fp16 hi +
//   lo (lo = the rounding of q - hi), two passes: within 2^-22 of each
//   value, or 2^-39 of the row's largest where lo falls among fp16's
//   subnormals;
// - scores, bf16 cache (bf16 q): q and K are bf16, one exact pass;
// - scores, fp32 cache (fp32 q): 3xTF32, q and K each split into tf32 hi +
//   lo (rounded to nearest, ties away), three m16n8k8 passes q_lo k_hi +
//   q_hi k_lo + q_hi k_hi: the dropped q_lo k_lo and the roundings of the
//   lo parts leave under 2^-21 of each product;
// - k_scale, 1/sqrt(D) and log2(e) multiply the fp32 scores; the softmax
//   is fp32 with exp2 of the log2-scaled scores (the hardware's exp2,
//   relative error about 2^-22) and an IEEE division for 1/sum;
// - PV, int8 cache: int8 V is exact in fp16; P x v_scale is scaled per row
//   by the power of two that lifts its largest value into [2^14, 2^15) and
//   the output divided back exactly; bf16 q: P rounded to fp16, one pass
//   (2^-11 per term); fp32 q: P split into fp16 hi + lo, two passes (as q
//   above);
// - PV, bf16 cache: P split into bf16 hi + lo, two passes (about 2^-16 per
//   term);
// - PV, fp32 cache: 3xTF32 of P and V, as the scores;
// - the output is rounded once, to q's type. bf16 stays within one bf16
//   ulp (2^-7) of its range of the twin evaluated in fp32; fp32 within
//   1e-5 of its range of the fp32 twin. The slab write is a bit-exact
//   copy. A query whose every column is dead gets 0, not NaN.
// (ops/spec_attention.py::spec_attention_mma_model and
// spec_attention_f32_mma_model evaluate these roundings on the CPU.)
//
// The int8_dots mode (int8 cache; the Pallas kernel's int8 x int8 MXU
// path, ops/spec_attention.py::spec_attention_int8_dots_reference): both
// products on the integer tensor cores, mma.sync m16n8k32 s8 x s8 -> s32,
// whose int32 sums are exact (the integers of the twin's float64
// products). What differs from the modes above:
// - q: quantized once a block per (head, query) row while the first tile
//   lands, a warp per row, into shared memory: s = max(max|q|, 1e-20) /
//   127, q8 = rint(q / s), the twin's q8 bit for bit (the quotients of
//   IEEE divisions from one reciprocal a row and two fma steps, div_rn; the
//   rounding a float addition, kRound; |q / s| < 127.5 needs no clip).
//   Each warp takes its s8 A fragments in the permuted depth order above,
//   so a B register is 4 depth bytes of one column as the cache stores
//   them: K needs no conversion;
// - scores: int32 x s x k_scale x log2(e)/sqrt(D), the twin's order; then
//   the same fp32 softmax, x v_scale;
// - probabilities: p = e x v_scale / sum quantized per row, ps = max(max
//   p, 1e-20) / 127, p8 = rint(e x v_scale x (1/sum)(1/ps)) by one fma a
//   value, into an int8 buffer in the order of PV's A fragments (each
//   thread reads its 8 bytes of a row with one load). The kernel's p
//   rounds otherwise than the twin's (softmax, then x v_scale) either way,
//   so an exact p / ps would not give the twin's p8;
// - PV: the B operand wants 4 consecutive columns of one head element in
//   a register, while the cache stores a column's elements together. Each
//   thread loads one word (4 elements) of each of its 8 columns of a
//   32-column step and transposes the 4x4 bytes with 8 byte permutes (prmt)
//   per 4 registers. (ldmatrix .trans moves 16-bit elements only; wgmma
//   takes 8-bit operands K-major only, and its 64-row minimum would waste
//   most of the tile at T <= 8.) The warps' int32 partial sums meet
//   exactly in shared memory; the output is int32 x ps, rounded once to
//   q's type. Output within 2^-6 of its range of the twin evaluated in
//   fp32: the kernel and the twin may round a probability to neighbouring
//   integers.
// What holds the mode back beyond the bf16-dot mode's limits is the work
// of its quantizers, not its loads (experiments/int8_dots_probe.py times
// copies of this source with one part changed, on an H100): an IEEE
// division a probability takes the refresh from 2.22 to 2.69 ms, a
// float-to-int conversion and two clips a value cost 2-3% more than the
// rounding addition, and the two quantizers, as they are here, still take
// 1-6% of a call each (the copies without them).
//
// Build with nvcc -gencode arch=compute_90a,code=sm_90a and WITHOUT
// --use_fast_math (exp2f, the IEEE 1/sum and reciprocals, which int8_dots'
// div_rn needs rounded to nearest, and fma's exact products).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr size_t kSmemLimit = 227 * 1024;
constexpr int kTooLarge = -1;  // returned when a block's buffers exceed shared memory
constexpr int kCH = 64;        // cache columns per staged tile
constexpr int kStages = 2;     // staged tiles in shared memory (the ring)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  // src_bytes 0 reads nothing and fills the 16 bytes with zeros
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
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

// m16n8k8 on tf32 operands: A slots (row g, col t4), (g+8, t4), (g, t4+4),
// (g+8, t4+4); B slots (row t4, col g), (t4+4, g); C as m16n8k16
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A * B on the integer tensor cores, m16n8k32 s8: exact int32 sums.
// A slots (row g, k 4t4..4t4+3), (g+8, 4t4..), (g, 16+4t4..), (g+8,
// 16+4t4..), byte i of a word the k 4t4+i; B slots (k 4t4..4t4+3, col g),
// (16+4t4.., g); C as m16n8k16
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 4x4 bytes of w0..w3 transposed: byte j of r[i] is byte i of wj
__device__ __forceinline__ void transpose_bytes(uint32_t w0, uint32_t w1, uint32_t w2,
                                                uint32_t w3, uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// x / s rounded to the nearest float, as an IEEE division gives it, from
// r = 1/s (an IEEE division, once per scale): x r is within 2 ulps of x / s,
// one fma step brings it within one ulp, and a second (Markstein's theorem)
// rounds it correctly. Here s is normal and |x / s| at most 127 (1 +
// 2^-23), so nothing overflows, and a quotient among the subnormals rounds
// to the integer 0 either way.
__device__ __forceinline__ float div_rn(float x, float s, float r) {
  float y = __fmul_rn(x, r);
  y = fmaf(fmaf(-s, y, x), r, y);
  return fmaf(fmaf(-s, y, x), r, y);
}

// x + kRound for |x| < 2^22 is a float whose low byte is rint(x) as an
// int8 (two's complement; the addition rounds half to even)
constexpr float kRound = 12582912.f;  // 1.5 * 2^23

// the low bytes of a, b, c, d (values + kRound) as one word, a lowest
__device__ __forceinline__ uint32_t pack_rounded(float a, float b, float c, float d) {
  return __byte_perm(__byte_perm(__float_as_uint(a), __float_as_uint(b), 0x0040),
                     __byte_perm(__float_as_uint(c), __float_as_uint(d), 0x0040), 0x5410);
}

// x rounded to tf32 (10 fraction bits; to nearest, ties away from zero)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 of x: hi its tf32 rounding, lo that of the
// (exact) rest
__device__ __forceinline__ uint32_t split_tf32(float x, uint32_t& lo) {
  const uint32_t hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
  return hi;
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

// two consecutive values of q as floats
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
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

__device__ __forceinline__ float2 unpack_f16(uint32_t w) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// (x, y) as an f16x2 word; with kLo also the f16x2 word of the (exact)
// rests x - hi, y - hi: the two-pass split of fp32 values
template <bool kLo>
__device__ __forceinline__ uint32_t split_f16(float x, float y, uint32_t& lo) {
  const uint32_t hi = pack_f16(x, y);
  if constexpr (kLo) {
    const float2 h = unpack_f16(hi);
    lo = pack_f16(x - h.x, y - h.y);
  }
  return hi;
}

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

// bytes in a row of int8_dots' quantized probabilities: the padded width +
// 32 (== 32 or 96 mod 128: the A-fragment reads and the packed writes are
// conflict-free)
__host__ __device__ constexpr int p8_stride(int S) { return round_up(S, kCH) + 32; }

// Dynamic shared memory, in order: the ring of kStages tiles [kCH][D] of
// the cache type, in int8_dots mode the quantized P [min(rows, T)]
// [p8_stride] int8, P [min(rows, T)][p_stride] fp32 (only the block's live
// query rows), col_pos [Sp] int, k and v scales [Sp] fp32 each, the rows' PV
// factors [2][rows], the warps' row maxima [warps / (rows/16)][rows], the
// live tile list [Sp/kCH] and its length.
size_t mma_smem_bytes(int S, int D, int item, int rows, int T, bool dots) {
  const size_t Sp = static_cast<size_t>(round_up(S, kCH));
  const size_t pr = static_cast<size_t>(T < rows ? T : rows);
  return static_cast<size_t>(kStages) * kCH * D * item + (dots ? pr * p8_stride(S) : 0) +
         sizeof(float) * (pr * p_stride(S, D) + 3 * Sp + 2 * rows + mma_warps(rows) * 16 +
                          Sp / kCH + 1);
}

// Blocks of a regime that share an SM: the registers are capped for them.
// Verify blocks: 8 in int8_dots mode and with a bf16 q over an int8 cache,
// 6 with an fp32 q over it (the lo parts of q and P spill at 8), 6 over a
// bf16 cache, 4 over an fp32 one; refresh blocks: 2. Measured
// (experiments/register_caps.py), more blocks in flight beat fewer spilled
// registers, up to a point.
template <typename QT, typename CacheT, bool kDots>
__host__ __device__ constexpr int mma_min_blocks(int rows) {
  return rows == 64 ? 2
                    : kDots ? 8
                            : (std::is_same<CacheT, int8_t>::value
                                   ? (std::is_same<QT, float>::value ? 6 : 8)
                                   : (std::is_same<CacheT, float>::value ? 4 : 6));
}

// Grid: one block per (query tile, head, row), the query tile fastest.
// kWR row groups of 16 queries per block: 1 (verify: 4 warps split each
// tile's columns) or 4 (refresh: 8 warps, two per 16 rows).
template <typename QT, typename CacheT, int kD, int kWR, bool kDots>
__global__ void __launch_bounds__(32 * mma_warps(16 * kWR),
                                  mma_min_blocks<QT, CacheT, kDots>(16 * kWR))
    spec_attention_mma_kernel(
    const QT* __restrict__ q,             // [B, T, H*D]
    CacheT* __restrict__ k,               // [B, S, H*D], slab written at cursor
    CacheT* __restrict__ v,               // [B, S, H*D], slab written at cursor
    const CacheT* __restrict__ k_slab,    // [B, Tw, H*D] or null (no write)
    const CacheT* __restrict__ v_slab,    // [B, Tw, H*D] or null
    const __nv_bfloat16* __restrict__ k_scale,  // [B, H, S] (int8 mode) or null
    const __nv_bfloat16* __restrict__ v_scale,  // [B, H, S] (int8 mode) or null
    const int32_t* __restrict__ col_pos,  // [B, S]
    const int32_t* __restrict__ lengths,  // [B]
    const int32_t* __restrict__ cursor_ptr,  // scalar, or null without a slab
    QT* __restrict__ out,                 // [B, T, H*D]
    int T, int S, int H) {
  constexpr bool kF32 = std::is_same<QT, float>::value;  // fp32 q: split passes
  constexpr bool kQuant = std::is_same<CacheT, int8_t>::value;
  constexpr bool kTF32 = std::is_same<CacheT, float>::value;  // 3xTF32 products
  static_assert(kQuant || std::is_same<CacheT, QT>::value, "an unquantized cache has q's type");
  static_assert(kQuant || !kDots, "int8_dots needs the int8 cache");
  constexpr int kItem = static_cast<int>(sizeof(CacheT));
  constexpr int kElems = 16 / kItem;            // cache values per 16 bytes
  constexpr int kChunks = kD / kElems;          // 16-byte chunks per column slice
  constexpr int kTile = kCH * kD * kItem;       // bytes of one staged tile
  constexpr int kR = 16 * kWR;                  // query rows per block
  constexpr int kWarpsM = mma_warps(kR);        // warps of the block
  constexpr int kThreadsM = 32 * kWarpsM;
  constexpr int kNcs = kWarpsM / kWR;           // warps sharing a row group
  constexpr int kNK = kTF32 ? kD / 8 : kD / 16;  // k-steps of QK^T (k8 tf32, else k16)
  constexpr int kNT = kD / 8;                   // n-tiles of PV
  constexpr int kKB = kD / 4 * kItem;           // K bytes per column and thread
  constexpr int kVB = kD / 8 * kItem;           // V bytes per column and thread
  constexpr int kKS = 2;                        // PV: warps splitting the k-steps
  constexpr int kNS = kNcs / kKS;               // ... and the n-tiles
  constexpr int kNTw = kNT / kNS;               // n-tiles of a warp
  constexpr int kVBw = kVB / kNS;               // its V bytes per column and thread
  constexpr int kNTs = kCH / 8 / kNcs;          // QK^T n-tiles of a tile per warp
  // ... taken together (one at a time over an fp32 cache: its K runs are 4x
  // an int8 cache's in registers)
  constexpr int kGrp = kTF32 ? 1 : (kNTs < 4 ? kNTs : 4);
  // int8_dots: k32-steps of QK^T, and the words of K and of q in a
  // thread's run of D/4 depths (a step takes words 2j and 2j + 1, 0 past
  // the run: D = 16 pads its one step)
  constexpr int kNK8 = (kD + 31) / 32;
  constexpr int kRunW = kD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Sp = round_up(S, kCH);
  const int PS = p_stride(S, kD);
  const int P8S = kDots ? p8_stride(S) : 0;
  const int PR = min(kR, T);  // rows of P: the most live query rows a block has
  unsigned char* ring = smem_raw;
  unsigned char* p8_s = ring + kStages * kTile;  // int8_dots: [PR][P8S]
  float* p_s = reinterpret_cast<float*>(p8_s + PR * P8S);
  int* cp_s = reinterpret_cast<int*>(p_s + PR * PS);
  float* ks_s = reinterpret_cast<float*>(cp_s + Sp);
  float* vs_s = ks_s + Sp;
  float* rowa_s = vs_s + Sp;  // the row's multiplier of P in PV (int8_dots: q's scale)
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
  QT* ob = out + (static_cast<int64_t>(b) * T + t0) * HD + hoff;

  int cursor = 0, Tw = 0;
  if (k_slab != nullptr) {
    cursor = *cursor_ptr;
    Tw = (T + 7) / 8 * 8;
    if (cursor < 0 || cursor > S - Tw) {
      // no window to write: write nothing and make the output NaN, so a
      // caller that broke the cursor + Tw <= S invariant cannot miss it
      for (int i = tid; i < nq * kD; i += kThreadsM)
        ob[static_cast<int64_t>(i / kD) * HD + i % kD] = from_float<QT>(NAN);
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

  // the queries of the warp's row group as A fragments (rows past T are
  // 0). The depth index of QK^T is permuted so that thread t4 owns the D/4
  // consecutive values from t4*D/4 of every column: pair i of them (depths
  // t4*D/4 + 2i, + 1) is k16-step i/2's slots {2t4, 2t4+1} (i even) or
  // {2t4+8, 2t4+9} (i odd), and k8-step i's slots t4 and t4+4. qa holds
  // the operand (an fp32 q: its hi part), ql the lo part of an fp32 q.
  // With an int8 cache each q row is scaled by the power of two that lifts
  // its largest |q| into [2^14, 2^15) for the fp16 products, and the
  // scores are scaled back exactly (qi0, qi1: rows g and g+8)
  uint32_t qa[kDots ? kNK8 : kNK][4], ql[kF32 && !kDots ? kNK : 1][4];
  float qi0 = 1.f, qi1 = 1.f;
  if constexpr (kDots) {
    // int8_dots, while the first tile lands: the block's live q rows
    // quantized once, as the twin quantizes them (the same quotients, so
    // the same q8), rows warp + kWarpsM i of the block a warp, 2 kQP
    // consecutive depths a lane, every row's loads issued first: the row's
    // scale s = max(max|q|, 1e-20) / 127 into rowa_s, q8 = rint(q / s) into
    // q8_s [nq][D] (the score buffer's start: its first score is stored
    // after the tile loop's first barrier). |q| / s < 127.5, so q8 needs no
    // clip to [-127, 127]
    unsigned char* q8_s = reinterpret_cast<unsigned char*>(p_s);
    {
      constexpr int kQP = kD > 64 ? kD / 64 : 1;  // pairs of depths a lane
      constexpr int kRW = kR / kWarpsM;           // rows a warp
      const int d0 = 2 * kQP * lane;
      float2 f[kRW][kQP];
      float x[kRW];
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        const int r = warp + kWarpsM * i;
        const QT* qr = q + (static_cast<int64_t>(b) * T + t0 + r) * HD + hoff + d0;
        x[i] = 0.f;
#pragma unroll
        for (int j = 0; j < kQP; ++j) {
          f[i][j] = r < nq && d0 < kD ? load_pair(qr + 2 * j) : make_float2(0.f, 0.f);
          x[i] = fmaxf(x[i], fmaxf(fabsf(f[i][j].x), fabsf(f[i][j].y)));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kRW; ++i) x[i] = fmaxf(x[i], __shfl_xor_sync(0xffffffffu, x[i], o));
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        const int r = warp + kWarpsM * i;
        if (r >= nq) break;
        const float s = div_rn(fmaxf(x[i], 1e-20f), 127.f, 1.f / 127.f), rs = 1.f / s;
        const auto q8 = [&](float y) { return __fadd_rn(div_rn(y, s, rs), kRound); };
        if (d0 < kD) {
          if constexpr (kQP == 1) {
            *reinterpret_cast<uint16_t*>(q8_s + r * kD + d0) = static_cast<uint16_t>(
                pack_rounded(q8(f[i][0].x), q8(f[i][0].y), 0.f, 0.f));
          } else {
#pragma unroll
            for (int j = 0; j < kQP; j += 2)
              *reinterpret_cast<uint32_t*>(q8_s + r * kD + d0 + 2 * j) = pack_rounded(
                  q8(f[i][j].x), q8(f[i][j].y), q8(f[i][j + 1].x), q8(f[i][j + 1].y));
          }
        }
        if (lane == 0) rowa_s[r] = s;
      }
    }
    __syncthreads();
    // q8 of the thread's run from q8_s, word w = depths 4w..4w+3 (rows
    // past nq: 0); k32-step j: words 2j (slots 4t4..) and 2j+1 (slots
    // 16+4t4..) of rows g and g + 8; the rows' scales, by which the int32
    // scores are multiplied
    uint32_t w0[kRunW] = {}, w1[kRunW] = {};
    const int r0 = 16 * rg + g;
    if (r0 < nq) {
      load_bytes<kD / 4>(q8_s + r0 * kD + t4 * (kD / 4), w0);
      qi0 = rowa_s[r0];
    }
    if (r0 + 8 < nq) {
      load_bytes<kD / 4>(q8_s + (r0 + 8) * kD + t4 * (kD / 4), w1);
      qi1 = rowa_s[r0 + 8];
    }
#pragma unroll
    for (int j = 0; j < kNK8; ++j) {
      qa[j][0] = w0[2 * j];
      qa[j][1] = w1[2 * j];
      qa[j][2] = 2 * j + 1 < kRunW ? w0[2 * j + 1] : 0u;
      qa[j][3] = 2 * j + 1 < kRunW ? w1[2 * j + 1] : 0u;
    }
  } else {
    float2 f0[kD / 8], f1[kD / 8];  // rows g and g + 8, pairs of depths
    const int r0 = t0 + 16 * rg + g;
    const QT* base = q + static_cast<int64_t>(b) * T * HD + hoff + t4 * (kD / 4);
    const int64_t o0 = static_cast<int64_t>(r0) * HD, o1 = o0 + 8 * HD;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      f0[i] = r0 < T ? load_pair(base + o0 + 2 * i) : make_float2(0.f, 0.f);
      f1[i] = r0 + 8 < T ? load_pair(base + o1 + 2 * i) : make_float2(0.f, 0.f);
    }
    float s0 = 1.f, s1 = 1.f;
    if constexpr (kQuant) {
      float x0 = 0.f, x1 = 0.f;  // the rows' largest |q| (a row spans a quad)
#pragma unroll
      for (int i = 0; i < kD / 8; ++i) {
        x0 = fmaxf(x0, fmaxf(fabsf(f0[i].x), fabsf(f0[i].y)));
        x1 = fmaxf(x1, fmaxf(fabsf(f1[i].x), fabsf(f1[i].y)));
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
      s0 = __int_as_float((127 + 15 - e0) << 23);
      s1 = __int_as_float((127 + 15 - e1) << 23);
      qi0 = __int_as_float((127 - 15 + e0) << 23);
      qi1 = __int_as_float((127 - 15 + e1) << 23);
    }
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi_row = e & 1;  // slots of row g + 8
        if constexpr (kTF32) {  // k8-step j: pair j, .x in slot t4, .y in t4 + 4
          const float x = hi_row ? (e & 2 ? f1[j].y : f1[j].x) : (e & 2 ? f0[j].y : f0[j].x);
          qa[j][e] = split_tf32(x, ql[j][e]);
        } else {  // k16-step j: pair 2j in slots 2t4, 2t4+1, pair 2j+1 in 2t4+8, 2t4+9
          const float2 p = hi_row ? f1[2 * j + (e >> 1)] : f0[2 * j + (e >> 1)];
          if constexpr (kQuant) {
            const float s = hi_row ? s1 : s0;
            qa[j][e] = split_f16<kF32>(p.x * s, p.y * s, ql[kF32 ? j : 0][e]);
          } else {
            qa[j][e] = pack_bf16(p.x, p.y);  // bf16 q: exact
          }
        }
      }
  }
  // scores are kept in log2 units, x * log2(e), so that the softmax takes
  // exp2 (one hardware instruction): exp(x - m) = exp2((x - m) log2(e))
  const float sm_scale = 1.f / sqrtf(static_cast<float>(kD)) * 1.4426950408889634f;

  // PV accumulators: n-tile j, slot n = g is depth g*D/8 + j (this
  // thread's D/8 consecutive values of every V column); the warp holds the
  // n-tiles npart*kNTw + jj, jj < kNTw
  float acc[kNTw][4];
  int acci[kDots ? kNTw : 1][4];  // int8_dots: exact int32 sums
#pragma unroll
  for (int j = 0; j < kNTw; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = 0.f;
      if constexpr (kDots) acci[j][e] = 0;
    }
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
        if constexpr (kDots) {
          // int8 x int8: B is the run's words 2j, 2j+1 as they landed
          int si[kGrp][4] = {};
#pragma unroll
          for (int j = 0; j < kNK8; ++j)
#pragma unroll
            for (int n = 0; n < kGrp; ++n)
              mma_s8(si[n], qa[j], kw[n][2 * j], 2 * j + 1 < kRunW ? kw[n][2 * j + 1] : 0u);
#pragma unroll
          for (int n = 0; n < kGrp; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = __int2float_rn(si[n][e]);
        } else {
#pragma unroll
          for (int j = 0; j < kNK; ++j)
#pragma unroll
            for (int n = 0; n < kGrp; ++n) {
              if constexpr (kQuant) {
                uint32_t b0, b1;
                s8x4_to_f16(kw[n][j], b0, b1);
                if constexpr (kF32) mma_f16(sc[n], ql[j], b0, b1);
                mma_f16(sc[n], qa[j], b0, b1);
              } else if constexpr (kTF32) {
                // k8-step j: slot t4 is word 2j of the run, slot t4 + 4 word 2j+1
                uint32_t l0, l1;
                const uint32_t h0 = split_tf32(__uint_as_float(kw[n][2 * j]), l0);
                const uint32_t h1 = split_tf32(__uint_as_float(kw[n][2 * j + 1]), l1);
                mma_tf32(sc[n], ql[j], h0, h1);
                mma_tf32(sc[n], qa[j], l0, l1);
                mma_tf32(sc[n], qa[j], h0, h1);
              } else {
                mma_bf16(sc[n], qa[j], kw[n][2 * j], kw[n][2 * j + 1]);
              }
            }
        }
        // C: rows ra, ra+8, columns 2t4, 2t4+1 of the n-tile: x = q.k (x the
        // q scale in int8_dots) x k_scale x log2(e)/sqrt(D), -inf where
        // col_pos > the query's position, stored, and the rows' running
        // maxima; rows past nq are neither stored nor read
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
          if constexpr (kDots) {
            // p = e x v_scale / sum quantized per row: ps = max(max p,
            // 1e-20) / 127, p8 = rint(e x v_scale x pc) with pc = (1 /
            // sum)(1 / ps), one fma a value with the rounding (p's own
            // roundings differ from the twin's, softmax then x v_scale, so
            // an exact p / ps would not make p8 the twin's; p8 < 127.5
            // needs no clip), stored in PV's A-fragment order: byte i of
            // word w of each 32 columns is column 16(w%2) + w/2 + 4i, so
            // that thread t4's 8 bytes from 8t4 are its slots 4t4.. and
            // 16+4t4.. (section 6); lane l8 packs word l8. The output is
            // multiplied by ps (rowo_s)
            __syncwarp();  // the row's e x v_scale, stored by its 8 lanes
            const float inv = sum > 0.f ? 1.f / sum : 0.f;
            const float ps = fmaxf(pmax * inv, 1e-20f) / 127.f, pc = inv * (1.f / ps);
            if (on) {
              const float* src = p_s + r * PS + 16 * (l8 & 1) + (l8 >> 1);
              unsigned char* dst = p8_s + r * P8S + 4 * l8;
              for (int li = 0; li < n_live; ++li) {
#pragma unroll
                for (int h2 = 0; h2 < kCH; h2 += 32) {
                  const int c = live_s[li] * kCH + h2;
                  const float* x = src + c;
                  *reinterpret_cast<uint32_t*>(dst + c) =
                      pack_rounded(fmaf(x[0], pc, kRound), fmaf(x[4], pc, kRound),
                                   fmaf(x[8], pc, kRound), fmaf(x[12], pc, kRound));
                }
              }
              if (l8 == 0) rowo_s[r] = ps;
            }
          } else if (on && l8 == 0) {
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
    } else if constexpr (kDots) {
      // ---- 6. O += P V on the integer tensor cores (int8_dots), 32
      // columns a k-step: thread t4's slots 4t4+i are tile columns t4 + 4i
      // and its slots 16+4t4+i columns 16 + t4 + 4i (the order of p8_s).
      // V gives one word of each of those columns (4 consecutive elements
      // of the thread's D/8, n-tiles npart*kNTw + ...); the words of 4
      // columns transposed are the B registers of 4 n-tiles
      const int c0 = live_s[i - n_live] * kCH;
      constexpr int kW = (kVBw + 3) / 4;
      for (int kk = kpart; kk < kCH / 32; kk += kKS) {
        const int s0 = 32 * kk + t4;
        uint32_t vw[8][kW];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          load_bytes<kVBw>(tile + (s0 + 4 * (u & 3) + 16 * (u >> 2)) * kD + g * kVB + npart * kVBw,
                           vw[u]);
        uint32_t a[4] = {0u, 0u, 0u, 0u};  // P of rows past nq is never read
        const unsigned char* pa = p8_s + c0 + 32 * kk + 8 * t4;
        if (on0) {
          const uint2 x = *reinterpret_cast<const uint2*>(pa + ra * P8S);
          a[0] = x.x;
          a[2] = x.y;
        }
        if (on1) {
          const uint2 x = *reinterpret_cast<const uint2*>(pa + (ra + 8) * P8S);
          a[1] = x.x;
          a[3] = x.y;
        }
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          uint32_t b0[4], b1[4];
          transpose_bytes(vw[0][w], vw[1][w], vw[2][w], vw[3][w], b0);
          transpose_bytes(vw[4][w], vw[5][w], vw[6][w], vw[7][w], b1);
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (4 * w + x < kNTw) mma_s8(acci[4 * w + x], a, b0[x], b1[x]);
        }
      }
    } else {
      // ---- 6. O += P V on the tensor cores. The column index is permuted
      // so that thread t4 takes columns t4 + {0, 4, 8, 12} of each 16: a
      // k16-step's slots {2t4, 2t4+1, 2t4+8, 2t4+9}, or the slots t4,
      // t4+4 of two k8-steps (columns t4, t4+4, then t4+8, t4+12).
      // int8 V in fp16 (exact) with P x the row factor in fp16 (fp32 q: hi +
      // lo); bf16 V with P split into bf16 hi + lo; fp32 V and P 3xTF32
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
        if constexpr (kTF32) {
          // k8-step st: A slots (g, t4), (g+8, t4), (g, t4+4), (g+8, t4+4)
          // are columns u = 2st, 2st+1 of rows g and g + 8
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int st = 0; st < 2; ++st)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              ah[st][e] = split_tf32(pv[e & 1][2 * st + (e >> 1)], al[st][e]);
#pragma unroll
          for (int j = 0; j < kNTw; ++j)
#pragma unroll
            for (int st = 0; st < 2; ++st) {
              uint32_t l0, l1;
              const uint32_t h0 = split_tf32(__uint_as_float(vw[2 * st][j]), l0);
              const uint32_t h1 = split_tf32(__uint_as_float(vw[2 * st + 1][j]), l1);
              mma_tf32(acc[j], al[st], h0, h1);
              mma_tf32(acc[j], ah[st], l0, l1);
              mma_tf32(acc[j], ah[st], h0, h1);
            }
        } else {
          uint32_t a[4], alo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = pv[e & 1][e & 2], y = pv[e & 1][(e & 2) + 1];
            if constexpr (kQuant) {
              a[e] = split_f16<kF32>(x, y, alo[e]);
            } else {
              a[e] = pack_bf16(x, y);
              alo[e] = pack_bf16(x - bf16_lo(a[e]), y - bf16_hi(a[e]));
            }
          }
#pragma unroll
          for (int j = 0; j < kNTw; ++j) {
            uint32_t b0, b1;
            if constexpr (kQuant) {
              b0 = u8_pair_to_f16(vw[0][j / 4], vw[1][j / 4], j % 4);
              b1 = u8_pair_to_f16(vw[2][j / 4], vw[3][j / 4], j % 4);
              if constexpr (kF32) mma_f16(acc[j], alo, b0, b1);
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
  }
  cp_async_wait<0>();

  // ---- 7. the warps' partial sums meet in the probability buffer (exact
  // int32 sums in int8_dots mode); rows of the block past T are not written
  __syncthreads();
  constexpr int kRS = kD + 1;  // odd row stride: at most 2-way bank conflicts
  float* red_s = p_s;          // [kKS][PR][kRS]
  int* redi_s = reinterpret_cast<int*>(p_s);
#pragma unroll
  for (int j = 0; j < kNTw; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ra + (e >> 1) * 8;
      const int d = (2 * t4 + (e & 1)) * kNT + npart * kNTw + j;
      if (r < nq) {
        if constexpr (kDots) {
          redi_s[(kpart * PR + r) * kRS + d] = acci[j][e];
        } else {
          red_s[(kpart * PR + r) * kRS + d] = acc[j][e];
        }
      }
    }
  __syncthreads();
  for (int i = tid; i < nq * kD; i += kThreadsM) {
    const int r = i / kD;
    const int d = i - r * kD;
    float y = 0.f;
    if constexpr (kDots) {
      int yi = 0;
#pragma unroll
      for (int c = 0; c < kKS; ++c) yi += redi_s[(c * PR + r) * kRS + d];
      if (n_live > 0) y = __int2float_rn(yi) * rowo_s[r];  // int32 x ps
    } else {
#pragma unroll
      for (int c = 0; c < kKS; ++c) y += red_s[(c * PR + r) * kRS + d];
      if (kQuant && n_live > 0) y *= rowo_s[r];  // 2^-k: exact
    }
    ob[static_cast<int64_t>(r) * HD + d] = from_float<QT>(y);
  }
}

template <typename QT, typename CacheT, int kD, int kWR, bool kDots>
int launch_mma_d(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
                 const void* k_scale, const void* v_scale, const void* col_pos,
                 const void* lengths, const void* cursor, void* out, int B, int T, int S, int H,
                 cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(S, kD, sizeof(CacheT), 16 * kWR, T, kDots);
  if (smem > kSmemLimit) return kTooLarge;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(spec_attention_mma_kernel<QT, CacheT, kD, kWR, kDots>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = static_cast<int64_t>((T + 16 * kWR - 1) / (16 * kWR)) * H * B;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  spec_attention_mma_kernel<QT, CacheT, kD, kWR, kDots>
      <<<static_cast<unsigned>(blocks), 32 * mma_warps(16 * kWR), smem, stream>>>(
          static_cast<const QT*>(q), static_cast<CacheT*>(k), static_cast<CacheT*>(v),
          static_cast<const CacheT*>(k_slab), static_cast<const CacheT*>(v_slab),
          static_cast<const __nv_bfloat16*>(k_scale), static_cast<const __nv_bfloat16*>(v_scale),
          static_cast<const int32_t*>(col_pos), static_cast<const int32_t*>(lengths),
          static_cast<const int32_t*>(cursor), static_cast<QT*>(out), T, S, H);
  return cudaGetLastError();
}

// The regime: 64 query rows per block (refresh) for T > 16 where those
// buffers fit shared memory, else 16 (verify, and a refresh over a long
// cache). The head size is a template parameter: 16, 32, 64 or 128
template <typename QT, typename CacheT, bool kDots = false>
int launch_mma(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
               const void* k_scale, const void* v_scale, const void* col_pos,
               const void* lengths, const void* cursor, void* out, int B, int T, int S, int H,
               int D, cudaStream_t stream) {
  const bool refresh =
      T > 16 && mma_smem_bytes(S, D, sizeof(CacheT), 64, T, kDots) <= kSmemLimit;
#define SPEC_MMA_LAUNCH(DD)                                                                  \
  case DD:                                                                                   \
    return refresh ? launch_mma_d<QT, CacheT, DD, 4, kDots>(q, k, v, k_slab, v_slab, k_scale, \
                                                            v_scale, col_pos, lengths,        \
                                                            cursor, out, B, T, S, H, stream)  \
                   : launch_mma_d<QT, CacheT, DD, 1, kDots>(q, k, v, k_slab, v_slab, k_scale, \
                                                            v_scale, col_pos, lengths,        \
                                                            cursor, out, B, T, S, H, stream);
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

// The int8_dots mode (an int8 cache) for a bf16 q (fp32 == 0) or an fp32
// one, as launch_mma launches the other modes. Its instantiations compile
// in spec_attention_dots.cu, beside the other modes' sources; the entry
// points of spec_attention.cu and spec_attention_f32.cu call it.
int launch_mma_dots(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
                    const void* k_scale, const void* v_scale, const void* col_pos,
                    const void* lengths, const void* cursor, void* out, int B, int T, int S,
                    int H, int D, int fp32, cudaStream_t stream);
