// Speculative-verify attention in int8_dots mode (an int8 spec KV cache
// with bf16 scales): q quantized per (head, query) and the scaled
// probabilities per row to int8, both products on the integer tensor cores
// (mma.sync m16n8k32 s8). This source instantiates the tensor-core kernel
// of spec_attention_mma.cuh in that mode for a bf16 q and for an fp32 one,
// in its own nvcc process beside spec_attention.cu and
// spec_attention_f32.cu, whose entry points call launch_mma_dots. The
// header's note gives the mode's design, what bounds it and its numerics.
//
// Replaces the int8_dots branch of the TPU kernels
// ai_music_generation_tpu/ops/spec_attention.py::_spec_attention_update and
// _spec_attention (their body _make_attend: int8 x int8 MXU dots). The
// plain PyTorch twin is ai_music_generation_tpu_torch/ops/
// spec_attention.py::spec_attention_int8_dots_reference.
//
// Build with nvcc -gencode arch=compute_90a,code=sm_90a and WITHOUT
// --use_fast_math: q's scales max(|q|, 1e-20) / 127 and quotients must be
// rounded as IEEE divisions (div_rn needs the IEEE reciprocal and exact
// fma), and the softmax needs its exp2f and IEEE 1/sum.

#include "spec_attention_mma.cuh"

int launch_mma_dots(const void* q, void* k, void* v, const void* k_slab, const void* v_slab,
                    const void* k_scale, const void* v_scale, const void* col_pos,
                    const void* lengths, const void* cursor, void* out, int B, int T, int S,
                    int H, int D, int fp32, cudaStream_t stream) {
  if (fp32)
    return launch_mma<float, int8_t, true>(q, k, v, k_slab, v_slab, k_scale, v_scale, col_pos,
                                           lengths, cursor, out, B, T, S, H, D, stream);
  return launch_mma<__nv_bfloat16, int8_t, true>(q, k, v, k_slab, v_slab, k_scale, v_scale,
                                                 col_pos, lengths, cursor, out, B, T, S, H, D,
                                                 stream);
}
