// Speculative-verify attention over the flat spec KV cache: T query tokens
// per row, column s readable by query t iff col_pos[b, s] <= lengths[b] + t,
// optionally preceded by the write of the step's Tw-column K/V slab at the
// shared cursor. This source holds the entry point of a bf16 q (a bf16
// model) and instantiates the tensor-core kernel of spec_attention_mma.cuh
// for bf16 q and output over an int8 or a bf16 cache (its note gives the
// design, what bounds it and its numerics). spec_attention_f32.cu
// instantiates it for fp32 and spec_attention_dots.cu in int8_dots mode,
// which this entry point reaches through launch_mma_dots.
//
// Replaces the TPU kernels ai_music_generation_tpu/ops/spec_attention.py::
// _spec_attention_update (slab write + attention) and _spec_attention
// (attention alone), which share their body _make_attend. The contract and
// the plain PyTorch twins live in ai_music_generation_tpu_torch/ops/
// spec_attention.py.
//
// Build with nvcc -gencode arch=compute_90a,code=sm_90a and WITHOUT
// --use_fast_math (exp2f, and the IEEE 1/sum).

#include "spec_attention_mma.cuh"

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
    return launch_mma_dots(q, k, v, k_slab, v_slab, k_scale, v_scale, col_pos, lengths, cursor,
                           out, B, T, S, H, D, 0, st);
  if (quantized)
    return launch_mma<__nv_bfloat16, int8_t>(q, k, v, k_slab, v_slab, k_scale, v_scale,
                                             col_pos, lengths, cursor, out, B, T, S, H, D, st);
  return launch_mma<__nv_bfloat16, __nv_bfloat16>(q, k, v, k_slab, v_slab, k_scale, v_scale,
                                                  col_pos, lengths, cursor, out, B, T, S, H, D,
                                                  st);
}
