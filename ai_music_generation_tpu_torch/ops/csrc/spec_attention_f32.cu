// Speculative-verify attention for an fp32 model: fp32 q and output over an
// int8 spec KV cache (bf16 scales) or an fp32 one. This source instantiates
// the tensor-core kernel of spec_attention_mma.cuh for fp32 q and output;
// its note gives the design, what bounds it and the split passes that keep
// the products at fp32 accuracy on the tensor cores (fp16 hi + lo of q and
// P over an int8 cache, 3xTF32 over an fp32 one). spec_attention.cu
// instantiates the same kernel for bf16, in its own nvcc process, and
// spec_attention_dots.cu in int8_dots mode, which this entry point reaches
// through launch_mma_dots.
//
// Replaces, at fp32, the TPU kernels ai_music_generation_tpu/ops/
// spec_attention.py::_spec_attention_update (slab write + attention) and
// _spec_attention (attention alone): the Pallas kernel computes in q's
// dtype, so an fp32 model runs its products at fp32. The contract and the
// plain PyTorch twin live in ai_music_generation_tpu_torch/ops/
// spec_attention.py.
//
// Build with nvcc -gencode arch=compute_90a,code=sm_90a and WITHOUT
// --use_fast_math (exp2f, and the IEEE 1/sum).

#include "spec_attention_mma.cuh"

// Plain C entry point of an fp32 q (loaded with ctypes). Every pointer is a
// device pointer to a contiguous tensor: q and out fp32, the cache and the
// slabs int8 when quantized is set (k_scale/v_scale bf16 then, else null),
// fp32 otherwise. k_slab, v_slab and cursor are null for the attention
// alone and all set for the write + attention; int8_dots needs quantized.
// Returns the cudaError_t of the launch (0 = launched), or -1 without
// launching when the block's buffers exceed shared memory.
extern "C" int spec_attention_f32_launch(const void* q, void* k, void* v, const void* k_slab,
                                         const void* v_slab, const void* k_scale,
                                         const void* v_scale, const void* col_pos,
                                         const void* lengths, const void* cursor, void* out,
                                         int B, int T, int S, int H, int D, int quantized,
                                         int int8_dots, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_dots && !quantized) return static_cast<int>(cudaErrorInvalidValue);
  if (int8_dots)
    return launch_mma_dots(q, k, v, k_slab, v_slab, k_scale, v_scale, col_pos, lengths, cursor,
                           out, B, T, S, H, D, 1, st);
  if (quantized)
    return launch_mma<float, int8_t>(q, k, v, k_slab, v_slab, k_scale, v_scale, col_pos,
                                     lengths, cursor, out, B, T, S, H, D, st);
  return launch_mma<float, float>(q, k, v, k_slab, v_slab, k_scale, v_scale, col_pos, lengths,
                                  cursor, out, B, T, S, H, D, st);
}
