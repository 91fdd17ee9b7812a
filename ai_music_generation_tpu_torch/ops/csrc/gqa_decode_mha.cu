// One T=1 decode step over a flat KV cache at G = H/KH = 1 (K1 for
// multi-head attention): the kernel, its design and its launchers live in
// gqa_decode_mha.cuh. This source instantiates its lockstep mode and holds
// gqa_decode_mha_launch, which gqa_decode.cu's entry point calls when
// H == KH; gqa_decode_mha_ring.cu instantiates the ring mode in its own
// nvcc process.
//
// Replaces the TPU kernel ai_music_generation_tpu/ops/gqa_decode.py::
// _gqa_decode_update (Pallas) at G = 1. The contract and the plain PyTorch
// twin live in ai_music_generation_tpu_torch/ops/gqa_decode.py.

#include "gqa_decode_mha.cuh"

// gqa_decode_update_launch's arguments, less KH: returns the cudaError_t of
// the launch (0 = launched).
int gqa_decode_mha_launch(const void* q, void* k, void* v, const void* k_slab,
                          const void* v_slab, void* k_scale, void* v_scale, const void* mask_rel,
                          const void* pos, void* out, int B, int S, int H, int D, int quantized,
                          int fp32, void* stream) {
  if (mask_rel)
    return gqa_decode_mha_ring_launch(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel, pos,
                                      out, B, S, H, D, quantized, fp32, stream);
  return dispatch<false>(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel, pos, out, B, S, H,
                         D, quantized, fp32, stream);
}
