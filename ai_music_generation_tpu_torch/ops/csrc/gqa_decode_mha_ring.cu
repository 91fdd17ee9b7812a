// One T=1 decode step over a flat KV cache at G = 1 (K1 for multi-head
// attention) in ring mode (mask_rel given): the kernel of
// gqa_decode_mha.cuh instantiated for it, in its own nvcc process
// (gqa_decode_mha.cu holds lockstep).

#include "gqa_decode_mha.cuh"

int gqa_decode_mha_ring_launch(const void* q, void* k, void* v, const void* k_slab,
                               const void* v_slab, void* k_scale, void* v_scale,
                               const void* mask_rel, const void* pos, void* out, int B, int S,
                               int H, int D, int quantized, int fp32, void* stream) {
  return dispatch<true>(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel, pos, out, B, S, H,
                        D, quantized, fp32, stream);
}
