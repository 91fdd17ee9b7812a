// One T=1 grouped-query decode step over a flat KV cache (K1) in ring mode
// (mask_rel given): the kernel of gqa_decode.cuh instantiated for it, in
// its own nvcc process (gqa_decode.cu holds lockstep and the C entry point).

#include "gqa_decode.cuh"

int gqa_decode_ring_launch(const void* q, void* k, void* v, const void* k_slab,
                           const void* v_slab, void* k_scale, void* v_scale, const void* mask_rel,
                           const void* pos, void* out, int B, int S, int H, int KH, int D,
                           int quantized, int fp32, void* stream) {
  return dispatch<true>(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel, pos, out, B, S, H,
                        KH, D, quantized, fp32, stream);
}
