// One T=1 grouped-query decode step over a flat KV cache (K1): the kernel
// for G = H/KH > 1, its design and its launchers live in gqa_decode.cuh.
// This source instantiates its lockstep mode and holds the C entry point;
// gqa_decode_ring.cu instantiates the ring mode in its own nvcc process;
// gqa_decode_mha.cuh holds the kernel for G = 1 (multi-head attention).
//
// Replaces the TPU kernel ai_music_generation_tpu/ops/gqa_decode.py::
// _gqa_decode_update (Pallas). The contract and the plain PyTorch twin live
// in ai_music_generation_tpu_torch/ops/gqa_decode.py.

#include "gqa_decode.cuh"

// the kernel for H == KH (G = 1): gqa_decode_mha.cuh, entry in gqa_decode_mha.cu
int gqa_decode_mha_launch(const void* q, void* k, void* v, const void* k_slab,
                          const void* v_slab, void* k_scale, void* v_scale, const void* mask_rel,
                          const void* pos, void* out, int B, int S, int H, int D, int quantized,
                          int fp32, void* stream);

// Plain C entry point (loaded with ctypes). Every pointer is a device
// pointer to a contiguous tensor (k and v on 16-byte boundaries); q, the
// slabs and out are fp32 when fp32 is set, else bf16; the cache is int8
// when quantized is set, else of q's type. k_scale/v_scale are null in
// float-cache mode, mask_rel is null in lockstep mode. H == KH (one query
// head per kv-head) goes to gqa_decode_mha.cuh's kernel in either mode,
// G > 1 to gqa_decode.cuh's. Returns the cudaError_t of the launch (0 =
// launched), or -1 without launching when the block's buffers (G > 1:
// smem_bytes) exceed shared memory.
extern "C" int gqa_decode_update_launch(const void* q, void* k, void* v, const void* k_slab,
                                        const void* v_slab, void* k_scale, void* v_scale,
                                        const void* mask_rel, const void* pos, void* out, int B,
                                        int S, int H, int KH, int D, int quantized, int fp32,
                                        void* stream) {
  if (H == KH)
    return gqa_decode_mha_launch(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel, pos, out, B,
                                 S, H, D, quantized, fp32, stream);
  if (mask_rel)
    return gqa_decode_ring_launch(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel, pos, out, B,
                                  S, H, KH, D, quantized, fp32, stream);
  return dispatch<false>(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel, pos, out, B, S, H,
                         KH, D, quantized, fp32, stream);
}
